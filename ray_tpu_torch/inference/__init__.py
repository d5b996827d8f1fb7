"""``ray_tpu_torch.inference`` — continuous-batching inference in PyTorch.

The port of ``ray_tpu.inference``: a paged KV cache with disaggregated
handoff and the tiered spill (:mod:`~ray_tpu_torch.inference.kv_cache`),
bucketed prefill and fixed-slot decode steps with deadlines, telemetry
and request tracing (:mod:`~ray_tpu_torch.inference.engine`), a
host-side scheduler (:mod:`~ray_tpu_torch.inference.scheduler`),
row-independent sampling (:mod:`~ray_tpu_torch.inference.sampling`)
and the speculative-decoding self-drafter
(:mod:`~ray_tpu_torch.inference.spec`).
Config via ``RAY_TPU_INFER_*`` and ``RAY_TPU_KV_*`` (:func:`infer_config`).
"""

from ray_tpu_torch.inference.config import (InferConfig,  # noqa: F401
                                            default_buckets, infer_config)
from ray_tpu_torch.inference.engine import (InferenceEngine,  # noqa: F401
                                            StepEvent)
from ray_tpu_torch.inference.kv_cache import (  # noqa: F401
    HandoffContentMissing, HostPagePool, KVCache, KVHandoff, KVPageStore,
    PageAllocator, PrefixIndex)
from ray_tpu_torch.inference.sampling import SamplingParams  # noqa: F401
from ray_tpu_torch.inference.scheduler import (  # noqa: F401
    DeadlineExceededError, QueueFullError, Request, SlotScheduler)
from ray_tpu_torch.inference.spec import DraftState  # noqa: F401

__all__ = [
    "InferConfig", "infer_config", "default_buckets",
    "InferenceEngine", "StepEvent", "KVCache", "PageAllocator",
    "PrefixIndex", "KVHandoff", "HandoffContentMissing",
    "HostPagePool", "KVPageStore",
    "SamplingParams", "QueueFullError", "DeadlineExceededError",
    "Request", "SlotScheduler", "DraftState",
]
