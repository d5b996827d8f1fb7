"""``ray_tpu_torch.inference`` — continuous-batching inference in PyTorch.

The port of ``ray_tpu.inference``: a paged KV cache
(:mod:`~ray_tpu_torch.inference.kv_cache`), bucketed prefill and
fixed-slot decode steps (:mod:`~ray_tpu_torch.inference.engine`), a
host-side scheduler (:mod:`~ray_tpu_torch.inference.scheduler`),
row-independent sampling (:mod:`~ray_tpu_torch.inference.sampling`)
and the speculative-decoding self-drafter
(:mod:`~ray_tpu_torch.inference.spec`).
Config via ``RAY_TPU_INFER_*`` (:func:`infer_config`).
"""

from ray_tpu_torch.inference.config import (InferConfig,  # noqa: F401
                                            default_buckets, infer_config)
from ray_tpu_torch.inference.engine import (InferenceEngine,  # noqa: F401
                                            StepEvent)
from ray_tpu_torch.inference.kv_cache import (KVCache,  # noqa: F401
                                              PageAllocator)
from ray_tpu_torch.inference.sampling import SamplingParams  # noqa: F401
from ray_tpu_torch.inference.scheduler import (  # noqa: F401
    DeadlineExceededError, QueueFullError, Request, SlotScheduler)
from ray_tpu_torch.inference.spec import DraftState  # noqa: F401

__all__ = [
    "InferConfig", "infer_config", "default_buckets",
    "InferenceEngine", "StepEvent", "KVCache", "PageAllocator",
    "SamplingParams", "QueueFullError", "DeadlineExceededError",
    "Request", "SlotScheduler", "DraftState",
]
