"""Inference-engine env knobs, the port's counterpart of
``ray_tpu/inference/config.py`` with only the knobs this slice honours.

- ``RAY_TPU_INFER_SLOTS`` (default ``8``): decode batch slots.
- ``RAY_TPU_INFER_PAGE_SIZE`` (default ``128``): tokens per KV page.
- ``RAY_TPU_INFER_PAGES`` (default ``0`` = auto: every slot at full
  context plus the reserved garbage page).
- ``RAY_TPU_INFER_BUCKETS`` (default unset = powers of two from 32 up to
  ``max_seq``): comma-separated prefill length buckets.
- ``RAY_TPU_INFER_MAX_QUEUE`` (default ``0`` = unbounded): waiting-queue
  cap; over-cap submits raise ``QueueFullError``.
- ``RAY_TPU_INFER_PREFIX`` (default ``1``): prefix caching, on as in
  the JAX package; ``0`` turns it off.
- ``RAY_TPU_KV_DTYPE`` (default ``model``): ``int8`` stores the KV cache
  as int8 codes with per-(position, head) f32 scales; an unknown value
  falls back to ``model`` with a line on stderr.
- ``RAY_TPU_INFER_SPEC`` (default ``0`` = off): speculative decoding
  by default.  The self-drafter proposes up to ``spec_k`` tokens per
  slot from the request's own context, one verify forward scores them,
  and exact acceptance keeps the output plain decode's (greedy
  bit-exact, sampled trajectory-exact).  ``SamplingParams.spec``
  overrides it per request.
- ``RAY_TPU_INFER_SPEC_K`` (default ``4``): the draft length cap per
  verify step; under 1 falls back to 4 with a line on stderr.
  ``SamplingParams.spec_k`` overrides it per request.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InferConfig:
    slots: int = 8
    page_size: int = 128
    pages: int = 0
    buckets: Tuple[int, ...] = ()
    kv_dtype: str = "model"
    prefix: bool = True
    max_queue: int = 0
    spec: bool = False
    spec_k: int = 4


_CONFIG: Optional[InferConfig] = None


def infer_config(refresh: bool = False) -> InferConfig:
    """The process-wide :class:`InferConfig` (env read once, cached)."""
    global _CONFIG
    if _CONFIG is None or refresh:
        env = os.environ.get
        raw_buckets = env("RAY_TPU_INFER_BUCKETS", "")
        buckets = tuple(sorted(int(b) for b in raw_buckets.split(",")
                               if b.strip())) if raw_buckets else ()
        kv_dtype = env("RAY_TPU_KV_DTYPE", "model")
        if kv_dtype not in ("model", "int8"):
            print(f"RAY_TPU_KV_DTYPE={kv_dtype!r} unknown; "
                  "using 'model'", file=sys.stderr)
            kv_dtype = "model"
        max_queue = int(env("RAY_TPU_INFER_MAX_QUEUE", "0"))
        if max_queue < 0:
            print(f"RAY_TPU_INFER_MAX_QUEUE={max_queue} negative; "
                  "using 0 (unbounded)", file=sys.stderr)
            max_queue = 0
        spec_k = int(env("RAY_TPU_INFER_SPEC_K", "4"))
        if spec_k < 1:
            print(f"RAY_TPU_INFER_SPEC_K={spec_k} < 1; using 4",
                  file=sys.stderr)
            spec_k = 4
        _CONFIG = InferConfig(
            slots=int(env("RAY_TPU_INFER_SLOTS", "8")),
            page_size=int(env("RAY_TPU_INFER_PAGE_SIZE", "128")),
            pages=int(env("RAY_TPU_INFER_PAGES", "0")),
            buckets=buckets,
            kv_dtype=kv_dtype,
            prefix=env("RAY_TPU_INFER_PREFIX", "1") != "0",
            max_queue=max_queue,
            spec=env("RAY_TPU_INFER_SPEC", "0") != "0",
            spec_k=spec_k,
        )
    return _CONFIG


def default_buckets(max_seq: int, smallest: int = 32) -> Tuple[int, ...]:
    """Powers of two from ``smallest`` up to (and including) ``max_seq``."""
    out = []
    b = min(smallest, max_seq)
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)
