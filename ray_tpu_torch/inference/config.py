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
- ``RAY_TPU_INFER_PREFIX`` (default ``0``): prefix caching is not ported
  yet, so it defaults off here and the engine raises when it is on.
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
    prefix: bool = False
    max_queue: int = 0


_CONFIG: Optional[InferConfig] = None


def infer_config(refresh: bool = False) -> InferConfig:
    """The process-wide :class:`InferConfig` (env read once, cached)."""
    global _CONFIG
    if _CONFIG is None or refresh:
        env = os.environ.get
        raw_buckets = env("RAY_TPU_INFER_BUCKETS", "")
        buckets = tuple(sorted(int(b) for b in raw_buckets.split(",")
                               if b.strip())) if raw_buckets else ()
        max_queue = int(env("RAY_TPU_INFER_MAX_QUEUE", "0"))
        if max_queue < 0:
            print(f"RAY_TPU_INFER_MAX_QUEUE={max_queue} negative; "
                  "using 0 (unbounded)", file=sys.stderr)
            max_queue = 0
        _CONFIG = InferConfig(
            slots=int(env("RAY_TPU_INFER_SLOTS", "8")),
            page_size=int(env("RAY_TPU_INFER_PAGE_SIZE", "128")),
            pages=int(env("RAY_TPU_INFER_PAGES", "0")),
            buckets=buckets,
            prefix=env("RAY_TPU_INFER_PREFIX", "0") != "0",
            max_queue=max_queue,
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
