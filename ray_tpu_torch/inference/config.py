"""Inference-engine env knobs, the port's counterpart of
``ray_tpu/inference/config.py`` with the knobs the port honours.

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
- ``RAY_TPU_INFER_TTFT_DEADLINE`` (default ``0`` = none): the default
  time-to-first-token budget in seconds; a request still waiting past
  it is retired with ``DeadlineExceededError`` on its stream.
- ``RAY_TPU_INFER_DEADLINE`` (default ``0`` = none): the default total
  budget in seconds (submit to last token); expiry mid-decode retires
  the request and releases its slot, pages and prefix references.
- ``RAY_TPU_INFER_WATCHDOG`` (default ``0`` = off): the stall budget of
  ``resilience.watchdog.EngineWatchdog`` in seconds.
- ``RAY_TPU_INFER_STREAM_IDLE`` (default ``0`` = off): the serve
  deployment's idle-stream budget in seconds.  A request whose stream
  has tokens waiting but has not been read for this long is cancelled
  (slot, pages and prefix references released) instead of decoding to
  ``max_new_tokens`` for a reader that is gone.
- ``RAY_TPU_KV_HOST_PAGES`` (default ``0`` = tiering off): pages in the
  per-engine host spill pool (tier 1).  With it set, pressure on the
  device pages demotes an idle prefix page to the host instead of
  forgetting it, and admission promotes it back.
- ``RAY_TPU_KV_STORE`` (default ``1``): with tiering on, share a
  content-addressed page store (tier 2) under the host pool; ``0`` caps
  the tiers at the host pool.
- ``RAY_TPU_KV_STORE_CAP`` (default ``0`` = unbounded): the store's
  byte cap; over-cap puts evict the least recently used entries that no
  fetch holds.
- ``RAY_TPU_KV_SPILL_DTYPE`` (default ``int8``): the spill format of a
  model-dtype cache's pages, ``int8`` (per-vector codes and scales,
  ``head_dim + 4`` bytes a vector) or ``model`` (exact).  An int8 cache
  spills its codes and scales as they are.

Negative counts and budgets fall back to 0 and unknown names to the
default, each with a line on stderr, as in the JAX package.
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
    ttft_deadline: float = 0.0
    deadline: float = 0.0
    watchdog: float = 0.0
    stream_idle: float = 0.0
    spec: bool = False
    spec_k: int = 4
    host_pages: int = 0
    store: bool = True
    store_cap: int = 0
    spill_dtype: str = "int8"


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

        def nonneg_float(name, off_meaning):
            val = float(env(name, "0"))
            if val < 0:
                print(f"{name}={val} negative; using 0 "
                      f"({off_meaning})", file=sys.stderr)
                return 0.0
            return val

        spec_k = int(env("RAY_TPU_INFER_SPEC_K", "4"))
        if spec_k < 1:
            print(f"RAY_TPU_INFER_SPEC_K={spec_k} < 1; using 4",
                  file=sys.stderr)
            spec_k = 4
        host_pages = int(env("RAY_TPU_KV_HOST_PAGES", "0"))
        if host_pages < 0:
            print(f"RAY_TPU_KV_HOST_PAGES={host_pages} negative; "
                  "using 0 (tiering off)", file=sys.stderr)
            host_pages = 0
        store_cap = int(env("RAY_TPU_KV_STORE_CAP", "0"))
        if store_cap < 0:
            print(f"RAY_TPU_KV_STORE_CAP={store_cap} negative; "
                  "using 0 (unbounded)", file=sys.stderr)
            store_cap = 0
        spill_dtype = env("RAY_TPU_KV_SPILL_DTYPE", "int8")
        if spill_dtype not in ("int8", "model"):
            print(f"RAY_TPU_KV_SPILL_DTYPE={spill_dtype!r} unknown; "
                  "using 'int8'", file=sys.stderr)
            spill_dtype = "int8"
        _CONFIG = InferConfig(
            slots=int(env("RAY_TPU_INFER_SLOTS", "8")),
            page_size=int(env("RAY_TPU_INFER_PAGE_SIZE", "128")),
            pages=int(env("RAY_TPU_INFER_PAGES", "0")),
            buckets=buckets,
            kv_dtype=kv_dtype,
            prefix=env("RAY_TPU_INFER_PREFIX", "1") != "0",
            max_queue=max_queue,
            ttft_deadline=nonneg_float("RAY_TPU_INFER_TTFT_DEADLINE",
                                       "no TTFT deadline"),
            deadline=nonneg_float("RAY_TPU_INFER_DEADLINE",
                                  "no total deadline"),
            watchdog=nonneg_float("RAY_TPU_INFER_WATCHDOG",
                                  "watchdog off"),
            stream_idle=nonneg_float("RAY_TPU_INFER_STREAM_IDLE",
                                     "idle-stream reaper off"),
            spec=env("RAY_TPU_INFER_SPEC", "0") != "0",
            spec_k=spec_k,
            host_pages=host_pages,
            store=env("RAY_TPU_KV_STORE", "1") != "0",
            store_cap=store_cap,
            spill_dtype=spill_dtype,
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
