"""Streaming-data-plane env knobs — the single home for input-pipeline
config.  The port's copy of ``ray_tpu/data/config.py`` (the same
variables, defaults and clamps).

Follows the ``resilience_config()`` / ``rl_config()`` precedent: one
frozen dataclass resolved from the environment once, ``refresh=True``
for tests and A/B drivers that flip flags after import.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input-pipeline knobs, resolved once from the environment.

    - ``RAY_TPU_DATA_PREFETCH`` (default ``2``): bounded prefetch-queue
      depth in batches between the packer and the trainer.  The
      producer thread blocks when the queue is full — backpressure by
      construction, an unbounded queue would convert a slow trainer
      into unbounded host memory.
    - ``RAY_TPU_DATA_READERS`` (default ``0``): shard-reader actor
      replicas.  ``0`` reads shards in-process on the producer thread
      (host-sim/tests); ``>= 1`` spawns that many restartable reader
      actors (needs an initialized ray_tpu_torch session).
    - ``RAY_TPU_DATA_RETRIES`` (default ``3``): reader-restart /
      pack-retry budget per fetch.  A read that keeps failing past it
      raises a typed :class:`~ray_tpu_torch.data.stream.DataPlaneError`
      instead of spinning forever.
    - ``RAY_TPU_DATA_PACK`` (default ``1``): sample packing — fill each
      ``[B, S]`` row with multiple documents under segment-aware
      attention masking, reclaiming padding FLOPs.  ``0`` gives every
      document its own row (pad-to-S), the unpacked A/B arm.
    - ``RAY_TPU_DATA_READ_TIMEOUT`` (default ``120``): seconds a
      reader-actor fetch may take before it counts as failed (the
      reader is restarted and the fetch re-issued against the retry
      budget).  Raise it for cold/slow shard storage — a healthy slow
      fetch must not be converted into restarts.
    - ``RAY_TPU_DATA_HEDGE`` (default ``0`` = off): shard-read hedge
      budget in seconds — a read that has not returned within it is
      re-issued to a standby reader, first response wins (the loser's
      identical result is discarded; exactly-once holds because
      sources are pure and only the cursor advances consumption).
      The gray-failure mitigation for the slow-but-alive shard.
    - ``RAY_TPU_DATA_STALL_S`` (default ``0.2``): **deprecated alias**
      — seconds a bare ``data.stall@N`` chaos entry sleeps inside a
      shard read.  Superseded by the unified ``site@N:delay=S`` /
      ``site@N..M:delay=S`` latency grammar (``util/chaos.py``),
      which needs no side-channel knob; kept so old specs replay.
    """
    prefetch: int = 2
    readers: int = 0
    retries: int = 3
    pack: bool = True
    read_timeout_s: float = 120.0
    hedge_s: float = 0.0
    stall_s: float = 0.2


_CONFIG: Optional[DataConfig] = None


def data_config(refresh: bool = False) -> DataConfig:
    """The process-wide :class:`DataConfig` (env read once, cached)."""
    global _CONFIG
    if _CONFIG is None or refresh:
        env = os.environ.get
        prefetch = int(env("RAY_TPU_DATA_PREFETCH", "2"))
        if prefetch < 1:
            print(f"RAY_TPU_DATA_PREFETCH={prefetch} must be >= 1 "
                  "(the trainer needs at least one staged batch); "
                  "using 1", file=sys.stderr)
            prefetch = 1
        readers = int(env("RAY_TPU_DATA_READERS", "0"))
        if readers < 0:
            print(f"RAY_TPU_DATA_READERS={readers} negative; using 0 "
                  "(in-process reads)", file=sys.stderr)
            readers = 0
        retries = int(env("RAY_TPU_DATA_RETRIES", "3"))
        if retries < 0:
            print(f"RAY_TPU_DATA_RETRIES={retries} negative; using 0 "
                  "(fail on the first error)", file=sys.stderr)
            retries = 0
        _CONFIG = DataConfig(
            prefetch=prefetch,
            readers=readers,
            retries=retries,
            pack=env("RAY_TPU_DATA_PACK", "1") != "0",
            read_timeout_s=float(env("RAY_TPU_DATA_READ_TIMEOUT",
                                     "120")),
            hedge_s=max(0.0, float(env("RAY_TPU_DATA_HEDGE", "0"))),
            stall_s=float(env("RAY_TPU_DATA_STALL_S", "0.2")),
        )
    return _CONFIG
