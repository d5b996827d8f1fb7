"""Resilience env knobs — the single home for checkpoint/recovery config.
The port's copy of ``ray_tpu/resilience/config.py`` (the same variables,
defaults and clamps).

Follows the ``infer_config()`` / ``rl_config()`` precedent: one frozen
dataclass resolved from the environment once, ``refresh=True`` for
tests and A/B drivers that flip flags after import.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Checkpoint/recovery knobs, resolved once from the environment.

    - ``RAY_TPU_CKPT_EVERY`` (default ``0`` = off): training steps
      between async TrainState snapshots.  The snapshot (device->host
      copy) runs on the training thread; the disk write runs on the
      checkpointer's background thread, off the critical path.
    - ``RAY_TPU_CKPT_DIR`` (default unset): checkpoint directory.  A
      :class:`~ray_tpu_torch.resilience.checkpoint.TrainCheckpointer` built
      without an explicit directory uses this; with neither set,
      checkpointing is off.
    - ``RAY_TPU_CKPT_KEEP`` (default ``3``): retained snapshots —
      retention rides ``train/checkpoint_manager.py`` (newest-first;
      the corrupt-restore fallback walks these in order).
    - ``RAY_TPU_ELASTIC_MIN_DEVICES`` (default ``1``): the smallest
      mesh :func:`~ray_tpu_torch.resilience.elastic.run_elastic_train_loop`
      will degrade to on a ``mesh.loss`` event — below it the loss is
      fatal (a 1-device "fleet" may be worse than waiting for quota).
    - ``RAY_TPU_ELASTIC_GRACEFUL`` (default ``1``): whether a mesh
      loss gets a final host snapshot (the eviction-notice model:
      zero lost steps) or must restore from the latest retained
      checkpoint (hard preemption: lost work bounded by the cadence).
    - ``RAY_TPU_STRAGGLER_FACTOR`` (default ``0`` = off): straggler
      threshold — a train step slower than this multiple of the
      rolling-median baseline counts as slow
      (:class:`~ray_tpu_torch.resilience.straggler.StragglerSupervisor`).
    - ``RAY_TPU_STRAGGLER_DWELL`` (default ``3``): consecutive slow
      steps before a straggle event fires — a cold compile or one GC
      pause is a blip, never a shrink.
    - ``RAY_TPU_STRAGGLER_WINDOW`` (default ``16``): rolling-baseline
      window in accepted (non-slow) step samples.
    """
    ckpt_every: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    elastic_min_devices: int = 1
    elastic_graceful: bool = True
    straggler_factor: float = 0.0
    straggler_dwell: int = 3
    straggler_window: int = 16


_CONFIG: Optional[ResilienceConfig] = None


def resilience_config(refresh: bool = False) -> ResilienceConfig:
    """The process-wide :class:`ResilienceConfig` (env read once)."""
    global _CONFIG
    if _CONFIG is None or refresh:
        env = os.environ.get
        every = int(env("RAY_TPU_CKPT_EVERY", "0"))
        if every < 0:
            print(f"RAY_TPU_CKPT_EVERY={every} negative; using 0 "
                  "(checkpointing off)", file=sys.stderr)
            every = 0
        keep = int(env("RAY_TPU_CKPT_KEEP", "3"))
        if keep < 1:
            print(f"RAY_TPU_CKPT_KEEP={keep} must be >= 1 (resume "
                  "needs at least the latest snapshot); using 1",
                  file=sys.stderr)
            keep = 1
        min_dev = int(env("RAY_TPU_ELASTIC_MIN_DEVICES", "1"))
        if min_dev < 1:
            print(f"RAY_TPU_ELASTIC_MIN_DEVICES={min_dev} must be "
                  ">= 1; using 1", file=sys.stderr)
            min_dev = 1
        factor = float(env("RAY_TPU_STRAGGLER_FACTOR", "0"))
        if factor < 0:
            print(f"RAY_TPU_STRAGGLER_FACTOR={factor} negative; "
                  "using 0 (straggler detection off)", file=sys.stderr)
            factor = 0.0
        dwell = int(env("RAY_TPU_STRAGGLER_DWELL", "3"))
        if dwell < 1:
            print(f"RAY_TPU_STRAGGLER_DWELL={dwell} must be >= 1; "
                  "using 1", file=sys.stderr)
            dwell = 1
        window = int(env("RAY_TPU_STRAGGLER_WINDOW", "16"))
        if window < 3:
            print(f"RAY_TPU_STRAGGLER_WINDOW={window} must be >= 3 "
                  "(the baseline is a median); using 3",
                  file=sys.stderr)
            window = 3
        _CONFIG = ResilienceConfig(
            ckpt_every=every,
            ckpt_dir=env("RAY_TPU_CKPT_DIR") or None,
            ckpt_keep=keep,
            elastic_min_devices=min_dev,
            elastic_graceful=env("RAY_TPU_ELASTIC_GRACEFUL", "1")
            not in ("0", "false", "False"),
            straggler_factor=factor,
            straggler_dwell=dwell,
            straggler_window=window,
        )
    return _CONFIG
