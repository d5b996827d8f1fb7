"""Training straggler supervisor: detect the step that is slow, not
dead.  The port's copy of ``ray_tpu/resilience/straggler.py``.

A synchronous train step is gated by its slowest participant, so one
straggling rank taxes every step of the run without tripping any of the
binary fault machinery (deadlines, watchdogs, ``mesh.loss``).  This
module gives the synchronous train loop the detection half, and
:func:`~ray_tpu_torch.resilience.elastic.run_elastic_train_loop`
converts a sustained straggle into the degraded-mesh shrink the elastic
loop already survives — snapshot, rebuild without the straggler's
capacity, keep the global batch via scaled gradient accumulation —
instead of stalling the run at the straggler's pace.

Detection is deliberately conservative (the fleet's median/dwell
vocabulary):

- the **baseline** is a rolling median of recent *accepted* step wall
  times — robust to the one-off outlier, and slow samples never enter
  it (a sustained straggle must not drag the baseline up until the
  straggle looks normal);
- a step is **slow** when its wall exceeds
  ``RAY_TPU_STRAGGLER_FACTOR`` x the baseline;
- only ``RAY_TPU_STRAGGLER_DWELL`` *consecutive* slow steps fire an
  event — a cold compile, a GC pause or one preempted host tick is a
  blip, not a straggle (and the first steps of a run cannot fire at
  all: the baseline needs ``min_samples`` accepted steps first).

The ``mesh.step`` chaos site (``util/chaos.py``,
``mesh.step@N..M:delay=S``) injects exactly this failure mode
deterministically: the elastic loop's step wall stretches by ``S`` for
the window, and the supervisor must convert it into a shrink.
"""

from __future__ import annotations

import collections
import statistics
from typing import Deque, Dict, List

from ray_tpu_torch.resilience.config import resilience_config


class StragglerSupervisor:
    """Per-step wall-time watcher; :meth:`observe` returns True when a
    sustained straggle should be handled as a degraded-mesh event.

    ``factor``/``dwell``/``window`` default from
    ``RAY_TPU_STRAGGLER_{FACTOR,DWELL,WINDOW}``; ``factor=0`` disables
    (every observe returns False).  Call :meth:`reset` after any
    topology change — step walls legitimately shift with the mesh size
    and accumulation factor, and a stale baseline would misread the
    new normal as a straggle.

    Baselines are kept **per tier** (the ``tier`` kwarg on
    :meth:`observe`/:meth:`baseline_s`): a DCN-crossing step on a
    multi-pod mesh is legitimately slower than an ICI-only one, so
    flagging it against an ICI baseline would convert every cross-pod
    step into a phantom straggle.  The elastic loop passes
    ``tier="dcn"`` when the live mesh has a ``dcn`` axis > 1 and
    ``tier="ici"`` otherwise; callers that never mix tiers can ignore
    the kwarg (everything lands in one ``"default"`` bucket).  Slow
    streaks are per-tier too — alternating tiers must not interleave
    into one phantom streak.
    """

    def __init__(self, *, factor: float = None, dwell: int = None,
                 window: int = None, min_samples: int = 3):
        rcfg = resilience_config()
        self.factor = rcfg.straggler_factor if factor is None \
            else float(factor)
        self.dwell = rcfg.straggler_dwell if dwell is None \
            else int(dwell)
        if self.dwell < 1:
            raise ValueError(f"straggler dwell must be >= 1, got "
                             f"{self.dwell} (RAY_TPU_STRAGGLER_DWELL)")
        window = rcfg.straggler_window if window is None else int(window)
        if window < min_samples:
            raise ValueError(
                f"straggler window ({window}) must hold at least "
                f"min_samples ({min_samples}) steps")
        self.min_samples = int(min_samples)
        self._window = int(window)
        self._walls: Dict[str, Deque[float]] = {}
        self._streaks: Dict[str, int] = {}
        self.events = 0
        self.slow_steps = 0
        self.event_log: List[dict] = []

    @property
    def enabled(self) -> bool:
        return self.factor > 0

    def _tier_walls(self, tier: str) -> Deque[float]:
        if tier not in self._walls:
            self._walls[tier] = collections.deque(maxlen=self._window)
        return self._walls[tier]

    def baseline_s(self, tier: str = "default") -> float:
        """The tier's rolling-median step wall (0.0 until enough
        samples)."""
        walls = self._walls.get(tier)
        if walls is None or len(walls) < self.min_samples:
            return 0.0
        return statistics.median(walls)

    def observe(self, wall_s: float, tier: str = "default") -> bool:
        """Feed one step's wall seconds; True when this step completes
        a sustained straggle (``dwell`` consecutive slow steps against
        the SAME tier's baseline) — the caller should shrink the mesh
        and :meth:`reset`."""
        if not self.enabled:
            return False
        wall_s = float(wall_s)
        walls = self._tier_walls(tier)
        base = self.baseline_s(tier)
        if base <= 0.0:
            # baseline still forming: accept unconditionally — the
            # cold-compile step lands here as one median-robust
            # outlier, never as a straggle verdict
            walls.append(wall_s)
            return False
        if wall_s <= self.factor * base:
            walls.append(wall_s)
            self._streaks[tier] = 0
            return False
        # slow: count the streak, keep the sample OUT of the baseline
        self.slow_steps += 1
        streak = self._streaks.get(tier, 0) + 1
        self._streaks[tier] = streak
        if streak < self.dwell:
            return False
        self.events += 1
        self.event_log.append({"wall_s": round(wall_s, 6),
                               "baseline_s": round(base, 6),
                               "streak": streak,
                               "tier": tier})
        self._streaks[tier] = 0
        return True

    def reset(self) -> None:
        """Forget every tier's baseline and streak (topology changed:
        the new mesh has a new normal)."""
        self._walls.clear()
        self._streaks.clear()
