"""Engine watchdog: detect a wedged step loop.

Counterpart of ``ray_tpu/resilience/watchdog.py``.  The engine stamps
``ticks``/``last_tick_ts`` at the end of every completed ``step()``; a
background thread declares a **wedge** when the engine has work pending
and neither stamp has moved for ``timeout_s`` (``RAY_TPU_INFER_WATCHDOG``
for the callers that read the config).  Detection is apart from
reaction: by default a wedge warns on stderr and counts (``wedges``);
``on_wedge`` injects the policy.  A wedge fires once per stall episode,
and progress re-arms it.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional


class EngineWatchdog:
    """Liveness monitor over one engine (anything with ``has_work()``,
    ``ticks`` and ``last_tick_ts``).  ``on_wedge(engine)`` runs on the
    watchdog thread, once per episode.  A context manager."""

    def __init__(self, engine, *, timeout_s: float,
                 poll_s: Optional[float] = None,
                 on_wedge: Optional[Callable] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s} "
                             "(check RAY_TPU_INFER_WATCHDOG)")
        self.engine = engine
        self.timeout_s = float(timeout_s)
        self.poll_s = poll_s if poll_s is not None else \
            min(self.timeout_s / 4, 0.5)
        self.on_wedge = on_wedge
        self.wedges = 0
        self.last_wedge_ts: Optional[float] = None
        self._fired_at_tick: Optional[int] = None
        # after an idle stretch the engine's last_tick_ts is stale by
        # construction (nothing steps an empty engine), so the stall
        # clock restarts when work arrives
        self._idle = True
        self._busy_since = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check(self, now: Optional[float] = None) -> bool:
        """One liveness probe (the thread calls it; tests can too).
        True when a wedge fired on this probe."""
        now = time.monotonic() if now is None else now
        eng = self.engine
        if not eng.has_work():
            self._fired_at_tick = None
            self._idle = True
            return False
        if self._idle:
            # idle -> busy: the last tick predates this work (on the card,
            # a cold engine's first step also builds the kernels)
            self._idle = False
            self._busy_since = now
            return False
        ticks = eng.ticks
        if now - max(eng.last_tick_ts, self._busy_since) \
                <= self.timeout_s:
            if self._fired_at_tick is not None \
                    and ticks != self._fired_at_tick:
                self._fired_at_tick = None  # progress resumed: re-arm
            return False
        if self._fired_at_tick == ticks:
            return False                    # this episode already fired
        self._fired_at_tick = ticks
        self.wedges += 1
        self.last_wedge_ts = now
        if self.on_wedge is not None:
            try:
                self.on_wedge(eng)
            except Exception as e:  # noqa: BLE001 — the dog must live
                print(f"EngineWatchdog on_wedge callback failed: "
                      f"{e!r}", file=sys.stderr)
        else:
            print(f"EngineWatchdog: engine wedged — work pending and "
                  f"no step completed for > {self.timeout_s:.1f}s "
                  f"(ticks={ticks}, waiting="
                  f"{len(eng.scheduler.waiting)}, active="
                  f"{len(eng.scheduler.active)})", file=sys.stderr)
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception as e:  # noqa: BLE001 — the dog must live
                print(f"EngineWatchdog probe failed: {e!r}",
                      file=sys.stderr)

    def start(self) -> "EngineWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="engine-watchdog")
            self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return self.wedges

    def __enter__(self) -> "EngineWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
