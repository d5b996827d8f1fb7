# The port's copy of ray_tpu/experimental/tqdm_ray.py
"""Distributed-safe progress bars (parity:
``python/ray/experimental/tqdm_ray.py``).

Plain ``tqdm`` from many worker processes interleaves garbage on the
driver's terminal.  Here each bar publishes its state through the
control-plane pubsub channel ``__tqdm__``; the driver side (hooked into
the log monitor's terminal) renders one line per live bar.  Workers
never touch the tty.

Usage inside a task/actor::

    from ray_tpu_torch.experimental import tqdm_ray
    for x in tqdm_ray.tqdm(range(1000), desc="shard 3"):
        ...
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Dict, Iterable, Optional


def _cp():
    from ray_tpu_torch._private.worker import global_worker
    w = global_worker()
    return w.cp if w is not None else None


_CHANNEL = "__tqdm__"


class tqdm:  # noqa: N801 - match the tqdm API
    """API-compatible subset of ``tqdm.tqdm``: iteration, ``update``,
    ``set_description``, ``close``, context manager."""

    def __init__(self, iterable: Optional[Iterable] = None,
                 desc: str = "", total: Optional[int] = None,
                 flush_interval_s: float = 0.2):
        self._iterable = iterable
        self.desc = desc
        if total is None and iterable is not None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        self.total = total
        self.n = 0
        self._bar_id = uuid.uuid4().hex[:12]
        self._flush_interval = flush_interval_s
        self._last_flush = 0.0
        self._closed = False
        self._publish()

    # ------------------------------------------------------------------
    def __iter__(self):
        assert self._iterable is not None, "no iterable given"
        try:
            for x in self._iterable:
                yield x
                self.update(1)
        finally:
            self.close()

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.monotonic()
        if now - self._last_flush >= self._flush_interval:
            self._publish()

    def set_description(self, desc: str) -> None:
        self.desc = desc
        self._publish()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._publish(done=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _publish(self, done: bool = False) -> None:
        self._last_flush = time.monotonic()
        cp = _cp()
        if cp is None:
            return
        try:
            cp.publish(_CHANNEL, {
                "bar_id": self._bar_id, "desc": self.desc,
                "n": self.n, "total": self.total, "done": done,
                "pid": os.getpid(),
            })
        except Exception:  # noqa: BLE001 - progress is best-effort
            pass


class DriverSideRenderer:
    """Driver-side consumer: renders every live bar as one tty line.

    Started by the driver (``tqdm_ray.install()``); polls the pubsub
    channel and repaints on change.  Rendering collapses when stdout is
    not a tty (CI): bars print once at completion instead.
    """

    def __init__(self):
        self._bars: Dict[str, Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._painted_lines = 0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tqdm-render")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        cp = _cp()
        if cp is None:
            return
        seq = 0
        while not self._stop.is_set():
            try:
                seq, msgs = cp.poll(_CHANNEL, seq, 0.5)
            except Exception:  # noqa: BLE001 - session shutting down
                return
            changed = False
            for m in msgs or []:
                changed = True
                if m.get("done"):
                    bar = self._bars.pop(m["bar_id"], None)
                    if bar is not None and not os.isatty(1):
                        print(self._format(m))
                else:
                    self._bars[m["bar_id"]] = m
            if changed and os.isatty(1):
                self._paint()

    @staticmethod
    def _format(m: Dict[str, Any]) -> str:
        total = m.get("total")
        if total:
            pct = 100.0 * m["n"] / total
            return (f"{m.get('desc') or m['bar_id']}: "
                    f"{m['n']}/{total} ({pct:.0f}%)")
        return f"{m.get('desc') or m['bar_id']}: {m['n']}"

    def _paint(self) -> None:
        # move cursor up over the previous frame, repaint every bar
        out = ""
        if self._painted_lines:
            out += f"\x1b[{self._painted_lines}F\x1b[J"
        lines = [self._format(m) for m in self._bars.values()]
        out += "\n".join(lines) + ("\n" if lines else "")
        print(out, end="", flush=True)
        self._painted_lines = len(lines)


_renderer: Optional[DriverSideRenderer] = None


def install() -> DriverSideRenderer:
    """Start the driver-side renderer (idempotent)."""
    global _renderer
    if _renderer is None:
        _renderer = DriverSideRenderer()
        _renderer.start()
    return _renderer
