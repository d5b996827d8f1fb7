"""Checkpoint telemetry: write latency, cadence, failure counts.

The port's copy of ``ray_tpu/telemetry/ckpt.py`` (the same series,
names and labels).  The async train checkpointer records one entry per
snapshot write (wall seconds on the *background* thread — the figure that says whether writes keep up with
the cadence, not whether they stall the step loop) plus the last
successfully persisted step.  Sinks: Prometheus through the
control plane when a session is up (``train_checkpoint_seconds``
histogram, ``train_last_checkpoint_step`` gauge), and :meth:`summary`
as the ``checkpoint`` block of driver JSON.

``RAY_TPU_TELEMETRY=0`` disables recording entirely.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List

from ray_tpu_torch.telemetry.config import telemetry_config

_WRITE_BOUNDARIES = [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0]


class CkptTelemetry:
    """Per-checkpointer recorder for snapshot-write records."""

    _MAX_RECORDS = 10_000

    def __init__(self, *, label: str = "train", config=None):
        tcfg = config or telemetry_config()
        self.enabled: bool = tcfg.enabled
        self.label = label
        self.writes: List[Dict[str, Any]] = []
        self.write_count = 0
        self.failed_count = 0
        self.last_step = -1
        self._metrics = None
        self._metrics_dead = False

    # ---------------------------------------------------------- records
    def record_write(self, wall_s: float, *, step: int) -> None:
        """One completed snapshot write (background thread)."""
        if not self.enabled:
            return
        self.write_count += 1
        self.last_step = int(step)
        self.writes.append({"wall_s": wall_s, "step": int(step)})
        del self.writes[:-self._MAX_RECORDS]
        self._emit(wall_s, step)

    def record_failure(self) -> None:
        """A snapshot write that raised (I/O error, injected fault):
        the trainer keeps going — a failed checkpoint must never kill
        the run it exists to protect — so failures get a counter the
        operator can alarm on instead."""
        if self.enabled:
            self.failed_count += 1

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        """The ``checkpoint`` block for driver JSON."""
        if not self.enabled:
            return {"enabled": False}
        out: Dict[str, Any] = {
            "enabled": True, "label": self.label,
            "checkpoints": self.write_count,
            "failed": self.failed_count,
            "last_checkpoint_step": self.last_step,
        }
        if self.writes:
            out["write_s"] = statistics.median(
                r["wall_s"] for r in self.writes)
            out["write_max_s"] = max(r["wall_s"] for r in self.writes)
        return out

    # ------------------------------------------------------- prometheus
    def _metric_objects(self):
        from ray_tpu_torch._private.worker import is_initialized
        if not is_initialized():
            return None
        if self._metrics is None:
            from ray_tpu_torch.util.metrics import Gauge, Histogram
            tags = ("label",)
            self._metrics = {
                "write": Histogram(
                    "train_checkpoint_seconds",
                    "async TrainState snapshot write wall seconds",
                    boundaries=_WRITE_BOUNDARIES, tag_keys=tags),
                "last_step": Gauge(
                    "train_last_checkpoint_step",
                    "last training step persisted to a checkpoint",
                    tag_keys=tags),
            }
        return self._metrics

    def _emit(self, wall_s: float, step: int):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                tags = {"label": self.label}
                metrics["write"].observe(wall_s, tags=tags)
                metrics["last_step"].set(float(step), tags=tags)
        except Exception:  # noqa: BLE001 — never tax the train loop
            self._metrics_dead = True
