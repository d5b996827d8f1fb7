"""Elastic-training telemetry: mesh size, reshard latency, transitions.

The port's copy of ``ray_tpu/telemetry/elastic.py`` (the same series,
names and labels).  The elastic supervisor records one entry per topology transition (shrink or
expand — the reshard wall seconds cover host snapshot/restore +
the copy onto the new mesh, the window in which no step runs)
plus the live device count.  Sinks: Prometheus through the
control plane when a session is up (``train_mesh_devices`` gauge,
``train_reshard_seconds`` histogram, ``train_elastic_transitions_total``
counter split by kind), and :meth:`summary` as the ``elastic`` block of
driver JSON.

``RAY_TPU_TELEMETRY=0`` disables recording entirely.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List

from ray_tpu_torch.telemetry.config import telemetry_config

_RESHARD_BOUNDARIES = [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0]


class ElasticTelemetry:
    """Per-loop recorder for elastic mesh transitions."""

    def __init__(self, *, label: str = "train", config=None):
        tcfg = config or telemetry_config()
        self.enabled: bool = tcfg.enabled
        self.label = label
        self.mesh_devices = 0
        self.transitions: Dict[str, int] = {}
        self.reshards: List[float] = []
        self.straggler_events = 0
        self._metrics = None
        self._metrics_dead = False

    # ---------------------------------------------------------- records
    def record_mesh(self, n_devices: int) -> None:
        """The current topology (call at loop start and after every
        transition — the gauge an operator watches during a shrink)."""
        if not self.enabled:
            return
        self.mesh_devices = int(n_devices)
        self._emit("mesh")

    def record_transition(self, kind: str, reshard_s: float, *,
                          n_devices: int) -> None:
        """One completed shrink/expand: the new device count and the
        reshard wall seconds (snapshot/restore + the copy — steps
        are stalled for exactly this long)."""
        if not self.enabled:
            return
        if kind not in ("shrink", "expand"):
            raise ValueError(f"unknown transition kind {kind!r}; "
                             "expected 'shrink' or 'expand'")
        self.transitions[kind] = self.transitions.get(kind, 0) + 1
        self.reshards.append(float(reshard_s))
        self.mesh_devices = int(n_devices)
        self._emit("transition", kind=kind, reshard_s=reshard_s)

    def record_straggler(self) -> None:
        """One sustained-straggle event from the straggler supervisor
        (the gray-failure counter — fires whether or not the loop
        could shrink in response)."""
        if not self.enabled:
            return
        self.straggler_events += 1
        self._emit("straggler")

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        """The ``elastic`` block for driver JSON."""
        if not self.enabled:
            return {"enabled": False}
        out: Dict[str, Any] = {
            "enabled": True, "label": self.label,
            "mesh_devices": self.mesh_devices,
            "transitions": dict(self.transitions),
            "transitions_total": sum(self.transitions.values()),
            "straggler_events": self.straggler_events,
        }
        if self.reshards:
            out["reshard_s"] = statistics.median(self.reshards)
            out["reshard_max_s"] = max(self.reshards)
        return out

    # ------------------------------------------------------- prometheus
    def _metric_objects(self):
        from ray_tpu_torch._private.worker import is_initialized
        if not is_initialized():
            return None
        if self._metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram
            tags = ("label",)
            self._metrics = {
                "devices": Gauge(
                    "train_mesh_devices",
                    "devices in the live training mesh",
                    tag_keys=tags),
                "reshard": Histogram(
                    "train_reshard_seconds",
                    "cross-mesh state reshard wall seconds",
                    boundaries=_RESHARD_BOUNDARIES, tag_keys=tags),
                "transitions": Counter(
                    "train_elastic_transitions_total",
                    "elastic mesh transitions, split by kind "
                    "(shrink/expand)",
                    tag_keys=tags + ("kind",)),
                "stragglers": Counter(
                    "train_straggler_events_total",
                    "sustained train-step straggles detected by the "
                    "straggler supervisor",
                    tag_keys=tags),
            }
        return self._metrics

    def _emit(self, what: str, *, kind: str = "",
              reshard_s: float = 0.0):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is None:
                return
            tags = {"label": self.label}
            metrics["devices"].set(float(self.mesh_devices), tags=tags)
            if what == "transition":
                metrics["reshard"].observe(reshard_s, tags=tags)
                metrics["transitions"].inc(
                    1.0, tags={**tags, "kind": kind})
            elif what == "straggler":
                metrics["stragglers"].inc(1.0, tags=tags)
        except Exception:  # noqa: BLE001 — never tax the train loop
            self._metrics_dead = True
