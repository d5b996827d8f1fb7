"""Input-pipeline telemetry: tok/s in, prefetch depth, trainer stalls.

The port's copy of ``ray_tpu/telemetry/data.py`` (the same series,
names and labels).  The streaming data plane records one entry per produced batch (packed
tokens + producer wall), one per consumer pop (how long the trainer
blocked on input — the figure that says whether the pipeline keeps up),
and counters for reader restarts and pack retries.  Sinks:
Prometheus through the control plane when a session is up
(``data_input_tokens_per_sec`` gauge, ``data_prefetch_depth`` gauge,
``data_stall_seconds`` histogram, ``data_reader_restarts_total``
counter), and :meth:`summary` as the ``data`` block of driver JSON.

``RAY_TPU_TELEMETRY=0`` disables recording entirely.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.telemetry.config import telemetry_config

_STALL_BOUNDARIES = [0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0]


class DataTelemetry:
    """Per-loader recorder for the streaming input pipeline."""

    def __init__(self, *, label: str = "train", config=None):
        tcfg = config or telemetry_config()
        self.enabled: bool = tcfg.enabled
        self.label = label
        self.batches = 0
        self.input_tokens = 0
        self.producer_wall_s = 0.0
        self.stall_s_total = 0.0
        self.stall_s_max = 0.0
        self.stalls = 0
        self.reader_restarts = 0
        self.pack_retries = 0
        self.read_hedges = 0
        self.read_hedges_won = 0
        self._depth_sum = 0
        self._metrics = None
        self._metrics_dead = False

    # ---------------------------------------------------------- records
    def record_batch(self, packed_tokens: int, wall_s: float, *,
                     queue_depth: int = 0) -> None:
        """One batch produced (producer thread): non-pad tokens and
        the wall seconds since the previous batch left the packer."""
        if not self.enabled:
            return
        self.batches += 1
        self.input_tokens += int(packed_tokens)
        self.producer_wall_s += max(float(wall_s), 0.0)
        self._depth_sum += int(queue_depth)
        self._emit("batch", queue_depth=queue_depth)

    def record_stall(self, seconds: float) -> None:
        """One consumer pop: how long the trainer blocked on input
        (~0 when the prefetch queue keeps up)."""
        if not self.enabled:
            return
        seconds = max(float(seconds), 0.0)
        self.stalls += 1
        self.stall_s_total += seconds
        self.stall_s_max = max(self.stall_s_max, seconds)
        self._emit("stall", stall_s=seconds)

    def record_reader_restart(self) -> None:
        """A shard reader died (injected or real) and was restarted;
        the fetch was re-issued — counted, never silently absorbed."""
        if not self.enabled:
            return
        self.reader_restarts += 1
        self._emit("restart")

    def record_pack_retry(self) -> None:
        if self.enabled:
            self.pack_retries += 1

    def record_read_hedge(self, *, won: bool) -> None:
        """A shard read outlived its hedge budget and a standby read
        was raced against it; ``won`` when the standby's
        response was the one used."""
        if not self.enabled:
            return
        self.read_hedges += 1
        if won:
            self.read_hedges_won += 1

    # ---------------------------------------------------------- summary
    def input_tok_s(self) -> float:
        return (self.input_tokens / self.producer_wall_s
                if self.producer_wall_s > 0 else 0.0)

    def summary(self) -> Dict[str, Any]:
        """The ``data`` block for driver JSON."""
        if not self.enabled:
            return {"enabled": False}
        out: Dict[str, Any] = {
            "enabled": True, "label": self.label,
            "batches": self.batches,
            "input_tokens": self.input_tokens,
            "input_tok_s": round(self.input_tok_s(), 1),
            "stall_s_total": round(self.stall_s_total, 6),
            "stall_s_max": round(self.stall_s_max, 6),
            "reader_restarts": self.reader_restarts,
            "pack_retries": self.pack_retries,
            "read_hedges": self.read_hedges,
            "read_hedges_won": self.read_hedges_won,
        }
        if self.batches:
            out["prefetch_depth_mean"] = round(
                self._depth_sum / self.batches, 3)
            out["packed_tokens_per_batch"] = round(
                self.input_tokens / self.batches, 1)
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
                "tok_s": Gauge(
                    "data_input_tokens_per_sec",
                    "input-pipeline packed tokens produced per second",
                    tag_keys=tags),
                "depth": Gauge(
                    "data_prefetch_depth",
                    "prefetch-queue depth at the last produced batch",
                    tag_keys=tags),
                "stall": Histogram(
                    "data_stall_seconds",
                    "seconds the trainer blocked waiting for input",
                    boundaries=_STALL_BOUNDARIES, tag_keys=tags),
                "restarts": Counter(
                    "data_reader_restarts_total",
                    "shard-reader restarts (fetch re-issued)",
                    tag_keys=tags),
            }
        return self._metrics

    def _emit(self, kind: str, *, queue_depth: int = 0,
              stall_s: float = 0.0):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is None:
                return
            tags = {"label": self.label}
            if kind == "batch":
                metrics["tok_s"].set(self.input_tok_s(), tags=tags)
                metrics["depth"].set(float(queue_depth), tags=tags)
            elif kind == "stall":
                metrics["stall"].observe(stall_s, tags=tags)
            elif kind == "restart":
                metrics["restarts"].inc(1.0, tags=tags)
        except Exception:  # noqa: BLE001 — never tax the input path
            self._metrics_dead = True
