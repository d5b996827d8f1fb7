"""RL-loop telemetry: rollout throughput, publish latency, staleness.

Counterpart of ``ray_tpu/telemetry/rl.py``: the third recorder family,
beside :class:`~ray_tpu_torch.telemetry.step.StepTelemetry` (training)
and :class:`~ray_tpu_torch.telemetry.infer.InferTelemetry` (serving):
the RL loop records one entry per rollout batch, per learner step and
per weight publication, and the staleness
signal — ``param_version_lag``, how many publications behind the
trained-on trajectories were generated — rides a Prometheus gauge so
an operator can see actor/learner skew without reading logs.  Sinks:
Prometheus through the port's control plane when a session is up
(``rl_rollout_tokens_per_sec`` / ``rl_learner_steps_per_sec`` /
``rl_param_version_lag`` gauges, ``rl_weight_publish_seconds``
histogram), and :meth:`summary` as the ``telemetry`` block of
an RL run's result.

``RAY_TPU_TELEMETRY=0`` disables recording entirely.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List

from ray_tpu_torch.telemetry.config import telemetry_config

_PUBLISH_BOUNDARIES = [0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                       0.01, 0.025, 0.05, 0.1, 0.25, 1.0, 5.0]


class RLTelemetry:
    """Per-loop recorder for rollout/learner/publish records."""

    _MAX_RECORDS = 10_000
    _EMIT_INTERVAL_S = 0.5

    def __init__(self, *, label: str = "rl", config=None):
        tcfg = config or telemetry_config()
        self.enabled: bool = tcfg.enabled
        self.label = label
        self.rollouts: List[Dict[str, Any]] = []
        self.learner_steps: List[Dict[str, Any]] = []
        self.publishes: List[Dict[str, Any]] = []
        self.rollout_count = 0
        self.rollout_tokens = 0
        self.learner_step_count = 0
        self.publish_count = 0
        self.param_version = 0
        self.version_lags: List[int] = []
        self.drops: Dict[str, int] = {}
        self.backpressure = 0
        self.actor_restarts = 0
        self.learner_restarts = 0
        self._metrics = None
        self._metrics_dead = False
        self._metrics_last = 0.0

    # ---------------------------------------------------------- records
    def record_rollout(self, wall_s: float, *, tokens: int,
                       param_version: int) -> None:
        if not self.enabled:
            return
        self.rollout_count += 1
        self.rollout_tokens += tokens
        self.rollouts.append({"wall_s": wall_s, "tokens": tokens,
                              "param_version": param_version})
        del self.rollouts[:-self._MAX_RECORDS]
        self._emit_rates()

    def record_learner_step(self, wall_s: float, *,
                            version_lag: int) -> None:
        if not self.enabled:
            return
        self.learner_step_count += 1
        self.version_lags.append(int(version_lag))
        del self.version_lags[:-self._MAX_RECORDS]
        self.learner_steps.append({"wall_s": wall_s,
                                   "version_lag": int(version_lag)})
        del self.learner_steps[:-self._MAX_RECORDS]
        self._emit_lag(version_lag)

    def record_publish(self, wall_s: float, *, version: int) -> None:
        if not self.enabled:
            return
        self.publish_count += 1
        self.param_version = int(version)
        self.publishes.append({"wall_s": wall_s, "version": version})
        del self.publishes[:-self._MAX_RECORDS]
        self._emit_publish(wall_s)

    def record_backpressure(self) -> None:
        """A full-queue put rejected under the ``wait`` policy: the
        producer holds the batch and retries — NOT a drop (the batch
        is still trained eventually), so it gets its own counter."""
        if self.enabled:
            self.backpressure += 1

    def record_actor_restart(self) -> None:
        """A rollout actor died (engine fault, injected kill) and the
        supervisor replaced it — the fleet-health signal
        (``rl_actor_restarts_total``) for preemptible actor pools."""
        if not self.enabled:
            return
        self.actor_restarts += 1
        self._emit_restart()

    def record_learner_restart(self) -> None:
        """The learner was restored from its checkpoint mid-loop."""
        if self.enabled:
            self.learner_restarts += 1

    def record_queue_counters(self, *, drops_stale: int,
                              drops_overflow: int) -> None:
        """Final queue accounting (the loop stamps these at
        shutdown so the summary and the queue always agree)."""
        if self.enabled:
            self.drops["stale"] = int(drops_stale)
            self.drops["overflow"] = int(drops_overflow)

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        """The ``telemetry`` block for an RL run's result."""
        if not self.enabled:
            return {"enabled": False}
        out: Dict[str, Any] = {
            "enabled": True, "label": self.label,
            "rollouts": self.rollout_count,
            "rollout_tokens": self.rollout_tokens,
            "learner_steps": self.learner_step_count,
            "publishes": self.publish_count,
            "param_version": self.param_version,
            "drops": dict(self.drops),
            "backpressure_rejections": self.backpressure,
            "actor_restarts": self.actor_restarts,
            "learner_restarts": self.learner_restarts,
        }
        if self.rollouts:
            wall = sum(r["wall_s"] for r in self.rollouts)
            tok = sum(r["tokens"] for r in self.rollouts)
            if wall > 0:
                out["rollout_tokens_per_sec"] = tok / wall
            out["rollout_s"] = statistics.median(
                r["wall_s"] for r in self.rollouts)
        if self.learner_steps:
            # steady learner rate: drop the first step (it carries the
            # cold start: the first kernel launches, allocator growth),
            # the StepTelemetry policy
            steady = self.learner_steps[1:] or self.learner_steps
            wall = sum(r["wall_s"] for r in steady)
            if wall > 0:
                out["learner_steps_per_sec"] = len(steady) / wall
            out["learner_step_s"] = statistics.median(
                r["wall_s"] for r in steady)
        if self.version_lags:
            out["version_lag_mean"] = statistics.fmean(
                self.version_lags)
            out["version_lag_max"] = max(self.version_lags)
        if self.publishes:
            out["publish_s"] = statistics.median(
                r["wall_s"] for r in self.publishes)
            out["publish_max_s"] = max(r["wall_s"]
                                       for r in self.publishes)
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
                "restarts": Counter(
                    "rl_actor_restarts_total",
                    "rollout actors restarted by the supervisor",
                    tag_keys=tags),
                "rollout_tok": Gauge("rl_rollout_tokens_per_sec",
                                     "actor rollout token throughput",
                                     tag_keys=tags),
                "learner_rate": Gauge("rl_learner_steps_per_sec",
                                      "learner update throughput",
                                      tag_keys=tags),
                "lag": Gauge("rl_param_version_lag",
                             "publications behind: version lag of the "
                             "last trained-on trajectory batch",
                             tag_keys=tags),
                "publish": Histogram(
                    "rl_weight_publish_seconds",
                    "weight snapshot publish latency",
                    boundaries=_PUBLISH_BOUNDARIES, tag_keys=tags),
            }
        return self._metrics

    def _emit_rates(self):
        if self._metrics_dead:
            return
        now = time.monotonic()
        if (self.rollout_count > 1
                and now - self._metrics_last < self._EMIT_INTERVAL_S):
            return
        self._metrics_last = now
        try:
            metrics = self._metric_objects()
            if metrics is None:
                return
            tags = {"label": self.label}
            last = self.rollouts[-1]
            if last["wall_s"] > 0:
                metrics["rollout_tok"].set(
                    last["tokens"] / last["wall_s"], tags=tags)
            steady = self.learner_steps[1:] or self.learner_steps
            wall = sum(r["wall_s"] for r in steady)
            if wall > 0:
                metrics["learner_rate"].set(len(steady) / wall,
                                            tags=tags)
        except Exception:  # noqa: BLE001 — never tax the loop
            self._metrics_dead = True

    def _emit_restart(self):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["restarts"].inc(1.0,
                                        tags={"label": self.label})
        except Exception:  # noqa: BLE001 — never tax the loop
            self._metrics_dead = True

    def _emit_lag(self, lag: int):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["lag"].set(float(lag),
                                   tags={"label": self.label})
        except Exception:  # noqa: BLE001 — never tax the loop
            self._metrics_dead = True

    def _emit_publish(self, wall_s: float):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["publish"].observe(wall_s,
                                           tags={"label": self.label})
        except Exception:  # noqa: BLE001 — never tax the loop
            self._metrics_dead = True
