# The port's copy of ray_tpu/telemetry/fleet.py
"""Fleet telemetry: routing, reconciliation and disaggregation records.

The fleet routers and the reconciler record every retry (split by
cause: a dead replica, a draining one, a full queue), every replica
restart, per-replica queue depth and the prefix-affinity hit rate; the
gray-failure series (hedges by outcome ``issued`` / ``won`` /
``wasted``, race winners, latency demotions, the per-replica EWMA
latency score); and the disaggregation series (every KV handoff's
bytes, wall seconds and pages, warm skips, per-pool queue depth, TTFT
split by pool mode).  Sinks: Prometheus through the runtime's metrics
when a ``ray_tpu_torch`` session is up, and nothing without one
(``serve_router_retries_total`` / ``serve_replica_restarts_total`` /
``serve_hedges_total`` / ``serve_replica_demotions_total`` /
``serve_handoff_bytes_total`` counters, ``serve_handoff_seconds`` /
``serve_ttft_seconds`` histograms, ``serve_replica_queue_depth`` /
``serve_replica_latency_score`` / ``serve_pool_queue_depth`` /
``serve_fleet_affinity_hit_rate`` gauges); and
:meth:`FleetTelemetry.summary`, the ``fleet`` block, key for key the
reference's.

``RAY_TPU_TELEMETRY=0`` disables recording entirely.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List

from ray_tpu_torch.telemetry.config import telemetry_config

_HANDOFF_BOUNDARIES = [0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                       0.01, 0.025, 0.05, 0.1, 0.25, 1.0]
_TTFT_BOUNDARIES = [0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0]


class FleetTelemetry:
    """Per-fleet recorder for routing/reconciliation events."""

    _EMIT_INTERVAL_S = 0.5

    def __init__(self, *, label: str = "fleet", config=None):
        tcfg = config or telemetry_config()
        self.enabled: bool = tcfg.enabled
        self.label = label
        # cause -> count; causes: "dead" (replica death/wedge failover
        # or a failed routed submit), "draining", "queue_full"
        self.retries: Dict[str, int] = {}
        self.replica_restarts = 0
        self.affinity_routed = 0
        self.affinity_decisions = 0
        self.queue_depths: Dict[str, int] = {}
        # outcome -> count; outcomes: "issued" (hedge submitted),
        # "won" (the hedge delivered the stream), "wasted" (the
        # primary did — the hedge's work was thrown away)
        self.hedges: Dict[str, int] = {}
        # winner -> count for resolved hedge races ("primary" /
        # "hedge") — the r24 /metrics view of race outcomes
        self.hedge_winners: Dict[str, int] = {}
        # cause -> count for completed failovers ("dead" / "wedged" /
        # "handoff" / ...) — previously only visible per-stream
        self.failovers: Dict[str, int] = {}
        self.replica_demotions = 0
        self.latency_scores: Dict[str, float] = {}
        # r20 disaggregation series: handoff accounting + per-pool
        # depth gauges + TTFT populations split by pool mode
        self.handoffs = 0
        self.handoffs_skipped = 0
        self.handoff_bytes = 0
        self.handoff_pages = 0
        self.handoff_s: List[float] = []
        self.pool_depths: Dict[str, int] = {}
        self.ttfts_by_mode: Dict[str, List[float]] = {}
        self._metrics = None
        self._metrics_dead = False
        self._depth_last: Dict[str, float] = {}
        self._latency_last: Dict[str, float] = {}
        self._pool_last: Dict[str, float] = {}
        self._rate_last = 0.0

    # ---------------------------------------------------------- records
    def record_retry(self, cause: str) -> None:
        """One routed request re-routed or failed over (``cause`` in
        ``dead`` / ``draining`` / ``queue_full``) — the fleet's
        churn signal: a rising rate means replicas are dying,
        draining under scale-down, or shedding load."""
        if not self.enabled:
            return
        self.retries[cause] = self.retries.get(cause, 0) + 1
        self._emit_retry(cause)

    def record_restart(self) -> None:
        """The reconciler replaced a wedged/dead replica."""
        if not self.enabled:
            return
        self.replica_restarts += 1
        self._emit_restart()

    def record_hedge(self, outcome: str) -> None:
        """One hedge event: ``issued`` when the router races a second
        replica for an over-deadline first token, then exactly one of
        ``won`` (the hedge carried the stream) / ``wasted`` (the
        primary did) when the race resolves."""
        if outcome not in ("issued", "won", "wasted"):
            raise ValueError(f"unknown hedge outcome {outcome!r}; "
                             "expected issued/won/wasted")
        if not self.enabled:
            return
        self.hedges[outcome] = self.hedges.get(outcome, 0) + 1
        self._emit_hedge(outcome)

    def record_hedge_won(self, winner: str) -> None:
        """One resolved hedge race, by ``winner`` (``primary`` /
        ``hedge``) — ``serve_hedges_won_total`` makes the race outcome
        visible on ``/metrics`` instead of only as per-stream
        attributes."""
        if winner not in ("primary", "hedge"):
            raise ValueError(f"unknown hedge winner {winner!r}; "
                             "expected primary/hedge")
        if not self.enabled:
            return
        self.hedge_winners[winner] = \
            self.hedge_winners.get(winner, 0) + 1
        self._emit_hedge_won(winner)

    def record_failover(self, cause: str) -> None:
        """One in-flight stream failed over to another replica, by
        cause (``dead`` — replica death/wedge — or ``handoff`` — a
        faulted disagg transfer leg).  Distinct from
        ``record_retry``: retries count *submission* re-routes too;
        this counts only mid-stream recoveries."""
        if not self.enabled:
            return
        self.failovers[cause] = self.failovers.get(cause, 0) + 1
        self._emit_failover(cause)

    def record_demotion(self, replica_id: str) -> None:
        """The router demoted a replica for latency (its EWMA tick
        latency crossed slow_factor x the fleet median) — counted once
        per demotion episode, not per routing decision."""
        if not self.enabled:
            return
        self.replica_demotions += 1
        self._emit_demotion(replica_id)

    def record_latency_score(self, replica_id: str,
                             score: float) -> None:
        """Per-replica EWMA tick-latency gauge (throttled per replica
        — the router records every poll)."""
        if not self.enabled:
            return
        self.latency_scores[replica_id] = float(score)
        if self._metrics_dead:
            return
        now = time.monotonic()
        if now - self._latency_last.get(replica_id, 0.0) \
                < self._EMIT_INTERVAL_S:
            return
        self._latency_last[replica_id] = now
        self._emit_latency(replica_id, score)

    _MAX_RECORDS = 10_000

    def record_handoff(self, *, n_bytes: int, seconds: float,
                       pages: int, skipped: bool = False,
                       trace_id: str = None) -> None:
        """One prefill→decode KV handoff (r20): content bytes moved
        through the object store (0 for a warm, metadata-only handoff
        — counted in ``handoffs_skipped``), wall seconds export→import,
        and the page count behind the byte math.  ``trace_id`` rides
        the latency histogram as an exemplar (r24)."""
        if not self.enabled:
            return
        self.handoffs += 1
        if skipped:
            self.handoffs_skipped += 1
        self.handoff_bytes += int(n_bytes)
        self.handoff_pages += int(pages)
        if len(self.handoff_s) < self._MAX_RECORDS:
            self.handoff_s.append(float(seconds))
        self._emit_handoff(n_bytes, seconds, trace_id)

    def record_pool_depth(self, pool: str, depth: int) -> None:
        """Aggregate queue depth of one pool (``prefill`` /
        ``decode``) — the disagg scale signals: prefill backlog is
        admission pressure, decode backlog is slot occupancy
        (throttled per pool; the router records every poll)."""
        if not self.enabled:
            return
        self.pool_depths[pool] = int(depth)
        if self._metrics_dead:
            return
        now = time.monotonic()
        if now - self._pool_last.get(pool, 0.0) < self._EMIT_INTERVAL_S:
            return
        self._pool_last[pool] = now
        self._emit_pool_depth(pool, depth)

    def record_ttft(self, seconds: float, *, mode: str,
                    trace_id: str = None) -> None:
        """Per-request time-to-first-token, split by pool mode
        (``disagg`` when a dedicated prefill pool served it,
        ``colocated`` for the single-pool fleet) — the comparison the
        split exists for: prefill interference shows up exactly here
        and in the decode inter-token tail.  ``trace_id`` rides the
        histogram as an exemplar (r24): the jump from a p99 bucket to
        that one request's flight-recorder span tree."""
        if not self.enabled:
            return
        bucket = self.ttfts_by_mode.setdefault(mode, [])
        if len(bucket) < self._MAX_RECORDS:
            bucket.append(float(seconds))
        self._emit_ttft(seconds, mode, trace_id)

    def record_affinity(self, *, hit: bool) -> None:
        """One routing decision with affinity enabled: ``hit`` when a
        prefix-digest match picked the replica (the fleet-wide cache
        working), False when routing fell through to pow-2."""
        if not self.enabled:
            return
        self.affinity_decisions += 1
        if hit:
            self.affinity_routed += 1
        self._emit_affinity()

    def record_queue_depth(self, replica_id: str, depth: int) -> None:
        """Per-replica queue-depth gauge (throttled per replica —
        the router records every poll)."""
        if not self.enabled:
            return
        self.queue_depths[replica_id] = int(depth)
        if self._metrics_dead:
            return
        now = time.monotonic()
        if now - self._depth_last.get(replica_id, 0.0) \
                < self._EMIT_INTERVAL_S:
            return
        self._depth_last[replica_id] = now
        self._emit_depth(replica_id, depth)

    def forget_replica(self, replica_id: str) -> None:
        """Drop a stopped replica's gauge state."""
        self.queue_depths.pop(replica_id, None)
        self._depth_last.pop(replica_id, None)
        self.latency_scores.pop(replica_id, None)
        self._latency_last.pop(replica_id, None)

    # ---------------------------------------------------------- summary
    @property
    def affinity_hit_rate(self) -> float:
        if not self.affinity_decisions:
            return 0.0
        return self.affinity_routed / self.affinity_decisions

    def summary(self) -> Dict[str, Any]:
        """The ``fleet`` block for multi-replica bench JSON."""
        if not self.enabled:
            return {"enabled": False}

        def pct(xs, q):
            return xs[min(len(xs) - 1, int(q * len(xs)))]

        ttft_by_mode = {}
        for mode, xs in self.ttfts_by_mode.items():
            srt = sorted(xs)
            ttft_by_mode[mode] = {
                "count": len(srt),
                "mean_s": statistics.fmean(srt) if srt else 0.0,
                "p50_s": pct(srt, 0.50) if srt else 0.0,
                "p99_s": pct(srt, 0.99) if srt else 0.0,
            }
        return {
            "enabled": True, "label": self.label,
            "router_retries": dict(self.retries),
            "router_retries_total": sum(self.retries.values()),
            "replica_restarts": self.replica_restarts,
            "affinity_decisions": self.affinity_decisions,
            "affinity_routed": self.affinity_routed,
            "affinity_hit_rate": self.affinity_hit_rate,
            "replica_queue_depth": dict(self.queue_depths),
            "hedges": dict(self.hedges),
            "hedge_winners": dict(self.hedge_winners),
            "failovers": dict(self.failovers),
            "replica_demotions": self.replica_demotions,
            "replica_latency_score": dict(self.latency_scores),
            # r20 disaggregation block
            "handoffs": self.handoffs,
            "handoffs_skipped": self.handoffs_skipped,
            "handoff_bytes_total": self.handoff_bytes,
            "handoff_pages_total": self.handoff_pages,
            "handoff_s_mean": (statistics.fmean(self.handoff_s)
                               if self.handoff_s else 0.0),
            "handoff_s_max": (max(self.handoff_s)
                              if self.handoff_s else 0.0),
            "pool_queue_depth": dict(self.pool_depths),
            "ttft_s_by_mode": ttft_by_mode,
        }

    # ------------------------------------------------------- prometheus
    def _metric_objects(self):
        from ray_tpu_torch._private.worker import is_initialized
        if not is_initialized():
            return None
        if self._metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram
            self._metrics = {
                "retries": Counter(
                    "serve_router_retries_total",
                    "routed requests re-routed or failed over, by "
                    "cause (dead / draining / queue_full)",
                    tag_keys=("label", "cause")),
                "restarts": Counter(
                    "serve_replica_restarts_total",
                    "replicas replaced by the fleet reconciler",
                    tag_keys=("label",)),
                "depth": Gauge(
                    "serve_replica_queue_depth",
                    "waiting + active requests on one replica",
                    tag_keys=("label", "replica")),
                "affinity": Gauge(
                    "serve_fleet_affinity_hit_rate",
                    "share of routing decisions won by a prefix-"
                    "affinity digest match",
                    tag_keys=("label",)),
                "hedges": Counter(
                    "serve_hedges_total",
                    "tail-latency hedges, by outcome (issued / won / "
                    "wasted)",
                    tag_keys=("label", "outcome")),
                "hedges_won": Counter(
                    "serve_hedges_won_total",
                    "resolved hedge races, by winner (primary / "
                    "hedge)",
                    tag_keys=("label", "winner")),
                "failovers": Counter(
                    "serve_failovers_total",
                    "mid-stream failovers to another replica, by "
                    "cause (dead / handoff)",
                    tag_keys=("label", "cause")),
                "demotions": Counter(
                    "serve_replica_demotions_total",
                    "replicas demoted from routing for EWMA tick "
                    "latency past slow_factor x the fleet median",
                    tag_keys=("label",)),
                "latency": Gauge(
                    "serve_replica_latency_score",
                    "EWMA engine-tick wall seconds for one replica "
                    "(the gray-failure health score)",
                    tag_keys=("label", "replica")),
                "handoff_bytes": Counter(
                    "serve_handoff_bytes_total",
                    "KV-page content bytes moved prefill->decode "
                    "through the object store (warm handoffs move 0)",
                    tag_keys=("label",)),
                "handoff_s": Histogram(
                    "serve_handoff_seconds",
                    "wall seconds per KV handoff, export through "
                    "decode-side admission",
                    boundaries=_HANDOFF_BOUNDARIES,
                    tag_keys=("label",)),
                "pool_depth": Gauge(
                    "serve_pool_queue_depth",
                    "aggregate waiting + active requests in one "
                    "disagg pool (prefill / decode)",
                    tag_keys=("label", "pool")),
                "ttft": Histogram(
                    "serve_ttft_seconds",
                    "per-request time-to-first-token, split by pool "
                    "mode (disagg / colocated)",
                    boundaries=_TTFT_BOUNDARIES,
                    tag_keys=("label", "mode")),
            }
        return self._metrics

    def _emit_hedge(self, outcome: str):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["hedges"].inc(
                    1.0, tags={"label": self.label,
                               "outcome": outcome})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_demotion(self, replica_id: str):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["demotions"].inc(1.0,
                                         tags={"label": self.label})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_latency(self, replica_id: str, score: float):
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["latency"].set(
                    float(score),
                    tags={"label": self.label, "replica": replica_id})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_hedge_won(self, winner: str):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["hedges_won"].inc(
                    1.0, tags={"label": self.label, "winner": winner})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_failover(self, cause: str):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["failovers"].inc(
                    1.0, tags={"label": self.label, "cause": cause})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_handoff(self, n_bytes: int, seconds: float,
                      trace_id: str = None):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["handoff_bytes"].inc(
                    float(n_bytes), tags={"label": self.label})
                metrics["handoff_s"].observe(
                    float(seconds), tags={"label": self.label},
                    exemplar=({"trace_id": trace_id}
                              if trace_id else None))
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_pool_depth(self, pool: str, depth: int):
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["pool_depth"].set(
                    float(depth),
                    tags={"label": self.label, "pool": pool})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_ttft(self, seconds: float, mode: str,
                   trace_id: str = None):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["ttft"].observe(
                    float(seconds),
                    tags={"label": self.label, "mode": mode},
                    exemplar=({"trace_id": trace_id}
                              if trace_id else None))
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_retry(self, cause: str):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["retries"].inc(
                    1.0, tags={"label": self.label, "cause": cause})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_restart(self):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["restarts"].inc(1.0,
                                        tags={"label": self.label})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_affinity(self):
        if self._metrics_dead:
            return
        now = time.monotonic()
        if (self.affinity_decisions > 1
                and now - self._rate_last < self._EMIT_INTERVAL_S):
            return
        self._rate_last = now
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["affinity"].set(self.affinity_hit_rate,
                                        tags={"label": self.label})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True

    def _emit_depth(self, replica_id: str, depth: int):
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["depth"].set(
                    float(depth),
                    tags={"label": self.label, "replica": replica_id})
        except Exception:  # noqa: BLE001 — never tax the router
            self._metrics_dead = True
