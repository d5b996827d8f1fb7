"""Fleet telemetry: router retries, replica restarts, affinity hit rate.

Counterpart of ``ray_tpu/telemetry/fleet.py``, recorder for recorder:
the fleet routers and the reconciler record every retry (split by
cause: a dead replica, a draining one, a full queue), every replica
restart, per-replica queue depth and the prefix-affinity hit rate; the
gray-failure series (hedges by outcome ``issued`` / ``won`` /
``wasted``, race winners, latency demotions, the per-replica EWMA
latency score); and the disaggregation series (every KV handoff's
bytes, wall seconds and pages, warm skips, per-pool queue depth, TTFT
split by pool mode).  :meth:`FleetTelemetry.summary` is the reference's
``fleet`` block, key for key.

The reference also feeds Prometheus series (``serve_router_retries_
total``, ``serve_hedges_total``, ``serve_ttft_seconds``, ...) through
the runtime's metrics when a runtime session is up, and emits nothing
without one.  The port has no runtime (ROADMAP Queue 1 item 6c), so it
emits nothing, as :mod:`ray_tpu_torch.telemetry.infer` does.

``RAY_TPU_TELEMETRY=0`` disables recording entirely.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional

from ray_tpu_torch.telemetry.config import telemetry_config


class FleetTelemetry:
    """Per-fleet recorder for routing/reconciliation events."""

    _MAX_RECORDS = 10_000

    def __init__(self, *, label: str = "fleet", config=None):
        tcfg = config or telemetry_config()
        self.enabled: bool = tcfg.enabled
        self.label = label
        # cause -> count; causes: "dead" (replica death/wedge failover
        # or a failed routed submit), "draining", "queue_full",
        # "adapter", "handoff"
        self.retries: Dict[str, int] = {}
        self.replica_restarts = 0
        self.affinity_routed = 0
        self.affinity_decisions = 0
        self.queue_depths: Dict[str, int] = {}
        # outcome -> count: "issued" (hedge submitted), "won" (the hedge
        # delivered the stream), "wasted" (the primary did)
        self.hedges: Dict[str, int] = {}
        # winner -> count for resolved races ("primary" / "hedge")
        self.hedge_winners: Dict[str, int] = {}
        # cause -> count for completed failovers ("dead" / "wedged" /
        # "handoff")
        self.failovers: Dict[str, int] = {}
        self.replica_demotions = 0
        self.latency_scores: Dict[str, float] = {}
        # disaggregation: handoff accounting, per-pool depth gauges and
        # TTFT populations split by pool mode
        self.handoffs = 0
        self.handoffs_skipped = 0
        self.handoff_bytes = 0
        self.handoff_pages = 0
        self.handoff_s: List[float] = []
        self.pool_depths: Dict[str, int] = {}
        self.ttfts_by_mode: Dict[str, List[float]] = {}

    # ---------------------------------------------------------- records
    def record_retry(self, cause: str) -> None:
        """One routed request re-routed or failed over, by ``cause`` —
        the fleet's churn signal: a rising rate means replicas are
        dying, draining under scale-down, or shedding load."""
        if not self.enabled:
            return
        self.retries[cause] = self.retries.get(cause, 0) + 1

    def record_restart(self) -> None:
        """The reconciler replaced a wedged/dead replica."""
        if not self.enabled:
            return
        self.replica_restarts += 1

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

    def record_hedge_won(self, winner: str) -> None:
        """One resolved hedge race, by ``winner`` (``primary`` /
        ``hedge``)."""
        if winner not in ("primary", "hedge"):
            raise ValueError(f"unknown hedge winner {winner!r}; "
                             "expected primary/hedge")
        if not self.enabled:
            return
        self.hedge_winners[winner] = \
            self.hedge_winners.get(winner, 0) + 1

    def record_failover(self, cause: str) -> None:
        """One in-flight stream failed over to another replica, by
        cause (``dead`` / ``wedged`` — replica death or wedge — or
        ``handoff`` — a faulted disagg transfer leg).  Retries count
        submission re-routes too; this counts only mid-stream
        recoveries."""
        if not self.enabled:
            return
        self.failovers[cause] = self.failovers.get(cause, 0) + 1

    def record_demotion(self, replica_id: str) -> None:
        """The router demoted a replica for latency (its EWMA tick
        latency crossed slow_factor x the fleet median) — counted once
        per demotion episode, not per routing decision."""
        if not self.enabled:
            return
        self.replica_demotions += 1

    def record_latency_score(self, replica_id: str,
                             score: float) -> None:
        """Per-replica EWMA tick-latency gauge."""
        if not self.enabled:
            return
        self.latency_scores[replica_id] = float(score)

    def record_handoff(self, *, n_bytes: int, seconds: float,
                       pages: int, skipped: bool = False,
                       trace_id: Optional[str] = None) -> None:
        """One prefill→decode KV handoff: content bytes moved (0 for a
        warm, metadata-only handoff — counted in ``handoffs_skipped``),
        wall seconds export→import, and the page count behind the byte
        math.  ``trace_id`` is the reference's histogram exemplar;
        nothing here emits it."""
        if not self.enabled:
            return
        self.handoffs += 1
        if skipped:
            self.handoffs_skipped += 1
        self.handoff_bytes += int(n_bytes)
        self.handoff_pages += int(pages)
        if len(self.handoff_s) < self._MAX_RECORDS:
            self.handoff_s.append(float(seconds))

    def record_pool_depth(self, pool: str, depth: int) -> None:
        """Aggregate queue depth of one pool (``prefill`` /
        ``decode``): prefill backlog is admission pressure, decode
        backlog is slot occupancy."""
        if not self.enabled:
            return
        self.pool_depths[pool] = int(depth)

    def record_ttft(self, seconds: float, *, mode: str,
                    trace_id: Optional[str] = None) -> None:
        """Per-request time to first token, split by pool mode
        (``disagg`` when a dedicated prefill pool served it,
        ``colocated`` for the single-pool fleet)."""
        if not self.enabled:
            return
        bucket = self.ttfts_by_mode.setdefault(mode, [])
        if len(bucket) < self._MAX_RECORDS:
            bucket.append(float(seconds))

    def record_affinity(self, *, hit: bool) -> None:
        """One routing decision with affinity enabled: ``hit`` when a
        prefix-digest match picked the replica, False when routing fell
        through to pow-2."""
        if not self.enabled:
            return
        self.affinity_decisions += 1
        if hit:
            self.affinity_routed += 1

    def record_queue_depth(self, replica_id: str, depth: int) -> None:
        """Per-replica queue-depth gauge."""
        if not self.enabled:
            return
        self.queue_depths[replica_id] = int(depth)

    def forget_replica(self, replica_id: str) -> None:
        """Drop a stopped replica's gauge state."""
        self.queue_depths.pop(replica_id, None)
        self.latency_scores.pop(replica_id, None)

    # ---------------------------------------------------------- summary
    @property
    def affinity_hit_rate(self) -> float:
        if not self.affinity_decisions:
            return 0.0
        return self.affinity_routed / self.affinity_decisions

    def summary(self) -> Dict[str, Any]:
        """The ``fleet`` block, key for key the reference's."""
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
