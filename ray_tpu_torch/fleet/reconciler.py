"""Autoscaler-v2-style reconciler: an instance state machine over the
fleet.

Counterpart of ``ray_tpu/fleet/reconciler.py``, itself after Ray's
``autoscaler/v2/instance_manager/reconciler.py``: desired state (a
target replica count plus scale signals) is reconciled against observed
instance state on every :meth:`Reconciler.reconcile` call, and every
decision is a pure function of ``(instances, signals, now)`` so a test
can drive the whole machine with an explicit clock.

States::

    STARTING -> RUNNING -> DRAINING -> STOPPED
                   \\-> WEDGED -> RESTARTING -> RUNNING
                   \\<-> DEGRADED -> DRAINING -> STOPPED (+replacement)

- **WEDGED requires a health signal**: a replica only leaves RUNNING
  for WEDGED when it is dead (``alive`` False) or its watchdog
  wedge counter moved — a slow-but-ticking replica never restarts
  *immediately*.
- **DEGRADED is the gray-failure arm**: the router's latency
  demotion signal (EWMA tick latency past
  ``RAY_TPU_FLEET_SLOW_FACTOR``x the fleet median) moves a RUNNING
  replica to DEGRADED.  A blip recovers to RUNNING; a demotion
  sustained for the dwell triggers a **drain-restart**: the replica
  drains (admission stops, in-flight streams finish — zero dropped)
  while target restoration spawns its replacement, and the corpse
  retires once drained.  A chronically slow replica is thus recycled
  without ever being trusted to finish nothing.
- **RESTARTING** replaces the corpse through the factory.  The port
  runs eagerly, so a restart compiles nothing; it costs the new
  engine's construction (its KV cache allocation on the card; the
  factory may hand every replica the same parameter tensors).  The
  corpse's cache is freed once no one holds its engine: this pass
  drops it from the router and from ``instances``.  Restart backoff
  doubles per restart and is capped (``RAY_TPU_FLEET_BACKOFF``/
  ``_MAX``) — a crash-looping replica cannot hot-loop the factory.
- **Scale up** on sustained queue-depth pressure or TTFT-SLO breach
  (``RAY_TPU_FLEET_UP_DEPTH`` / ``RAY_TPU_FLEET_TTFT_SLO``), **scale
  down** through ``drain()`` only — a DRAINING replica stops admitting
  (the router re-routes) but finishes every in-flight stream before it
  STOPs, so scale-down drops zero streams (the router refuses to
  remove a replica with bound streams).
- **Anti-flap hysteresis**: a scale signal must persist for
  ``RAY_TPU_FLEET_DWELL`` before acting, and consecutive scale actions
  are at least a dwell apart.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.fleet.config import FleetConfig, fleet_config

STARTING = "STARTING"
RUNNING = "RUNNING"
DRAINING = "DRAINING"
STOPPED = "STOPPED"
WEDGED = "WEDGED"
RESTARTING = "RESTARTING"
DEGRADED = "DEGRADED"


@dataclasses.dataclass
class Instance:
    """Observed + desired state for one replica slot."""
    replica: Any
    state: str
    since: float
    restarts: int = 0
    wedges_seen: int = 0
    restart_at: float = 0.0      # backoff gate while WEDGED
    degraded_since: float = 0.0  # dwell gate while DEGRADED


class Reconciler:
    """Reconcile the fleet toward ``target`` healthy replicas.

    ``factory(replica_id)`` builds a replacement/scale-up replica
    (sharing the parameter tensors is the factory's job); ``target`` is
    the steady count restored after deaths and the scale-down floor;
    ``max_replicas`` (default ``target``) bounds scale-up.
    """

    def __init__(self, router, factory: Callable[[str], Any], *,
                 target: int, max_replicas: Optional[int] = None,
                 cfg: Optional[FleetConfig] = None,
                 now: Optional[float] = None):
        if target < 1:
            raise ValueError(f"target must be >= 1, got {target}")
        self.router = router
        self.factory = factory
        self.target = target
        self.max_replicas = max(max_replicas or target, target)
        self.cfg = cfg or fleet_config()
        now = time.monotonic() if now is None else now
        self.instances: Dict[str, Instance] = {
            r.id: Instance(replica=r, state=RUNNING, since=now)
            for r in router.replicas()}
        self._spawned = 0
        self.restarts_total = 0
        self.demotion_restarts = 0   # gray-failure drain-restarts
        # spawns whose engine came up attached to a non-empty
        # fleet-shared KV page store — a restart or scale-from-zero
        # replica that warms up from other replicas' prefix pages on
        # its first admissions instead of re-prefilling everything
        self.warm_starts = 0
        self._breach_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_scale_ts = now

    # ------------------------------------------------------------- views
    def states(self) -> Dict[str, str]:
        return {rid: inst.state for rid, inst in self.instances.items()}

    def _count(self, *states: str) -> int:
        return sum(1 for i in self.instances.values()
                   if i.state in states)

    def _backoff(self, restarts: int) -> float:
        return min(self.cfg.backoff * (2 ** restarts),
                   self.cfg.backoff_max)

    def _new_id(self) -> str:
        self._spawned += 1
        return f"r{len(self.instances)}-{self._spawned}"

    def _spawn(self, now: float, *, state: str = STARTING,
               restarts: int = 0) -> Instance:
        rid = self._new_id()
        replica = self.factory(rid)
        self.router.add_replica(replica)
        store = getattr(getattr(replica, "engine", None), "store", None)
        if store is not None and len(store):
            self.warm_starts += 1
        inst = Instance(replica=replica, state=state, since=now,
                        restarts=restarts)
        self.instances[rid] = inst
        return inst

    # --------------------------------------------------------- reconcile
    def reconcile(self, now: Optional[float] = None) -> List[str]:
        """One reconciliation pass; returns the actions taken (state
        transitions and scale decisions) for logs and tests."""
        now = time.monotonic() if now is None else now
        actions: List[str] = []
        # the router's instantaneous latency verdict; the dwell below
        # converts it into a decision (blip vs chronic)
        slow = self.router.slow_replicas() \
            if hasattr(self.router, "slow_replicas") else set()

        def move(rid, inst, state):
            actions.append(f"{rid}: {inst.state}->{state}")
            inst.state = state
            inst.since = now

        for rid, inst in list(self.instances.items()):
            r = inst.replica
            if inst.state in (STARTING, RESTARTING):
                # in-process replicas are ready at construction; the
                # distinct state exists so a pass can observe the spawn
                move(rid, inst, RUNNING)
            if inst.state == RUNNING:
                wedge_signal = (not r.alive
                                or r.wedges > inst.wedges_seen)
                if wedge_signal:
                    inst.wedges_seen = r.wedges
                    inst.restart_at = now + self._backoff(inst.restarts)
                    move(rid, inst, WEDGED)
                elif rid in slow:
                    inst.degraded_since = now
                    move(rid, inst, DEGRADED)
            if inst.state == DEGRADED:
                # gray turned black: death/wedge dominates slowness
                if not r.alive or r.wedges > inst.wedges_seen:
                    inst.wedges_seen = r.wedges
                    inst.restart_at = now + self._backoff(inst.restarts)
                    move(rid, inst, WEDGED)
                elif rid not in slow:
                    # a blip: the score recovered before the dwell —
                    # re-promoted, nothing recycled
                    move(rid, inst, RUNNING)
                elif now - inst.degraded_since >= self.cfg.dwell:
                    # chronically slow: drain-restart.  Admission
                    # stops (the router re-routes), in-flight streams
                    # finish (zero dropped), target restoration below
                    # spawns the replacement this same pass, and the
                    # DRAINING branch retires the corpse once drained.
                    r.drain()
                    self.demotion_restarts += 1
                    self.router.telemetry.record_restart()
                    move(rid, inst, DRAINING)
                    actions[-1] += " (degraded drain-restart)"
            if inst.state == WEDGED and now >= inst.restart_at:
                # replace the corpse: reap (slots/pages/refcounts
                # release so the fleet audit stays clean), drop from
                # routing, spawn the replacement with escalated backoff
                r.alive = False       # a wedged survivor must not serve
                if not r.reaped:
                    r.reap()
                self.router.remove_replica(rid)
                move(rid, inst, STOPPED)
                del self.instances[rid]
                new = self._spawn(now, state=RESTARTING,
                                  restarts=inst.restarts + 1)
                self.restarts_total += 1
                self.router.telemetry.record_restart()
                actions.append(f"{new.replica.id}: RESTARTING "
                               f"(for {rid}, restart "
                               f"#{inst.restarts + 1})")
            if inst.state == DRAINING:
                # health checks apply while draining too — a replica
                # that dies or wedges mid-drain would otherwise be a
                # permanent zombie (its cancels never process, so
                # `drained` never turns true).  It was leaving anyway:
                # reap (slots/pages/refcounts release), no replacement.
                if not r.alive or r.wedges > inst.wedges_seen:
                    inst.wedges_seen = r.wedges
                    r.alive = False
                    if not r.reaped:
                        r.reap()
                if (r.drained or not r.alive) \
                        and self.router.bound_streams(rid) == 0:
                    # (bound streams from a mid-drain death are failed
                    # over by the router's next poll; retire then)
                    self.router.remove_replica(rid)
                    move(rid, inst, STOPPED)
                    del self.instances[rid]

        self._reconcile_scale(now, actions)
        return actions

    # ----------------------------------------------------------- scaling
    def _signals(self) -> Dict[str, float]:
        running = [i.replica for i in self.instances.values()
                   if i.state == RUNNING and i.replica.alive]
        waiting = sum(r.waiting_depth() for r in running)
        depth = sum(r.queue_depth() for r in running)
        ttfts = self.router.recent_ttfts()
        return {
            "running": len(running),
            "mean_waiting": waiting / len(running) if running else 0.0,
            "total_depth": depth,
            "ttft_p50": statistics.median(ttfts) if ttfts else 0.0,
        }

    def _reconcile_scale(self, now: float, actions: List[str]) -> None:
        sig = self._signals()
        # WEDGED counts as live: its 1:1 replacement is already
        # scheduled behind the backoff gate — spawning a restore on
        # top would overshoot the target by one per wedge.  DEGRADED
        # counts too (it still serves); only its drain-restart drops
        # it from this set, which is exactly what lets restoration
        # spawn the replacement.
        live = self._count(STARTING, RUNNING, RESTARTING, WEDGED,
                           DEGRADED)

        # target restoration is failure recovery, not autoscaling: no
        # dwell gate — a killed replica's capacity comes back now
        while live < self.target:
            inst = self._spawn(now)
            actions.append(f"{inst.replica.id}: STARTING (restore "
                           f"target {self.target})")
            live += 1

        breach = sig["mean_waiting"] >= self.cfg.up_depth or (
            self.cfg.ttft_slo > 0
            and sig["ttft_p50"] > self.cfg.ttft_slo)
        if breach:
            self._idle_since = None
            if self._breach_since is None:
                self._breach_since = now
            elif (now - self._breach_since >= self.cfg.dwell
                    and now - self._last_scale_ts >= self.cfg.dwell
                    and live < self.max_replicas):
                inst = self._spawn(now)
                self._last_scale_ts = now
                self._breach_since = None
                actions.append(f"{inst.replica.id}: STARTING "
                               f"(scale-up: mean_waiting="
                               f"{sig['mean_waiting']:.1f}, ttft_p50="
                               f"{sig['ttft_p50']:.3f}s)")
            return
        self._breach_since = None

        idle = sig["total_depth"] == 0
        if idle and sig["running"] > self.target:
            if self._idle_since is None:
                self._idle_since = now
            elif (now - self._idle_since >= self.cfg.dwell
                    and now - self._last_scale_ts >= self.cfg.dwell):
                # newest RUNNING instance drains first (LIFO: the
                # scale-up surge unwinds in reverse)
                rid, inst = max(
                    ((rid, i) for rid, i in self.instances.items()
                     if i.state == RUNNING and i.replica.alive),
                    key=lambda kv: kv[1].since)
                inst.replica.drain()
                actions.append(f"{rid}: RUNNING->DRAINING (scale-down)")
                inst.state = DRAINING
                inst.since = now
                self._last_scale_ts = now
                self._idle_since = None
        else:
            self._idle_since = None
