"""Deterministic fault injection for the serving stack and the RL loop.

Counterpart of the fault-plan half of ``ray_tpu/util/chaos.py``: named
injection **sites** call :func:`maybe_fail` (raise sites) or
:func:`should_fire` (action sites), and a spec — ``RAY_TPU_FAULTS`` or
:func:`install_faults` — arms the Nth hit of a site to raise
:class:`InjectedFault`, or to sleep.  The sites the port's engine has:

- ``infer.decode`` — the Nth decode dispatch raises before the step
  launches anything, so the cache is untouched and the engine stays
  drainable;
- ``kv.spill`` — the tiered cache's demote legs: once on the HBM ->
  host spill (before the page's contents leave the card) and once per
  host-pool overflow on the host -> store leg.  A faulted leg forgets
  the page; a later request re-prefills it;
- ``kv.fetch`` — the promote leg, per page as admission installs a
  host or store hit back into the cache.  A fault stops the install
  walk there and the suffix prefill covers the rest.

and the fleet's (:mod:`ray_tpu_torch.fleet`):

- ``serve.replica`` — the top of every replica tick, before the engine
  steps: a fault kills the replica and its streams fail over;
- ``serve.tick`` / ``serve.tick[<replica_id>]`` — inside the timed
  tick window, fleet-wide or on one replica: a ``:delay=`` slowdown is
  a gray failure the latency score sees, a fault a death;
- ``serve.route`` — a routed submit, before the replica admits it: a
  fault re-routes the request;
- ``serve.handoff`` — the disaggregated handoff's export and import
  legs: a fault re-prefills the stream from its prompt.

and the RL loop's (:mod:`ray_tpu_torch.rl`,
:mod:`ray_tpu_torch.resilience.supervisor`):

- ``rl.rollout`` — a rollout actor dies entering its Nth rollout,
  before it submits anything (the supervisor replaces it);
- ``rl.learner`` — the learner dies entering its Nth update (the
  supervisor restores it from its checkpoint and republishes);
- ``rl.publish`` — the Nth weight publication fails before the store
  changes (the loop keeps the previous version).

Spec grammar, comma-separated entries::

    site[@N[..M]][:delay=S]

``N`` is the 1-based hit index (bare ``site`` means ``site@1``).
Without ``:delay=`` the entry is a **fault**: hit ``N`` raises (or, for
an action site, returns True) exactly once, and a hit range is
rejected.  With ``:delay=S`` every hit in ``[N, M]`` (``M`` defaults to
``N``) sleeps ``S`` seconds inside the site.  Hit counters are
lock-protected, so a fixed spec and a fixed call order reproduce the
same failure point every run.

:class:`ResourceKiller` is the random half: a background thread that
kills a random victim every ``interval_s`` (a busy task worker, a live
actor or an extra node of the runtime), so the runtime's recovery paths
(task retries, actor restarts, node-death handling) run for real.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple


class InjectedFault(RuntimeError):
    """Raised by an armed fault-injection site, never by a real code
    path."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at site {site!r} (hit {hit})")
        self.site = site
        self.hit = hit

    def __reduce__(self):
        return (InjectedFault, (self.site, self.hit))


class FaultPlan:
    """A parsed fault spec: deterministic per-site hit counters.

    ``fires(site)`` counts one hit of ``site``, sleeps any slowdown armed
    for that hit, and says whether an armed fault triggers on exactly
    this hit.  ``fired`` logs every triggered ``(site, hit)`` and
    ``slowed`` every injected ``(site, hit, seconds)``."""

    def __init__(self, spec: str = ""):
        self._armed: Dict[str, List[int]] = {}
        # site -> [(first_hit, last_hit, delay_s)] slowdown windows
        self._delays: Dict[str, List[Tuple[int, int, float]]] = {}
        self._hits: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int]] = []
        self.slowed: List[Tuple[str, int, float]] = []
        self.spec = spec.strip()
        for entry in self.spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            head, _, tail = entry.partition(":")
            delay = None
            if tail:
                key, _, val = tail.partition("=")
                if key.strip() != "delay" or not val:
                    raise ValueError(
                        f"bad RAY_TPU_FAULTS entry {entry!r}: the "
                        "only site modifier is ':delay=S' (seconds)")
                try:
                    delay = float(val)
                except ValueError:
                    raise ValueError(
                        f"bad RAY_TPU_FAULTS entry {entry!r}: "
                        f"delay {val!r} is not a number of seconds")
                if delay < 0:
                    raise ValueError(
                        f"bad RAY_TPU_FAULTS entry {entry!r}: delay "
                        "must be >= 0 seconds")
            site, _, at = head.partition("@")
            site = site.strip()
            lo, _, hi = at.partition("..")
            try:
                first = int(lo) if lo else 1
                last = int(hi) if hi else first
            except ValueError:
                raise ValueError(
                    f"bad RAY_TPU_FAULTS entry {entry!r}: expected "
                    "'site', 'site@N' or 'site@N..M' (1-based hit "
                    "indices)")
            if first < 1 or last < first:
                raise ValueError(
                    f"bad RAY_TPU_FAULTS entry {entry!r}: hit index "
                    "must be >= 1 (and N <= M for a window)")
            if delay is None:
                if hi:
                    raise ValueError(
                        f"bad RAY_TPU_FAULTS entry {entry!r}: a hit "
                        "range only makes sense for a slowdown — add "
                        "':delay=S' (a fault fires once, at one hit)")
                self._armed.setdefault(site, []).append(first)
            else:
                self._delays.setdefault(site, []).append(
                    (first, last, delay))

    def fires(self, site: str) -> bool:
        """Count one hit of ``site``; sleep this hit's armed slowdown
        (if any); True iff an armed fault triggers on exactly this
        hit."""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            delay = 0.0
            for first, last, d in self._delays.get(site, ()):
                if first <= hit <= last:
                    delay += d
            if delay > 0:
                self.slowed.append((site, hit, delay))
            fired = hit in self._armed.get(site, ())
            if fired:
                self.fired.append((site, hit))
        if delay > 0:           # outside the lock: a slowed site must
            time.sleep(delay)   # not block the other counters
        return fired

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def slowdown_s(self, site: str) -> float:
        """Total delay the plan has injected at ``site`` so far."""
        with self._lock:
            return sum(d for s, _, d in self.slowed if s == site)


_PLAN: Optional[FaultPlan] = None
_PLAN_FROM_ENV = False


def install_faults(spec: str) -> FaultPlan:
    """Arm a fault plan programmatically; returns it so the caller can
    read ``plan.fired``.  An installed plan wins over the env."""
    global _PLAN, _PLAN_FROM_ENV
    _PLAN = FaultPlan(spec)
    _PLAN_FROM_ENV = True
    return _PLAN


def clear_faults() -> None:
    global _PLAN, _PLAN_FROM_ENV
    _PLAN = None
    _PLAN_FROM_ENV = False


def fault_plan() -> Optional[FaultPlan]:
    """The active plan: an installed one, else one parsed once from
    ``RAY_TPU_FAULTS``, else None."""
    global _PLAN, _PLAN_FROM_ENV
    if _PLAN is None and not _PLAN_FROM_ENV:
        spec = os.environ.get("RAY_TPU_FAULTS", "")
        _PLAN_FROM_ENV = True
        if spec.strip():
            _PLAN = FaultPlan(spec)
    return _PLAN


def should_fire(site: str) -> bool:
    """Count a hit of an *action* site (the site corrupts something
    itself when True)."""
    plan = fault_plan()
    return plan.fires(site) if plan is not None else False


def maybe_fail(site: str) -> None:
    """Count a hit of a *raise* site; raise :class:`InjectedFault` when
    an armed fault triggers.  Free when no plan is armed.  Every raise
    is a flight-recorder anomaly (``telemetry.trace``)."""
    plan = fault_plan()
    if plan is not None and plan.fires(site):
        hit = plan.hits(site)
        from ray_tpu_torch.telemetry import trace as trace_mod
        trace_mod.on_injected_fault(site, hit)
        raise InjectedFault(site, hit)


class ResourceKiller:
    """Kill a random victim every ``interval_s`` while running.

    ``kind``: "worker" (SIGKILL a task worker process), "actor"
    (ray_tpu_torch.kill a random live actor), or "node" (terminate a random
    non-head node process).
    """

    def __init__(self, kind: str = "worker", interval_s: float = 1.0,
                 max_kills: Optional[int] = None,
                 rng_seed: Optional[int] = None):
        assert kind in ("worker", "actor", "node")
        self.kind = kind
        self.interval_s = interval_s
        self.max_kills = max_kills
        self.kills: List[str] = []
        self._rng = random.Random(rng_seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- victim selection ---------------------------------------------
    def _pick_worker_pid(self) -> Optional[int]:
        # pids via task events would be racy; read the head node
        # manager's live worker table instead
        from ray_tpu_torch._private.worker import global_node
        nm = global_node().node_manager
        with nm._lock:
            pids = [w.proc.pid for w in nm._workers.values()
                    if w.proc is not None and w.state == "busy"]
        return self._rng.choice(pids) if pids else None

    def _pick_actor(self):
        from ray_tpu_torch.util.state import list_actors
        rows = [r for r in list_actors() if r["state"] == "ALIVE"
                and not (r.get("name") or "").startswith("__")]
        if not rows:
            return None
        return bytes.fromhex(self._rng.choice(rows)["actor_id"])

    def _pick_node(self) -> Optional[bytes]:
        from ray_tpu_torch._private.worker import global_node
        extra = [nid for nid, proc in global_node()._extra_nodes
                 if proc.poll() is None]
        return self._rng.choice(extra) if extra else None

    # -- kill actions --------------------------------------------------
    def _kill_once(self) -> bool:
        import os
        import signal
        if self.kind == "worker":
            pid = self._pick_worker_pid()
            if pid is None:
                return False
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                return False
            self.kills.append(f"worker pid={pid}")
        elif self.kind == "actor":
            aid = self._pick_actor()
            if aid is None:
                return False
            from ray_tpu_torch._private.worker import global_worker
            global_worker().kill_actor(aid, no_restart=False)
            self.kills.append(f"actor {aid.hex()[:12]}")
        else:
            nid = self._pick_node()
            if nid is None:
                return False
            from ray_tpu_torch._private.worker import global_node
            global_node().remove_node(nid)
            self.kills.append(f"node {nid.hex()[:12]}")
        return True

    # -- lifecycle -----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self.max_kills is not None and \
                    len(self.kills) >= self.max_kills:
                return
            try:
                self._kill_once()
            except Exception:  # noqa: BLE001 — chaos must not crash
                pass

    def start(self) -> "ResourceKiller":
        if self.kind in ("worker", "node"):
            from ray_tpu_torch._private.worker import global_node
            if getattr(global_node(), "node_manager", None) is None:
                raise ValueError(
                    f"chaos kind={self.kind!r} needs the head driver "
                    "(an attached driver has no local node manager)")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"chaos-{self.kind}")
        self._thread.start()
        return self

    def stop(self) -> List[str]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return list(self.kills)

    def __enter__(self) -> "ResourceKiller":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
