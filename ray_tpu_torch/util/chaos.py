"""Deterministic fault injection for the serving stack.

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

Spec grammar, comma-separated entries::

    site[@N[..M]][:delay=S]

``N`` is the 1-based hit index (bare ``site`` means ``site@1``).
Without ``:delay=`` the entry is a **fault**: hit ``N`` raises (or, for
an action site, returns True) exactly once, and a hit range is
rejected.  With ``:delay=S`` every hit in ``[N, M]`` (``M`` defaults to
``N``) sleeps ``S`` seconds inside the site.  Hit counters are
lock-protected, so a fixed spec and a fixed call order reproduce the
same failure point every run.

``ResourceKiller``, which kills runtime workers at random, waits for the
runtime (ROADMAP Queue 1 item 6c).
"""

from __future__ import annotations

import os
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
