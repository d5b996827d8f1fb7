"""One fleet replica: an inference engine plus health/drain state.

Counterpart of ``ray_tpu/fleet/replica.py``.  The fleet layer is
host-driven: the router owns the tick loop and calls :meth:`step` on
every replica with work, so a deterministic ``RAY_TPU_FAULTS`` plan
reproduces the same death/wedge point every run.  A replica wraps one
:class:`~ray_tpu_torch.inference.engine.InferenceEngine` (the replicas
of one fleet may share one parameter set on the card: the engine keeps
the tensors it is given when they are already on its device and of its
dtype) and carries the health signals the router and reconciler read:

- **alive**: flips False when a step raises (the ``serve.replica``
  chaos site fires at the top of :meth:`step`, before any engine
  mutation, so an injected death leaves the engine state consistent
  for the host-side reap);
- **latency**: an EWMA of tick wall seconds (the ``serve.tick`` /
  ``serve.tick[<replica_id>]`` slowdown sites stretch exactly this
  window, so an injected gray failure is visible to the same signal a
  real one would be) — the router's health score: replicas past
  ``RAY_TPU_FLEET_SLOW_FACTOR``x the fleet median are demoted from
  routing and reported DEGRADED to the reconciler;
- **wedged**: the :class:`~ray_tpu_torch.resilience.watchdog.
  EngineWatchdog` signal, probed by the router's poll loop (no
  background thread, so tests drive it with explicit clocks);
- **draining**: admission stopped (``submit`` raises the typed
  :class:`~ray_tpu_torch.inference.serve_gpt.ReplicaDrainingError`,
  the router's immediate re-route signal) while in-flight sequences
  decode to completion — the zero-dropped-streams scale-down path.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.inference.engine import InferenceEngine, StepEvent

# EWMA smoothing for the tick-latency health score: new = a*x + (1-a)*old.
# 0.25 converges on a sustained slowdown within ~8 ticks while a single
# slow tick (GC pause, one long prefill) decays away instead of demoting
# the replica — the blip-vs-sustained line the reconciler dwell also draws.
LATENCY_EWMA_ALPHA = 0.25
# An idle replica produces no fresh ticks, and demotion is exactly what
# stops its traffic — without decay a demoted-then-idle replica's frozen
# slow EWMA would keep it demoted forever and the reconciler's
# blip-recovers-to-RUNNING arm could never fire for replicas without
# continuous work.  Halving the score per 5 idle seconds lets a MILD
# transient (a few x the fleet median) age back under the demotion
# threshold and be re-probed by real traffic, while a severe outlier
# stays demoted past the reconciler's dwell (default 5 s) and is
# recycled — the severity of the score decides blip vs restart.  The
# half-life must stay of the dwell's order: a fast decay flaps
# demote/re-promote inside one routing episode (measured: it doubles
# demotions and wastes hedges in the reference's gray-failure bench).
LATENCY_IDLE_HALFLIFE_S = 5.0


class EngineReplica:
    """One engine behind the fleet router.

    ``watchdog_s`` arms a manual-probe wedge detector (the router
    calls :meth:`check` each poll; no thread, so tests drive it with
    explicit clocks).  ``replica_id`` must be unique within a fleet —
    the router keys stream bindings by ``(replica_id, rid)`` so a
    failed-over request's stale events can never leak into its
    stream.
    """

    def __init__(self, replica_id: str, engine: InferenceEngine, *,
                 watchdog_s: float = 0.0):
        self.id = replica_id
        self.engine = engine
        # tracing: engine spans carry this replica's id, so a
        # cross-replica trace tree (disagg, failover) attributes each
        # span to the replica that did the work
        engine.trace_label = replica_id
        self.alive = True
        self.draining = False
        self.watchdog = None
        if watchdog_s:
            from ray_tpu_torch.resilience.watchdog import EngineWatchdog
            # NOT .start()ed: the router's poll loop probes check()
            self.watchdog = EngineWatchdog(engine, timeout_s=watchdog_s)
        # test/chaos hook: a "wedged" replica has work but its step
        # stops ticking (the engine stamp freezes -> the watchdog
        # fires); real wedges are a hung device step, which host-sim
        # cannot produce in a single-threaded drive loop
        self._stalled = False
        self.reaped = False
        # prefix-digest memo, keyed by engine tick: registrations only
        # happen inside step() (which bumps ticks), so within one
        # router poll the digest is immutable — the routing hot path
        # must not rebuild an O(pages) frozenset per candidate per
        # request.  (A set_params prefix flush without a tick can
        # serve one stale digest: a routing-quality blip, never a
        # correctness one — admission re-walks the real index.)
        self._digest: Optional[frozenset] = None
        self._digest_ticks = -1
        # EWMA tick wall seconds (None until the first worked tick) —
        # the gray-failure health score.  _tick_t0 marks a step in
        # flight (concurrent router mode): its age is a live lower
        # bound on this tick's wall, so a sustained slowdown is
        # scoreable BEFORE the first slow tick even completes.
        self._latency_ewma: Optional[float] = None
        self._tick_t0: Optional[float] = None
        self._last_tick_done_ts = time.monotonic()

    # --------------------------------------------------------- admission
    def submit(self, prompt, *, max_new_tokens: int, sampling=None,
               eos_token=None, ttft_deadline_s=None,
               deadline_s=None, hold_pages: bool = False,
               trace_ctx=None) -> int:
        """Admit one request; raises the typed re-route signals
        (``ReplicaDrainingError`` / ``QueueFullError``) the router
        retries on, or ``ValueError`` for a request this fleet's
        geometry can never serve (the router fails the stream).
        ``hold_pages`` is the disagg prefill seam, ``trace_ctx`` the
        tracing one (see :meth:`InferenceEngine.submit`)."""
        self._check_admittable()
        return self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                  sampling=sampling, eos_token=eos_token,
                                  ttft_deadline_s=ttft_deadline_s,
                                  deadline_s=deadline_s,
                                  hold_pages=hold_pages,
                                  trace_ctx=trace_ctx)

    def submit_import(self, handoff, *, max_new_tokens: int,
                      sampling=None, eos_token=None,
                      deadline_s=None) -> int:
        """Admit a KV handoff (the disagg decode seam) under the same
        alive/draining admission guards as :meth:`submit`."""
        self._check_admittable()
        return self.engine.import_submit(
            handoff, max_new_tokens=max_new_tokens, sampling=sampling,
            eos_token=eos_token, deadline_s=deadline_s)

    def _check_admittable(self) -> None:
        if not self.alive:
            raise RuntimeError(f"replica {self.id} is dead — the "
                               "router must not route to it")
        if self.draining:
            from ray_tpu_torch.inference.serve_gpt import ReplicaDrainingError
            raise ReplicaDrainingError(
                f"replica {self.id} is draining: admission stopped, "
                "in-flight requests finishing — route elsewhere")

    # -------------------------------------------------------------- tick
    def step(self) -> List[StepEvent]:
        """One engine tick.  The ``serve.replica`` fault site fires
        BEFORE the engine steps (donated buffers untouched, scheduler
        consistent) and any raise — injected or real — marks the
        replica dead before propagating, so the router's failover path
        sees a consistent corpse.  The ``serve.tick`` slowdown sites
        (fleet-wide, and ``serve.tick[<id>]`` addressing this replica
        alone) stretch the timed window, so injected gray failure
        lands in the same EWMA a genuinely slow device would."""
        from ray_tpu_torch.util import chaos
        if self._stalled:
            return []                  # wedge: work pending, no tick
        t0 = time.monotonic()
        self._tick_t0 = t0
        try:
            chaos.maybe_fail("serve.replica")
            chaos.maybe_fail("serve.tick")
            chaos.maybe_fail(f"serve.tick[{self.id}]")
            events = self.engine.step()
        except BaseException:
            self.alive = False
            raise
        finally:
            self._tick_t0 = None
            self._last_tick_done_ts = time.monotonic()
        wall = time.monotonic() - t0
        self._latency_ewma = wall if self._latency_ewma is None else (
            LATENCY_EWMA_ALPHA * wall
            + (1.0 - LATENCY_EWMA_ALPHA) * self._latency_ewma)
        return events

    # ------------------------------------------------------------ health
    @property
    def wedged(self) -> bool:
        return self.watchdog is not None and self.watchdog.wedges > 0

    @property
    def wedges(self) -> int:
        return self.watchdog.wedges if self.watchdog is not None else 0

    def check(self, now: Optional[float] = None) -> None:
        """Probe the watchdog (the router calls this each poll)."""
        if self.watchdog is not None:
            self.watchdog.check(now)

    def stall(self) -> None:
        """Wedge this replica (test and chaos hook): work stops ticking,
        the engine stamps freeze, and the next watchdog probe past the
        budget declares the wedge."""
        self._stalled = True

    def has_work(self) -> bool:
        return self.alive and self.engine.has_work()

    def queue_depth(self) -> int:
        """Waiting + active — the pow-2 load signal."""
        sched = self.engine.scheduler
        return len(sched.waiting) + len(sched.active)

    def waiting_depth(self) -> int:
        return len(self.engine.scheduler.waiting)

    def latency_score(self) -> float:
        """EWMA tick wall seconds; 0.0 until the first worked tick
        (an unmeasured replica is presumed healthy — a cold replica
        must not start its life demoted).  A step in flight raises the
        score to at least its age: a tick that has already run 0.4 s
        *is* 0.4 s slow — demotion must not wait for it to finish
        (benign cross-thread read: t0 is a monotonic stamp).  An
        *idle* replica's score decays (``LATENCY_IDLE_HALFLIFE_S``):
        stale slowness evidence must not demote forever."""
        score = self._latency_ewma or 0.0
        t0 = self._tick_t0
        now = time.monotonic()
        if t0 is not None:
            return max(score, now - t0)
        if score > 0.0 and not self.has_work():
            score *= 0.5 ** ((now - self._last_tick_done_ts)
                             / LATENCY_IDLE_HALFLIFE_S)
        return score

    def prefix_digest(self) -> frozenset:
        ticks = self.engine.ticks
        if self._digest is None or self._digest_ticks != ticks:
            self._digest = self.engine.prefix_digest()
            self._digest_ticks = ticks
        return self._digest

    def adapter_digest(self) -> frozenset:
        """Resident tenant model_ids: the router's adapter-
        affinity signal — a request for a resident tenant skips the
        store fetch + bank install entirely.  Cheap enough (a few
        entries, bounded by the bank) not to memo like the prefix
        digest."""
        return self.engine.adapter_digest()

    # ------------------------------------------------------------- drain
    def drain(self) -> None:
        self.draining = True

    @property
    def drained(self) -> bool:
        return self.draining and not self.engine.has_work()

    # -------------------------------------------------------------- reap
    def reap(self) -> int:
        """Host-side teardown for a dead/wedged replica being replaced:
        retire every request so slots/pages/prefix refcounts release
        (the dead-actor precedent — the corpse must audit clean
        before it is dropped).  Returns retired-request count."""
        self.reaped = True
        return self.engine.drain_requests()

    def leak_free(self) -> bool:
        """Fleet-wide leak audit: every slot free, every page either
        free or parked idle in the prefix pool, nothing in flight —
        and the engine's tier inventory partitions exactly, with
        no store fetch left checked out."""
        sched = self.engine.scheduler
        return (not sched.active and not sched.waiting
                and len(sched.free_slots) == self.engine.slots
                and sched.allocator.free_count
                == sched.allocator.num_pages - 1
                and self.engine.leak_free())

    def tier_hits(self, chain_hashes) -> "tuple[int, int]":
        """How far this replica's warm tiers cover a prompt's chained
        page hashes: ``(n_hbm, n_dram)`` — consecutive leading pages
        resident in HBM, then consecutive pages sitting in the host-
        DRAM pool.  The router's tier-aware cost signal: an HBM hit is
        a refcount bump, a DRAM hit pays a host->device copy, and the
        store is deliberately absent — any replica can fetch a store
        page at the same price, so store coverage never differentiates
        candidates."""
        digest = self.prefix_digest()
        n_hbm = 0
        for h in chain_hashes:
            if h not in digest:
                break
            n_hbm += 1
        n_dram = 0
        pool = self.engine.host_pool
        if pool is not None:
            ver = self.engine.param_version
            for h in chain_hashes[n_hbm:]:
                if (h, ver) not in pool:
                    break
                n_dram += 1
        return n_hbm, n_dram

    def stats(self) -> Dict[str, Any]:
        out = self.engine.stats()
        out["replica"] = self.id
        out["alive"] = self.alive
        out["draining"] = self.draining
        out["wedges"] = self.wedges
        out["last_wedge_ts"] = (self.watchdog.last_wedge_ts
                                if self.watchdog is not None else None)
        out["latency_score"] = self.latency_score()
        return out
