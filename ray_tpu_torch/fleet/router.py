"""Health-aware replica router: pow-2 choices, prefix affinity,
mid-stream failover.

Counterpart of ``ray_tpu/fleet/router.py``: the layer that makes N
replicas look like one reliable service.  The API is
``DeploymentHandle``-shaped — ``router.remote(payload)`` takes the
serving request dict (:func:`~ray_tpu_torch.inference.serve_gpt.
parse_request`) and returns a stream you iterate — but the router runs
host-side over :class:`~ray_tpu_torch.fleet.replica.EngineReplica`
objects and drives their engine ticks itself (:meth:`FleetRouter.poll`),
so every routing and recovery decision is deterministic under a
``RAY_TPU_FAULTS`` plan.

**Routing** (per request): with affinity on, the prompt's chained page
hashes (the :class:`~ray_tpu_torch.inference.kv_cache.PrefixIndex`
keys) are matched against each healthy replica's warm tiers
(:meth:`~ray_tpu_torch.fleet.replica.EngineReplica.tier_hits`); the
best-covered replica wins if it is under the affinity queue-depth cap —
the fleet-wide prefix cache.  Otherwise power-of-two-choices on queue
depth: sample two (``random.Random(rng_seed)``), take the shallower
queue — near-least-loaded at O(1) probe cost.

**Gray failure**: binary health misses the replica that is slow
without being dead.  Three mitigations share one latency vocabulary:
(1) every replica carries an EWMA tick-latency **health score**; the
pow-2 comparison weighs queue depth by relative latency, and replicas
past ``RAY_TPU_FLEET_SLOW_FACTOR``x the fleet median are **demoted** —
excluded from routing while any faster replica exists (soft: an
all-slow fleet still routes) and surfaced via :meth:`FleetRouter.
slow_replicas` for the reconciler's DEGRADED dwell.  (2) a stream
whose first token misses the rolling-p99-informed **hedge deadline**
(``RAY_TPU_FLEET_HEDGE_*``) is re-admitted on a second replica —
first responder wins, the loser is cancelled; at-most-once delivery
is preserved by the same ``(replica_id, rid)`` binding keys failover
uses (the losing binding drops before its token could land).  (3) a
hedged stream whose primary *dies* promotes the surviving binding
instead of re-routing — the hedge was the failover.

**Failover**: a replica death (``serve.replica`` chaos site, or any
step raise) or a watchdog wedge mid-stream re-admits every bound
request on a healthy replica — re-prefilling from the original prompt
*plus the tokens already emitted*, with ``max_new`` reduced by the
same count, so delivery is at-most-once by construction (the stream
asserts it).  Stale events from a wedged replica that later revives
cannot reach the stream: bindings are keyed ``(replica_id, rid)`` and
dropped at failover.  ``ReplicaDrainingError`` / ``QueueFullError`` /
a ``serve.route`` submit fault are immediate re-route signals (each
replica tried at most once per attempt); only death/wedge failovers
consume the ``RAY_TPU_FLEET_RETRIES`` budget, and exhausting it — or
running out of healthy replicas — surfaces a typed
:class:`ReplicaUnavailableError` on the stream, never a hang.

**Threads** (``concurrent_steps=True``): each replica steps on a
worker thread while the poll thread routes and dispatches.  Replicas on
one card launch on the thread's current stream, the default stream, so
their device work serialises there; the mode overlaps host work only.
"""

from __future__ import annotations

import collections
import queue
import random
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.adapters import AdapterUnavailableError
from ray_tpu_torch.fleet.config import FleetConfig, fleet_config
from ray_tpu_torch.fleet.replica import EngineReplica
from ray_tpu_torch.inference.kv_cache import PrefixIndex
from ray_tpu_torch.inference.scheduler import QueueFullError
from ray_tpu_torch.telemetry import trace as trace_mod


def _omp_set_num_threads():
    """The OpenMP runtime's ``omp_set_num_threads`` as torch loaded it,
    from the process's global scope.  Raises when it is not there, so a
    step pool that cannot narrow its threads fails instead of
    oversubscribing the cores."""
    import ctypes
    try:
        return ctypes.CDLL(None).omp_set_num_threads
    except AttributeError:
        raise RuntimeError(
            "no omp_set_num_threads in this process: the fleet's step "
            "threads cannot narrow their intra-op width") from None


def _split_intra_op(narrow, share: int) -> None:
    """Step-pool initializer: this worker thread runs torch's intra-op
    work on ``share`` threads, its part of the process's pool.  Torch's
    OpenMP team is per calling thread, so N stepping threads at the
    full width run N x width threads; on the CPU that oversubscription
    stretches every tick (a tiny engine's prefill tick went from ~9 ms
    to 60-230 ms with six such processes on 8 cores), and a healthy
    replica's inflated EWMA then hides the slow one.  The replica
    threads are the parallelism here.

    ``torch.set_num_threads`` would also write the process-wide width
    that every thread reads at its first torch call, so a thread
    starting while this runs would settle at ``share`` for life.  So
    this thread first settles its own width (the first
    ``get_num_threads`` reads the process's), then narrows only its own
    OpenMP setting, which the BLAS calls read too; the process-wide
    value is never written.  ``narrow`` is :func:`_omp_set_num_threads`,
    looked up on the poll thread, where a missing entry point raises to
    the caller; raised here it would only break the pool."""
    torch.get_num_threads()
    narrow(share)


class ReplicaUnavailableError(RuntimeError):
    """Typed routing failure: the failover budget is exhausted or no
    healthy replica remains — the caller sees this on the stream, not
    a hang (the fleet's zero-hung-streams contract)."""

    def __init__(self, msg: str, *, retries: int = 0):
        super().__init__(msg)
        self.retries = retries


class FleetStream:
    """One routed request: iterate tokens as they land (the
    ``DeploymentResponseGenerator`` shape).  Iteration pumps the
    router's poll loop; a typed error — deadline expiry, exhausted
    failover — raises out of ``__next__``."""

    def __init__(self, router: "FleetRouter", payload: Dict[str, Any]):
        from ray_tpu_torch.inference.serve_gpt import parse_request
        self._router = router
        self.prompt = [int(t) for t in payload["tokens"]]
        parsed = parse_request(payload)    # the deployment's parser:
        self.max_new_tokens = parsed["max_new_tokens"]  # no drift
        self.sampling = parsed["sampling"]
        self.want_logprobs = parsed["want_logprobs"]
        self.eos_token = parsed["eos_token"]
        self.ttft_deadline_s = parsed["ttft_deadline_s"]
        self.deadline_s = parsed["deadline_s"]
        # tracing: mint the request's TraceContext here — the
        # router boundary IS the request's birth.  The root "request"
        # span records immediately (dur=0) so a mid-request anomaly
        # dump is still rooted, and every later span parents under it.
        ctx = trace_mod.mint()
        root_id = trace_mod.record_span(
            "request", ctx, start=time.time(), dur=0.0,
            prompt_tokens=len(self.prompt),
            max_new=self.max_new_tokens)
        self.trace = ctx.child(root_id) if root_id is not None else ctx
        self.submitted_ts = time.monotonic()
        self.first_token_ts: Optional[float] = None
        # every token the fleet has emitted for this request, in order
        # (the failover re-prefill source), with its model logprob
        # beside it; _cursor is how far the consumer has read
        self.generated: List[int] = []
        self.logprobs: List[float] = []
        self.token_ts: List[float] = []   # per-token arrival stamps
        self._cursor = 0
        self.done = False
        self.error: Optional[BaseException] = None
        self.retries = 0                  # death/wedge failovers only
        self.replica_id: Optional[str] = None
        self.rid: Optional[int] = None
        # tail-latency hedge: a second concurrent binding racing the
        # primary for the first token (None when not hedged)
        self.hedge_replica_id: Optional[str] = None
        self.hedge_rid: Optional[int] = None
        self.hedges = 0                   # hedges issued for this stream

    # ------------------------------------------------- router callbacks
    def _push(self, token: int, logprob: float) -> None:
        if len(self.generated) >= self.max_new_tokens:
            # at-most-once delivery is structural (failover re-admits
            # with max_new reduced by the emitted count) — a violation
            # is a router bug, surfaced loudly
            raise AssertionError(
                f"stream got token {len(self.generated) + 1} of "
                f"{self.max_new_tokens}: duplicate delivery after "
                "failover")
        now = time.monotonic()
        if self.first_token_ts is None:
            self.first_token_ts = now
            self._router._record_ttft(now - self.submitted_ts,
                                      trace_id=self.trace.trace_id)
        self.generated.append(int(token))
        self.logprobs.append(float(logprob))
        self.token_ts.append(now)

    def _finish(self) -> None:
        self.done = True
        trace_mod.event("request_end", self.trace,
                        tokens=len(self.generated))

    def _fail(self, err: BaseException) -> None:
        self.error = err
        self.done = True
        trace_mod.event("request_error", self.trace,
                        error=type(err).__name__)

    # ---------------------------------------------------------- consume
    def __iter__(self):
        return self

    def __next__(self) -> int:
        while self._cursor >= len(self.generated):
            if self.error is not None:
                raise self.error
            if self.done:
                raise StopIteration
            if not self._router.poll():
                # no replica ticked (e.g. a wedge waiting out its
                # watchdog budget): yield the cpu instead of spinning
                time.sleep(0.001)
        tok = self.generated[self._cursor]
        lp = self.logprobs[self._cursor]
        self._cursor += 1
        # same item shape as the deployment's stream: bare token ids,
        # or {"token", "logprob"} dicts under {"logprobs": True}
        return {"token": tok, "logprob": lp} if self.want_logprobs \
            else tok

    def result(self) -> List[int]:
        """Drain to completion and return every token (raises the
        stream's typed error like iteration does)."""
        for _ in self:
            pass
        return list(self.generated)

    def close(self) -> None:
        """Abandon the stream: cancel the in-flight request so its
        slot/pages/prefix refs free within a tick."""
        self._router._cancel_stream(self)


class FleetRouter:
    """Route requests over a set of replicas and drive their ticks.

    ``replicas`` seed the fleet (the reconciler adds/removes later);
    all replicas must share page size and bucket geometry (the prefix
    hashes and re-admission lengths assume it — checked here).
    ``rng_seed`` pins the pow-2 sampling so routing distributions are
    reproducible in tests and benchmarks.

    ``concurrent_steps``: step each replica on its own worker thread
    (the engine already serves submit-vs-step concurrency — the
    deployment pump's contract) instead of sequentially inside
    :meth:`poll`.  Sequential is the default: every decision is
    deterministic under a fault plan (the acceptance-test
    contract).  Concurrent exists because a *slowdown* cannot be
    modeled sequentially — a straggling replica's tick would stall
    the whole drive loop, taxing every replica equally, when the
    point of gray-failure mitigation is that it must not
    (the gray-failure runs use this mode; event interleaving is
    timing-dependent there, so its tests assert order-independent
    invariants).
    """

    _TTFT_WINDOW = 256

    def __init__(self, replicas: List[EngineReplica], *,
                 cfg: Optional[FleetConfig] = None,
                 affinity: Optional[bool] = None,
                 rng_seed: int = 0, telemetry=None,
                 concurrent_steps: bool = False):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.cfg = cfg or fleet_config()
        self.affinity = (self.cfg.affinity if affinity is None
                         else bool(affinity))
        self.concurrent_steps = bool(concurrent_steps)
        # concurrent mode state: a worker pool stepping replicas, the
        # completion queue workers report into, and the ids with a
        # step in flight (never step one engine from two threads)
        self._step_pool = None
        self._step_results: Optional["queue.Queue"] = None
        self._stepping: set = set()
        self._replicas: "collections.OrderedDict[str, EngineReplica]" \
            = collections.OrderedDict()
        self._rng = random.Random(rng_seed)
        # (replica_id, rid) -> stream; dropped at failover so a stale
        # event from a revived wedge can never reach a re-homed stream
        self._by_rid: Dict[Tuple[str, int], FleetStream] = {}
        self._ttfts: "collections.deque[float]" = collections.deque(
            maxlen=self._TTFT_WINDOW)
        if telemetry is None:
            from ray_tpu_torch.telemetry.fleet import FleetTelemetry
            telemetry = FleetTelemetry()
        self.telemetry = telemetry
        # gray-failure health state, refreshed once per poll: the ids
        # currently demoted (latency score past slow_factor x median)
        # and the fleet median score backing the pow-2 penalty
        self._demoted: set = set()
        self._median_latency = 0.0
        self.page_size = replicas[0].engine.page_size
        self.buckets = replicas[0].engine.buckets
        for r in replicas:
            self.add_replica(r)

    # ----------------------------------------------------------- fleet
    def add_replica(self, replica: EngineReplica) -> None:
        if replica.id in self._replicas:
            raise ValueError(f"duplicate replica id {replica.id!r}")
        if replica.engine.page_size != self.page_size \
                or replica.engine.buckets != self.buckets:
            # one fleet geometry: the prefix hashes assume the page
            # size and failover re-admission assumes every replica
            # accepts the same prompt lengths
            raise ValueError(
                f"replica {replica.id!r} geometry (page_size "
                f"{replica.engine.page_size}, buckets "
                f"{replica.engine.buckets}) != fleet (page_size "
                f"{self.page_size}, buckets {self.buckets})")
        self._replicas[replica.id] = replica

    def remove_replica(self, replica_id: str) -> EngineReplica:
        """Drop a replica from routing.  Refuses while streams are
        still bound to it — scale-down must drain first (zero dropped
        streams); dead/wedged replicas are unbound by failover."""
        bound = [k for k in self._by_rid if k[0] == replica_id]
        if bound:
            raise ValueError(
                f"replica {replica_id!r} still has {len(bound)} "
                "in-flight stream(s) — drain (or fail over) first")
        # drop the gauge state too, or a long-running fleet's
        # queue-depth series grows one stale replica per restart
        self.telemetry.forget_replica(replica_id)
        return self._replicas.pop(replica_id)

    def replicas(self) -> List[EngineReplica]:
        return list(self._replicas.values())

    def bound_streams(self, replica_id: str) -> int:
        """How many in-flight streams are bound to a replica (the
        reconciler's retire gate: removal requires zero)."""
        return sum(1 for k in self._by_rid if k[0] == replica_id)

    def healthy(self) -> List[EngineReplica]:
        return [r for r in self._replicas.values()
                if r.alive and not r.draining and not r.wedged]

    # ---------------------------------------------------- health scoring
    def _update_health(self) -> None:
        """Refresh the demoted set from live latency scores (once per
        poll).  A replica is demoted while its EWMA tick latency
        exceeds ``slow_factor`` x the fleet median score; uniform
        slowness moves the median with it, so a fleet that is *all*
        slow (shared cause: thermal throttle, noisy host) demotes
        nobody — demotion is for the outlier, the gray failure."""
        factor = self.cfg.slow_factor
        newly: set = set()
        med = 0.0
        if factor > 0:
            scored = [(r.id, r.latency_score()) for r in self.healthy()]
            scores = [s for _, s in scored if s > 0]
            if len(scores) >= 2:
                # median_low: an even fleet takes the lower middle, so
                # one outlier in a 2-replica fleet still stands out
                # against the healthy score instead of their average
                med = statistics.median_low(scores)
                if med > 0:
                    newly = {rid for rid, s in scored
                             if s > factor * med}
        for rid in sorted(newly - self._demoted):
            self.telemetry.record_demotion(rid)
            trace_mod.anomaly("demotion", replica=rid,
                              median_latency_s=med, slow_factor=factor)
        self._demoted = newly
        self._median_latency = med

    def slow_replicas(self) -> set:
        """Ids currently demoted for latency (the reconciler's
        DEGRADED signal — dwell-gating is the reconciler's job; this
        is the instantaneous verdict)."""
        return set(self._demoted)

    def _effective_load(self, r: EngineReplica) -> float:
        """Queue depth weighted by relative latency: the pow-2 signal.
        ``depth + 1`` so an idle-but-slow replica still loses to an
        idle fast one; the latency ratio only ever penalizes (a
        faster-than-median replica is not rewarded — depth stays the
        primary balance signal)."""
        med = self._median_latency
        score = r.latency_score()
        rel = score / med if (med > 0 and score > 0) else 1.0
        return (r.queue_depth() + 1) * max(rel, 1.0)

    # --------------------------------------------------------- routing
    def remote(self, payload: Dict[str, Any]) -> FleetStream:
        """Route one request (the ``GPTDeployment`` payload dict) and
        return its stream.  Routing failures surface as the stream's
        typed error at first iteration — the streaming-path contract
        (``QueueFullError`` precedent), never an exception here."""
        stream = FleetStream(self, payload)
        try:
            self._route(stream)
        except (ReplicaUnavailableError, ValueError) as e:
            stream._fail(e)
        return stream

    def _chain_hashes(self, prompt: List[int],
                      salt: bytes = b"") -> List[bytes]:
        """Hit-eligible chained page hashes of a prompt — the
        scheduler's own walk (shared helper, so the hashing scheme
        and the final-page eligibility rule can never drift between
        routing and admission).  ``salt`` is the per-tenant
        chain salt: a multi-tenant request's routing-side hashes must
        match the salted entries its admission will register, or
        affinity would score adapter traffic against base K/V it can
        never legally hit."""
        eligible = PrefixIndex.hit_eligible(len(prompt),
                                            self.page_size)
        return PrefixIndex.chain_hashes(prompt, self.page_size,
                                        salt=salt)[:eligible]

    def _adapter_salt(self, model_id: Optional[str]) -> bytes:
        """The routing-side view of a tenant's prefix-chain salt,
        through the fleet-shared adapter store (the first replica
        wired to one — replicas of a fleet share the instance)."""
        if not model_id:
            return b""
        store = next(
            (getattr(r.engine, "adapter_store", None)
             for r in self._replicas.values()
             if getattr(r.engine, "adapter_store", None) is not None),
            None)
        return store.salt_for(model_id) if store is not None else b""

    # Tier-aware affinity weights: an HBM-resident page is a
    # pure refcount bump; a host-DRAM page pays one host->device page
    # copy, so it is worth most-but-not-all of an HBM hit — a replica
    # holding the whole prefix spilled still beats one holding a short
    # resident stub.  The store tier is deliberately weightless: any
    # replica fetches a store page at the same price, so store
    # coverage cannot differentiate candidates (those requests fall
    # through to the pow-2 load pick and warm whichever replica wins).
    TIER_WEIGHT_HBM = 1.0
    TIER_WEIGHT_DRAM = 0.8
    # Adapter residency: a resident tenant skips the store
    # fetch + bank install a cold replica would pay — worth a couple
    # of page hits, but a long prefix hit should still dominate (the
    # saved prefill FLOPs scale with the prefix; the adapter load is
    # one bounded host-side install)
    ADAPTER_WEIGHT = 2.0

    def _affinity_pick(self, prompt, cands,
                       model_id: Optional[str] = None
                       ) -> Optional[EngineReplica]:
        """The tier-aware cost model over the prefix-affinity
        pick: candidates score by how much re-prefill their warm tiers
        save (HBM hit > DRAM hit > nothing; ties break toward the
        shallower queue), and the winner still yields to pow-2 when
        its queue is past the affinity cap — a hot cache must not
        become a hot spot.  Multi-tenant requests compose an
        adapter-residency bonus into the same score — their prefix
        hashes are salted per tenant, so the two signals can never
        double-count the same pages — unless
        ``RAY_TPU_FLEET_ADAPTER_AFFINITY=0`` pins the residency-blind
        A/B arm."""
        hashes = self._chain_hashes(prompt,
                                    salt=self._adapter_salt(model_id))
        score_adapters = (model_id is not None
                          and self.cfg.adapter_affinity)
        if not hashes and not score_adapters:
            return None
        best, best_score = None, 0.0
        for r in cands:
            n_hbm, n_dram = r.tier_hits(hashes) if hashes else (0, 0)
            score = (n_hbm * self.TIER_WEIGHT_HBM
                     + n_dram * self.TIER_WEIGHT_DRAM)
            if score_adapters and model_id in r.adapter_digest():
                score += self.ADAPTER_WEIGHT
            if score > best_score or (
                    score == best_score and best is not None
                    and score > 0.0
                    and r.queue_depth() < best.queue_depth()):
                best, best_score = r, score
        if best is not None \
                and best.queue_depth() < self.cfg.affinity_cap:
            return best
        return None             # no hit, or the hit replica is hot

    def _pow2_pick(self, cands) -> EngineReplica:
        if len(cands) == 1:
            return cands[0]
        a, b = self._rng.sample(cands, 2)
        return a if self._effective_load(a) <= self._effective_load(b) \
            else b

    def _route(self, stream: FleetStream) -> None:
        """Pick a replica and submit; draining/queue-full/route-fault
        rejections re-route immediately (each replica tried at most
        once).  Raises :class:`ReplicaUnavailableError` when no
        healthy replica accepts."""
        from ray_tpu_torch.inference.serve_gpt import \
            ReplicaDrainingError
        from ray_tpu_torch.util import chaos
        # failover re-prefill: prompt plus every already-emitted token
        prompt = stream.prompt + stream.generated
        remaining = stream.max_new_tokens - len(stream.generated)
        if len(prompt) > self.buckets[-1]:
            # the grown prompt outruns the fleet's largest prefill
            # bucket: the original request was admissible but its
            # re-admission is not — a geometry limit (size buckets to
            # cover prompt + max_new when failover must always work),
            # surfaced typed instead of as a raw engine ValueError
            raise ReplicaUnavailableError(
                f"failover re-prefill needs {len(prompt)} prompt "
                f"tokens but the fleet's largest prefill bucket is "
                f"{self.buckets[-1]} — size RAY_TPU_INFER_BUCKETS to "
                "cover prompt + max_new_tokens for failover-proof "
                "requests", retries=stream.retries)
        excluded: set = set()
        route_t0 = time.monotonic()
        rejected: List[str] = []   # cause-tagged per-attempt rejections
        while True:
            cands = [r for r in self.healthy()
                     if r.id not in excluded]
            if not cands:
                raise ReplicaUnavailableError(
                    f"no healthy replica accepted the request "
                    f"({len(self._replicas)} total, "
                    f"{len(excluded)} rejected this attempt, "
                    f"{stream.retries} failover(s) used)",
                    retries=stream.retries)
            # gray-failure demotion: route past latency-demoted
            # replicas while any faster one exists — but an all-slow
            # candidate set still routes (soft demotion, never a
            # dead-end)
            fast = [r for r in cands if r.id not in self._demoted]
            cands = fast or cands
            replica = None
            if self.affinity:
                replica = self._affinity_pick(
                    prompt, cands, model_id=stream.sampling.model_id)
                if not excluded and stream.retries == 0:
                    # one decision per REQUEST: re-routes and failover
                    # re-admissions must not multiply-count a request
                    # in the hit-rate gauge (failovers skew toward
                    # hits — the re-prefill is resident fleet-wide —
                    # which would inflate the metric exactly when the
                    # fleet is unhealthy)
                    self.telemetry.record_affinity(
                        hit=replica is not None)
            if replica is None:
                replica = self._pow2_pick(cands)
            try:
                chaos.maybe_fail("serve.route")
                rid = replica.submit(
                    prompt, max_new_tokens=remaining,
                    sampling=stream.sampling,
                    eos_token=stream.eos_token,
                    ttft_deadline_s=stream.ttft_deadline_s,
                    deadline_s=stream.deadline_s,
                    trace_ctx=stream.trace)
            except chaos.InjectedFault:
                # a routed submit failed in flight: indistinguishable
                # from a dead target at the router — re-route
                self.telemetry.record_retry("dead")
                rejected.append(f"dead:{replica.id}")
                excluded.add(replica.id)
                continue
            except ReplicaDrainingError:
                self.telemetry.record_retry("draining")
                rejected.append(f"draining:{replica.id}")
                excluded.add(replica.id)
                continue
            except QueueFullError:
                self.telemetry.record_retry("queue_full")
                rejected.append(f"queue_full:{replica.id}")
                excluded.add(replica.id)
                continue
            except AdapterUnavailableError:
                # this replica cannot serve the tenant (no adapter
                # support / bank full of pinned tenants): try the
                # others — only when EVERY replica rejects does the
                # typed error surface (via the empty-candidates raise)
                self.telemetry.record_retry("adapter")
                rejected.append(f"adapter:{replica.id}")
                excluded.add(replica.id)
                continue
            stream.replica_id, stream.rid = replica.id, rid
            self._by_rid[(replica.id, rid)] = stream
            if stream.trace.sampled:
                trace_mod.record_span(
                    "route", stream.trace,
                    start=trace_mod.epoch_of(route_t0),
                    dur=time.monotonic() - route_t0,
                    picked=replica.id, attempt=stream.retries,
                    rejected=rejected,
                    candidates={r.id: round(self._effective_load(r), 6)
                                for r in cands})
            return

    # --------------------------------------------------------- hedging
    def hedge_deadline_s(self) -> float:
        """How long a stream may wait for its first token before the
        router races a second replica: ``hedge_factor`` x the rolling
        p99 TTFT once enough samples exist, floored at ``hedge_min``
        (which is also the whole deadline on a cold fleet — a fleet
        with no latency history must not hedge everything)."""
        if len(self._ttfts) >= 16:
            srt = sorted(self._ttfts)
            p99 = srt[min(len(srt) - 1, int(0.99 * len(srt)))]
            return max(self.cfg.hedge_min,
                       self.cfg.hedge_factor * p99)
        return self.cfg.hedge_min

    def _maybe_hedge(self) -> None:
        """Re-admit over-deadline first-token waiters on a second
        replica.  The hedge races the primary: both bindings map to
        the stream, the first token resolves the race and cancels the
        loser — delivery stays at-most-once because exactly one
        binding survives to push tokens.

        Two gates keep hedging from amplifying load (the Tail-at-Scale
        failure mode: a saturated fleet hedging itself deeper into
        saturation): the stream must be past the p99-informed
        deadline, AND the hedge target must have **spare capacity
        now** (an empty waiting queue) — a stream that is slow because
        the whole fleet is queued gains nothing from one more queue
        slot, only the stream stuck behind a *relatively* slow replica
        does.  Capacity is observable before the straggler's first
        slow tick even completes, so the gate protects a cold fleet
        without blinding the hedge exactly when it is needed."""
        now = time.monotonic()
        deadline = self.hedge_deadline_s()
        for stream in list(dict.fromkeys(self._by_rid.values())):
            # hedges > 0: a stream races at most ONE hedge in its
            # lifetime.  Without the cap, a leg whose TTFT deadline
            # expires is absorbed by the partner and the stream
            # re-hedges next poll — an unmeetable deadline would spin
            # fresh admissions forever (each restarts the engine-side
            # deadline clock) instead of surfacing the typed error.
            if (stream.done or stream.first_token_ts is not None
                    or stream.hedge_rid is not None
                    or stream.hedges > 0
                    or stream.replica_id is None
                    or now - stream.submitted_ts < deadline):
                continue
            self._submit_hedge(stream)

    def _submit_hedge(self, stream: FleetStream) -> None:
        from ray_tpu_torch.inference.serve_gpt import \
            ReplicaDrainingError
        cands = [r for r in self.healthy()
                 if r.id != stream.replica_id]
        # fastest-first, demoted last: the hedge exists to dodge the
        # slow replica — racing it against another slow one is waste
        cands.sort(key=lambda r: (r.id in self._demoted,
                                  self._effective_load(r)))
        if not cands or cands[0].waiting_depth() > 0:
            return      # no spare capacity anywhere: don't amplify
        for replica in cands:
            if replica.waiting_depth() > 0:
                # the capacity gate holds per candidate, not just for
                # the best one: a rejected submit must not fall
                # through to a queued replica — that's the exact load
                # amplification the gate exists to prevent
                continue
            try:
                rid = replica.submit(
                    stream.prompt,
                    max_new_tokens=stream.max_new_tokens,
                    sampling=stream.sampling,
                    eos_token=stream.eos_token,
                    ttft_deadline_s=stream.ttft_deadline_s,
                    deadline_s=stream.deadline_s,
                    trace_ctx=stream.trace)
            except (ReplicaDrainingError, QueueFullError, ValueError,
                    AdapterUnavailableError):
                continue              # best-effort: primary still runs
            stream.hedge_replica_id, stream.hedge_rid = replica.id, rid
            stream.hedges += 1
            self._by_rid[(replica.id, rid)] = stream
            self.telemetry.record_hedge("issued")
            trace_mod.event("hedge_issued", stream.trace,
                            hedge_replica=replica.id,
                            primary_replica=stream.replica_id,
                            waited_s=(time.monotonic()
                                      - stream.submitted_ts))
            return

    def _other_binding(self, stream: FleetStream,
                       key: Tuple[str, int]) -> Optional[Tuple[str, int]]:
        """The stream's still-bound race partner of ``key`` (None when
        the stream is not hedged or the partner is already unbound)."""
        if stream.hedge_rid is None:
            return None
        primary = (stream.replica_id, stream.rid)
        hedge = (stream.hedge_replica_id, stream.hedge_rid)
        other = hedge if key == primary else (
            primary if key == hedge else None)
        return other if other is not None and other in self._by_rid \
            else None

    def _resolve_hedge(self, stream: FleetStream,
                       winner: Tuple[str, int],
                       loser: Optional[Tuple[str, int]]) -> None:
        """Settle a hedge race: the winning binding becomes the
        stream's one binding; the loser (if still bound) is unbound
        and cancelled engine-side so its slot/pages/prefix refs free
        within a tick."""
        hedge_won = winner == (stream.hedge_replica_id,
                               stream.hedge_rid)
        if loser is not None:
            self._by_rid.pop(loser, None)
            rep = self._replicas.get(loser[0])
            if rep is not None and rep.alive:
                rep.engine.cancel(loser[1])
        stream.replica_id, stream.rid = winner
        stream.hedge_replica_id = stream.hedge_rid = None
        self.telemetry.record_hedge("won" if hedge_won else "wasted")
        self.telemetry.record_hedge_won(
            "hedge" if hedge_won else "primary")
        trace_mod.event("hedge_resolved", stream.trace,
                        winner="hedge" if hedge_won else "primary",
                        replica=winner[0])

    # ------------------------------------------------------- tick loop
    def quiesce(self, timeout_s: float = 5.0) -> bool:
        """Poll until no step is in flight and no replica holds work
        (True when settled).  Post-run audits need this in
        ``concurrent_steps`` mode: a cancelled hedge loser's tick may
        still be sleeping in a worker when the last stream finishes,
        and ``leak_free`` must not read an engine mid-step."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.poll()
            if not self._stepping and not any(
                    r.alive and r.has_work()
                    for r in self._replicas.values()):
                return True
            time.sleep(0.002)
        return False

    def close(self) -> None:
        """Release the concurrent-mode step pool (idempotent; a no-op
        for sequential routers).  Worker threads are only created by
        ``concurrent_steps`` polling — a dropped router would
        otherwise park them until GC/interpreter exit."""
        pool, self._step_pool = self._step_pool, None
        # _stepping is NOT cleared: shutdown(wait=False) leaves already-
        # running steps running, and a poll() after close() (a consumer
        # draining a leftover stream) must still see their replicas as
        # in flight — clearing would let it double-step an engine.  No
        # id can be stranded either: the pool holds >= one worker per
        # replica, so every submitted step runs (cancel_futures never
        # finds a queued one) and its completion drain discards the id.
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    def poll(self) -> bool:
        """One fleet tick: refresh health scores, hedge over-deadline
        first-token waiters, probe watchdogs, step every live replica
        with work, dispatch events, fail streams over from dead or
        wedged replicas.  Returns whether any replica made progress
        (consumers back off briefly when none did)."""
        self._update_health()
        if self.cfg.hedge:
            self._maybe_hedge()
        progressed = (self._poll_concurrent() if self.concurrent_steps
                      else self._poll_sequential())
        self._record_depths()
        return progressed

    def _poll_sequential(self) -> bool:
        progressed = False
        for replica in list(self._replicas.values()):
            if not replica.alive:
                self._on_replica_down(replica, reap=True)
                continue
            replica.check()
            if replica.wedged:
                self._on_replica_down(replica, reap=False)
                continue
            if not replica.has_work():
                continue
            try:
                events = replica.step()
            except BaseException:  # noqa: BLE001 — death IS the event
                self._on_replica_down(replica, reap=True)
                continue
            progressed = progressed or bool(events)
            for ev in events:
                self._dispatch(replica, ev)
        return progressed

    def _poll_concurrent(self) -> bool:
        """Concurrent-mode tick: launch one worker-thread step per
        idle replica with work (the engine's submit-vs-step lock makes
        main-thread admissions safe against it), then drain whatever
        steps have completed and dispatch their events here on the
        poll thread — all stream/binding state stays single-threaded.
        A straggling replica's slow tick occupies only its own worker;
        the fleet keeps polling at the healthy replicas' pace (the
        whole point of the mode — see the class docstring)."""
        if self._step_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            workers = max(4, len(self._replicas) + 2)
            share = max(1, torch.get_num_threads() // workers)
            narrow = _omp_set_num_threads()
            self._step_pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="fleet-step",
                initializer=_split_intra_op, initargs=(narrow, share))
            self._step_results = queue.Queue()

        def run_step(rep: EngineReplica) -> None:
            try:
                self._step_results.put((rep, rep.step(), None))
            except BaseException as e:  # noqa: BLE001 — death IS the event
                self._step_results.put((rep, None, e))

        for replica in list(self._replicas.values()):
            in_flight = replica.id in self._stepping
            if not replica.alive:
                # an in-flight step's death report arrives via the
                # completion queue; handling it here too would be fine
                # (idempotent) but noisy
                if not in_flight:
                    self._on_replica_down(replica, reap=True)
                continue
            replica.check()
            if replica.wedged:
                # a hung in-flight step IS the wedge: re-home the
                # streams now — a late completion's events drop on the
                # stale (replica_id, rid) bindings, the invariant
                self._on_replica_down(replica, reap=False)
                continue
            if in_flight or not replica.has_work():
                continue
            self._stepping.add(replica.id)
            self._step_pool.submit(run_step, replica)

        progressed = False
        while True:
            try:
                replica, events, err = self._step_results.get_nowait()
            except queue.Empty:
                break
            self._stepping.discard(replica.id)
            if err is not None:
                self._on_replica_down(replica, reap=True)
                continue
            progressed = progressed or bool(events)
            for ev in events:
                self._dispatch(replica, ev)
        return progressed

    def _dispatch(self, replica: EngineReplica, ev) -> None:
        rid, token, done = ev
        key = (replica.id, rid)
        stream = self._by_rid.get(key)
        if stream is None:
            return                       # cancelled/stale binding
        if ev.error is not None:
            del self._by_rid[key]
            other = self._other_binding(stream, key)
            if other is not None:
                # one leg of a hedge race expired (e.g. its TTFT
                # deadline): the partner is still decoding — let it
                # carry the stream instead of surfacing the error
                self._resolve_hedge(stream, winner=other, loser=None)
                return
            # deadline expiry: policy shed the request (everything
            # already released engine-side) — typed error, no failover
            stream._fail(ev.error)
            return
        if stream.first_token_ts is None and stream.hedge_rid is not None:
            # the first token resolves the hedge race: this binding
            # wins, the other is unbound BEFORE any of its tokens
            # could land (at-most-once stays structural)
            self._resolve_hedge(stream, winner=key,
                                loser=self._other_binding(stream, key))
        stream._push(token, ev.logprob)
        if done:
            del self._by_rid[key]
            stream._finish()

    def _on_replica_down(self, replica: EngineReplica,
                         *, reap: bool) -> None:
        """Fail every stream bound to a dead/wedged replica over to a
        healthy one.  Dead replicas are reaped host-side (slots/pages/
        prefix refcounts released — the corpse audits clean); a wedged
        replica keeps its engine state for the reconciler's restart,
        but its bound rids are cancelled so a revival cannot keep
        decoding for streams that have moved on."""
        cause = "dead" if reap else "wedged"
        bound = [(k, s) for k, s in list(self._by_rid.items())
                 if k[0] == replica.id]
        if not reap:
            # a watchdog wedge is an anomaly trigger even with nothing
            # bound: the record of what the fleet was doing when the
            # step loop froze is the whole point of the recorder
            trace_mod.anomaly("wedge", replica=replica.id,
                              bound_streams=len(bound))
        for key, stream in bound:
            del self._by_rid[key]
            if replica.alive:
                replica.engine.cancel(key[1])
            other = self._other_binding(stream, key)
            if other is not None:
                # a hedged stream lost one leg to the death/wedge: the
                # surviving binding IS the failover — promote it, no
                # re-route ("won" when the hedge saved the stream)
                self._resolve_hedge(stream, winner=other, loser=None)
                continue
            self._failover(stream, cause=cause)
        if reap and not replica.alive and not replica.reaped:
            replica.reap()

    def _failover(self, stream: FleetStream, *,
                  cause: str = "dead") -> None:
        self.telemetry.record_retry("dead")
        self.telemetry.record_failover(cause)
        from_replica = stream.replica_id
        stream.retries += 1
        if stream.retries > self.cfg.retries:
            trace_mod.anomaly("failover_budget", trace=stream.trace,
                              retries=stream.retries - 1, cause=cause)
            stream._fail(ReplicaUnavailableError(
                f"failover budget exhausted after {stream.retries - 1} "
                f"retr{'y' if stream.retries == 2 else 'ies'} "
                "(RAY_TPU_FLEET_RETRIES)", retries=stream.retries - 1))
            return
        try:
            self._route(stream)
        except (ReplicaUnavailableError, ValueError) as e:
            stream._fail(e)
            return
        trace_mod.event("failover", stream.trace, cause=cause,
                        from_replica=from_replica,
                        to_replica=stream.replica_id,
                        tokens_resent=len(stream.generated),
                        retry=stream.retries)

    def _cancel_stream(self, stream: FleetStream) -> None:
        if stream.replica_id is None or stream.done:
            return
        for rep_id, rid in ((stream.replica_id, stream.rid),
                            (stream.hedge_replica_id,
                             stream.hedge_rid)):
            if rid is None:
                continue
            self._by_rid.pop((rep_id, rid), None)
            replica = self._replicas.get(rep_id)
            if replica is not None and replica.alive:
                replica.engine.cancel(rid)
        stream.hedge_replica_id = stream.hedge_rid = None
        stream._finish()

    # ------------------------------------------------------ observability
    def _record_ttft(self, ttft_s: float,
                     trace_id: Optional[str] = None) -> None:
        self._ttfts.append(ttft_s)
        # the single-pool arm of the TTFT-by-pool-mode split (the
        # disagg router records mode="disagg"); the trace id rides the
        # histogram as an exemplar
        self.telemetry.record_ttft(ttft_s, mode="colocated",
                                   trace_id=trace_id)

    def recent_ttfts(self) -> List[float]:
        """Recent first-token latencies (the reconciler's SLO signal
        and the callers' percentile source)."""
        return list(self._ttfts)

    def _record_depths(self) -> None:
        for r in self._replicas.values():
            if r.alive:
                self.telemetry.record_queue_depth(r.id, r.queue_depth())
                self.telemetry.record_latency_score(
                    r.id, r.latency_score())

    def leak_free(self) -> bool:
        """Fleet-wide invariant: no slot/page/refcount held anywhere
        (dead replicas were reaped at failover, so they audit too)."""
        return all(r.leak_free() for r in self._replicas.values())

    def stats(self) -> Dict[str, Any]:
        return {
            "replicas": {r.id: {"alive": r.alive,
                                "draining": r.draining,
                                "wedged": r.wedged,
                                "queue_depth": r.queue_depth(),
                                "latency_score": r.latency_score(),
                                "demoted": r.id in self._demoted}
                         for r in self._replicas.values()},
            "in_flight": len(self._by_rid),
            "affinity": self.affinity,
            "hedge_deadline_s": self.hedge_deadline_s(),
            # the fleet-shared KV page store, when any replica
            # tiers into one (replicas share the instance, so the
            # first is everyone's view)
            "kv_store": next(
                (r.engine.store.stats()
                 for r in self._replicas.values()
                 if r.engine.store is not None), None),
            # the fleet-shared adapter store (same one-instance
            # convention as kv_store)
            "adapter_store": next(
                (getattr(r.engine, "adapter_store", None).stats()
                 for r in self._replicas.values()
                 if getattr(r.engine, "adapter_store", None)
                 is not None), None),
        }
