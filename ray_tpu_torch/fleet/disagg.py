"""Disaggregated prefill/decode serving: split replica pools with
KV-page handoff.

Counterpart of ``ray_tpu/fleet/disagg.py``.  Prefill batches are
compute-bound while decode is latency-bound, so co-locating them on one
replica makes every decode tick queue behind someone else's prefill.
This module splits them: a **prefill pool** of replicas whose streams
end at the first sampled token (``max_new_tokens=1`` first-token-stop
submissions with ``hold_pages=True``), and a **decode pool** that
imports the handed-off KV pages into its own allocator, seeds the slot
at the absolute context offset, and streams the rest through the
ordinary batched decode step (the decode-attention kernel).

**The handoff is a transfer of page ownership, not a copy protocol.**
Pages are already content-addressed (chained hashes) and refcounted, so
the payload (:class:`~ray_tpu_torch.inference.kv_cache.KVHandoff`) is
the cached context's tokens + chained page hashes + raw K/V contents on
the host — int8 codes and scales ride the same arrays, about half the
bytes of bf16 — held by :class:`HandoffStore` while in flight.  The
import installs through the ``PrefixIndex`` registration: a decode
replica that already holds the prefix by content hash acquires
refcounts and skips the content writes, and when it holds *every*
context page the router ships metadata only — **affinity routing by
page digest makes warm handoffs near-free** (the decode-side pick
mirrors the prefix-affinity pick, keyed by the handoff's chain hashes).

**Failure semantics stay those of the co-located fleet.**  A prefill
replica dying after export, a decode replica dying after import, or a
``serve.handoff`` chaos fault on either leg of the transfer all degrade
to the same re-prefill-from-prompt failover the co-located fleet uses:
the stream re-admits on the prefill pool with ``prompt + every token
already emitted`` (at-most-once delivery is structural — the stream
asserts over-delivery) and hands off again.  Orphaned exports cannot
leak: held pages are released on every failure path, a reaped corpse's
``drain_requests`` covers them, and :meth:`DisaggRouter.leak_free`
additionally audits in-flight handoff objects in the store.

**Both pools run the engine's ordinary steps**: the prefill pool its
cold and cached prefills, the decode pool its fixed-slot decode step
over a seeded slot, so an import adds no kind of device work.

**Autoscaling** stays the reconciler, one per pool through
:meth:`DisaggRouter.pool_view`: the prefill pool scales on queue depth
and TTFT (its TTFTs are the fleet's TTFTs — the first token comes from
prefill), the decode pool on slot occupancy (a queued import means
every decode slot is busy — ``waiting_depth`` IS the occupancy
backlog).

Knobs: ``RAY_TPU_FLEET_DISAGG`` / ``RAY_TPU_FLEET_PREFILL_REPLICAS`` /
``RAY_TPU_FLEET_HANDOFF_INLINE`` (:func:`~ray_tpu_torch.fleet.config.
fleet_config`), plus the shared ``RAY_TPU_FLEET_*`` routing knobs.
"""

from __future__ import annotations

import collections
import random
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.fleet.config import FleetConfig, fleet_config
from ray_tpu_torch.fleet.replica import EngineReplica
from ray_tpu_torch.fleet.router import ReplicaUnavailableError
from ray_tpu_torch.inference.kv_cache import (HandoffContentMissing,
                                              KVHandoff, PrefixIndex)
from ray_tpu_torch.inference.scheduler import QueueFullError
from ray_tpu_torch.telemetry import trace as trace_mod

PREFILL = "prefill"
DECODE = "decode"


class HandoffStore:
    """``ray_tpu_torch.put``-shaped home for in-flight handoff payloads.

    Payloads ride the runtime's object store when a ``ray_tpu_torch``
    session is up and an in-process slot otherwise;
    ``RAY_TPU_FLEET_HANDOFF_INLINE=1`` forces the inline path either
    way.  The router materializes the payload itself before
    ``submit_import``, because every replica is host-driven in this
    process; with a session up the put/get pair prices the serialise
    and copy honestly.  Every live handle is tracked so the fleet-wide
    leak audit can assert none is orphaned (``in_flight``), and byte
    counters feed the ``serve_handoff_bytes_total`` telemetry."""

    def __init__(self, use_object_store: Optional[bool] = None, *,
                 cfg: Optional[FleetConfig] = None):
        if use_object_store is None:
            cfg = cfg or fleet_config()
            if cfg.handoff_inline:
                use_object_store = False
            else:
                from ray_tpu_torch._private.worker import is_initialized
                use_object_store = is_initialized()
        self._use_ray = bool(use_object_store)
        self._live: Dict[int, Any] = {}     # handle id -> payload/ref
        self._next = 0
        self.puts = 0
        self.bytes_put = 0

    @property
    def in_flight(self) -> int:
        return len(self._live)

    def put(self, payload: KVHandoff) -> int:
        """Stash one payload; returns its handle (drop it when the
        import lands or the handoff is abandoned)."""
        obj: Any = payload
        if self._use_ray:
            import ray_tpu_torch
            obj = ray_tpu_torch.put(payload)
        handle = self._next
        self._next += 1
        self._live[handle] = obj
        self.puts += 1
        self.bytes_put += payload.nbytes
        return handle

    def get(self, handle: int) -> KVHandoff:
        obj = self._live[handle]
        if self._use_ray:
            import ray_tpu_torch
            return ray_tpu_torch.get(obj)
        return obj

    def drop(self, handle: int) -> None:
        """Release a handle (idempotent): the payload's store memory
        frees — the refcount half of 'orphaned exported pages cannot
        leak'."""
        self._live.pop(handle, None)


class DisaggStream:
    """One disaggregated request: iterate tokens as they land (the
    :class:`~ray_tpu_torch.fleet.router.FleetStream` shape — bare token
    ids, or ``{"token", "logprob"}`` dicts under ``{"logprobs": True}``).
    The stream's life is prefill → handoff → decode; failovers restart
    it at prefill with the emitted tokens carried forward."""

    def __init__(self, router: "DisaggRouter", payload: Dict[str, Any]):
        from ray_tpu_torch.inference.serve_gpt import parse_request
        self._router = router
        self.prompt = [int(t) for t in payload["tokens"]]
        parsed = parse_request(payload)
        self.max_new_tokens = parsed["max_new_tokens"]
        self.sampling = parsed["sampling"]
        self.want_logprobs = parsed["want_logprobs"]
        self.eos_token = parsed["eos_token"]
        self.ttft_deadline_s = parsed["ttft_deadline_s"]
        self.deadline_s = parsed["deadline_s"]
        # every disagg request owns one trace — the context rides
        # the prefill submit AND the handoff payload, so both replicas'
        # spans join a single tree under this root
        ctx = trace_mod.mint()
        root_id = trace_mod.record_span(
            "request", ctx, start=time.time(), dur=0.0,
            prompt_tokens=len(self.prompt),
            max_new=self.max_new_tokens, disagg=True)
        self.trace = ctx.child(root_id) if root_id is not None else ctx
        self.submitted_ts = time.monotonic()
        self.first_token_ts: Optional[float] = None
        self.generated: List[int] = []
        self.logprobs: List[float] = []
        self.token_ts: List[float] = []
        self._cursor = 0
        self.done = False
        self.error: Optional[BaseException] = None
        self.retries = 0
        self.handoffs = 0            # completed page handoffs
        self.phase: Optional[str] = None          # PREFILL | DECODE
        self.replica_id: Optional[str] = None
        self.rid: Optional[int] = None

    # ------------------------------------------------- router callbacks
    def _push(self, token: int, logprob: float) -> None:
        if len(self.generated) >= self.max_new_tokens:
            raise AssertionError(
                f"stream got token {len(self.generated) + 1} of "
                f"{self.max_new_tokens}: duplicate delivery after "
                "failover")
        now = time.monotonic()
        if self.first_token_ts is None:
            self.first_token_ts = now
            ttft = now - self.submitted_ts
            self._router._record_ttft(ttft,
                                      trace_id=self.trace.trace_id)
            trace_mod.event("first_token", self.trace, ttft_s=ttft,
                            replica=self.replica_id)
        self.generated.append(int(token))
        self.logprobs.append(float(logprob))
        self.token_ts.append(now)

    def _finish(self) -> None:
        self.done = True
        trace_mod.event("request_end", self.trace,
                        tokens=len(self.generated),
                        handoffs=self.handoffs)

    def _fail(self, err: BaseException) -> None:
        self.error = err
        self.done = True
        trace_mod.event("request_error", self.trace,
                        error=type(err).__name__)

    @property
    def complete(self) -> bool:
        """Every requested token emitted (or EOS hit) — nothing left
        to hand off or decode."""
        return (len(self.generated) >= self.max_new_tokens
                or (self.eos_token is not None and self.generated
                    and self.generated[-1] == self.eos_token))

    # ---------------------------------------------------------- consume
    def __iter__(self):
        return self

    def __next__(self):
        while self._cursor >= len(self.generated):
            if self.error is not None:
                raise self.error
            if self.done:
                raise StopIteration
            if not self._router.poll():
                time.sleep(0.001)
        tok = self.generated[self._cursor]
        lp = self.logprobs[self._cursor]
        self._cursor += 1
        return {"token": tok, "logprob": lp} if self.want_logprobs \
            else tok

    def result(self) -> List[int]:
        for _ in self:
            pass
        return list(self.generated)

    def close(self) -> None:
        """Abandon the stream: cancel whichever pool currently holds
        it so its slot/pages/prefix refs free within a tick."""
        self._router._cancel_stream(self)


class PoolView:
    """Reconciler-protocol adapter over one pool of a
    :class:`DisaggRouter` — the :class:`~ray_tpu_torch.fleet.reconciler.
    Reconciler` drives each pool through one of these, unchanged: the
    prefill view surfaces the fleet TTFTs (queue-depth/TTFT-SLO
    scale-up), the decode view surfaces none (its ``mean_waiting``
    signal is queued imports = slot occupancy backlog)."""

    def __init__(self, router: "DisaggRouter", pool: str):
        self._router = router
        self.pool = pool

    def replicas(self) -> List[EngineReplica]:
        return list(self._router._pools[self.pool].values())

    def add_replica(self, replica: EngineReplica) -> None:
        self._router.add_replica(replica, pool=self.pool)

    def remove_replica(self, replica_id: str) -> EngineReplica:
        pool = self._router._pool_of.get(replica_id)
        if pool != self.pool:
            # the adapter's whole point is the pool boundary: a
            # reconciler must not silently shrink the OTHER pool
            raise ValueError(
                f"replica {replica_id!r} is in pool {pool!r}, not "
                f"this view's {self.pool!r}")
        return self._router.remove_replica(replica_id)

    def bound_streams(self, replica_id: str) -> int:
        return self._router.bound_streams(replica_id)

    def slow_replicas(self) -> set:
        return self._router.slow_replicas(self.pool)

    def recent_ttfts(self) -> List[float]:
        return (self._router.recent_ttfts() if self.pool == PREFILL
                else [])

    @property
    def telemetry(self):
        return self._router.telemetry


class DisaggRouter:
    """Front a prefill pool and a decode pool as one service.

    Host-driven like the :class:`~ray_tpu_torch.fleet.router.FleetRouter`
    (the router owns the tick loop and steps every replica itself), so
    every routing, handoff and recovery decision is deterministic under
    a ``RAY_TPU_FAULTS`` plan.  The pick/health helpers
    (`_update_health`/`_effective_load`/`_affinity_pick`/`_pow2_pick`)
    deliberately mirror ``router.py``'s — per-pool medians and a
    two-pool binding model don't graft cleanly onto the hedging-aware
    FleetRouter, so a behavioral fix to either copy should be applied
    to both (they are kept line-comparable on purpose).  All replicas
    — both pools — must share
    page size, bucket geometry and KV dtype: the handoff payload is
    raw page contents, and failover re-admission assumes any prefill
    replica accepts the same prompt lengths.

    Per request: route to a prefill replica (prefix-affinity by the
    prompt's chained page hashes, else pow-2 on queue depth), collect
    its first token (``max_new_tokens=1`` + ``hold_pages``), then hand
    the KV pages to a decode replica picked by *digest affinity over
    the handoff's chain hashes* — the replica already holding the most
    context pages wins, and one holding **all** of them gets a
    metadata-only handoff with zero content bytes.  The decode replica
    imports, seeds the slot at the absolute offset, and the stream
    rides ordinary batched decode to completion.
    """

    _TTFT_WINDOW = 256

    def __init__(self, prefill: List[EngineReplica],
                 decode: List[EngineReplica], *,
                 cfg: Optional[FleetConfig] = None,
                 affinity: Optional[bool] = None,
                 store: Optional[HandoffStore] = None,
                 rng_seed: int = 0, telemetry=None):
        if not prefill or not decode:
            raise ValueError("a disaggregated fleet needs >= 1 replica "
                             "in BOTH pools (prefill and decode)")
        self.cfg = cfg or fleet_config()
        self.affinity = (self.cfg.affinity if affinity is None
                         else bool(affinity))
        self._rng = random.Random(rng_seed)
        self._pools: Dict[
            str, "collections.OrderedDict[str, EngineReplica]"] = {
                PREFILL: collections.OrderedDict(),
                DECODE: collections.OrderedDict()}
        self._pool_of: Dict[str, str] = {}
        self._by_rid: Dict[Tuple[str, int], DisaggStream] = {}
        self._ttfts: "collections.deque[float]" = collections.deque(
            maxlen=self._TTFT_WINDOW)
        self._demoted: Dict[str, set] = {PREFILL: set(), DECODE: set()}
        self._median_latency: Dict[str, float] = {PREFILL: 0.0,
                                                  DECODE: 0.0}
        if telemetry is None:
            from ray_tpu_torch.telemetry.fleet import FleetTelemetry
            telemetry = FleetTelemetry()
        self.telemetry = telemetry
        self._store = store if store is not None else \
            HandoffStore(cfg=self.cfg)
        ref = prefill[0].engine
        self.page_size = ref.page_size
        self.buckets = ref.buckets
        self.kv_dtype = ref.kv_dtype
        for r in prefill:
            self.add_replica(r, pool=PREFILL)
        for r in decode:
            self.add_replica(r, pool=DECODE)

    # ------------------------------------------------------------- fleet
    @property
    def store(self) -> HandoffStore:
        return self._store

    def add_replica(self, replica: EngineReplica, *, pool: str) -> None:
        if pool not in self._pools:
            raise ValueError(f"unknown pool {pool!r}; expected "
                             f"{PREFILL!r} or {DECODE!r}")
        if replica.id in self._pool_of:
            raise ValueError(f"duplicate replica id {replica.id!r} "
                             "(ids are fleet-unique across pools)")
        eng = replica.engine
        if (eng.page_size != self.page_size
                or eng.buckets != self.buckets
                or eng.kv_dtype != self.kv_dtype):
            raise ValueError(
                f"replica {replica.id!r} geometry (page_size "
                f"{eng.page_size}, buckets {eng.buckets}, kv_dtype "
                f"{eng.kv_dtype!r}) != fleet (page_size "
                f"{self.page_size}, buckets {self.buckets}, kv_dtype "
                f"{self.kv_dtype!r}) — handoffs move raw page "
                "contents, one fleet geometry")
        self._pools[pool][replica.id] = replica
        self._pool_of[replica.id] = pool

    def remove_replica(self, replica_id: str) -> EngineReplica:
        pool = self._pool_of.get(replica_id)
        if pool is None:
            raise KeyError(replica_id)
        bound = [k for k in self._by_rid if k[0] == replica_id]
        if bound:
            raise ValueError(
                f"replica {replica_id!r} still has {len(bound)} "
                "in-flight stream(s) — drain (or fail over) first")
        # removing a pool's last replica is legal (the reconciler
        # removes a corpse before spawning its replacement): routing
        # into a momentarily-empty pool surfaces the typed
        # ReplicaUnavailableError, never a hang
        del self._pool_of[replica_id]
        self.telemetry.forget_replica(replica_id)
        return self._pools[pool].pop(replica_id)

    def replicas(self, pool: Optional[str] = None) -> List[EngineReplica]:
        if pool is not None:
            return list(self._pools[pool].values())
        return [r for p in self._pools.values() for r in p.values()]

    def pool_view(self, pool: str) -> PoolView:
        if pool not in self._pools:
            raise ValueError(f"unknown pool {pool!r}")
        return PoolView(self, pool)

    def bound_streams(self, replica_id: str) -> int:
        return sum(1 for k in self._by_rid if k[0] == replica_id)

    def _healthy(self, pool: str) -> List[EngineReplica]:
        return [r for r in self._pools[pool].values()
                if r.alive and not r.draining and not r.wedged]

    # ---------------------------------------------------- health scoring
    def _update_health(self, pool: str) -> None:
        """Per-pool latency demotion (the pools have different
        healthy tick profiles — a prefill tick is a whole bucket of
        compute, a decode tick one token — so the outlier median must
        be computed within the pool, never across it)."""
        factor = self.cfg.slow_factor
        newly: set = set()
        med = 0.0
        if factor > 0:
            scored = [(r.id, r.latency_score())
                      for r in self._healthy(pool)]
            scores = [s for _, s in scored if s > 0]
            if len(scores) >= 2:
                med = statistics.median_low(scores)
                if med > 0:
                    newly = {rid for rid, s in scored
                             if s > factor * med}
        for rid in sorted(newly - self._demoted[pool]):
            self.telemetry.record_demotion(rid)
            trace_mod.anomaly("demotion", replica=rid, pool=pool,
                              median_latency_s=med,
                              slow_factor=factor)
        self._demoted[pool] = newly
        self._median_latency[pool] = med

    def slow_replicas(self, pool: Optional[str] = None) -> set:
        if pool is not None:
            return set(self._demoted[pool])
        return self._demoted[PREFILL] | self._demoted[DECODE]

    def _effective_load(self, r: EngineReplica, pool: str) -> float:
        med = self._median_latency[pool]
        score = r.latency_score()
        rel = score / med if (med > 0 and score > 0) else 1.0
        return (r.queue_depth() + 1) * max(rel, 1.0)

    # ---------------------------------------------------------- routing
    def remote(self, payload: Dict[str, Any]) -> DisaggStream:
        """Route one request (the ``GPTDeployment`` payload dict);
        routing failures surface as the stream's typed error at first
        iteration, never an exception here (the streaming-path
        contract)."""
        stream = DisaggStream(self, payload)
        try:
            self._route_prefill(stream)
        except (ReplicaUnavailableError, ValueError) as e:
            stream._fail(e)
        return stream

    def _candidates(self, pool: str, excluded: set) -> List[EngineReplica]:
        cands = [r for r in self._healthy(pool)
                 if r.id not in excluded]
        fast = [r for r in cands if r.id not in self._demoted[pool]]
        return fast or cands        # soft demotion: never a dead-end

    def _affinity_pick(self, hashes: List[bytes], cands,
                       pool: str) -> Optional[EngineReplica]:
        """Longest-chain-hit pick (the affinity rule, shared by
        both pools: prompt hashes against prefill caches, handoff
        hashes against decode caches)."""
        if not hashes:
            return None
        best, best_hits = None, 0
        for r in cands:
            digest = r.prefix_digest()
            hits = 0
            for h in hashes:
                if h not in digest:
                    break
                hits += 1
            if hits > best_hits:
                best, best_hits = r, hits
        if best is not None \
                and best.queue_depth() < self.cfg.affinity_cap:
            return best
        return None

    def _pow2_pick(self, cands, pool: str) -> EngineReplica:
        if len(cands) == 1:
            return cands[0]
        a, b = self._rng.sample(cands, 2)
        return a if (self._effective_load(a, pool)
                     <= self._effective_load(b, pool)) else b

    def _route_prefill(self, stream: DisaggStream) -> None:
        """(Re-)admit a stream on the prefill pool: a first-token-stop
        submission over ``prompt + every emitted token``.  Raises
        :class:`ReplicaUnavailableError` when no healthy prefill
        replica accepts."""
        from ray_tpu_torch.inference.serve_gpt import ReplicaDrainingError
        from ray_tpu_torch.util import chaos
        prompt = stream.prompt + stream.generated
        if len(prompt) > self.buckets[-1]:
            raise ReplicaUnavailableError(
                f"failover re-prefill needs {len(prompt)} prompt "
                f"tokens but the fleet's largest prefill bucket is "
                f"{self.buckets[-1]} — size RAY_TPU_INFER_BUCKETS to "
                "cover prompt + max_new_tokens for failover-proof "
                "requests", retries=stream.retries)
        hashes = PrefixIndex.chain_hashes(
            prompt, self.page_size)[:PrefixIndex.hit_eligible(
                len(prompt), self.page_size)] if self.affinity else []
        excluded: set = set()
        route_t0 = time.monotonic()
        rejected: List[str] = []
        while True:
            cands = self._candidates(PREFILL, excluded)
            if not cands:
                raise ReplicaUnavailableError(
                    f"no healthy prefill replica accepted the request "
                    f"({len(self._pools[PREFILL])} in the pool, "
                    f"{len(excluded)} rejected this attempt, "
                    f"{stream.retries} failover(s) used)",
                    retries=stream.retries)
            replica = None
            if self.affinity:
                replica = self._affinity_pick(hashes, cands, PREFILL)
                if not excluded and stream.retries == 0 \
                        and not stream.generated:
                    self.telemetry.record_affinity(
                        hit=replica is not None)
            if replica is None:
                replica = self._pow2_pick(cands, PREFILL)
            try:
                chaos.maybe_fail("serve.route")
                rid = replica.submit(
                    prompt, max_new_tokens=1, hold_pages=True,
                    sampling=stream.sampling,
                    eos_token=stream.eos_token,
                    # a re-admission's first token is NOT the stream's
                    # first token: 0 disables the engine-side TTFT
                    # deadline outright (None would re-arm the engine
                    # DEFAULT and could shed a stream whose real first
                    # token was delivered long ago)
                    ttft_deadline_s=(stream.ttft_deadline_s
                                     if not stream.generated else 0),
                    deadline_s=self._remaining_deadline(stream),
                    trace_ctx=stream.trace)
            except chaos.InjectedFault:
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
            stream.phase = PREFILL
            stream.replica_id, stream.rid = replica.id, rid
            self._by_rid[(replica.id, rid)] = stream
            if stream.trace.sampled:
                now = time.monotonic()
                trace_mod.record_span(
                    "route", stream.trace,
                    start=trace_mod.epoch_of(route_t0),
                    dur=now - route_t0, picked=replica.id,
                    pool=PREFILL, attempt=stream.retries,
                    rejected=rejected,
                    candidates={r.id: round(
                        self._effective_load(r, PREFILL), 6)
                        for r in cands})
            return

    def _remaining_deadline(self, stream: DisaggStream) -> Optional[float]:
        """The stream's unspent total budget (None = the stream set
        none, engine defaults apply).  Every engine-side leg — prefill
        submit, decode import, failover re-admissions — measures its
        deadline from its own submit, so the stream-level budget must
        shrink by the time already spent; otherwise a disagg request's
        clock restarts at the decode leg and the co-located A/B
        compares different deadline semantics.  An exhausted budget
        passes a near-zero positive value: the next expiry sweep sheds
        it with the typed error, the streaming-path contract."""
        if stream.deadline_s is None:
            return None
        return max(stream.deadline_s
                   - (time.monotonic() - stream.submitted_ts), 1e-3)

    # ---------------------------------------------------------- handoff
    def _handoff(self, prefill_rep: EngineReplica, rid: int,
                 stream: DisaggStream) -> None:
        """Move the stream's KV pages from ``prefill_rep`` to a decode
        replica.  The ``serve.handoff`` chaos site fires on the export
        leg (before the pages leave the prefill allocator) and the
        import leg (before the decode side admits); either fault
        releases everything it holds and degrades to the re-prefill
        failover."""
        from ray_tpu_torch.util import chaos
        t0 = time.monotonic()
        try:
            chaos.maybe_fail("serve.handoff")          # export leg
            handoff = prefill_rep.engine.export_request(rid)
        except chaos.InjectedFault:
            prefill_rep.engine.release_held(rid)
            self._failover(stream, cause="handoff")
            return
        if stream.trace.sampled:
            trace_mod.record_span(
                "handoff.export", stream.trace,
                start=trace_mod.epoch_of(t0),
                dur=time.monotonic() - t0,
                replica=prefill_rep.id, pages=handoff.n_pages,
                nbytes=handoff.nbytes)
        try:
            self._import(handoff, stream, t0)
        except chaos.InjectedFault:
            self._failover(stream, cause="handoff")

    def _import(self, handoff: KVHandoff, stream: DisaggStream,
                t0: float) -> None:
        """The import leg: pick a decode replica by digest affinity
        over the handoff's chain hashes, ship only the pages it is
        missing (a fully-resident target gets metadata alone and the
        store is never touched — that is what makes warm handoffs
        near-free), and re-bind the stream to the decode pool.  The
        handle always drops on the way out, so no store object can
        outlive its handoff."""
        from ray_tpu_torch.inference.serve_gpt import ReplicaDrainingError
        from ray_tpu_torch.util import chaos
        chaos.maybe_fail("serve.handoff")              # import leg
        import_t0 = time.monotonic()
        remaining = stream.max_new_tokens - len(stream.generated)
        excluded: set = set()
        handle: Optional[int] = None
        try:
            while True:
                cands = self._candidates(DECODE, excluded)
                if not cands:
                    stream._fail(ReplicaUnavailableError(
                        f"no healthy decode replica accepted the "
                        f"handoff ({len(self._pools[DECODE])} in the "
                        f"pool, {len(excluded)} rejected this "
                        "attempt)", retries=stream.retries))
                    return
                replica = None
                if self.affinity:
                    replica = self._affinity_pick(handoff.chain_hashes,
                                                  cands, DECODE)
                if replica is None:
                    replica = self._pow2_pick(cands, DECODE)
                # strip the payload to what the target is MISSING: the
                # leading run of chain hashes in its digest is already
                # resident (the admission walk installs them as hits),
                # so only the pages past it — plus the partial tail —
                # ship.  Fully resident + no tail = the warm handoff:
                # metadata only, the store is never touched.
                digest = replica.prefix_digest()
                resident = 0
                for h in handoff.chain_hashes:
                    if h not in digest:
                        break
                    resident += 1
                warm = (resident == handoff.n_full_pages
                        == handoff.n_pages)
                if warm:
                    payload = handoff.strip_contents()
                else:
                    ship = handoff if resident == 0 else \
                        handoff.strip_to(range(resident,
                                               handoff.n_pages))
                    if handle is not None:   # a rejected attempt's put
                        self._store.drop(handle)
                    handle = self._store.put(ship)
                    payload = self._store.get(handle)
                try:
                    rid = replica.submit_import(
                        payload, max_new_tokens=remaining,
                        sampling=stream.sampling,
                        eos_token=stream.eos_token,
                        deadline_s=self._remaining_deadline(stream))
                except (ReplicaDrainingError, QueueFullError):
                    excluded.add(replica.id)
                    continue
                except ValueError as e:
                    # a request the decode geometry can never serve
                    # (e.g. context + remaining tokens past max_seq):
                    # typed failure on the stream, not a poll-loop
                    # crash
                    stream._fail(e)
                    return
                stream.phase = DECODE
                stream.replica_id, stream.rid = replica.id, rid
                stream.handoffs += 1
                self._by_rid[(replica.id, rid)] = stream
                self.telemetry.record_handoff(
                    n_bytes=payload.nbytes,
                    seconds=time.monotonic() - t0,
                    pages=len(payload.page_list), skipped=warm,
                    trace_id=stream.trace.trace_id)
                if stream.trace.sampled:
                    trace_mod.record_span(
                        "handoff.import", stream.trace,
                        start=trace_mod.epoch_of(import_t0),
                        dur=time.monotonic() - import_t0,
                        replica=replica.id, warm=warm,
                        nbytes=payload.nbytes,
                        pages=len(payload.page_list))
                return
        finally:
            if handle is not None:
                self._store.drop(handle)

    # --------------------------------------------------------- tick loop
    def poll(self) -> bool:
        """One fleet tick: refresh per-pool health, step every live
        replica with work (prefill pool first — its first tokens
        become this tick's handoffs), dispatch events, fail streams
        over from dead/wedged replicas.  Returns whether any replica
        made progress."""
        for pool in (PREFILL, DECODE):
            self._update_health(pool)
        progressed = False
        for pool in (PREFILL, DECODE):
            for replica in list(self._pools[pool].values()):
                if replica.id not in self._pool_of:
                    continue             # removed by a reconciler mid-poll
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
                    self._dispatch(replica, pool, ev)
        self._record_depths()
        return progressed

    def _dispatch(self, replica: EngineReplica, pool: str, ev) -> None:
        rid, token, done = ev
        key = (replica.id, rid)
        stream = self._by_rid.get(key)
        if stream is None:
            if pool == PREFILL and done and ev.error is None:
                # a held export whose stream vanished (cancelled
                # between submit and first token): release, don't leak
                replica.engine.release_held(rid)
            return
        if ev.error is not None:
            del self._by_rid[key]
            if isinstance(ev.error, HandoffContentMissing):
                # a warm handoff whose resident pages evaporated:
                # re-prefill (a re-route, not a failover — no budget
                # burned, the pages were simply gone)
                self.telemetry.record_retry("handoff")
                self._reroute(stream)
                return
            stream._fail(ev.error)
            return
        stream._push(token, ev.logprob)
        if pool == PREFILL:
            # first-token-stop: the event is always terminal
            del self._by_rid[key]
            if stream.complete:
                replica.engine.release_held(rid)
                stream._finish()
            else:
                self._handoff(replica, rid, stream)
        elif done:
            del self._by_rid[key]
            stream._finish()

    def _on_replica_down(self, replica: EngineReplica, *,
                         reap: bool) -> None:
        """Fail every stream bound to a dead/wedged replica over to the
        prefill pool (re-prefill from prompt + emitted tokens — the one
        failover path both pools share).  Reaping releases the corpse's
        slots/pages/prefix refs *and* any held exports."""
        bound = [(k, s) for k, s in list(self._by_rid.items())
                 if k[0] == replica.id]
        cause = "dead" if reap else "wedged"
        if not reap:
            trace_mod.anomaly("wedge", replica=replica.id,
                              bound_streams=len(bound))
        for key, stream in bound:
            del self._by_rid[key]
            if replica.alive:
                replica.engine.cancel(key[1])
            self._failover(stream, cause=cause)
        if reap and not replica.alive and not replica.reaped:
            replica.reap()

    def _failover(self, stream: DisaggStream, *,
                  cause: str = "dead") -> None:
        self.telemetry.record_retry(cause)
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
        self._reroute(stream)
        if not stream.done:
            trace_mod.event(
                "failover", stream.trace, cause=cause,
                from_replica=from_replica,
                to_replica=stream.replica_id,
                tokens_resent=len(stream.generated),
                retry=stream.retries)

    def _reroute(self, stream: DisaggStream) -> None:
        if stream.complete:
            stream._finish()            # nothing left to decode
            return
        try:
            self._route_prefill(stream)
        except (ReplicaUnavailableError, ValueError) as e:
            stream._fail(e)

    def _cancel_stream(self, stream: DisaggStream) -> None:
        if stream.replica_id is None or stream.done:
            return
        key = (stream.replica_id, stream.rid)
        self._by_rid.pop(key, None)
        replica = self._pools.get(self._pool_of.get(stream.replica_id,
                                                    ""), {}) \
            .get(stream.replica_id)
        if replica is not None and replica.alive:
            replica.engine.cancel(stream.rid)
        stream._finish()

    # ------------------------------------------------------ observability
    def _record_ttft(self, ttft_s: float,
                     trace_id: Optional[str] = None) -> None:
        self._ttfts.append(ttft_s)
        self.telemetry.record_ttft(ttft_s, mode="disagg",
                                   trace_id=trace_id)

    def recent_ttfts(self) -> List[float]:
        return list(self._ttfts)

    def _record_depths(self) -> None:
        for pool, reps in self._pools.items():
            depth = 0
            for r in reps.values():
                if r.alive:
                    depth += r.queue_depth()
                    self.telemetry.record_queue_depth(r.id,
                                                      r.queue_depth())
                    self.telemetry.record_latency_score(
                        r.id, r.latency_score())
            self.telemetry.record_pool_depth(pool, depth)

    def quiesce(self, timeout_s: float = 5.0) -> bool:
        """Poll until no replica holds work (True when settled) — the
        post-run audit gate."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.poll()
            if not any(r.alive and r.has_work()
                       for r in self.replicas()):
                return True
            time.sleep(0.002)
        return False

    def leak_free(self) -> bool:
        """Fleet-wide invariant: no slot/page/refcount held on either
        pool (held exports count — ``EngineReplica.leak_free`` reads
        the allocator), and no handoff object still in flight in the
        store."""
        return (all(r.leak_free() for r in self.replicas())
                and self._store.in_flight == 0)

    def stats(self) -> Dict[str, Any]:
        return {
            "pools": {
                pool: {r.id: {"alive": r.alive,
                              "draining": r.draining,
                              "wedged": r.wedged,
                              "queue_depth": r.queue_depth(),
                              "latency_score": r.latency_score(),
                              "demoted": r.id in self._demoted[pool]}
                       for r in reps.values()}
                for pool, reps in self._pools.items()},
            "in_flight": len(self._by_rid),
            "handoffs_in_store": self._store.in_flight,
            "affinity": self.affinity,
            # the fleet-shared KV page store, when any replica
            # tiers into one (replicas share the instance, so the
            # first is everyone's view)
            "kv_store": next(
                (r.engine.store.stats() for r in self.replicas()
                 if r.engine.store is not None), None),
        }
