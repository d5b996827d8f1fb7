"""Port parity: the serving fleet (``ray_tpu_torch.fleet``).

Across the packages, on ``GPTConfig.tiny`` (f32, 2 slots, page 16) with
the same parameters (``convert.params_from_jax``): a JAX ``FleetRouter``
over JAX replicas and a port one over port replicas, both with
``rng_seed=0``, ``slow_factor=0`` and ``hedge=False`` (latency scores
are wall-clock EWMAs, and the two engines tick at different speeds),
fed the same payloads, route every stream to the same replica, deliver
the same greedy tokens and end with the same ``stats()`` and telemetry
counters — with affinity on and off, under the same ``serve.replica``
death (with the reconciler's restart on explicit clocks) and under a
``serve.route`` reroute.  ``DisaggRouter`` over one prefill and one
decode replica gives the same streams and handoff byte counts in f32
and int8, and ``FleetTelemetry`` fed the same records the same
``summary()``.

Then the port's own counterparts of the reference's fleet tests
(``tests/test_fleet.py`` but the idle-stream reaper, which needs the
deployment; the ``DisaggRouter`` / ``HandoffStore`` tests of
``tests/test_disagg.py``; the tier-aware pick and the tiered fleet of
``tests/test_tiers.py``; the fleet traces of ``tests/test_trace.py``;
``tests/test_telemetry.py::test_fleet_telemetry_summary``), gray
failure and hedging within the port, and the ``concurrent_steps`` poll
mode with the kernels' launch counter under threads.  The reference's
zero-recompile assertions have no counterpart: the port runs eagerly.
"""

import json
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.fleet import DisaggRouter as JaxDisagg
from ray_tpu.fleet import EngineReplica as JaxReplica
from ray_tpu.fleet import FleetConfig as JaxFleetConfig
from ray_tpu.fleet import FleetRouter as JaxRouter
from ray_tpu.fleet import Reconciler as JaxReconciler
from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.models import gpt as jgpt
from ray_tpu.telemetry import trace as jtrace
from ray_tpu.telemetry.config import TelemetryConfig as JaxTelConfig
from ray_tpu.telemetry.fleet import FleetTelemetry as JaxFleetTelemetry
from ray_tpu.util import chaos as jchaos
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.fleet import (DEGRADED, DRAINING, RESTARTING, RUNNING,
                                 STOPPED, WEDGED, DisaggRouter,
                                 EngineReplica, FleetConfig, FleetRouter,
                                 HandoffStore, Reconciler,
                                 ReplicaUnavailableError)
from ray_tpu_torch.inference import (InferenceEngine, KVHandoff,
                                     KVPageStore, PrefixIndex,
                                     QueueFullError)
from ray_tpu_torch.inference.serve_gpt import (ReplicaDrainingError,
                                               StreamIdleError,
                                               parse_request)
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import _build
from ray_tpu_torch.telemetry import FleetTelemetry, trace
from ray_tpu_torch.telemetry.config import TelemetryConfig
from ray_tpu_torch.util import chaos

GEOMETRY = dict(slots=2, page_size=16, buckets=(16, 32, 64))
VOCAB = 512
# the JAX engines' compiled steps, shared within this file per kv dtype
_JAX_EXEC = {"model": {}, "int8": {}}


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No armed faults, trace sampling 1, a fresh ring and no dump
    directory, in both packages."""
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "1")
    monkeypatch.delenv("RAY_TPU_TRACE_RING", raising=False)
    monkeypatch.delenv("RAY_TPU_TRACE_DIR", raising=False)
    for mod in (trace, jtrace):
        mod.trace_config(refresh=True)
        mod.reset()
    chaos.clear_faults()
    jchaos.clear_faults()
    yield
    chaos.clear_faults()
    jchaos.clear_faults()
    for mod in (trace, jtrace):
        mod.trace_config(refresh=True)
        mod.reset()


def _prompt(n, seed=0):
    return [int(t) for t in np.random.RandomState(seed).randint(0, VOCAB, n)]


def _engine(models, **kw):
    _j, _jp, tcfg, tparams = models
    return InferenceEngine(tcfg, tparams, device="cpu", telemetry=False,
                           **{**GEOMETRY, **kw})


def _replica(models, rid, *, watchdog_s=0.0, **kw):
    return EngineReplica(rid, _engine(models, **kw), watchdog_s=watchdog_s)


def _jax_replica(models, rid, kv_dtype="model", **kw):
    jcfg, jparams, _t, _tp = models
    return JaxReplica(rid, JaxEngine(
        jcfg, jparams, telemetry=False, kv_dtype=kv_dtype,
        executable_cache=_JAX_EXEC[kv_dtype], **{**GEOMETRY, **kw}))


_FCFG = dict(retries=2, affinity=True, affinity_cap=8, up_depth=4.0,
             ttft_slo=0.0, dwell=1.0, backoff=1.0, backoff_max=8.0)


def _fcfg(**over):
    """The reference's ``tests/test_fleet.py`` config."""
    return FleetConfig(**{**_FCFG, **over})


def _tel():
    return FleetTelemetry(config=TelemetryConfig(enabled=True))


def _generate(models, prompts, max_new, **kw):
    return [[int(t) for t in out] for out in
            _engine(models, **kw).generate(prompts, max_new_tokens=max_new)]


# --------------------------------------------- across the two packages
_PARITY = dict(slow_factor=0.0, hedge=False, dwell=0.0)
_SIDES = {
    "jax": types.SimpleNamespace(
        replica=_jax_replica, Router=JaxRouter, Disagg=JaxDisagg,
        Reconciler=JaxReconciler, chaos=jchaos,
        cfg=lambda **o: JaxFleetConfig(**{**_FCFG, **_PARITY, **o}),
        tel=lambda: JaxFleetTelemetry(config=JaxTelConfig(enabled=True))),
    "port": types.SimpleNamespace(
        replica=lambda models, rid, kv_dtype="model", **kw: _replica(
            models, rid, kv_dtype=kv_dtype, **kw),
        Router=FleetRouter, Disagg=DisaggRouter, Reconciler=Reconciler,
        chaos=chaos, cfg=lambda **o: _fcfg(**{**_PARITY, **o}),
        tel=_tel),
}
# the telemetry keys a run decides (the rest are wall-clock)
_TEL_KEYS = ("router_retries", "router_retries_total", "replica_restarts",
             "affinity_decisions", "affinity_routed", "affinity_hit_rate",
             "replica_queue_depth", "hedges", "hedge_winners", "failovers",
             "replica_demotions", "handoffs", "handoffs_skipped",
             "handoff_bytes_total", "handoff_pages_total",
             "pool_queue_depth")


def _decided(router):
    """``stats()`` and the telemetry summary without the wall-clock
    entries (latency scores, the p99-driven hedge deadline, times)."""
    st = router.stats()
    st.pop("hedge_deadline_s", None)
    for reps in ([st["replicas"]] if "replicas" in st
                 else st["pools"].values()):
        for r in reps.values():
            r.pop("latency_score")
    summ = router.telemetry.summary()
    tel = {k: summ[k] for k in _TEL_KEYS}
    tel["ttft_counts"] = {m: v["count"]
                          for m, v in summ["ttft_s_by_mode"].items()}
    return st, tel


def _waves():
    """Two system prompts of 2 pages behind 6 requests: one per system
    prompt in the first wave (cold), the other 4 at once in the second
    (hits under affinity), and a singleton."""
    systems = [_prompt(32, 300 + i) for i in range(2)]
    first = [systems[i] + _prompt(5 + i, 310 + i) for i in range(2)]
    second = [systems[i % 2] + _prompt(3 + i, 320 + i) for i in range(4)]
    return [first, second + [_prompt(9, 330)]]


def _run_fleet(side, models, waves, *, affinity=True, faults=None,
               max_new=4, reconcile=False):
    """Route each wave at once and drain it; returns what the packages
    must agree on."""
    reps = [side.replica(models, f"r{i}") for i in range(3)]
    cfg = side.cfg()
    router = side.Router(reps, cfg=cfg, affinity=affinity, rng_seed=0,
                         telemetry=side.tel())
    rec = side.Reconciler(
        router, lambda rid: side.replica(models, rid), target=3,
        cfg=cfg, now=0.0) if reconcile else None
    plan = side.chaos.install_faults(faults) if faults else None
    streams = []
    try:
        for wave in waves:
            batch = [router.remote({"tokens": p, "max_new_tokens": max_new})
                     for p in wave]
            for s in batch:
                s.result()
            streams += batch
    finally:
        side.chaos.clear_faults()
    actions = []
    if rec is not None:
        for t in (1.0, 1.5, 2.5, 3.0):
            actions.append(rec.reconcile(now=t))
    st, tel = _decided(router)
    return dict(
        out=[[int(t) for t in s.generated] for s in streams],
        replicas=[s.replica_id for s in streams],
        retries=[s.retries for s in streams],
        errors=[type(s.error).__name__ if s.error else None
                for s in streams],
        stats=st, tel=tel, actions=actions,
        states=rec.states() if rec is not None else None,
        fired=plan.fired if plan is not None else None,
        leak_free=router.leak_free())


@pytest.mark.parametrize("affinity", [True, False], ids=["affinity",
                                                         "pow2"])
def test_router_matches_jax_fleet(models, affinity):
    jax_run = _run_fleet(_SIDES["jax"], models, _waves(), affinity=affinity)
    port_run = _run_fleet(_SIDES["port"], models, _waves(),
                          affinity=affinity)
    assert port_run == jax_run
    assert port_run["leak_free"] and not any(port_run["errors"])
    if affinity:
        # every second-wave request behind a system prompt hits
        assert port_run["tel"]["affinity_routed"] == 4
        assert port_run["replicas"][2:6] == [port_run["replicas"][i % 2]
                                             for i in range(4)]


def test_replica_death_failover_matches_jax_fleet(models):
    """``serve.replica@3``: the third replica tick dies mid-traffic in
    both packages; the same streams fail over to the same replicas with
    the same tokens, and the reconciler's restart (explicit clocks)
    takes the same actions."""
    prompts = [_waves()[0][0][:32] + _prompt(5 + i, 340 + i)
               for i in range(6)]
    runs = {k: _run_fleet(_SIDES[k], models, [prompts],
                          faults="serve.replica@3", reconcile=True)
            for k in ("jax", "port")}
    assert runs["port"] == runs["jax"]
    port = runs["port"]
    assert port["fired"] == [("serve.replica", 3)]
    assert any(port["retries"]) and not any(port["errors"])
    assert port["out"] == _generate(models, prompts, 4)
    assert port["tel"]["failovers"] == {"dead": sum(port["retries"])}
    assert sorted(port["states"].values()) == [RUNNING] * 3
    assert any("RESTARTING" in a for acts in port["actions"] for a in acts)


def test_route_fault_reroute_matches_jax_fleet(models):
    prompts = [_prompt(8 + i, 350 + i) for i in range(4)]
    runs = {k: _run_fleet(_SIDES[k], models, [prompts],
                          faults="serve.route@1,serve.route@3")
            for k in ("jax", "port")}
    assert runs["port"] == runs["jax"]
    assert runs["port"]["fired"] == [("serve.route", 1),
                                     ("serve.route", 3)]
    assert runs["port"]["tel"]["router_retries"] == {"dead": 2}
    assert runs["port"]["out"] == _generate(models, prompts, 4)


def _run_disagg(side, models, kv_dtype):
    shared = _prompt(32, 360)
    exact = _prompt(48, 361)                 # 3 full pages, no tail
    waves = [[exact, shared + _prompt(7, 362), _prompt(9, 363)],
             [shared + _prompt(5, 364), exact]]
    router = side.Disagg([side.replica(models, "p0", kv_dtype)],
                         [side.replica(models, "d0", kv_dtype)],
                         cfg=side.cfg(), rng_seed=0, telemetry=side.tel())
    streams = []
    for wave in waves:
        batch = [router.remote({"tokens": p, "max_new_tokens": 5})
                 for p in wave]
        for s in batch:
            s.result()
        streams += batch
    assert router.quiesce() and router.leak_free()
    st, tel = _decided(router)
    return dict(out=[[int(t) for t in s.generated] for s in streams],
                handoffs=[s.handoffs for s in streams],
                puts=router.store.puts, bytes_put=router.store.bytes_put,
                stats=st, tel=tel), waves


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_disagg_router_matches_jax(models, kv_dtype):
    jax_run, _ = _run_disagg(_SIDES["jax"], models, kv_dtype)
    port_run, waves = _run_disagg(_SIDES["port"], models, kv_dtype)
    assert port_run == jax_run
    assert port_run["tel"]["handoffs"] == 5
    assert port_run["tel"]["handoffs_skipped"] == 1      # the repeat
    assert port_run["bytes_put"] == port_run["tel"]["handoff_bytes_total"]
    if kv_dtype == "model":
        prompts = [p for w in waves for p in w]
        assert port_run["out"] == _generate(models, prompts, 5)


def _feed(tel):
    tel.record_retry("dead")
    tel.record_retry("dead")
    tel.record_retry("draining")
    tel.record_retry("queue_full")
    tel.record_restart()
    for hit in (True, False, True, True):
        tel.record_affinity(hit=hit)
    tel.record_queue_depth("r0", 3)
    tel.record_queue_depth("r1", 0)
    for outcome in ("issued", "issued", "won", "wasted"):
        tel.record_hedge(outcome)
    for winner in ("hedge", "primary"):
        tel.record_hedge_won(winner)
    tel.record_failover("dead")
    tel.record_failover("handoff")
    tel.record_demotion("r1")
    tel.record_latency_score("r0", 0.002)
    tel.record_latency_score("r1", 0.31)
    tel.record_handoff(n_bytes=4096, seconds=0.002, pages=2,
                       trace_id="t1")
    tel.record_handoff(n_bytes=0, seconds=0.001, pages=0, skipped=True)
    tel.record_pool_depth("prefill", 3)
    tel.record_pool_depth("decode", 1)
    for s, mode in ((0.02, "disagg"), (0.04, "disagg"),
                    (0.05, "colocated")):
        tel.record_ttft(s, mode=mode)
    return tel


@pytest.mark.parametrize("enabled", [True, False])
def test_fleet_telemetry_summary_matches_reference(enabled):
    port = _feed(FleetTelemetry(config=TelemetryConfig(enabled=enabled)))
    ref = _feed(JaxFleetTelemetry(config=JaxTelConfig(enabled=enabled)))
    assert port.summary() == ref.summary()
    port.forget_replica("r1")
    ref.forget_replica("r1")
    assert port.summary() == ref.summary()


def test_parse_request_and_errors_match_reference():
    from ray_tpu.inference import serve_gpt as jserve
    payload = {"tokens": [1, 2], "max_new_tokens": 7, "temperature": 0.5,
               "top_k": 3, "top_p": 0.9, "seed": 4, "speculation": 1,
               "speculation_k": 2, "logprobs": True, "eos_token": 9,
               "ttft_deadline_s": 1.5, "deadline_s": 3.0}
    for p in (payload, {"tokens": [1]}):
        got, want = parse_request(p), jserve.parse_request(p)
        assert {k: v for k, v in got.items() if k != "sampling"} == \
            {k: v for k, v in want.items() if k != "sampling"}
        assert vars(got["sampling"]) == vars(want["sampling"])
    for err in (ReplicaDrainingError, StreamIdleError):
        assert issubclass(err, RuntimeError)


def test_fleet_config_env_knobs_match_reference(monkeypatch):
    from ray_tpu.fleet import fleet_config as jax_fleet_config
    from ray_tpu_torch.fleet import fleet_config
    env = {"RAY_TPU_FLEET_RETRIES": "5", "RAY_TPU_FLEET_AFFINITY": "0",
           "RAY_TPU_FLEET_AFFINITY_CAP": "-1", "RAY_TPU_FLEET_DWELL": "2",
           "RAY_TPU_FLEET_HEDGE": "0", "RAY_TPU_FLEET_SLOW_FACTOR": "0",
           "RAY_TPU_FLEET_PREFILL_REPLICAS": "0",
           "RAY_TPU_FLEET_HANDOFF_INLINE": "1"}
    try:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got, want = fleet_config(refresh=True), jax_fleet_config(
            refresh=True)
        assert vars(got) == vars(want)
        assert (got.retries, got.affinity, got.affinity_cap,
                got.prefill_replicas) == (5, False, 8, 1)
        for k in env:
            monkeypatch.delenv(k)
        assert vars(fleet_config(refresh=True)) == vars(
            jax_fleet_config(refresh=True)) == vars(FleetConfig())
    finally:
        fleet_config(refresh=True)
        jax_fleet_config(refresh=True)


# ------------------------------------------------- the port's own: stubs
class StubReplica:
    """Router/reconciler-protocol stub: no engine, pure host state."""

    def __init__(self, rid, *, depth=0, digest=(), page_size=16):
        self.id = rid
        self.alive = True
        self.draining = False
        self.reaped = False
        self.wedges = 0
        self._depth = depth
        self._digest = frozenset(digest)
        self._drained = False
        self._next_rid = 0
        self.submit_error = None       # raised once per set
        self.submitted = 0
        self.latency = 0.0             # health score (0 = unmeasured)
        self.engine = types.SimpleNamespace(
            page_size=page_size, buckets=(64,), cancel=lambda rid: None,
            store=None)

    def submit(self, prompt, **kw):
        if self.submit_error is not None:
            err, self.submit_error = self.submit_error, None
            raise err
        self.submitted += 1
        self._depth += 1
        self._next_rid += 1
        return self._next_rid

    def step(self):
        return []

    @property
    def wedged(self):
        return self.wedges > 0

    def check(self, now=None):
        pass

    def has_work(self):
        return False

    def queue_depth(self):
        return self._depth

    def waiting_depth(self):
        return self._depth

    def latency_score(self):
        return self.latency

    def prefix_digest(self):
        return self._digest

    def adapter_digest(self):
        return frozenset()

    def tier_hits(self, chain_hashes):
        n_hbm = 0
        for h in chain_hashes:
            if h not in self._digest:
                break
            n_hbm += 1
        return n_hbm, 0

    def drain(self):
        self.draining = True

    @property
    def drained(self):
        return self.draining and self._drained

    def reap(self):
        self.reaped = True
        return 0

    def leak_free(self):
        return True


def test_router_pow2_converges_to_least_loaded():
    reps = [StubReplica("r0", depth=12), StubReplica("r1", depth=0),
            StubReplica("r2", depth=6)]
    router = FleetRouter(reps, cfg=_fcfg(affinity=False), rng_seed=7,
                         telemetry=_tel())
    for _ in range(30):
        s = router.remote({"tokens": [1, 2, 3], "max_new_tokens": 2})
        assert s.error is None and s.replica_id is not None
    depths = [r.queue_depth() for r in reps]
    assert max(depths) - min(depths) <= 4, depths
    assert reps[1].submitted > reps[2].submitted > reps[0].submitted


def test_router_affinity_overrides_only_healthy_under_cap():
    prompt = _prompt(40, 3)                  # 2 hit-eligible pages @16
    h1 = PrefixIndex.chain(PrefixIndex.ROOT, prompt[:16])
    h2 = PrefixIndex.chain(h1, prompt[16:32])
    cold = StubReplica("cold", depth=0)
    warm = StubReplica("warm", depth=3, digest=(h1, h2))
    tel = _tel()
    router = FleetRouter([cold, warm], cfg=_fcfg(affinity_cap=5),
                         rng_seed=0, telemetry=tel)
    s = router.remote({"tokens": prompt, "max_new_tokens": 2})
    assert s.replica_id == "warm"             # hit wins despite depth
    assert tel.affinity_routed == 1
    warm._depth = 6                           # over the cap: pow-2
    s = router.remote({"tokens": prompt, "max_new_tokens": 2})
    assert s.replica_id == "cold"
    warm._depth = 0
    warm.draining = True                      # not a candidate at all
    s = router.remote({"tokens": prompt, "max_new_tokens": 2})
    assert s.replica_id == "cold"
    warm.draining = False
    router_off = FleetRouter([cold, warm], cfg=_fcfg(affinity=False),
                             rng_seed=0, telemetry=_tel())
    router_off.remote({"tokens": prompt, "max_new_tokens": 2})
    assert router_off.telemetry.affinity_decisions == 0
    router.remote({"tokens": prompt[:8], "max_new_tokens": 2})
    assert tel.summary()["affinity_decisions"] >= 4


def test_router_reroute_signals_and_exhaustion():
    r0, r1 = StubReplica("r0", depth=0), StubReplica("r1", depth=5)
    tel = _tel()
    router = FleetRouter([r0, r1], cfg=_fcfg(affinity=False),
                         rng_seed=1, telemetry=tel)
    r0.submit_error = ReplicaDrainingError("draining")
    s = router.remote({"tokens": [1, 2], "max_new_tokens": 2})
    assert s.error is None and s.replica_id == "r1"
    assert tel.retries == {"draining": 1}

    def submit_full(prompt, **kw):
        raise QueueFullError("full")

    r0.submit = submit_full
    r1.submit = submit_full
    s = router.remote({"tokens": [1, 2], "max_new_tokens": 2})
    with pytest.raises(ReplicaUnavailableError, match="no healthy"):
        next(iter(s))
    assert tel.retries["queue_full"] == 2


def test_failover_past_largest_bucket_is_typed():
    router = FleetRouter([StubReplica("r0"), StubReplica("r1")],
                         cfg=_fcfg(), telemetry=_tel())
    s = router.remote({"tokens": list(range(60)), "max_new_tokens": 20})
    assert s.error is None
    s.generated = list(range(10))
    router._failover(s)
    assert isinstance(s.error, ReplicaUnavailableError)
    assert "largest prefill bucket" in str(s.error)
    with pytest.raises(ValueError, match="geometry"):
        router.add_replica(StubReplica("odd", page_size=8))


def _stub_fleet(n=2, **cfg_over):
    reps = [StubReplica(f"r{i}") for i in range(n)]
    fcfg = _fcfg(**cfg_over)
    router = FleetRouter(reps, cfg=fcfg, telemetry=_tel())
    made = []

    def factory(rid):
        r = StubReplica(rid)
        made.append(r)
        return r

    rec = Reconciler(router, factory, target=n, cfg=fcfg, now=0.0)
    return reps, router, rec, made


def test_reconciler_wedged_requires_watchdog_signal():
    reps, router, rec, made = _stub_fleet(2, dwell=1.0, backoff=2.0,
                                          backoff_max=8.0)
    for t in (1.0, 10.0, 100.0):
        assert rec.reconcile(now=t) == []
    assert set(rec.states().values()) == {RUNNING}
    reps[0].wedges = 1
    assert rec.reconcile(now=100.5) == ["r0: RUNNING->WEDGED"]
    assert rec.reconcile(now=101.0) == []      # still backing off
    assert rec.states()["r0"] == WEDGED
    acts = rec.reconcile(now=102.6)
    assert any("RESTARTING" in a for a in acts)
    assert "r0" not in rec.states()
    assert reps[0].reaped and not reps[0].alive
    (new_id,) = [rid for rid, st in rec.states().items()
                 if st == RESTARTING]
    assert rec.restarts_total == 1
    rec.reconcile(now=103.0)
    assert rec.states()[new_id] == RUNNING
    made[0].alive = False                      # crash loop: backoff 2 -> 4
    rec.reconcile(now=103.5)
    assert rec.states()[new_id] == WEDGED
    assert rec.instances[new_id].restart_at == pytest.approx(103.5 + 4.0)
    assert rec._backoff(10) == 8.0


def test_reconciler_dead_replica_is_wedge_equivalent():
    reps, router, rec, made = _stub_fleet(2, backoff=0.0)
    reps[1].alive = False
    assert "r1: RUNNING->WEDGED" in rec.reconcile(now=1.0)
    assert any("RESTARTING" in a for a in rec.reconcile(now=1.1))
    assert rec.restarts_total == 1
    assert WEDGED not in rec.states().values()
    assert len(router.replicas()) == 2


def test_reconciler_scale_up_hysteresis_and_cap():
    reps = [StubReplica("r0"), StubReplica("r1")]
    fcfg = _fcfg(up_depth=4.0, dwell=2.0)
    router = FleetRouter(reps, cfg=fcfg, telemetry=_tel())
    rec = Reconciler(router, lambda rid: StubReplica(rid), target=2,
                     max_replicas=4, cfg=fcfg, now=0.0)
    reps[0]._depth = reps[1]._depth = 10
    assert rec.reconcile(now=1.0) == []           # breach starts
    reps[0]._depth = reps[1]._depth = 0
    assert rec.reconcile(now=2.0) == []           # cleared: reset
    reps[0]._depth = reps[1]._depth = 10
    assert rec.reconcile(now=3.0) == []
    acts = rec.reconcile(now=5.0)
    assert len([a for a in acts if "scale-up" in a]) == 1
    assert len(router.replicas()) == 3
    assert all("scale-up" not in a for a in rec.reconcile(now=5.5))
    rec.reconcile(now=7.5)
    assert len(router.replicas()) == 4
    for t in (10.0, 12.0, 20.0):
        assert all("scale-up" not in a for a in rec.reconcile(now=t))
    assert len(router.replicas()) == 4


def test_reconciler_dead_while_draining_is_retired_not_replaced():
    reps, router, rec, made = _stub_fleet(3)
    rec.target = 2
    rec.instances["r2"].state = DRAINING
    reps[2].drain()
    reps[2].alive = False
    assert "r2: DRAINING->STOPPED" in rec.reconcile(now=1.0)
    assert reps[2].reaped and "r2" not in rec.states()
    assert len(router.replicas()) == 2 and made == []


def test_router_latency_demotion_is_soft():
    reps = [StubReplica(f"r{i}") for i in range(3)]
    tel = _tel()
    router = FleetRouter(reps, cfg=_fcfg(affinity=False, slow_factor=3.0),
                         rng_seed=1, telemetry=tel)
    for r, lat in zip(reps, (0.01, 0.012, 0.1)):
        r.latency = lat
    router._update_health()
    assert router.slow_replicas() == {"r2"}
    assert tel.replica_demotions == 1
    router._update_health()                  # same episode: no re-count
    assert tel.replica_demotions == 1
    for _ in range(12):
        s = router.remote({"tokens": [1, 2, 3], "max_new_tokens": 2})
        assert s.replica_id != "r2"
    for r in reps:
        r.latency = 0.1
    router._update_health()
    assert router.slow_replicas() == set()
    router._demoted = {"r0", "r1", "r2"}
    s = router.remote({"tokens": [1, 2, 3], "max_new_tokens": 2})
    assert s.error is None and s.replica_id is not None
    off = FleetRouter([StubReplica("a"), StubReplica("b")],
                      cfg=_fcfg(slow_factor=0.0), telemetry=_tel())
    off.replicas()[0].latency = 99.0
    off._update_health()
    assert off.slow_replicas() == set()


def test_router_pow2_latency_penalty():
    reps = [StubReplica("fast"), StubReplica("meh")]
    router = FleetRouter(reps, cfg=_fcfg(affinity=False, slow_factor=3.0),
                         rng_seed=5, telemetry=_tel())
    reps[0].latency, reps[1].latency = 0.01, 0.02
    router._update_health()
    assert router.slow_replicas() == set()
    assert router._effective_load(reps[0]) < router._effective_load(reps[1])
    s = router.remote({"tokens": [1, 2], "max_new_tokens": 1})
    assert s.replica_id == "fast"
    for _ in range(19):
        router.remote({"tokens": [1, 2], "max_new_tokens": 1})
    assert reps[0].submitted > reps[1].submitted


def test_hedge_deadline_and_capacity_gate():
    reps = [StubReplica("h0"), StubReplica("h1")]
    router = FleetRouter(reps, cfg=_fcfg(affinity=False, hedge=True,
                                         hedge_factor=2.0, hedge_min=0.05),
                         rng_seed=0, telemetry=_tel())
    assert router.hedge_deadline_s() == pytest.approx(0.05)
    for _ in range(20):
        router._record_ttft(0.1)
    assert router.hedge_deadline_s() == pytest.approx(0.2)
    router._record_ttft(1.0)
    assert router.hedge_deadline_s() == pytest.approx(2.0)
    s = router.remote({"tokens": [1, 2, 3], "max_new_tokens": 2})
    other = next(r for r in reps if r.id != s.replica_id)
    other._depth = 5
    s.submitted_ts -= 100.0
    router._maybe_hedge()
    assert s.hedge_rid is None
    other._depth = 0
    router._maybe_hedge()
    assert s.hedge_rid is not None and s.hedge_replica_id == other.id
    assert router.telemetry.hedges == {"issued": 1}


def test_reconciler_degraded_blip_sustained_and_death():
    reps, router, rec, made = _stub_fleet(3, dwell=2.0, backoff=0.0,
                                          slow_factor=3.0)
    for r in reps:
        r.latency = 0.01

    def set_latency(rid, lat):
        router._replicas[rid].latency = lat
        router._update_health()

    set_latency("r2", 0.5)
    assert rec.reconcile(now=1.0) == ["r2: RUNNING->DEGRADED"]
    set_latency("r2", 0.01)
    assert rec.reconcile(now=1.5) == ["r2: DEGRADED->RUNNING"]
    assert rec.demotion_restarts == 0 and made == []
    set_latency("r2", 0.5)
    assert rec.reconcile(now=2.0) == ["r2: RUNNING->DEGRADED"]
    assert rec.reconcile(now=3.5) == []
    acts = rec.reconcile(now=4.1)
    assert "r2: DEGRADED->DRAINING (degraded drain-restart)" in acts
    assert any("STARTING (restore" in a for a in acts)
    assert reps[2].draining and rec.demotion_restarts == 1
    assert len(made) == 1
    reps[2]._drained = True
    assert "r2: DRAINING->STOPPED" in rec.reconcile(now=4.2)
    assert "r2" not in rec.states()
    assert sorted(rec.states().values()).count(RUNNING) == 3
    set_latency("r1", 0.5)
    rec.reconcile(now=5.0)
    assert rec.states()["r1"] == DEGRADED
    reps[1].alive = False
    acts = rec.reconcile(now=5.5)
    assert "r1: DEGRADED->WEDGED" in acts
    assert any("RESTARTING" in a for a in acts)
    assert "r1" not in rec.states()
    assert rec.demotion_restarts == 1


def test_reconciler_ttft_slo_breach_scales_up():
    reps, router, rec, made = _stub_fleet(2, ttft_slo=0.1, dwell=1.0)
    rec.max_replicas = 3
    for _ in range(8):
        router._record_ttft(0.5)
    assert rec.reconcile(now=1.0) == []
    acts = rec.reconcile(now=2.5)
    assert any("scale-up" in a and "ttft" in a for a in acts)


def test_reconciler_scale_down_drains_newest_after_dwell():
    reps, router, rec, made = _stub_fleet(2, dwell=1.0)
    rec.target = 1
    assert rec.reconcile(now=0.5) == []
    acts = rec.reconcile(now=2.0)
    (drain_act,) = [a for a in acts if "DRAINING" in a]
    drained_id = drain_act.split(":")[0]
    assert rec.states()[drained_id] == DRAINING
    draining = rec.instances[drained_id].replica
    assert draining.draining
    assert rec.reconcile(now=3.0) == []
    assert router.remote({"tokens": [1, 2], "max_new_tokens": 1}
                         ).replica_id != drained_id
    draining._drained = True
    assert f"{drained_id}: DRAINING->STOPPED" in rec.reconcile(now=4.0)
    assert list(rec.states().values()) == [RUNNING]
    for t in (10.0, 20.0):
        assert all("DRAINING" not in a for a in rec.reconcile(now=t))


# ----------------------------------------- the port's own: real engines
def test_fleet_failover_mid_stream_chaos(models):
    """A deterministic plan kills one replica mid-traffic and a second
    wedges: every stream completes by failover with at-most-once
    delivery (greedy continuations equal the unfailed run), the
    reconciler restores the target with replacements sharing the
    parameter tensors, and nothing leaks fleet-wide."""
    shared = _prompt(32, 11)
    prompts = [shared + _prompt(5 + i, 20 + i) for i in range(6)]
    expected = _generate(models, prompts, 4)
    reps = [_replica(models, f"r{i}", watchdog_s=0.05) for i in range(3)]
    fcfg = _fcfg(retries=2, dwell=0.0, backoff=0.0)
    router = FleetRouter(reps, cfg=fcfg, rng_seed=0, telemetry=_tel())
    rec = Reconciler(router, lambda rid: _replica(models, rid,
                                                  watchdog_s=0.05),
                     target=3, cfg=fcfg)
    plan = chaos.install_faults("serve.replica@3")
    streams = [router.remote({"tokens": p, "max_new_tokens": 4})
               for p in prompts]
    for _ in range(2):
        router.poll()
    assert [r for r in reps if not r.alive]
    assert plan.fired == [("serve.replica", 3)]
    wedge = next(r for r in reps if r.alive and r.engine.has_work())
    wedge.stall()
    outs = [list(s) for s in streams]
    chaos.clear_faults()
    assert outs == expected
    assert all(s.error is None and s.done for s in streams)
    assert any(s.retries > 0 for s in streams)
    assert wedge.wedges >= 1
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        rec.reconcile()
        if sorted(rec.states().values()).count(RUNNING) == 3:
            break
        time.sleep(0.01)
    assert list(rec.states().values()).count(RUNNING) == 3
    assert rec.restarts_total == 2          # the corpse + the wedge
    embed = models[3]["embed"]
    for r in router.replicas():
        assert r.engine.params["embed"].data_ptr() == embed.data_ptr()
    assert router.leak_free()
    assert all(r.leak_free() for r in reps)
    tel = router.telemetry.summary()
    assert tel["router_retries"]["dead"] >= 2
    assert tel["replica_restarts"] == 2


def test_failover_budget_exhausts_typed(models):
    reps = [_replica(models, f"x{i}") for i in range(2)]
    router = FleetRouter(reps, cfg=_fcfg(retries=1), rng_seed=0,
                         telemetry=_tel())
    s = router.remote({"tokens": _prompt(8), "max_new_tokens": 4})
    chaos.install_faults("serve.replica@1,serve.replica@2")
    with pytest.raises(ReplicaUnavailableError):
        list(s)
    chaos.clear_faults()
    assert s.done
    assert all(not r.alive for r in reps)
    assert all(r.leak_free() for r in reps)


def test_route_site_fault_reroutes(models):
    reps = [_replica(models, f"s{i}") for i in range(2)]
    tel = _tel()
    router = FleetRouter(reps, cfg=_fcfg(), rng_seed=0, telemetry=tel)
    plan = chaos.install_faults("serve.route@1")
    s = router.remote({"tokens": _prompt(8), "max_new_tokens": 3})
    out = list(s)
    chaos.clear_faults()
    assert plan.fired == [("serve.route", 1)]
    assert len(out) == 3 and s.error is None
    assert tel.retries == {"dead": 1}
    assert router.leak_free()


def test_draining_replica_never_admits_and_drains_clean(models):
    reps = [_replica(models, f"d{i}") for i in range(2)]
    router = FleetRouter(reps, cfg=_fcfg(affinity=False), rng_seed=3,
                         telemetry=_tel())
    rec = Reconciler(router, lambda rid: None, target=1,
                     cfg=_fcfg(dwell=0.0))
    streams = [router.remote({"tokens": _prompt(8, i),
                              "max_new_tokens": 3}) for i in range(4)]
    target = reps[1]
    rec.instances[target.id].state = DRAINING
    target.drain()
    with pytest.raises(ReplicaDrainingError):
        target.submit([1, 2, 3], max_new_tokens=2)
    s_new = router.remote({"tokens": _prompt(8, 9), "max_new_tokens": 2})
    assert s_new.replica_id == reps[0].id
    for s in streams + [s_new]:
        assert list(s) and s.error is None
    assert target.drained
    assert f"{target.id}: DRAINING->STOPPED" in rec.reconcile()
    assert rec.states() == {reps[0].id: RUNNING}
    assert len(router.replicas()) == 1
    assert STOPPED not in rec.states().values()
    assert all(r.leak_free() for r in reps)


def _hedged(models, prompt, max_new, names):
    expected = _generate(models, [prompt], max_new)[0]
    reps = [_replica(models, n) for n in names]
    tel = _tel()
    router = FleetRouter(reps, cfg=_fcfg(affinity=False, hedge=True,
                                         hedge_min=0.05),
                         rng_seed=2, telemetry=tel)
    s = router.remote({"tokens": prompt, "max_new_tokens": max_new})
    primary = router._replicas[s.replica_id]
    hedge_rep = next(r for r in reps if r.id != primary.id)
    s.submitted_ts -= 10.0            # the primary is "slow": force it
    router._maybe_hedge()
    return expected, reps, tel, router, s, primary, hedge_rep


def _drain(router, s):
    deadline = time.monotonic() + 5
    while not s.done and time.monotonic() < deadline:
        router.poll()


def test_hedge_race_hedge_wins_exactly_once(models):
    expected, reps, tel, router, s, primary, hedge_rep = _hedged(
        models, _prompt(8, 40), 4, ("p0", "p1"))
    assert (s.hedge_replica_id, s.hedges) == (hedge_rep.id, 1)
    for ev in hedge_rep.step():          # the hedge's first token wins
        router._dispatch(hedge_rep, ev)
    assert s.hedge_rid is None and s.replica_id == hedge_rep.id
    assert tel.hedges == {"issued": 1, "won": 1}
    assert 1 <= len(s.generated) <= 2
    before = list(s.generated)
    for ev in primary.step():            # the loser can deliver nothing
        router._dispatch(primary, ev)
    assert s.generated == before
    _drain(router, s)
    assert list(s.generated) == expected and s.error is None
    while primary.has_work() or hedge_rep.has_work():
        router.poll()
    assert all(r.leak_free() for r in reps)


def test_hedge_race_primary_recovers_after_fire(models):
    expected, reps, tel, router, s, primary, hedge_rep = _hedged(
        models, _prompt(19, 41), 4, ("q0", "q1"))
    assert s.hedge_rid is not None
    hedge_key = (s.hedge_replica_id, s.hedge_rid)
    for ev in primary.step():            # the primary recovers and wins
        router._dispatch(primary, ev)
    assert s.hedge_rid is None and s.replica_id == primary.id
    assert tel.hedges == {"issued": 1, "wasted": 1}
    assert hedge_key not in router._by_rid
    hedge_rep.step()                     # processes the cancel
    assert hedge_rep.leak_free() and not hedge_rep.has_work()
    _drain(router, s)
    assert list(s.generated) == expected and s.error is None
    assert s.retries == 0
    assert all(r.leak_free() for r in reps)


def test_hedged_stream_survives_primary_death(models):
    expected, reps, tel, router, s, primary, hedge_rep = _hedged(
        models, _prompt(8, 42), 3, ("k0", "k1"))
    assert s.hedge_rid is not None
    primary.alive = False                # gray turned black
    _drain(router, s)
    assert list(s.generated) == expected and s.error is None
    assert s.retries == 0                # promoted, not re-routed
    assert tel.hedges == {"issued": 1, "won": 1}
    assert primary.reaped
    assert all(r.leak_free() for r in reps)


def test_gray_failure_acceptance(models):
    """One replica runs a sustained ``serve.tick[<id>]`` slowdown (slow,
    never dead).  With health-scored routing and hedging on, every
    stream completes equal to the unfailed run, the fleet p99 TTFT
    beats the mitigation-off arm by >= 2x, the slow replica is demoted
    and recycled (DEGRADED -> drain-restart) with zero dropped streams,
    every hedge resolves exactly once, and nothing leaks."""
    prompts = [_prompt(8 + i, 50 + i) for i in range(9)]
    expected = _generate(models, prompts, 4)
    delay, gap = 0.4, 0.05

    def run_arm(mitigate):
        fcfg = _fcfg(retries=2, dwell=0.3, backoff=0.0,
                     slow_factor=3.0 if mitigate else 0.0,
                     hedge=mitigate, hedge_factor=2.0, hedge_min=0.06)
        tag = "m" if mitigate else "u"
        reps = [_replica(models, f"{tag}{i}") for i in range(3)]
        slow_id = reps[0].id
        router = FleetRouter(reps, cfg=fcfg, affinity=False, rng_seed=1,
                             concurrent_steps=True, telemetry=_tel())
        rec = Reconciler(router, lambda rid: _replica(models, rid),
                         target=3, cfg=fcfg)
        chaos.install_faults(
            f"serve.tick[{slow_id}]@1..100000:delay={delay}")
        streams, i = [], 0
        t0 = time.monotonic()
        try:
            while i < len(prompts) or any(not s.done for s in streams):
                now = time.monotonic() - t0
                while i < len(prompts) and i * gap <= now:
                    streams.append(router.remote(
                        {"tokens": prompts[i], "max_new_tokens": 4}))
                    i += 1
                progressed = router.poll()
                if mitigate:
                    rec.reconcile()
                if not progressed:
                    time.sleep(0.002)
                assert time.monotonic() - t0 < 60, "gray arm hung"
            if mitigate:
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    router.poll()
                    rec.reconcile()
                    if (slow_id not in rec.states() and sorted(
                            rec.states().values()).count(RUNNING) == 3):
                        break
                    time.sleep(0.005)
        finally:
            chaos.clear_faults()
        return streams, router, rec, reps, slow_id

    streams_on, router_on, rec_on, reps_on, slow_on = run_arm(True)
    streams_off, router_off, _, reps_off, _ = run_arm(False)
    for streams in (streams_on, streams_off):
        assert all(s.done and s.error is None for s in streams)
        assert [list(s.generated) for s in streams] == expected

    def p99(xs):
        return sorted(xs)[min(len(xs) - 1, int(0.99 * len(xs)))]

    p99_on = p99(router_on.recent_ttfts())
    p99_off = p99(router_off.recent_ttfts())
    assert p99_off >= 2 * p99_on, (p99_on, p99_off)
    tel = router_on.telemetry.summary()
    assert tel["replica_demotions"] >= 1
    assert rec_on.demotion_restarts == 1
    assert slow_on not in rec_on.states()
    assert sorted(rec_on.states().values()).count(RUNNING) == 3
    hedges = tel["hedges"]
    assert hedges.get("issued", 0) == \
        hedges.get("won", 0) + hedges.get("wasted", 0)
    for router, reps in ((router_on, reps_on), (router_off, reps_off)):
        assert router.quiesce()
        assert router.leak_free()
        assert all(r.leak_free() for r in reps)
        router.close()


def test_latency_score_decays_when_idle(models):
    rep = _replica(models, "idle-decay")
    rep._latency_ewma = 1.0
    rep._last_tick_done_ts = time.monotonic()
    assert rep.latency_score() == pytest.approx(1.0, rel=0.05)
    rep._last_tick_done_ts = time.monotonic() - 60.0
    assert rep.latency_score() < 0.01
    rep._last_tick_done_ts = time.monotonic() - 1.0
    assert rep.latency_score() > 0.5
    rep._tick_t0 = time.monotonic() - 0.4   # step in flight: age floor
    assert rep.latency_score() >= 0.4
    rep._tick_t0 = None
    assert rep.leak_free()


def test_fleet_stream_logprobs_parity(models):
    prompt = _prompt(9, 42)
    toks, lps = _engine(models).generate([prompt], max_new_tokens=4,
                                         return_logprobs=True)
    router = FleetRouter([_replica(models, "lp0")], cfg=_fcfg(),
                         telemetry=_tel())
    out = list(router.remote({"tokens": prompt, "max_new_tokens": 4,
                              "logprobs": True}))
    assert [o["token"] for o in out] == toks[0]
    assert [o["logprob"] for o in out] == pytest.approx(lps[0])


def test_adapter_requests_are_refused_typed(models):
    """Engines built without an adapter bank: ``adapter_digest()`` is
    empty, and a request naming a ``model_id`` is rejected by every
    replica (retry cause ``adapter``) and fails typed."""
    reps = [_replica(models, f"a{i}") for i in range(2)]
    assert all(r.adapter_digest() == frozenset() for r in reps)
    tel = _tel()
    router = FleetRouter(reps, cfg=_fcfg(), rng_seed=0, telemetry=tel)
    s = router.remote({"tokens": _prompt(8), "model_id": "tenant"})
    with pytest.raises(ReplicaUnavailableError, match="no healthy"):
        s.result()
    assert tel.retries == {"adapter": 2}
    assert router.stats()["adapter_store"] is None


# ------------------------------------------------- concurrent poll mode
def test_concurrent_poll_gives_the_sequential_streams(models):
    """``concurrent_steps=True`` steps each replica on a worker thread;
    the greedy streams are the sequential poll's, every replica ends
    leak-free, and ``close`` releases the pool."""
    prompts = [_prompt(10 + 3 * i, 60 + i) for i in range(8)]
    outs = {}
    for mode in (False, True):
        reps = [_replica(models, f"c{i}") for i in range(3)]
        router = FleetRouter(reps, cfg=_fcfg(slow_factor=0.0, hedge=False),
                             rng_seed=0, concurrent_steps=mode,
                             telemetry=_tel())
        streams = [router.remote({"tokens": p, "max_new_tokens": 5})
                   for p in prompts]
        outs[mode] = [s.result() for s in streams]
        assert router.quiesce() and router.leak_free()
        assert all(s.error is None for s in streams)
        router.close()
        router.close()                      # idempotent
    assert outs[True] == outs[False] == _generate(models, prompts, 5)


def test_concurrent_poll_narrows_only_its_step_threads(models):
    """The step pool runs each step thread's intra-op work on its share
    of torch's threads; the poll thread, and threads started after the
    pool, keep the process's width."""
    default = torch.get_num_threads()
    reps = [_replica(models, f"t{i}") for i in range(3)]
    router = FleetRouter(reps, cfg=_fcfg(slow_factor=0.0, hedge=False),
                         rng_seed=0, concurrent_steps=True,
                         telemetry=_tel())
    try:
        streams = [router.remote({"tokens": _prompt(12, 70 + i),
                                  "max_new_tokens": 3}) for i in range(3)]
        assert all(s.result() for s in streams)
        pool = router._step_pool
        share = max(1, default // pool._max_workers)
        in_pool = [pool.submit(torch.get_num_threads)
                   for _ in range(pool._max_workers)]
        assert [f.result() for f in in_pool] == [share] * len(in_pool)
        assert torch.get_num_threads() == default
        seen = []
        later = threading.Thread(
            target=lambda: seen.append(torch.get_num_threads()))
        later.start()
        later.join()
        assert seen == [default]
    finally:
        router.close()
    assert torch.get_num_threads() == default


def test_step_pool_initializer_never_narrows_other_threads(models):
    """The race the step pool's initializer must not open: at every line
    of it, in every step thread, a new thread makes its first torch call
    while the worker is still inside its initializer, and that thread
    sees the process's width; the step threads still end at their
    share."""
    from ray_tpu_torch.fleet import router as router_mod
    default = torch.get_num_threads()
    code = router_mod._split_intra_op.__code__
    seen, probing = [], threading.local()

    def probe():
        probing.on = True
        try:
            t = threading.Thread(
                target=lambda: seen.append(torch.get_num_threads()))
            t.start()
            t.join()
        finally:
            probing.on = False

    def local_trace(frame, event, arg):
        if event in ("line", "return") and not getattr(probing, "on", False):
            probe()
        return local_trace

    def tracer(frame, event, arg):
        return local_trace if frame.f_code is code else None

    reps = [_replica(models, f"r{i}") for i in range(3)]
    router = FleetRouter(reps, cfg=_fcfg(slow_factor=0.0, hedge=False),
                         rng_seed=0, concurrent_steps=True,
                         telemetry=_tel())
    threading.settrace(tracer)
    try:
        streams = [router.remote({"tokens": _prompt(12, 90 + i),
                                  "max_new_tokens": 3}) for i in range(3)]
        assert all(s.result() for s in streams)
        pool = router._step_pool
        share = max(1, default // pool._max_workers)
        in_pool = [pool.submit(torch.get_num_threads)
                   for _ in range(pool._max_workers)]
        assert [f.result() for f in in_pool] == [share] * len(in_pool)
    finally:
        threading.settrace(None)
        router.close()
    assert len(seen) >= 2
    assert seen == [default] * len(seen)
    assert torch.get_num_threads() == default


def test_step_pool_without_openmp_entry_point_raises(models, monkeypatch):
    """No ``omp_set_num_threads`` in the process: the lookup raises, and a concurrent poll surfaces that to its caller
    rather than stepping at the full width on every thread."""
    import ctypes
    from ray_tpu_torch.fleet import router as router_mod

    class NoOpenMP:
        def __init__(self, name):
            pass

    monkeypatch.setattr(ctypes, "CDLL", NoOpenMP)
    with pytest.raises(RuntimeError, match="omp_set_num_threads"):
        router_mod._omp_set_num_threads()
    reps = [_replica(models, f"o{i}") for i in range(2)]
    router = FleetRouter(reps, cfg=_fcfg(slow_factor=0.0, hedge=False),
                         rng_seed=0, concurrent_steps=True,
                         telemetry=_tel())
    try:
        with pytest.raises(RuntimeError, match="omp_set_num_threads"):
            router.remote({"tokens": _prompt(12, 95),
                           "max_new_tokens": 3}).result()
        assert router._step_pool is None
    finally:
        router.close()


def test_launch_counter_exact_under_threads(monkeypatch):
    """Kernel launches from several threads at once, the first launches
    racing to bind the entry point: the count is exact and every call
    ran typed.  The stub library is the C library's ``abs`` (returns 0
    for 0, so every launch is accepted)."""
    import ctypes
    libc = ctypes.CDLL(None)
    monkeypatch.setattr(_build, "load", lambda: libc)
    # the stub registers into a copy of the registry, dropped afterwards
    monkeypatch.setattr(_build, "_REGISTRY", dict(_build._REGISTRY))
    kern = _build.Kernel("abs", ctypes.c_int)
    n_threads, per = 16, 2000            # more threads than cores
    start = threading.Barrier(n_threads)

    def launch():
        start.wait()
        for _ in range(per):
            kern(0)

    threads = [threading.Thread(target=launch) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as can be
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kern.launches == n_threads * per
    assert kern._fn.argtypes == [ctypes.c_int]
    assert kern._fn.restype is ctypes.c_int


# ------------------------------------------- disaggregated pools (port)
def test_disagg_acceptance(models):
    """Mixed traffic through 1 prefill + 2 decode replicas equals the
    co-located run; every stream handed off exactly once; the repeat
    of an exact-page prompt is a warm, metadata-only handoff; the pools
    split the work; nothing leaks, no handoff left in the store."""
    shared = _prompt(32, 11)
    exact = _prompt(48, 31)
    prompts = ([exact] + [shared + _prompt(5 + i, 20 + i) for i in range(5)]
               + [_prompt(9, 32)] + [exact])
    expected = _generate(models, prompts, 4)
    pre = [_replica(models, "p0")]
    dec = [_replica(models, f"d{i}") for i in range(2)]
    tel = _tel()
    router = DisaggRouter(pre, dec, cfg=_fcfg(), rng_seed=0, telemetry=tel)
    streams = [router.remote({"tokens": p, "max_new_tokens": 4})
               for p in prompts[:-1]]
    outs = [list(s) for s in streams]
    streams.append(router.remote({"tokens": prompts[-1],
                                  "max_new_tokens": 4}))
    outs.append(list(streams[-1]))
    assert outs == expected
    assert all(s.done and s.error is None and s.retries == 0
               for s in streams)
    assert router.quiesce()
    assert router.leak_free() and router.store.in_flight == 0
    summ = tel.summary()
    assert summ["handoffs"] == len(prompts)
    assert summ["handoffs_skipped"] >= 1
    assert summ["handoff_bytes_total"] > 0
    assert summ["ttft_s_by_mode"]["disagg"]["count"] == len(prompts)
    assert set(summ["pool_queue_depth"]) == {"prefill", "decode"}
    assert sum(r.engine.stats()["exports"]
               for r in router.replicas("prefill")) == len(prompts)
    assert sum(r.engine.stats()["imports"]
               for r in router.replicas("decode")) == len(prompts)
    assert all(r.engine.call_counts["prefill"] == 0
               and r.engine.call_counts["prefill_cached"] == 0
               for r in router.replicas("decode"))


def test_disagg_stream_logprobs_and_geometry(models):
    prompt = _prompt(19, 42)
    toks, lps = _engine(models).generate([prompt], max_new_tokens=4,
                                         return_logprobs=True)
    router = DisaggRouter([_replica(models, "lp-p")],
                          [_replica(models, "lp-d")], cfg=_fcfg(),
                          telemetry=_tel())
    out = list(router.remote({"tokens": prompt, "max_new_tokens": 4,
                              "logprobs": True}))
    assert [o["token"] for o in out] == toks[0]
    assert [o["logprob"] for o in out] == pytest.approx(lps[0])
    assert router.quiesce() and router.leak_free()
    with pytest.raises(ValueError, match="geometry"):
        DisaggRouter([_replica(models, "g-p")],
                     [_replica(models, "g-d", page_size=8)],
                     cfg=_fcfg(), telemetry=_tel())
    with pytest.raises(ValueError, match="BOTH pools"):
        DisaggRouter([_replica(models, "g2-p")], [], cfg=_fcfg(),
                     telemetry=_tel())


@pytest.mark.parametrize("spec", ["serve.handoff@1", "serve.handoff@4",
                                  "serve.handoff@1,serve.handoff@4"])
def test_handoff_chaos_all_legs_reprefill_exactly(models, spec):
    prompts = [_prompt(20 + 3 * i, i) for i in range(5)]
    expected = _generate(models, prompts, 4)
    tel = _tel()
    router = DisaggRouter([_replica(models, "hp")],
                          [_replica(models, "hd0"),
                           _replica(models, "hd1")],
                          cfg=_fcfg(), rng_seed=0, telemetry=tel)
    plan = chaos.install_faults(spec)
    streams = [router.remote({"tokens": p, "max_new_tokens": 4})
               for p in prompts]
    outs = [list(s) for s in streams]
    chaos.clear_faults()
    assert len(plan.fired) == spec.count("serve.handoff")
    assert outs == expected
    assert all(s.done and s.error is None for s in streams)
    assert any(s.retries > 0 for s in streams)
    assert tel.retries.get("handoff", 0) >= 1
    assert router.quiesce() and router.leak_free()
    assert router.store.in_flight == 0


def test_handoff_slowdown_delay_supported(models):
    prompt = _prompt(20, 3)
    want = _generate(models, [prompt], 3)[0]
    tel = _tel()
    router = DisaggRouter([_replica(models, "sd-p")],
                          [_replica(models, "sd-d")], cfg=_fcfg(),
                          telemetry=tel)
    plan = chaos.install_faults("serve.handoff@1..2:delay=0.05")
    out = list(router.remote({"tokens": prompt, "max_new_tokens": 3}))
    chaos.clear_faults()
    assert out == want
    assert plan.slowdown_s("serve.handoff") == pytest.approx(0.1)
    assert tel.summary()["handoff_s_max"] >= 0.1
    assert router.quiesce() and router.leak_free()


def test_prefill_death_after_export_acceptance(models):
    """The prefill replica dies on its tick after its first tick's
    requests were handed off: those streams decode on untouched, the
    streams still bound to the corpse re-prefill on the other prefill
    replica, held exports are reaped with the corpse, and the prefill
    pool's reconciler restores it."""
    prompts1 = [_prompt(18 + 4 * i, 40 + i) for i in range(4)]
    expected1 = _generate(models, prompts1, 4)
    fcfg = _fcfg(retries=2)
    router = DisaggRouter([_replica(models, "pk-p0"),
                           _replica(models, "pk-p1")],
                          [_replica(models, "pk-d0"),
                           _replica(models, "pk-d1")],
                          cfg=fcfg, rng_seed=0, telemetry=_tel())
    rec = Reconciler(router.pool_view("prefill"),
                     lambda rid: _replica(models, f"pk-f{rid}"),
                     target=2, cfg=fcfg)
    wave1 = [router.remote({"tokens": p, "max_new_tokens": 4})
             for p in prompts1]
    router.poll()
    assert all(s.phase == "decode" and not s.done for s in wave1)
    victim = router.replicas("prefill")[0]
    assert victim.id == "pk-p0"
    mine = [p for p in prompts1
            if all(h in victim.prefix_digest()
                   for h in PrefixIndex.chain_hashes(p, 16))]
    assert mine
    prompts2 = [list(p) + _prompt(3, 90 + j) for j, p in enumerate(mine)]
    expected2 = _generate(models, prompts2, 4)
    assert victim.engine.ticks >= 1
    plan = chaos.install_faults("serve.tick[pk-p0]@1")
    wave2 = [router.remote({"tokens": p, "max_new_tokens": 4})
             for p in prompts2]
    assert all(s.replica_id == "pk-p0" for s in wave2)
    streams = wave1 + wave2
    outs = [list(s) for s in streams]
    chaos.clear_faults()
    assert plan.fired and plan.fired[0][0] == "serve.tick[pk-p0]"
    assert outs == expected1 + expected2
    assert all(s.done and s.error is None for s in streams)
    assert all(s.retries == 0 for s in wave1)
    assert any(s.retries > 0 for s in wave2)
    (corpse,) = [r for r in router.replicas() if not r.alive]
    assert corpse.id == "pk-p0" and corpse.reaped
    assert corpse.engine.stats()["held"] == 0
    assert corpse.leak_free()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        rec.reconcile()
        if sorted(rec.states().values()).count(RUNNING) == 2:
            break
        time.sleep(0.01)
    assert sorted(rec.states().values()).count(RUNNING) == 2
    assert len(router.replicas("prefill")) == 2
    assert router.quiesce() and router.leak_free()


def test_decode_death_after_import_acceptance(models):
    prompts = [_prompt(18 + 4 * i, 50 + i) for i in range(5)]
    expected = _generate(models, prompts, 5)
    tel = _tel()
    router = DisaggRouter([_replica(models, "dd-p0")],
                          [_replica(models, "dd-d0"),
                           _replica(models, "dd-d1")],
                          cfg=_fcfg(retries=2), rng_seed=0, telemetry=tel)
    plan = chaos.install_faults("serve.tick[dd-d0]@2")
    streams = [router.remote({"tokens": p, "max_new_tokens": 5})
               for p in prompts]
    outs = [list(s) for s in streams]
    chaos.clear_faults()
    assert plan.fired == [("serve.tick[dd-d0]", 2)]
    assert outs == expected
    assert all(s.done and s.error is None for s in streams)
    assert any(s.retries > 0 for s in streams)
    (corpse,) = [r for r in router.replicas() if not r.alive]
    assert corpse.id == "dd-d0" and corpse.reaped and corpse.leak_free()
    assert tel.summary()["handoffs"] > len(prompts)
    assert router.quiesce() and router.leak_free()


def test_disagg_failover_budget_and_empty_pools_typed(models):
    router = DisaggRouter([_replica(models, "fb-p")],
                          [_replica(models, "fb-d")],
                          cfg=_fcfg(retries=1), rng_seed=0,
                          telemetry=_tel())
    s = router.remote({"tokens": _prompt(8), "max_new_tokens": 4})
    chaos.install_faults("serve.replica@1,serve.replica@2")
    with pytest.raises(ReplicaUnavailableError):
        list(s)
    chaos.clear_faults()
    assert s.done
    assert all(r.leak_free() for r in router.replicas() if not r.alive)


def test_partial_residency_strips_resident_pages(models):
    shared = _prompt(32, 13)
    p1 = shared + _prompt(8, 70)
    p2 = shared + _prompt(9, 71)
    expected = _generate(models, [p1, p2], 4)
    tel = _tel()
    router = DisaggRouter([_replica(models, "ps-p")],
                          [_replica(models, "ps-d")], cfg=_fcfg(),
                          rng_seed=0, telemetry=tel)
    out1 = list(router.remote({"tokens": p1, "max_new_tokens": 4}))
    out2 = list(router.remote({"tokens": p2, "max_new_tokens": 4}))
    assert [out1, out2] == expected
    summ = tel.summary()
    assert summ["handoffs"] == 2 and summ["handoffs_skipped"] == 0
    assert summ["handoff_pages_total"] == 3 + 1
    assert summ["handoff_bytes_total"] % 4 == 0
    assert router.quiesce() and router.leak_free()
    assert router.store.in_flight == 0


def test_disagg_deadline_is_one_budget_across_legs(models):
    prompt = _prompt(20, 6)
    pre = _replica(models, "bd-p", ttft_deadline=30.0)
    dec = [_replica(models, "bd-d0"), _replica(models, "bd-d1")]
    router = DisaggRouter([pre], dec, cfg=_fcfg(), rng_seed=0,
                          telemetry=_tel())
    s = router.remote({"tokens": prompt, "max_new_tokens": 6,
                       "deadline_s": 100.0})
    s.submitted_ts -= 60.0                   # 60 s already spent
    router.poll()                            # prefill, handoff, install
    assert s.phase == "decode"
    drep = next(r for r in dec if r.id == s.replica_id)
    assert drep.engine._requests[s.rid].deadline_s == pytest.approx(
        40.0, abs=2.0)
    drep.alive = False                       # the decode replica dies
    router.poll()
    assert s.phase == "prefill" and s.retries == 1
    req2 = pre.engine._requests[s.rid]
    assert req2.ttft_deadline_s is None
    assert req2.deadline_s == pytest.approx(40.0, abs=2.0)
    assert list(s) == _generate(models, [prompt], 6)[0]
    assert router.quiesce() and router.leak_free()


def test_handoff_store_accounting_and_no_object_store():
    store = HandoffStore(use_object_store=False)
    h = KVHandoff(context=[1, 2, 3], page_size=16, kv_dtype="model",
                  dtype="float32", chain_hashes=[], next_token=7,
                  next_logprob=-0.5,
                  k=np.zeros((2, 1, 16, 4, 8), np.float32),
                  v=np.zeros((2, 1, 16, 4, 8), np.float32))
    handle = store.put(h)
    assert store.in_flight == 1 and store.bytes_put == h.nbytes
    assert store.get(handle) is h
    store.drop(handle)
    store.drop(handle)
    assert store.in_flight == 0 and store.puts == 1
    # outside a session None resolves to the in-process slot
    assert HandoffStore().in_flight == 0 and not HandoffStore()._use_ray


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_handoff_store_object_store_leg(models, kv_dtype, monkeypatch):
    """Under a ``ray_tpu_torch`` session ``HandoffStore()`` carries a
    real export through the runtime's object store: what comes back is
    the in-process leg's payload bit for bit (bf16 tensors included),
    the decode engine continues it as the co-located run does, and no
    handle is left in flight.  ``RAY_TPU_FLEET_HANDOFF_INLINE=1`` keeps
    it inline under the session."""
    import ray_tpu_torch
    from ray_tpu_torch.fleet import fleet_config
    _jc, _jp, tcfg, tparams = models
    cfg16 = tgpt.GPTConfig.tiny(dtype=torch.bfloat16)
    params16 = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(torch.bfloat16))
                for k, v in tparams.items()}

    def engine():
        return InferenceEngine(cfg16, params16, device="cpu", **GEOMETRY,
                               kv_dtype=kv_dtype)

    prompt = _prompt(40, 5)
    want = engine().generate([prompt], max_new_tokens=6)[0]
    pre = engine()
    rid = pre.submit(prompt, max_new_tokens=1, hold_pages=True)
    while pre.has_work():
        pre.step()
    payload = pre.export_request(rid)
    inline = HandoffStore(use_object_store=False)
    ray_tpu_torch.init(num_cpus=1)
    try:
        store = HandoffStore()
        assert store._use_ray
        h, hi = store.put(payload), inline.put(payload)
        got, ref = store.get(h), inline.get(hi)
        for name in ("context", "page_size", "kv_dtype", "dtype",
                     "chain_hashes", "next_token", "next_logprob",
                     "present", "trace"):
            assert getattr(got, name) == getattr(ref, name), name
        for name in ("k", "v", "k_scale", "v_scale"):
            x, y = getattr(ref, name), getattr(got, name)
            if x is None:
                assert y is None
            elif isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype
                assert torch.equal(x.view(torch.uint8),
                                   y.view(torch.uint8))
            else:
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        dec = engine()
        r2 = dec.import_submit(got, max_new_tokens=5)
        out = [payload.next_token]
        while dec.has_work():
            out.extend(int(t) for r, t, _d in dec.step() if r == r2)
        assert out == [int(t) for t in want]
        store.drop(h)
        inline.drop(hi)
        assert store.in_flight == inline.in_flight == 0
        assert store.bytes_put == inline.bytes_put == payload.nbytes
        monkeypatch.setenv("RAY_TPU_FLEET_HANDOFF_INLINE", "1")
        fleet_config(refresh=True)
        assert not HandoffStore()._use_ray
    finally:
        monkeypatch.delenv("RAY_TPU_FLEET_HANDOFF_INLINE", raising=False)
        fleet_config(refresh=True)
        ray_tpu_torch.shutdown()


# --------------------------------------------- tiers under the router
def _pressure(engine, rounds=3, seed=100):
    for i in range(rounds):
        engine.generate([_prompt(60, seed + i)], max_new_tokens=4)


def test_router_tier_aware_pick(models):
    shared = _prompt(40, 17)
    hashes = PrefixIndex.chain_hashes(shared, 16)
    kw = dict(num_pages=9, host_pages=4, store=True, spill_dtype="model")
    resident = EngineReplica("hot", _engine(models, **kw))
    spilled = EngineReplica("warm", _engine(models, **kw))
    cold = EngineReplica("cold", _engine(models, **kw))
    for rep in (resident, spilled):
        rep.engine.generate([shared + [1]], max_new_tokens=2)
    _pressure(spilled.engine, rounds=2)
    assert resident.tier_hits(hashes)[0] == 2
    n_hbm, n_dram = spilled.tier_hits(hashes)
    assert n_hbm == 0 and n_dram >= 1
    assert cold.tier_hits(hashes) == (0, 0)
    router = FleetRouter([cold, spilled, resident],
                         cfg=FleetConfig(affinity=True, affinity_cap=8),
                         rng_seed=0)
    assert router._affinity_pick(shared + [2], router.healthy()) \
        is resident                      # HBM beats DRAM beats cold
    assert router._affinity_pick(shared + [2], [cold, spilled]) is spilled
    assert router._affinity_pick(_prompt(40, 23), router.healthy()) is None


def test_tiered_fleet_acceptance(models):
    """Two replicas and a shared system prompt: replica A prefills it,
    pressure demotes it through the host pool into the fleet-shared
    store, and replica B's first request and a restarted A both admit
    it as a store hit (suffix-only prefill); every stream equals a cold
    run's (int8 cache); the tiers audit leak-free."""
    system = _prompt(40, 31)
    suffixes = [[5, 6, 7], [8, 9], [10, 11, 12]]
    cold = _engine(models, num_pages=9, kv_dtype="int8")
    expected = [[int(t) for t in cold.generate([system + s],
                                               max_new_tokens=6)[0]]
                for s in suffixes]
    store = KVPageStore(use_object_store=False)

    def replica(rid):
        return EngineReplica(rid, _engine(
            models, num_pages=9, kv_dtype="int8", host_pages=2,
            store=store))

    rep_a, rep_b = replica("ta"), replica("tb")
    router = FleetRouter([rep_a, rep_b], cfg=FleetConfig(
        affinity=True, affinity_cap=8, retries=2), rng_seed=0)

    def run(prompt, target):
        others = [r for r in router.replicas() if r.id != target.id]
        for r in others:
            r.draining = True
        stream = router.remote({"tokens": prompt, "max_new_tokens": 6})
        for r in others:
            r.draining = False
        out = list(stream)
        assert stream.error is None and stream.replica_id == target.id
        return out

    assert run(system + suffixes[0], rep_a) == expected[0]
    assert run(system + suffixes[1], rep_a) == expected[1]
    assert rep_a.engine.stats()["tiers"]["hits"]["hbm"] == 2
    _pressure(rep_a.engine)
    a_tiers = rep_a.engine.stats()["tiers"]
    assert a_tiers["host"]["spills"] > 0
    assert a_tiers["host"]["demotions"] > 0
    ver = rep_a.engine.param_version
    assert all((h, ver) in store
               for h in PrefixIndex.chain_hashes(system, 16))
    assert run(system + suffixes[2], rep_b) == expected[2]
    b_stats = rep_b.engine.stats()
    assert b_stats["tiers"]["hits"]["store"] == 2
    assert b_stats["tiers"]["hits"]["hbm"] == 0
    assert b_stats["prefix"]["hit_tokens"] == 32
    rep_a.alive = False
    rep_a.reap()
    router.remove_replica("ta")
    rep_a2 = replica("ta2")
    router.add_replica(rep_a2)
    assert run(system + suffixes[0], rep_a2) == expected[0]
    a2_stats = rep_a2.engine.stats()
    assert a2_stats["tiers"]["hits"]["store"] == 2
    assert a2_stats["prefix"]["hit_tokens"] == 32
    assert router.leak_free()
    assert store.in_flight == 0
    assert router.stats()["kv_store"]["in_flight"] == 0


# ------------------------------------------------------- fleet traces
def _assert_gap_free(tid):
    spans = trace.spans_for(tid)
    assert spans, f"no spans recorded for trace {tid}"
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if s.get("parent_id") is None]
    assert [r["name"] for r in roots] == ["request"]
    dangling = [(s["name"], s["parent_id"]) for s in spans
                if s.get("parent_id") is not None
                and s["parent_id"] not in ids]
    assert not dangling, f"spans with missing parents: {dangling}"
    return spans


_TRACE_CFG = dict(slow_factor=0.0, hedge=False, backoff=0.0)


def test_disagg_handoff_one_trace_gap_free(models):
    router = DisaggRouter([_replica(models, "tp0")],
                          [_replica(models, "td0")],
                          cfg=_fcfg(**_TRACE_CFG), rng_seed=0,
                          telemetry=_tel())
    s = router.remote({"tokens": _prompt(36, 1), "max_new_tokens": 4})
    assert len(s.result()) == 4 and s.error is None
    spans = _assert_gap_free(s.trace.trace_id)
    names = {x["name"] for x in spans}
    assert {"request", "route", "queue", "prefix_walk", "prefill",
            "handoff.export", "handoff.import", "handoff.install",
            "first_token", "request_end"} <= names
    replicas = {(x.get("attributes") or {}).get("replica")
                for x in spans} - {None}
    assert {"tp0", "td0"} <= replicas
    ticks = [x for x in trace.recorder().spans()
             if x["name"] == "decode_tick"]
    assert any(s.trace.trace_id in t["attributes"]["trace_ids"]
               for t in ticks)
    assert router.quiesce() and router.leak_free()


def test_death_failover_single_trace(models):
    prompts = [_prompt(20 + 3 * i, 30 + i) for i in range(4)]
    expected = _generate(models, prompts, 4)
    tel = _tel()
    reps = [_replica(models, f"df{i}") for i in range(3)]
    router = FleetRouter(reps, cfg=_fcfg(**_TRACE_CFG), rng_seed=0,
                         telemetry=tel)
    chaos.install_faults("serve.replica@2")
    streams = [router.remote({"tokens": p, "max_new_tokens": 4})
               for p in prompts]
    outs = [list(s) for s in streams]
    chaos.clear_faults()
    assert outs == expected
    failed_over = [s for s in streams if s.retries > 0]
    assert failed_over
    assert tel.summary()["failovers"].get("dead", 0) >= 1
    for s in failed_over:
        spans = _assert_gap_free(s.trace.trace_id)
        routes = [x for x in spans if x["name"] == "route"]
        assert len(routes) >= 2
        evs = [x for x in spans if x["name"] == "failover"]
        assert evs and all(x["attributes"]["cause"] == "dead" for x in evs)
        assert (routes[-1]["attributes"]["picked"]
                != routes[0]["attributes"]["picked"])
    while any(r.alive and r.engine.has_work() for r in reps):
        router.poll()
    assert router.leak_free()


def test_hedge_won_single_trace(models):
    prompt = _prompt(8, 40)
    expected = _generate(models, [prompt], 4)[0]
    reps = [_replica(models, "hw0"), _replica(models, "hw1")]
    tel = _tel()
    router = FleetRouter(reps, cfg=_fcfg(**{**_TRACE_CFG, "hedge": True},
                                         affinity=False, hedge_min=0.05),
                         rng_seed=2, telemetry=tel)
    s = router.remote({"tokens": prompt, "max_new_tokens": 4})
    primary = router._replicas[s.replica_id]
    hedge_rep = next(r for r in reps if r.id != primary.id)
    s.submitted_ts -= 10.0
    router._maybe_hedge()
    assert s.hedge_replica_id == hedge_rep.id
    for ev in hedge_rep.step():
        router._dispatch(hedge_rep, ev)
    _drain(router, s)
    assert list(s.generated) == expected and s.error is None
    assert tel.summary()["hedge_winners"] == {"hedge": 1}
    spans = _assert_gap_free(s.trace.trace_id)
    issued = [x for x in spans if x["name"] == "hedge_issued"]
    resolved = [x for x in spans if x["name"] == "hedge_resolved"]
    assert len(issued) == 1 and len(resolved) == 1
    assert issued[0]["attributes"]["hedge_replica"] == hedge_rep.id
    assert resolved[0]["attributes"]["winner"] == "hedge"
    while any(r.has_work() for r in reps):
        router.poll()
    assert all(r.leak_free() for r in reps)


def test_hedge_winner_label_validated():
    tel = _tel()
    tel.record_hedge_won("primary")
    tel.record_hedge_won("hedge")
    tel.record_hedge_won("hedge")
    assert tel.summary()["hedge_winners"] == {"primary": 1, "hedge": 2}
    with pytest.raises(ValueError):
        tel.record_hedge_won("bystander")


def test_injected_handoff_fault_dumps_perfetto(models, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", str(tmp_path))
    trace.trace_config(refresh=True)
    trace.reset()
    prompts = [_prompt(20 + 3 * i, 50 + i) for i in range(2)]
    router = DisaggRouter([_replica(models, "fp0")],
                          [_replica(models, "fd0"),
                           _replica(models, "fd1")],
                          cfg=_fcfg(**_TRACE_CFG), rng_seed=0,
                          telemetry=_tel())
    # hits 1 and 2 are the first stream's legs; hit 3 faults the second
    # stream's export, when the ring holds a whole cross-replica story
    plan = chaos.install_faults("serve.handoff@3")
    streams = [router.remote({"tokens": p, "max_new_tokens": 4})
               for p in prompts]
    outs = [list(s) for s in streams]
    chaos.clear_faults()
    assert len(plan.fired) == 1
    assert all(len(o) == 4 for o in outs)
    faulted = [s for s in streams if s.retries > 0]
    assert len(faulted) == 1
    dumps = sorted(tmp_path.glob("flight-injected_fault-*.json"))
    assert len(dumps) == 1
    doc = json.loads(dumps[0].read_text())
    assert doc["metadata"]["trigger"] == "injected_fault"
    events = doc["traceEvents"]
    assert events == sorted(events, key=lambda e: e["ts"])
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    assert by_name["anomaly/injected_fault"][0]["args"]["site"] \
        == "serve.handoff"
    pids = {e["pid"] for e in events}
    assert "fp0" in pids and ({"fd0", "fd1"} & pids)
    tid = faulted[0].trace.trace_id
    mine = [e for e in events if e["args"].get("trace_id") == tid]
    assert any(e["name"] == "request" for e in mine)
    assert any(e["name"] == "route" for e in mine)
    assert router.quiesce() and router.leak_free()


# ------------------------------------------------------------ telemetry
def test_fleet_telemetry_summary():
    tel = FleetTelemetry(config=TelemetryConfig(enabled=True))
    for cause in ("dead", "dead", "draining", "queue_full"):
        tel.record_retry(cause)
    tel.record_restart()
    for hit in (True, False, True, True):
        tel.record_affinity(hit=hit)
    tel.record_queue_depth("r0", 3)
    tel.record_queue_depth("r1", 0)
    for outcome in ("issued", "issued", "won", "wasted"):
        tel.record_hedge(outcome)
    tel.record_demotion("r1")
    tel.record_latency_score("r0", 0.002)
    tel.record_latency_score("r1", 0.31)
    with pytest.raises(ValueError, match="issued"):
        tel.record_hedge("lost")
    tel.record_handoff(n_bytes=4096, seconds=0.002, pages=2)
    tel.record_handoff(n_bytes=0, seconds=0.001, pages=0, skipped=True)
    tel.record_pool_depth("prefill", 3)
    tel.record_pool_depth("decode", 1)
    tel.record_ttft(0.02, mode="disagg")
    tel.record_ttft(0.04, mode="disagg")
    tel.record_ttft(0.05, mode="colocated")
    out = tel.summary()
    assert out["enabled"] and out["label"] == "fleet"
    assert out["router_retries"] == {"dead": 2, "draining": 1,
                                     "queue_full": 1}
    assert out["router_retries_total"] == 4
    assert out["replica_restarts"] == 1
    assert out["affinity_decisions"] == 4
    assert out["affinity_hit_rate"] == pytest.approx(0.75)
    assert out["replica_queue_depth"] == {"r0": 3, "r1": 0}
    assert out["hedges"] == {"issued": 2, "won": 1, "wasted": 1}
    assert out["replica_demotions"] == 1
    assert out["replica_latency_score"] == {"r0": 0.002, "r1": 0.31}
    assert out["handoffs"] == 2 and out["handoffs_skipped"] == 1
    assert out["handoff_bytes_total"] == 4096
    assert out["handoff_pages_total"] == 2
    assert out["handoff_s_mean"] == pytest.approx(0.0015)
    assert out["handoff_s_max"] == pytest.approx(0.002)
    assert out["pool_queue_depth"] == {"prefill": 3, "decode": 1}
    assert out["ttft_s_by_mode"]["disagg"]["count"] == 2
    assert out["ttft_s_by_mode"]["disagg"]["mean_s"] == pytest.approx(0.03)
    assert out["ttft_s_by_mode"]["disagg"]["p99_s"] == pytest.approx(0.04)
    assert out["ttft_s_by_mode"]["colocated"]["count"] == 1
    tel.forget_replica("r1")
    assert tel.summary()["replica_queue_depth"] == {"r0": 3}
    assert tel.summary()["replica_latency_score"] == {"r0": 0.002}
    off = FleetTelemetry(config=TelemetryConfig(enabled=False))
    off.record_retry("dead")
    off.record_restart()
    off.record_affinity(hit=True)
    off.record_hedge("issued")
    off.record_demotion("r0")
    off.record_latency_score("r0", 1.0)
    off.record_handoff(n_bytes=1, seconds=0.1, pages=1)
    off.record_pool_depth("prefill", 1)
    off.record_ttft(0.1, mode="disagg")
    assert off.summary() == {"enabled": False}
