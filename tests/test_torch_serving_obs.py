"""Port parity: deadlines, chaos, telemetry, request tracing and the
watchdog of the serving engine.

The port's copies of ``ray_tpu.util.chaos``, ``telemetry.infer``,
``telemetry.trace`` and ``resilience.watchdog`` are held to the JAX
package's on the same inputs: the same fault spec fires on the same
hits, the same ``record_*`` calls give the same summary, the same env
knobs resolve to the same values.  The engine features run on
``GPTConfig.tiny`` (f32, page 16) beside the JAX engine where their
outcome is deterministic (telemetry counts, the stats keys, the span
names of a trace), and on their own where it is timing (deadlines).
"""

import json
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.inference.config import infer_config as jax_infer_config
from ray_tpu.models import gpt as jgpt
from ray_tpu.resilience import EngineWatchdog as JaxWatchdog
from ray_tpu.telemetry import trace as jtrace
from ray_tpu.telemetry.config import TelemetryConfig as JaxTelConfig
from ray_tpu.telemetry.infer import InferTelemetry as JaxInferTelemetry
from ray_tpu.util import chaos as jchaos
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.inference import (DeadlineExceededError,
                                     InferenceEngine, SamplingParams)
from ray_tpu_torch.inference.config import infer_config
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.resilience import EngineWatchdog
from ray_tpu_torch.telemetry import trace
from ray_tpu_torch.telemetry.config import (TelemetryConfig,
                                            telemetry_config)
from ray_tpu_torch.telemetry.infer import InferTelemetry
from ray_tpu_torch.util import chaos, tracing

GEOMETRY = dict(slots=2, page_size=16, buckets=(16, 32, 64))
_JAX_EXEC = {}


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
    """No armed faults, sampling 1, a fresh ring and no dump directory in
    both packages."""
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
    tracing.disable_tracing()
    tracing.clear_recorded()
    for mod in (trace, jtrace):
        mod.trace_config(refresh=True)
        mod.reset()


def _engine(models, **kw):
    _j, _jp, tcfg, tparams = models
    return InferenceEngine(tcfg, tparams, device="cpu",
                           **{**GEOMETRY, **kw})


def _jax_engine(models, **kw):
    jcfg, jparams, _t, _tp = models
    kw.setdefault("telemetry", False)
    return JaxEngine(jcfg, jparams, executable_cache=_JAX_EXEC,
                     **{**GEOMETRY, **kw})


def _prompt(n, seed=0):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 512, n)]


def _run(engine):
    """Run the engine dry -> ({rid: tokens}, {rid: error})."""
    toks, errs = {}, {}
    while engine.has_work():
        for ev in engine.step():
            if ev.error is not None:
                errs[ev[0]] = ev.error
            else:
                toks.setdefault(ev[0], []).append(int(ev[1]))
    return toks, errs


# ------------------------------------------------------------- deadlines
def test_ttft_deadline_expires_waiting_request(models):
    engine = _engine(models, slots=1, telemetry=True)
    p = _prompt(8)
    r1 = engine.submit(p, max_new_tokens=4)
    r2 = engine.submit(p, max_new_tokens=4, ttft_deadline_s=1e-4)
    time.sleep(0.005)                       # r2 waits behind r1's slot
    events = []
    while engine.has_work():
        events += engine.step()
    errs = [ev for ev in events if ev.error is not None]
    assert [ev[0] for ev in events if ev.error is None] == [r1] * 4
    (ev,) = errs
    assert ev == (r2, -1, True)
    assert isinstance(ev.error, DeadlineExceededError)
    assert (ev.error.kind, ev.error.rid) == ("ttft", r2)
    back = pickle.loads(pickle.dumps(ev.error))
    assert (back.rid, back.kind, str(back)) == (r2, "ttft", str(ev.error))
    assert engine.deadline_exceeded == 1
    assert engine.stats()["deadline_exceeded"] == 1
    assert engine.telemetry.summary()["deadline_exceeded"] == {"ttft": 1}
    assert not engine._requests and engine.leak_free()


def test_total_deadline_retires_mid_decode_and_releases_all(models):
    engine = _engine(models, prefix=True)
    alloc = engine.scheduler.allocator
    free0 = alloc.free_count
    engine.submit(_prompt(8), max_new_tokens=20, deadline_s=0.05)
    engine.step()                           # the prefill: first token
    time.sleep(0.06)                        # past the budget mid-decode
    toks, errs = _run(engine)
    (err,) = errs.values()
    assert isinstance(err, DeadlineExceededError) and err.kind == "total"
    assert sum(len(t) for t in toks.values()) < 20
    assert len(engine.scheduler.free_slots) == engine.slots
    assert alloc.free_count == free0 and engine.leak_free()
    with pytest.raises(DeadlineExceededError):
        engine.generate([_prompt(8, seed=1)], max_new_tokens=4,
                        deadline_s=1e-9)
    assert engine.leak_free() and not engine.has_work()


def test_engine_default_deadlines_and_zero_turns_off(models):
    engine = _engine(models, ttft_deadline=5.0, deadline=7.0)
    rid = engine.submit(_prompt(8), max_new_tokens=2)
    req = engine._requests[rid]
    assert (req.ttft_deadline_s, req.deadline_s) == (5.0, 7.0)
    rid = engine.submit(_prompt(8), max_new_tokens=2, ttft_deadline_s=0,
                        deadline_s=0)
    req = engine._requests[rid]
    assert (req.ttft_deadline_s, req.deadline_s) == (None, None)
    _run(engine)
    jeng = _jax_engine(models, ttft_deadline=5.0, deadline=7.0)
    assert (jeng.ttft_deadline, jeng.deadline) == \
        (engine.ttft_deadline, engine.deadline)


def test_deadline_expiry_records_anomaly(models):
    engine = _engine(models, slots=1)
    ctx = trace.mint(sampled=True)
    engine.submit(_prompt(8), max_new_tokens=4)
    r2 = engine.submit(_prompt(8, seed=1), max_new_tokens=4,
                       ttft_deadline_s=1e-4, trace_ctx=ctx)
    time.sleep(0.005)
    _toks, errs = _run(engine)
    assert isinstance(errs[r2], DeadlineExceededError)
    (rec,) = [r for r in trace.recorder().spans()
              if r["name"] == "anomaly/deadline"]
    assert rec["attributes"]["budget"] == "ttft"
    assert rec["trace_id"] == ctx.trace_id
    assert engine.leak_free()


def test_deadline_env_knobs_match_reference(monkeypatch):
    def both():
        t, j = infer_config(refresh=True), jax_infer_config(refresh=True)
        got = (t.ttft_deadline, t.deadline, t.watchdog)
        assert got == (j.ttft_deadline, j.deadline, j.watchdog)
        return got

    assert both() == (0, 0, 0)
    monkeypatch.setenv("RAY_TPU_INFER_TTFT_DEADLINE", "0.25")
    monkeypatch.setenv("RAY_TPU_INFER_DEADLINE", "30")
    monkeypatch.setenv("RAY_TPU_INFER_WATCHDOG", "10")
    assert both() == (0.25, 30.0, 10.0)
    monkeypatch.setenv("RAY_TPU_INFER_DEADLINE", "-3")
    assert both() == (0.25, 0.0, 10.0)
    for name in ("TTFT_DEADLINE", "DEADLINE", "WATCHDOG"):
        monkeypatch.delenv(f"RAY_TPU_INFER_{name}")
    assert both() == (0, 0, 0)


# ----------------------------------------------------------------- chaos
def _drive_plan(mod, spec):
    plan = mod.FaultPlan(spec)
    log = []
    for site in ["infer.decode", "kv.spill", "kv.fetch", "kv.spill",
                 "kv.spill", "infer.decode", "kv.spill", "kv.fetch",
                 "kv.fetch", "kv.spill"]:
        log.append(plan.fires(site))
    return log, plan.fired, [(s, h) for s, h, _d in plan.slowed], \
        {s: plan.hits(s) for s in ("infer.decode", "kv.spill",
                                   "kv.fetch")}


@pytest.mark.parametrize("spec", [
    "kv.spill@1", "kv.spill@4", "kv.fetch@1,infer.decode@2",
    "kv.spill", "kv.fetch@2..3:delay=0.001, kv.spill@3",
    "infer.decode@1,infer.decode@2"])
def test_fault_spec_fires_on_the_same_hits(spec):
    got = _drive_plan(chaos, spec)
    assert got == _drive_plan(jchaos, spec)
    assert got[1], "the spec fired nothing"


@pytest.mark.parametrize("bad", ["kv.fetch@0", "kv.fetch@2..1:delay=1",
                                 "kv.fetch@1..3", "kv.fetch:delay=x",
                                 "kv.fetch:speed=2", "kv.fetch@x"])
def test_bad_fault_specs_refused_alike(bad):
    with pytest.raises(ValueError) as got:
        chaos.FaultPlan(bad)
    with pytest.raises(ValueError) as want:
        jchaos.FaultPlan(bad)
    assert str(got.value) == str(want.value)


def test_faults_from_env_and_injected_fault_anomaly(monkeypatch, tmp_path):
    monkeypatch.setenv("RAY_TPU_FAULTS", "infer.decode@2")
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", str(tmp_path))
    trace.trace_config(refresh=True)
    chaos.clear_faults()
    chaos.maybe_fail("infer.decode")
    with pytest.raises(chaos.InjectedFault) as exc:
        chaos.maybe_fail("infer.decode")
    assert (exc.value.site, exc.value.hit) == ("infer.decode", 2)
    back = pickle.loads(pickle.dumps(exc.value))
    assert (back.site, back.hit) == ("infer.decode", 2)
    assert chaos.fault_plan().fired == [("infer.decode", 2)]
    assert chaos.should_fire("ckpt.truncate") is False
    (path,) = tmp_path.iterdir()
    doc = json.loads(path.read_text())
    assert doc["metadata"]["trigger"] == "injected_fault"
    assert any(e["name"] == "anomaly/injected_fault"
               for e in doc["traceEvents"])


def test_decode_fault_fires_before_any_launch(models):
    """``infer.decode`` raises before the decode step touches anything:
    the cache is bit-identical across the failed tick, and the engine
    drains leak-free."""
    engine = _engine(models)
    engine.submit(_prompt(20, 1), max_new_tokens=8)
    engine.submit(_prompt(30, 2), max_new_tokens=8)
    engine.step()                           # both prefilled, one decode
    engine.step()
    before = (engine.cache.k.clone(), engine.cache.v.clone(),
              engine.scheduler.lengths.copy())
    plan = chaos.install_faults("infer.decode@1")
    with pytest.raises(chaos.InjectedFault):
        engine.step()
    assert plan.fired == [("infer.decode", 1)]
    assert torch.equal(engine.cache.k, before[0])
    assert torch.equal(engine.cache.v, before[1])
    assert (engine.scheduler.lengths == before[2]).all()
    assert any(r["name"] == "anomaly/injected_fault"
               for r in trace.recorder().spans())
    assert engine.drain_requests() == 2
    assert engine.leak_free() and not engine.has_work()
    alloc = engine.scheduler.allocator
    assert alloc.free_count == alloc.num_pages - 1


# ------------------------------------------------------------- telemetry
def _record_script(tel):
    tel.record_cache_info(kv_dtype="int8", cache_bytes=1024,
                          kv_bytes_per_slot=256)
    tel.record_queue_depth(3)
    tel.record_queue(0.002, depth=1)
    tel.record_queue(0.004, depth=0)
    tel.record_prefill(0.01, prompt_tokens=40, bucket=64)
    tel.record_prefill(0.02, prompt_tokens=48, bucket=16,
                       cached_tokens=32)
    tel.record_ttft(0.03, prefix_hit=False, trace_id="abc")
    tel.record_ttft(0.05, prefix_hit=True)
    tel.record_ttft(0.02, prefix_hit=True, trace_id="def")
    for wall, active in ((0.004, 2), (0.002, 2), (0.003, 1)):
        tel.record_decode(wall, active=active)
    tel.record_verify(0.01, proposed=4, accepted=4, emitted=5)
    tel.record_verify(0.01, proposed=4, accepted=0, emitted=1)
    tel.record_request_done()
    tel.record_request_done()
    tel.record_deadline_exceeded(kind="ttft")
    tel.record_deadline_exceeded(kind="total")
    tel.record_deadline_exceeded(kind="ttft")
    tel.record_prefix_hits(2, tier="hbm")
    tel.record_prefix_hits(1, tier="dram")
    tel.record_prefix_hits(3, tier="store")
    tel.record_kv_spill(4096)
    tel.record_kv_fetch(0.002, tier="dram")
    tel.record_kv_fetch(0.004, tier="store")
    tel.record_kv_store_evictions(2)
    tel.record_kv_store_evictions(0)
    tel.record_tier_occupancy(hbm=5, dram=2, store=7)
    tel.record_adapter_cache(hit=True)
    tel.record_adapter_cache(hit=False)
    tel.record_adapter_load(0.1, resident=1)
    return tel.summary()


@pytest.mark.parametrize("enabled", [True, False])
def test_infer_telemetry_summary_matches_reference(enabled):
    got = _record_script(InferTelemetry(
        config=TelemetryConfig(enabled=enabled)))
    want = _record_script(JaxInferTelemetry(
        config=JaxTelConfig(enabled=enabled)))
    assert got == want
    if enabled:
        assert got["deadline_exceeded"] == {"ttft": 2, "total": 1}
        assert got["spec"]["accept_rate"] == 0.5
        assert got["tiers"]["store_evictions"] == 2
        assert got["ttft_worst_trace"] == {"ttft_s": 0.03,
                                           "trace_id": "abc"}
    else:
        assert got == {"enabled": False}


def test_telemetry_env_knob(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TELEMETRY", "0")
    assert telemetry_config(refresh=True).enabled is False
    monkeypatch.setenv("RAY_TPU_TELEMETRY", "junk")
    assert telemetry_config(refresh=True).enabled is True
    monkeypatch.setenv("RAY_TPU_PROFILE", "/nowhere")
    assert telemetry_config(refresh=True).profile_dir == "/nowhere"
    monkeypatch.delenv("RAY_TPU_TELEMETRY")
    monkeypatch.delenv("RAY_TPU_PROFILE")
    assert telemetry_config(refresh=True) == TelemetryConfig()


_COUNT_KEYS = ("requests_done", "prefills", "decode_steps",
               "decode_tokens", "prompt_tokens", "prefill_tokens_skipped",
               "kv_dtype", "kv_cache_bytes", "kv_bytes_per_slot",
               "deadline_exceeded", "prefix_hit_rate", "spec")


def _serve_traffic(engine):
    shared = _prompt(32, 3)
    suffixes = [_prompt(9, 10), _prompt(20, 11), _prompt(6, 12) * 4]
    for i, suffix in enumerate(suffixes):
        sp = SamplingParams(spec=(i == 2), spec_k=2)
        engine.submit(shared + suffix, max_new_tokens=6, sampling=sp)
    first = engine.step()
    engine.submit(_prompt(24, 9), max_new_tokens=4)
    toks, errs = _run(engine)
    for ev in reversed(first):
        toks[ev[0]].insert(0, int(ev[1]))
    return toks, errs


def test_engine_telemetry_counts_match_reference(models):
    """The same traffic (prefix hits, a speculating request) through
    both engines with telemetry on: the summary's counts equal each
    other's and the port's own call counts."""
    engine = _engine(models, telemetry=True)
    toks, _ = _serve_traffic(engine)
    jeng = _jax_engine(models, telemetry=True)
    jtoks, _ = _serve_traffic(jeng)
    assert toks == {r: [int(t) for t in v] for r, v in jtoks.items()}
    got, want = engine.telemetry.summary(), jeng.telemetry.summary()
    assert sorted(got) == sorted(want)
    for key in _COUNT_KEYS:
        assert got[key] == want[key], key
    calls = engine.call_counts
    assert got["prefills"] == calls["prefill"] + calls["prefill_cached"]
    assert got["decode_steps"] == calls["decode"] + calls["verify"]
    assert got["requests_done"] == 4
    assert got["decode_tokens"] == sum(len(t) for t in toks.values()) - 4
    assert len(engine.telemetry.ttfts) == 4
    assert _engine(models, telemetry=False).telemetry.summary() == \
        {"enabled": False}


def test_stats_keys_match_reference(models):
    engine, jeng = _engine(models), _jax_engine(models)
    _serve_traffic(engine)
    _serve_traffic(jeng)
    got, want = engine.stats(), jeng.stats()
    for key in ("deadline_exceeded", "exports", "imports", "held",
                "ticks", "prefix", "spec", "tiers"):
        assert key in got, key
        if isinstance(want[key], dict):
            assert sorted(got[key]) == sorted(want[key]), key
        if key not in ("tiers",):
            assert got[key] == want[key], key
    assert got["tiers"]["hits"] == want["tiers"]["hits"]


# --------------------------------------------------------------- tracing
def test_trace_env_knobs_and_sampling(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "0.25")
    monkeypatch.setenv("RAY_TPU_TRACE_RING", "128")
    for mod in (trace, jtrace):
        cfg = mod.trace_config(refresh=True)
        assert (cfg.sample, cfg.ring, cfg.dir) == (0.25, 128, None)
        mod.reset()
        assert mod.recorder().capacity == 128
    assert [trace.mint().sampled for _ in range(8)] == \
        [jtrace.mint().sampled for _ in range(8)]
    assert sum(trace.mint().sampled for _ in range(8)) == 2
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "junk")
    monkeypatch.setenv("RAY_TPU_TRACE_RING", "-5")
    assert trace.trace_config(refresh=True) == \
        trace.TraceConfig(sample=1.0, ring=4096)
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "7")
    assert trace.trace_config(refresh=True).sample == \
        jtrace.trace_config(refresh=True).sample == 1.0


def test_ring_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_RING", "8")
    trace.trace_config(refresh=True)
    trace.reset()
    ctx = trace.mint(sampled=True)
    for i in range(20):
        trace.record_span(f"s{i}", ctx, start=float(i), dur=0.0)
    rec = trace.recorder()
    assert len(rec) == 8 and rec.recorded == 20 and rec.dropped == 12
    assert [r["name"] for r in rec.spans()] == \
        [f"s{i}" for i in range(12, 20)]
    ctx2 = trace.TraceContext.from_wire(ctx.child("s1").to_wire())
    assert (ctx2.trace_id, ctx2.parent_id, ctx2.sampled) == \
        (ctx.trace_id, "s1", True)
    assert trace.TraceContext.from_wire(None) is None


def _assert_gap_free(mod, tid):
    """One rooted, parent-complete span tree."""
    spans = mod.spans_for(tid)
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if s.get("parent_id") is None]
    assert [r["name"] for r in roots] == ["request"]
    dangling = [(s["name"], s["parent_id"]) for s in spans
                if s.get("parent_id") is not None
                and s["parent_id"] not in ids]
    assert not dangling, dangling
    return spans


def _traced_handoff(mod, pre, dec, prompt, sp, convert=None):
    """A root ``request`` span, the prefill side's first-token-stop
    submission under it, the handoff, the import, drained."""
    ctx = mod.mint(sampled=True)
    root = mod.record_span("request", ctx, start=time.time(), dur=0.0)
    rid = pre.submit(prompt, max_new_tokens=1, hold_pages=True,
                     sampling=sp, trace_ctx=ctx.child(root))
    _run(pre)
    handoff = pre.export_request(rid)
    dec.import_submit(convert(handoff) if convert else handoff,
                      max_new_tokens=4, sampling=sp)
    toks, errs = _run(dec)
    assert not errs
    return ctx.trace_id, toks


def test_trace_across_handoff_is_one_gap_free_tree(models):
    """A sampled request's trace across a disaggregated handoff: the
    context rides the payload, so the importer's spans join the
    exporter's tree; the spans are the JAX engines' by name, and the
    decode ticks list the trace."""
    prompt = _prompt(40, 4)
    sp = SamplingParams(temperature=0.8, top_k=50, seed=7)
    tid, toks = _traced_handoff(trace, _engine(models), _engine(models),
                                prompt, sp)
    spans = _assert_gap_free(trace, tid)
    names = sorted(s["name"] for s in spans)
    assert names == sorted(["request", "prefix_walk", "queue", "prefill",
                            "first_token", "prefix_walk",
                            "handoff.install"])
    ticks = [r for r in trace.recorder().spans()
             if r["name"] == "decode_tick" and tid in
             r["attributes"]["trace_ids"]]
    assert len(ticks) == 4 == len(next(iter(toks.values())))
    jtid, _ = _traced_handoff(jtrace, _jax_engine(models),
                              _jax_engine(models), prompt,
                              SamplingParams(temperature=0.8, top_k=50,
                                             seed=7))
    jnames = sorted(s["name"] for s in _assert_gap_free(jtrace, jtid))
    assert names == jnames
    print(trace.format_tree(tid))


def test_unsampled_records_nothing_but_anomalies_land(models):
    engine = _engine(models)
    ctx = trace.mint(sampled=False)
    engine.submit(_prompt(12), max_new_tokens=3, trace_ctx=ctx)
    _run(engine)
    assert len(trace.recorder()) == 0
    trace.anomaly("wedge", replica="u0")
    assert len(trace.recorder()) == 1


def test_local_spans_and_dump(models, tmp_path):
    """With ``util.tracing`` on the engine's prefill/decode spans land in
    the local recorder, and ``trace.dump`` writes them beside the ring
    as one Perfetto JSON."""
    tracing.enable_tracing()
    engine = _engine(models)
    engine.generate([_prompt(12)], max_new_tokens=3)
    names = [s["name"] for s in tracing.recorded_spans()]
    assert names.count("infer/prefill") == 1
    assert names.count("infer/decode") == 2
    tracing.disable_tracing()
    engine.generate([_prompt(12, 1)], max_new_tokens=3)
    assert len(tracing.recorded_spans()) == 3
    trace.anomaly("wedge", replica="r0")
    doc = json.loads(open(trace.dump(str(tmp_path / "d.json"),
                                     trigger="test")).read())
    got = sorted(e["name"] for e in doc["traceEvents"])
    assert got == sorted(names + ["anomaly/wedge"])
    assert doc["metadata"]["trigger"] == "test"


# -------------------------------------------------------------- watchdog
class _FakeEngine:
    def __init__(self):
        self.ticks = 0
        self.last_tick_ts = time.monotonic()
        self._work = False
        self.scheduler = type("S", (), {"waiting": [], "active": {}})()

    def has_work(self):
        return self._work

    def tick(self):
        self.ticks += 1
        self.last_tick_ts = time.monotonic()


def _watchdog_script(Watchdog):
    eng = _FakeEngine()
    fired = []
    wd = Watchdog(eng, timeout_s=0.1, poll_s=0.02,
                  on_wedge=lambda e: fired.append(e.ticks))
    eng.last_tick_ts -= 10
    log = [wd.check()]
    eng._work = True
    now = time.monotonic()
    log += [wd.check(now=now), wd.check(now=now + 0.05),
            wd.check(now=now + 0.2), wd.check(now=now + 0.3)]
    eng.tick()
    log += [wd.check(), wd.check(now=time.monotonic() + 0.2)]
    return log, wd.wedges, fired


def test_watchdog_matches_reference(capfd):
    got = _watchdog_script(EngineWatchdog)
    assert got == _watchdog_script(JaxWatchdog)
    assert got == ([False, False, False, True, False, False, True], 2,
                   [0, 1])
    eng = _FakeEngine()
    eng.tick()
    eng._work = True
    eng.last_tick_ts -= 10
    with EngineWatchdog(eng, timeout_s=0.05, poll_s=0.01) as wd:
        time.sleep(0.25)
    assert wd.wedges == 1
    assert "wedged" in capfd.readouterr().err
    with pytest.raises(ValueError, match="RAY_TPU_INFER_WATCHDOG"):
        EngineWatchdog(_FakeEngine(), timeout_s=0)


def test_watchdog_reads_a_real_engine(models):
    engine = _engine(models)
    wd = EngineWatchdog(engine, timeout_s=2.0)
    engine.submit(_prompt(8), max_new_tokens=3)
    now = time.monotonic()
    assert wd.check(now=now) is False       # idle -> busy
    assert wd.check(now=now + 10.0) is True  # no tick since
    ticks = engine.ticks
    engine.step()
    assert engine.ticks == ticks + 1 and engine.last_tick_ts > now
    assert wd.check() is False              # progress re-arms
    _run(engine)
    assert wd.check(now=time.monotonic() + 50) is False  # idle
