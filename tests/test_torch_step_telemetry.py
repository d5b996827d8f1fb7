"""Port counterparts of the step-telemetry tests in
``tests/test_telemetry.py`` (record schema and compile split, MFU against
a hand count, Chrome-trace validity, monotonic span durations, disabled
mode, and the under-1% overhead by decomposition) for
``ray_tpu_torch.telemetry.StepTelemetry``, on the CPU.

The port's ``compile_s`` is step 0's wall over step 1's (eager PyTorch
has no ahead-of-time compile; ``telemetry/step.py``), so the schema test
holds that definition instead of the reference's ``lower().compile()``
time, and with ``aot=True`` the ``hbm`` block holds the argument bytes
(no allocator peak off the card).
"""

import json
import time

import pytest
import torch


def _tiny_cfg():
    from ray_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                     max_seq=64, dtype=torch.float32)


@pytest.fixture(scope="module")
def aot_run():
    """One instrumented run shared by the schema/MFU/trace tests."""
    from ray_tpu_torch.models import training
    from ray_tpu_torch.parallel.mesh import single_device_mesh
    from ray_tpu_torch.telemetry import StepTelemetry

    cfg = _tiny_cfg()
    mesh = single_device_mesh()
    fns = training.build_gpt_train(cfg, mesh, telemetry=False, device="cpu")
    assert "telemetry" not in fns
    tel = StepTelemetry(cfg, mesh, comm_mode=fns["comm_mode"], label="t9",
                        aot=True)
    step = tel.wrap(fns["step_fn"])
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = training.synthetic_lm_batch(torch.Generator().manual_seed(1), 4,
                                        32, cfg.vocab_size, device="cpu")
    for _ in range(4):
        state, metrics = step(state, batch)
    return {"cfg": cfg, "mesh": mesh, "tel": tel, "batch": batch,
            "state": state, "loss": float(metrics["loss"])}


def test_step_record_schema_and_compile_split(aot_run):
    tel = aot_run["tel"]
    assert len(tel.records) == 4
    for rec in tel.records:
        for key in ("step", "ts", "wall_s", "dispatch_s", "sync_s",
                    "tokens", "loss"):
            assert key in rec, (key, rec)
        assert rec["wall_s"] > 0
        assert rec["wall_s"] >= rec["dispatch_s"] > 0
        assert rec["tokens"] == 4 * 32
    assert tel.records[-1]["loss"] == pytest.approx(aot_run["loss"])
    # throughput/MFU only on steady steps
    assert "tokens_per_sec" not in tel.records[0]
    for rec in tel.records[1:]:
        assert rec["tokens_per_sec"] > 0 and "mfu" in rec
    # compile_s: step 0 only, step 0's wall over step 1's
    assert [r["step"] for r in tel.records if "compile_s" in r] == [0]
    first, second = tel.records[0], tel.records[1]
    assert first["compile_s"] == max(first["wall_s"] - second["wall_s"], 0)
    s = tel.summary()
    assert s["enabled"] and s["steps"] == 4
    assert s["compile_s"] == first["compile_s"] >= 0
    assert s["first_step_s"] == first["wall_s"] >= s["compile_s"]
    assert s["steady_step_s"] > 0
    # aot: the argument bytes of step 0 (state and batch), no card peak
    state = aot_run["state"]
    from ray_tpu_torch.models.training import _leaves
    want = sum(t.numel() * t.element_size() for t in
               _leaves(state.params) + _leaves(state.opt_state.mu)
               + _leaves(state.opt_state.nu)
               + list(aot_run["batch"].values()))
    assert s["hbm"] == {"argument_bytes": want}
    # logical collective accounting is present (single device: zeros)
    assert s["collective_bytes_per_step"]["total"] == 0
    assert s["comm_mode"] == "gspmd"


def test_mfu_arithmetic_vs_hand_computed_flops(aot_run):
    """The analytic FLOPs/token matches a hand count for the tiny GPT
    (and the JAX package's count), and the recorded MFU is exactly
    tokens/s/device * flops_per_token / the H100 peak."""
    from ray_tpu.models.gpt import GPTConfig as JGPTConfig
    from ray_tpu.telemetry import gpt_train_flops_per_token as jflops
    from ray_tpu_torch.telemetry import (H100_PEAK_TFLOPS,
                                         gpt_train_flops_per_token)

    cfg, tel = aot_run["cfg"], aot_run["tel"]
    seq = 32
    d, H, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.ff_dim
    L, V = cfg.n_layers, cfg.vocab_size
    per_layer = (3 * 2 * d * H * hd          # q, k, v projections
                 + 2 * seq * H * hd          # QK^T + AV, causal-halved
                 + 2 * H * hd * d            # output projection
                 + 3 * 2 * d * f)            # w1, w3, w2
    fwd = L * per_layer + 2 * d * V          # + lm head
    want = 3 * fwd + 2 * d * V               # fwd + 2x bwd + CE recompute
    got = gpt_train_flops_per_token(cfg, seq)
    assert got == pytest.approx(want, rel=1e-9), (got, want)
    assert got == jflops(JGPTConfig(vocab_size=V, d_model=d, n_layers=L,
                                    n_heads=H, max_seq=64), seq)
    assert tel.flops_per_token() == got
    rec = tel.records[2]
    expect = rec["tokens_per_sec"] * got / (H100_PEAK_TFLOPS * 1e12)
    assert rec["mfu"] == pytest.approx(expect, rel=1e-6)


def test_chrome_trace_export_valid(aot_run):
    """The exporter emits Perfetto-loadable JSON: a ``traceEvents`` list
    of complete events carrying host spans and the step records."""
    from ray_tpu_torch.telemetry import chrome_trace
    from ray_tpu_torch.util import tracing

    tracing.clear_recorded()
    tracing.enable_tracing()
    try:
        with tracing.span("host-side-work", kind="test"):
            time.sleep(0.01)
    finally:
        tracing.disable_tracing()

    trace = json.loads(chrome_trace.export())
    evs = trace["traceEvents"]
    assert isinstance(evs, list) and evs
    for ev in evs:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
    host = [e for e in evs if e["name"] == "host-side-work"]
    assert host and host[0]["pid"] == "host"
    assert host[0]["dur"] >= 0.01 * 1e6
    steps = [e for e in evs if e.get("cat") == "train_step"]
    assert len(steps) >= 4
    assert any("compile" in e["name"] for e in evs)
    assert any(e["name"].endswith("/sync") for e in evs)
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)


def test_tracing_spans_use_monotonic_durations():
    """Fallback-recorder spans carry a monotonic ``dur`` plus the epoch
    placement keys."""
    from ray_tpu_torch.util import tracing

    tracing.clear_recorded()
    tracing.enable_tracing()
    try:
        with tracing.span("mono"):
            time.sleep(0.02)
    finally:
        tracing.disable_tracing()
    (rec,) = [s for s in tracing.recorded_spans() if s["name"] == "mono"]
    assert rec["dur"] >= 0.02
    assert rec["end"] == pytest.approx(rec["start"] + rec["dur"])
    assert "tid" in rec


def test_disabled_mode_noop(monkeypatch):
    """RAY_TPU_TELEMETRY=0: the wrapper is identity, instrument() adds
    nothing, and the builder returns the unwrapped step."""
    import ray_tpu_torch.telemetry.config as tcfg_mod
    from ray_tpu_torch.models import training
    from ray_tpu_torch.telemetry import (StepTelemetry, instrument,
                                         telemetry_config)

    monkeypatch.setenv("RAY_TPU_TELEMETRY", "0")
    try:
        cfg = telemetry_config(refresh=True)
        assert not cfg.enabled
        tel = StepTelemetry(label="off")
        assert not tel.enabled

        def step(x):
            return x

        assert tel.wrap(step) is step
        fns = {"step_fn": step}
        out = instrument(fns)
        assert out is fns and "telemetry" not in out
        assert tel.summary() == {"enabled": False}
        built = training.build_gpt_train(_tiny_cfg(), device="cpu")
        assert "telemetry" not in built and "raw_step_fn" not in built
        forced = training.build_gpt_train(_tiny_cfg(), device="cpu",
                                          telemetry=True)
        assert forced["telemetry"].enabled
        assert forced["step_fn"].telemetry is forced["telemetry"]
    finally:
        monkeypatch.delenv("RAY_TPU_TELEMETRY")
        telemetry_config(refresh=True)
    assert tcfg_mod.telemetry_config().enabled
    on = training.build_gpt_train(_tiny_cfg(), device="cpu")
    assert on["raw_step_fn"] is not on["step_fn"]


def test_telemetry_overhead_under_one_percent():
    """Telemetry-on steady step time exceeds telemetry-off by < 1%,
    checked by decomposition as the reference does: (1) the wrapper's
    cost per call, the mean difference over many calls of a near-free
    step (the same path through the recorder: spans, sync check, record,
    emit check); (2) a real GPT step's steady wall time; (1) < 1% of
    (2)."""
    from ray_tpu_torch.models import training
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.parallel.mesh import single_device_mesh
    from ray_tpu_torch.telemetry import StepTelemetry

    def fake_step(state, batch):
        s = state + 1.0
        return s, {"loss": s.sum()}

    cfg = GPTConfig(vocab_size=2048, d_model=128, n_layers=2, n_heads=4,
                    max_seq=256, dtype=torch.float32)
    mesh = single_device_mesh()
    tel = StepTelemetry(cfg, mesh, comm_mode="gspmd", label="overhead")
    wrapped = tel.wrap(fake_step)
    s = torch.zeros((8, 128))
    batch = {"tokens": torch.zeros((4, 128), dtype=torch.long)}
    s, _ = fake_step(s, batch)
    s, _ = wrapped(s, batch)
    n = 800
    t0 = time.monotonic()
    for _ in range(n):
        out = fake_step(s, batch)
        float(out[1]["loss"])          # the raw loop reads its loss too
    t_raw = time.monotonic() - t0
    t0 = time.monotonic()
    for _ in range(n):
        wrapped(s, batch)
    t_wrapped = time.monotonic() - t0
    per_call = max((t_wrapped - t_raw) / n, 0.0)
    assert len(tel.records) == n + 1

    fns = training.build_gpt_train(cfg, mesh, telemetry=False, device="cpu")
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    gbatch = training.synthetic_lm_batch(torch.Generator().manual_seed(1),
                                         4, 128, cfg.vocab_size,
                                         device="cpu")
    walls = []
    for i in range(6):
        t0 = time.monotonic()
        state, m = fns["step_fn"](state, gbatch)
        float(m["loss"])
        if i > 0:
            walls.append(time.monotonic() - t0)
    walls.sort()
    steady = walls[len(walls) // 2]
    overhead = per_call / steady
    assert overhead < 0.01, (
        f"telemetry bookkeeping {per_call * 1e6:.0f}us/step is "
        f"{overhead:.2%} of the {steady * 1e3:.1f}ms steady step")


def test_profile_dir_captures_steps_one_to_three(tmp_path):
    """``RAY_TPU_PROFILE=<dir>``'s counterpart: a recorder whose config
    names a profile directory writes a ``torch.profiler`` Chrome trace
    of steps 1-3 (the first steady window) there, and only once."""
    from ray_tpu_torch.telemetry import StepTelemetry, TelemetryConfig

    def step(state, batch):
        return state + 1.0, {"loss": (state + 1.0).sum()}

    tel = StepTelemetry(label="prof", config=TelemetryConfig(
        enabled=True, profile_dir=str(tmp_path)))
    wrapped = tel.wrap(step)
    s = torch.zeros(4)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long)}
    for _ in range(6):
        s, _ = wrapped(s, batch)
    trace = tmp_path / "prof_steps.json"
    assert trace.exists() and tel._profile_done
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("add" in str(e.get("name", "")) for e in events)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["prof_steps.json"]


# ---------------------------------------------------------------------------
# collective bytes: the reference's per-tier accounting
# ---------------------------------------------------------------------------

BYTES_MESHES = [dict(dp=2), dict(fsdp=4), dict(fsdp=2, tp=2),
                dict(dcn=2, fsdp=2), dict(sp=2, tp=2)]
BYTES_ARMS = [("gspmd", "none"), ("overlap", "none"), ("overlap", "int8"),
              ("overlap", "dcn"), ("gspmd", "int8")]


def _bytes_summaries(axes, mode, quant, dtype):
    """The port's and the JAX package's recorder summaries after one
    step of a stand-in step function: the JAX recorder sees the global
    batch (8 x 32), the port's one rank's rows and sequence shard."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.gpt import GPTConfig as JGPTConfig
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.telemetry import StepTelemetry as JStepTelemetry
    from ray_tpu.telemetry.config import TelemetryConfig as JTelemetryConfig
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.telemetry import StepTelemetry, TelemetryConfig

    kw = dict(vocab_size=256, d_model=64, n_layers=3, n_heads=4, max_seq=32)
    B, S = 8, 32
    n = 1
    for a in axes.values():
        n *= a
    jmesh = make_mesh(**axes, devices=jax.devices()[:n])
    jtel = JStepTelemetry(JGPTConfig(**kw, dtype=getattr(jnp, dtype)), jmesh,
                          comm_mode=mode, comm_quant=quant,
                          config=JTelemetryConfig(enabled=True))
    jtel.wrap(lambda b: (b, {"loss": 0.0}))(
        {"tokens": jnp.zeros((B, S), jnp.int32)})
    rows = B // (axes.get("dcn", 1) * axes.get("dp", 1)
                 * axes.get("fsdp", 1))
    tel = StepTelemetry(GPTConfig(**kw, dtype=getattr(torch, dtype)),
                        MeshSpec.create(**axes), comm_mode=mode,
                        comm_quant=quant,
                        config=TelemetryConfig(enabled=True))
    tel.wrap(lambda b: (b, {"loss": 0.0}))(
        {"tokens": torch.zeros(rows, S // axes.get("sp", 1),
                               dtype=torch.int32)})
    return tel.summary(), jtel.summary()


@pytest.mark.parametrize("arm", BYTES_ARMS, ids=["-".join(a) for a in
                                                  BYTES_ARMS])
@pytest.mark.parametrize("axes", BYTES_MESHES,
                         ids=["-".join(f"{k}{v}" for k, v in a.items())
                              for a in BYTES_MESHES])
def test_collective_bytes_equal_the_reference(axes, arm):
    """``summary()["collective_bytes_per_step"]`` and its flattened tier
    totals equal the JAX package's recorder's for the same config,
    global batch and sequence, entry for entry, on each mesh, under both
    schedules and the int8 and "dcn" wires (bf16, so the int8 wire's
    bytes differ from the plain ones); each tier's ``seconds`` is its
    bytes over the port's price (the H100 specification's figures)."""
    from ray_tpu_torch.parallel import overlap

    got, want = _bytes_summaries(axes, *arm, "bfloat16")
    g, w = got["collective_bytes_per_step"], want["collective_bytes_per_step"]
    assert g.keys() == w.keys() == {"ici", "dcn", "total"}
    assert g["total"] == w["total"]
    for tier in ("ici", "dcn"):
        assert g[tier].keys() == w[tier].keys()
        for k, v in w[tier].items():
            if k != "seconds":
                assert g[tier][k] == v, (tier, k, g[tier][k], v)
        assert g[tier]["seconds"] == g[tier]["total"] / (
            overlap.TIER_BANDWIDTH_GBPS[tier] * 1e9)
        assert got[f"collective_bytes_{tier}"] == w[tier]["total"]
        assert got[f"collective_seconds_{tier}"] == g[tier]["seconds"]
    assert got.get("dcn_reduction_vs_flat") == \
        want.get("dcn_reduction_vs_flat")
    assert (got["comm_mode"], got["comm_quant"]) == arm


def test_collective_bytes_f32_and_tier_prices():
    """f32 on {dcn 2, fsdp 2} under the "dcn" wire: the port's bytes equal
    the reference's, and the prices are the H100 SXM specification's
    figures (NVLink 4 at 450 GB/s each way, one 400 Gb/s InfiniBand port
    at 50 GB/s), not the reference's TPU figures."""
    from ray_tpu_torch.parallel import overlap

    got, want = _bytes_summaries(dict(dcn=2, fsdp=2), "overlap", "dcn",
                                 "float32")
    for tier in ("ici", "dcn"):
        assert got[f"collective_bytes_{tier}"] == \
            want[f"collective_bytes_{tier}"]
    assert got["collective_bytes_dcn"] > 0
    assert overlap.TIER_BANDWIDTH_GBPS == {"ici": 450.0, "dcn": 50.0}
    assert overlap.tier_seconds(450_000_000_000, "ici") == 1.0


# the pipeline's recorder ("train_pp", its rows split over the data axes
# but the stage axis) and a MoE mesh's (the expert leaves over ep)
PP_TEL_CASES = [("pp2", dict(pp=2), "train_pp", {}),
                ("pp2-dp2", dict(pp=2, dp=2), "train_pp", {}),
                ("moe-dp2-ep2", dict(dp=2, ep=2), "train",
                 dict(n_experts=4))]


@pytest.mark.parametrize("case", PP_TEL_CASES,
                         ids=[c[0] for c in PP_TEL_CASES])
def test_train_pp_and_moe_recorders_equal_the_reference(case):
    """The ``train_pp`` recorder of ``build_gpt_train_pp`` (as
    ``_maybe_instrument`` makes it, with ``pp_batch_axes``) on {pp 2} and
    {pp 2, dp 2}, and ``build_gpt_train``'s on the MoE mesh {dp 2, ep 2},
    after one step of a stand-in step function: ``summary()``'s fields
    and ``collective_bytes()`` equal the JAX package's recorder's
    (made as its trainers make it, for the global batch 8 x 32), every
    byte entry exact; ``seconds`` are the port's prices (the H100's)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.gpt import GPTConfig as JGPTConfig
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.telemetry import StepTelemetry as JStepTelemetry
    from ray_tpu.telemetry.config import TelemetryConfig as JTelemetryConfig
    from ray_tpu_torch.models import training
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.parallel.mesh import MeshSpec

    _name, axes, label, extra = case
    kw = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4, max_seq=32,
              **extra)
    B, S = 8, 32
    n = 1
    for a in axes.values():
        n *= a
    jmesh = make_mesh(**axes, devices=jax.devices()[:n])
    jtel = JStepTelemetry(JGPTConfig(**kw, dtype=jnp.bfloat16), jmesh,
                          label=label, config=JTelemetryConfig(enabled=True))
    jtel.wrap(lambda b: (b, {"loss": 0.0}))(
        {"tokens": jnp.zeros((B, S), jnp.int32)})
    batch_axes = (training.pp_batch_axes("pp") if label == "train_pp"
                  else ("dcn", "dp", "fsdp"))
    rows = B
    for a in batch_axes:
        rows //= axes.get(a, 1)
    fns = training._maybe_instrument(
        {"step_fn": lambda b: (b, {"loss": 0.0})},
        GPTConfig(**kw, dtype=torch.bfloat16), MeshSpec.create(**axes),
        label=label, batch_axes=batch_axes, telemetry=True)
    fns["step_fn"]({"tokens": torch.zeros(rows, S, dtype=torch.int32)})
    got, want = fns["telemetry"].summary(), jtel.summary()
    assert got["label"] == want["label"] == label
    assert got["steps"] == want["steps"] == 1
    assert "comm_mode" not in got and "comm_mode" not in want
    assert got.keys() == want.keys()
    g, w = fns["telemetry"].collective_bytes(), jtel.collective_bytes()
    assert g.keys() == w.keys() == {"ici", "dcn", "total"}
    assert g["total"] == w["total"]
    for tier in ("ici", "dcn"):
        assert {k: v for k, v in g[tier].items() if k != "seconds"} == \
            {k: v for k, v in w[tier].items() if k != "seconds"}
        assert got[f"collective_bytes_{tier}"] == \
            want[f"collective_bytes_{tier}"]
    if extra:
        # the expert leaves shard over ep: a dp all-reduce of less than
        # the whole tree
        assert g["ici"]["grad_allreduce_dp"]["bytes"] > 0
