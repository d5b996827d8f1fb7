"""Port parity: the training slice (``models/gpt.py:loss_fn`` and
``models/training.py:build_gpt_train``) against the JAX package.

The model ``GPTConfig(vocab_size=512, d_model=128, n_layers=2,
n_heads=2, max_seq=128, dtype=f32)`` at batch 2 x 128: head_dim 64 puts
the JAX side on its lane-packed flash attention with fused RoPE, and
d = 128 passes both fused-norm gates, so every Pallas kernel of the
training step runs there (interpret mode): the pack2 forward and
backward, the out-proj epilogue forward and backward, and flash-CE
forward and backward with the final-norm prologue.  The port runs the
same autograd.Functions the card runs, with the plain bodies.  The same
JAX batches go to both sides and the parameters cross by
``params_from_jax``.

Tolerances (f32 on both sides; summation order is the only difference):
- the loss within 2e-5 (the JAX suite's own fuse-norm bound,
  tests/test_models.py:168);
- each gradient leaf within 1e-4 of its own largest value (its grad
  bound, tests/test_models.py:177);
- over the optimizer steps, loss and grad_norm within 1e-4 relative, and
  each post-step parameter within 1e-5 absolute: the weights move by
  about lr = 1e-3 per step, and Adam's normalised update carries a
  relative gradient error of ~1e-6 into ~1e-9 of a weight, so 1e-5 is
  far above the noise and far below a wrong update (a dropped clip,
  decay or bias correction moves a weight by ~1e-4 or more).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtrain
from ray_tpu.ops import attention as JA
from ray_tpu.ops import flash_ce as JC
from ray_tpu.ops import fused_norm as JF
from ray_tpu.parallel.mesh import make_mesh
from ray_tpu.telemetry import flops as jflops
from ray_tpu_torch.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.ops import attention as TA
from ray_tpu_torch.telemetry import flops as tflops

SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
             max_seq=128)
B, S = 2, 128
STEPS = 6
# the first steps' gradient norms are ~1 here: this clip engages on them
GRAD_CLIP = 0.5


def _cfgs():
    return (jgpt.GPTConfig(**SMALL, dtype=jnp.float32),
            tgpt.GPTConfig(**SMALL, dtype=torch.float32))


def _jax_batch(seed):
    return jtrain.synthetic_lm_batch(jax.random.PRNGKey(seed), B, S,
                                     SMALL["vocab_size"])


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_every_training_kernel_engages_on_the_jax_side():
    """Without these the parity below would hold the port against the
    JAX package's XLA fallbacks instead of its kernels."""
    assert JA.uses_pack2(S, S, SMALL["n_heads"], 64)
    assert JF.out_proj_norm_plan(B * S, 128, 128, seq=S, enabled=True)
    assert JC.uses_flash_ce_norm(B * S, 128, 512, enabled=True)


@pytest.mark.parametrize("fuse_norm", [True, False])
def test_loss_fn_grads_match_jax(fuse_norm):
    jcfg, tcfg = _cfgs()
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _jax_batch(1)
    jattn = JA.make_flash_attention_fn(mesh, causal=True,
                                       rope_theta=jcfg.rope_theta)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, batch, jcfg, attn_fn=jattn, mesh=mesh,
                               fuse_norm=fuse_norm))(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tattn = TA.make_flash_attention_fn(rope_theta=tcfg.rope_theta)
    tloss, tgrads = ttrain.value_and_grad(
        lambda p, b: tgpt.loss_fn(p, b, tcfg, attn_fn=tattn,
                                  fuse_norm=fuse_norm),
        tparams, _to_torch(batch))
    assert float(tloss) == pytest.approx(float(jloss), abs=2e-5)
    jl = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    tl = dict(_leaves(params_to_numpy(tgrads)))
    assert jl.keys() == tl.keys()
    for path, want in jl.items():
        err = np.abs(tl[path] - want).max() / max(1e-8, np.abs(want).max())
        assert err < 1e-4, (path, err)


@pytest.mark.parametrize("fuse_norm", [True, False])
def test_loss_fn_grads_match_jax_with_the_norm_kernel(fuse_norm,
                                                      monkeypatch):
    """``_PALLAS_NORM`` on in both packages (``RAY_TPU_PALLAS_NORM=1``):
    the JAX side's norms go through its Pallas rmsnorm (interpret mode),
    the port's through ``ops.rmsnorm``'s autograd.Function.  Loss and
    every gradient leaf under the bounds above.  On the port side the
    forward and backward run once per norm that ``_norm`` takes: ``ln1``
    per layer with the fused epilogues on, and ``ln2`` and ``ln_f`` too
    with them off."""
    from ray_tpu_torch.ops import rmsnorm as TR
    monkeypatch.setattr(jgpt, "_PALLAS_NORM", True)
    monkeypatch.setattr(tgpt, "_PALLAS_NORM", True)
    calls = {"fwd": 0, "bwd": 0}
    for kind in calls:
        real = getattr(TR, f"rmsnorm_{kind}")

        def spy(*a, _real=real, _kind=kind, **k):
            calls[_kind] += 1
            return _real(*a, **k)

        monkeypatch.setattr(TR, f"rmsnorm_{kind}", spy)
    jcfg, tcfg = _cfgs()
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _jax_batch(2)
    jattn = JA.make_flash_attention_fn(mesh, causal=True,
                                       rope_theta=jcfg.rope_theta)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, batch, jcfg, attn_fn=jattn, mesh=mesh,
                               fuse_norm=fuse_norm))(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tattn = TA.make_flash_attention_fn(rope_theta=tcfg.rope_theta)
    tloss, tgrads = ttrain.value_and_grad(
        lambda p, b: tgpt.loss_fn(p, b, tcfg, attn_fn=tattn,
                                  fuse_norm=fuse_norm),
        tparams, _to_torch(batch))
    n_norms = SMALL["n_layers"] * (1 if fuse_norm else 2) + \
        (0 if fuse_norm else 1)
    assert calls == {"fwd": n_norms, "bwd": n_norms}
    assert float(tloss) == pytest.approx(float(jloss), abs=2e-5)
    jl = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    tl = dict(_leaves(params_to_numpy(tgrads)))
    for path, want in jl.items():
        err = np.abs(tl[path] - want).max() / max(1e-8, np.abs(want).max())
        assert err < 1e-4, (path, err)


# the JAX package's modes, each alone and all together
MODES = [dict(norm="layernorm"), dict(act="gelu"), dict(pos="learned"),
         dict(use_bias=True), dict(tie_embeddings=False),
         dict(norm="layernorm", act="gelu", pos="learned", use_bias=True,
              tie_embeddings=False)]
MODE_IDS = ["layernorm", "gelu", "learned", "bias", "untied", "all"]


def _perturbed(tree, rng):
    """Biases and norm scales moved off their zeros and ones."""
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k.startswith(("ln", "b")):
            out[k] = (np.asarray(v) + 0.1 * rng.standard_normal(
                np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_mode_step_grads_match_jax(kw):
    """``build_gpt_train``'s ``value_and_grad_fn`` in each mode (its own
    attention hook: in-kernel RoPE, or none for learned positions; the
    epilogue and the flash-CE prologue where their gates take the mode)
    against ``jax.value_and_grad`` of the JAX package's loss through its
    trainer's hook, on parameters whose biases and norms are perturbed:
    the loss within 2e-5, each gradient leaf within 1e-4 of its largest
    value.  ``bk``'s gradient is zero in exact arithmetic (a key bias
    shifts every score of a query alike), so a leaf whose largest value
    is below 1e-4 is held at 1e-8 absolute."""
    jcfg = jgpt.GPTConfig(**SMALL, dtype=jnp.float32, **kw)
    tcfg = tgpt.GPTConfig(**SMALL, dtype=torch.float32, **kw)
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jparams = _perturbed(jax.tree.map(np.asarray, jgpt.init_params(
        jcfg, jax.random.PRNGKey(0))), np.random.default_rng(0))
    batch = _jax_batch(3)
    jfns = jtrain.build_gpt_train(jcfg, mesh, telemetry=False)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, batch, jcfg, attn_fn=jfns["attn_fn"],
                               mesh=mesh))(jax.tree.map(jnp.asarray,
                                                        jparams))
    tfns = ttrain.build_gpt_train(tcfg, device="cpu", telemetry=False)
    tstate = tfns["init_fn"](params=params_from_jax(jparams, tcfg,
                                                    device="cpu"))
    tloss, tgrads = tfns["value_and_grad_fn"](tstate.params,
                                              _to_torch(batch))
    assert float(tloss) == pytest.approx(float(jloss), abs=2e-5)
    jl = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    tl = dict(_leaves(params_to_numpy(tgrads)))
    assert jl.keys() == tl.keys()
    for path, want in jl.items():
        err = np.abs(tl[path] - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-4), (path, err)


def test_train_steps_match_jax():
    """STEPS optimizer steps (clip engaged, warmup then cosine) from the
    same parameters on the same batches: the loss and grad_norm
    sequences and every post-step parameter."""
    jcfg, tcfg = _cfgs()
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    kw = dict(lr=1e-3, warmup=2, total_steps=8, grad_clip=GRAD_CLIP)
    jfns = jtrain.build_gpt_train(
        jcfg, mesh, optimizer=jtrain.default_optimizer(**kw),
        telemetry=False)
    jstate = jfns["init_fn"](jax.random.PRNGKey(0))
    tfns = ttrain.build_gpt_train(
        tcfg, optimizer=ttrain.default_optimizer(**kw), device="cpu")
    tstate = tfns["init_fn"](params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params), tcfg, device="cpu"))
    jm, tm = [], []
    for i in range(STEPS):
        batch = _jax_batch(10 + i)
        jstate, m = jfns["step_fn"](jstate, batch)
        jm.append((float(m["loss"]), float(m["grad_norm"])))
        tstate, m = tfns["step_fn"](tstate, _to_torch(batch))
        tm.append((float(m["loss"]), float(m["grad_norm"])))
        assert m["step"] == i + 1
    assert jm[0][1] > GRAD_CLIP        # the clip engaged
    np.testing.assert_allclose(np.array(tm), np.array(jm), rtol=1e-4)
    jl = dict(_leaves(jax.tree.map(np.asarray, jstate.params)))
    tl = dict(_leaves(params_to_numpy(tstate.params)))
    for path, want in jl.items():
        np.testing.assert_allclose(tl[path], want, atol=1e-5,
                                   err_msg=str(path))


def test_accum_steps_matches_one_step():
    """accum_steps=2 (two microbatches of one row, f32 accumulation)
    gives the full-batch loss and gradients: the microbatches carry
    equal valid-token counts, so the mean of their means is the batch
    mean and only the summation order differs (each gradient leaf within
    1e-5 of its largest value).  The gradients are compared, not the
    post-step weights: Adam's first update is ~lr * sign(g), so an entry
    whose gradient is ~1e-7 may flip sign on summation order alone."""
    _jcfg, tcfg = _cfgs()
    batch = _to_torch(_jax_batch(3))
    out = {}
    for k in (1, 2):
        fns = ttrain.build_gpt_train(tcfg, accum_steps=k, device="cpu")
        params = fns["init_fn"](torch.Generator().manual_seed(0)).params

        def loss(p, b):
            return tgpt.loss_fn(p, b, tcfg, attn_fn=fns["attn_fn"])

        out[k] = (ttrain._accum_value_and_grad(loss, params, batch, k)
                  if k > 1 else ttrain.value_and_grad(loss, params, batch))
        state, m = fns["step_fn"](fns["init_fn"](params=params), batch)
        assert float(m["loss"]) == pytest.approx(float(out[k][0]), rel=1e-6)
    assert float(out[2][0]) == pytest.approx(float(out[1][0]), rel=1e-5)
    for (path, a), (_, b) in zip(_leaves(params_to_numpy(out[2][1])),
                                 _leaves(params_to_numpy(out[1][1]))):
        err = np.abs(a - b).max() / max(1e-8, np.abs(b).max())
        assert err < 1e-5, (path, err)


def test_training_step_rotates_inside_the_kernel(monkeypatch):
    """The training path's attention takes the RoPE tables inside the
    kernel: a step never calls the outside rotation for q or k (the
    serving path's ``rope_rotate``)."""
    _jcfg, tcfg = _cfgs()

    def outside(*_a, **_k):
        raise AssertionError("rope_rotate ran in a training step")

    monkeypatch.setattr(tgpt, "rope_rotate", outside)
    fns = ttrain.build_gpt_train(tcfg, device="cpu")
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = _to_torch(_jax_batch(4))
    _state, m = fns["step_fn"](state, batch)
    assert np.isfinite(float(m["loss"]))
    # the default attention (no fused RoPE) does rotate outside
    with pytest.raises(AssertionError, match="rope_rotate"):
        tgpt.loss_fn(state.params, batch, tcfg)


@pytest.mark.parametrize("kw, exc, item", [
    pytest.param(dict(mesh=type("Mesh", (), {"size": 4})()), ValueError,
                 "must name its axes", id="kw0-item 9"),
    pytest.param(dict(sp_impl="bogus"), ValueError, "unknown sp_impl",
                 id="kw1-item 9"),
    pytest.param(dict(lora=True), ValueError, "needs base_params",
                 id="kw4-item 11"),
])
def test_unported_training_options_raise(kw, exc, item):
    """Trainable-adapter mode without ``base_params`` raises as the
    reference's does (``tests/test_torch_adapters.py`` trains adapters);
    an unknown ``sp_impl`` raises as the reference does, and so does a
    mesh of several devices without named axes."""
    _jcfg, tcfg = _cfgs()
    with pytest.raises(exc, match=item):
        ttrain.build_gpt_train(tcfg, device="cpu", **kw)


def test_comm_config_and_fallback_dispatch(monkeypatch, capsys):
    """``overlap.comm_config``'s env resolution (aliases, unknown values
    printed and replaced) and ``training.resolve_comm``'s loud gspmd
    fallbacks, as ``tests/test_parallel.py::
    test_comm_config_and_fallback_dispatch`` holds the reference's; the
    multi-device meshes are ``MeshSpec`` shapes here (the gloo worlds of
    ``tests/test_torch_overlap.py`` build the real ones)."""
    from ray_tpu_torch.parallel import overlap as ovl
    from ray_tpu_torch.parallel.mesh import MeshSpec, single_device_mesh

    monkeypatch.setenv("RAY_TPU_COMM", "overlap")
    assert ovl.comm_config(refresh=True).mode == "overlap"
    monkeypatch.setenv("RAY_TPU_COMM", "bogus")
    assert ovl.comm_config(refresh=True).mode == "gspmd"
    assert "RAY_TPU_COMM='bogus' unknown" in capsys.readouterr().err
    monkeypatch.delenv("RAY_TPU_COMM")
    assert ovl.comm_config(refresh=True).mode == "gspmd"
    assert ovl.comm_config(refresh=True).quant == "none"
    for raw, want in (("int8", "int8"), ("dcn", "dcn"), ("off", "none"),
                      ("all", "int8"), ("int4", "none")):
        monkeypatch.setenv("RAY_TPU_COMM_QUANT", raw)
        assert ovl.comm_config(refresh=True).quant == want, raw
    assert "RAY_TPU_COMM_QUANT='int4' unknown" in capsys.readouterr().err
    monkeypatch.delenv("RAY_TPU_COMM_QUANT")
    ovl.comm_config(refresh=True)

    _jcfg, cfg = _cfgs()
    mesh = MeshSpec.create
    # sp mesh: outside the overlap schedule's cover, falls back, says why
    assert "sp" in ovl.overlap_supported(cfg, mesh(dp=2, sp=4))
    assert ttrain.resolve_comm(cfg, mesh(dp=2, sp=4), "overlap") == \
        ("gspmd", "none")
    assert "overlap unsupported (mesh has sp>1" in capsys.readouterr().err
    cfg3 = dataclasses.replace(cfg, d_model=66, n_heads=3)
    assert "n_heads" in ovl.overlap_supported(cfg3, mesh(tp=2))
    assert "d_ff" in ovl.overlap_supported(
        dataclasses.replace(cfg, d_ff=129), mesh(tp=2))
    assert "vocab" in ovl.overlap_supported(
        dataclasses.replace(cfg, vocab_size=511), mesh(tp=2))
    assert "d_model" in ovl.overlap_supported(cfg, mesh(fsdp=3))
    assert "MoE" in ovl.overlap_supported(
        dataclasses.replace(cfg, n_experts=2), mesh(fsdp=2))
    assert ovl.overlap_supported(cfg, mesh(fsdp=4, tp=2)) is None
    assert ttrain.resolve_comm(cfg, mesh(fsdp=4, tp=2), "overlap",
                               "int8") == ("overlap", "int8")
    # one device: nothing to schedule, silently
    for one in (None, single_device_mesh()):
        assert ttrain.resolve_comm(cfg, one, "overlap") == ("gspmd", "none")
    assert capsys.readouterr().err == ""
    fns1 = ttrain.build_gpt_train(cfg, single_device_mesh(),
                                  comm_mode="overlap", device="cpu",
                                  telemetry=False)
    assert (fns1["comm_mode"], fns1["comm_quant"]) == ("gspmd", "none")
    # accumulation and adapters fall back loudly
    assert ttrain.resolve_comm(cfg, mesh(fsdp=4), "overlap",
                               accum_steps=2) == ("gspmd", "none")
    assert "accum_steps=2" in capsys.readouterr().err
    assert ttrain.resolve_comm(cfg, mesh(fsdp=4), "overlap",
                               lora=True) == ("gspmd", "none")
    assert "trainable-adapter" in capsys.readouterr().err
    # the wire needs the overlap schedule: dropped loudly under gspmd
    # (asked for or fallen back to)
    assert ttrain.resolve_comm(cfg, mesh(fsdp=4, tp=2), "gspmd",
                               "int8") == ("gspmd", "none")
    assert "comm_quant=int8 needs the overlap schedule" in \
        capsys.readouterr().err
    assert ttrain.resolve_comm(cfg, mesh(dp=2, sp=4), "overlap",
                               "dcn") == ("gspmd", "none")
    fns2 = ttrain.build_gpt_train(cfg, comm_mode="gspmd", comm_quant="int8",
                                  device="cpu", telemetry=False)
    assert (fns2["comm_mode"], fns2["comm_quant"]) == ("gspmd", "none")
    with pytest.raises(ValueError, match="comm_quant"):
        ttrain.build_gpt_train(cfg, comm_mode="overlap", comm_quant="fp8",
                               device="cpu")
    with pytest.raises(ValueError, match="comm_mode"):
        ttrain.build_gpt_train(cfg, comm_mode="zero", device="cpu")
    # the env reaches build_gpt_train through comm_config
    monkeypatch.setenv("RAY_TPU_COMM_QUANT", "all")
    ovl.comm_config(refresh=True)
    try:
        assert ttrain.resolve_comm(cfg, mesh(fsdp=4), "overlap") == \
            ("overlap", "int8")
    finally:
        monkeypatch.delenv("RAY_TPU_COMM_QUANT")
        ovl.comm_config(refresh=True)


def test_remat_step_matches_jax_remat():
    """``cfg.remat`` (each block under ``torch.utils.checkpoint``)
    against the JAX package's ``remat=True`` loss (``jax.checkpoint`` on
    the scanned block): the loss within 1e-5 relative and each gradient
    leaf within 1e-4 of its largest value (tests/test_models.py:177)."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, remat=True)
    tcfg = dataclasses.replace(tcfg, remat=True)
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _jax_batch(5)
    jattn = JA.make_flash_attention_fn(mesh, causal=True,
                                       rope_theta=jcfg.rope_theta)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, batch, jcfg, attn_fn=jattn,
                               mesh=mesh))(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    fns = ttrain.build_gpt_train(tcfg, device="cpu", telemetry=False)
    tloss, tgrads = ttrain.value_and_grad(
        lambda p, b: tgpt.loss_fn(p, b, tcfg, attn_fn=fns["attn_fn"]),
        tparams, _to_torch(batch))
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    jl = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    tl = dict(_leaves(params_to_numpy(tgrads)))
    for path, want in jl.items():
        err = np.abs(tl[path] - want).max() / max(1e-8, np.abs(want).max())
        assert err < 1e-4, (path, err)


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms`` for one test: the
    embedding's backward (a scatter-add over repeated tokens) otherwise
    sums in an order that may change from one call to the next, which
    moves the embedding's gradient by an ulp between two runs of the
    same step."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("norm_kernel", [False, True])
def test_remat_step_equals_the_plain_step(norm_kernel, monkeypatch,
                                          deterministic):
    """The remat step recomputes the same kernels on the same inputs:
    its loss, every gradient and the post-step parameters equal the
    non-remat step's bit for bit (``torch.equal``), with the RMSNorm
    kernels' path on too.  The recompute runs each block's forward
    kernels once more (the attention forward twice per layer)."""
    from ray_tpu_torch.ops import attention as TA_
    monkeypatch.setattr(tgpt, "_PALLAS_NORM", norm_kernel)
    calls = {"n": 0}
    real = TA_.FlashAttention.forward

    def counting(ctx, *a, **k):
        calls["n"] += 1
        return real(ctx, *a, **k)

    monkeypatch.setattr(TA_.FlashAttention, "forward",
                        staticmethod(counting))
    _jcfg, tcfg = _cfgs()
    batch = _to_torch(_jax_batch(6))
    out = {}
    for remat in (False, True):
        calls["n"] = 0
        cfg = dataclasses.replace(tcfg, remat=remat)
        fns = ttrain.build_gpt_train(cfg, device="cpu", telemetry=False)
        state = fns["init_fn"](torch.Generator().manual_seed(0))
        loss, grads = ttrain.value_and_grad(
            lambda p, b: tgpt.loss_fn(p, b, cfg, attn_fn=fns["attn_fn"]),
            state.params, batch)
        out[remat] = (loss, grads, calls["n"])
        state, _m = fns["step_fn"](state, batch)
        out[remat] += (state.params,)
    assert out[False][2] == tcfg.n_layers
    assert out[True][2] == 2 * tcfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(ttrain._leaves(out[True][1]),
                    ttrain._leaves(out[False][1])):
        assert torch.equal(a, b)
    for a, b in zip(ttrain._leaves(out[True][3]),
                    ttrain._leaves(out[False][3])):
        assert torch.equal(a, b)


def test_remat_pins_the_norm_path_of_its_forward(monkeypatch):
    """A block's recompute takes the path of its forward: flipping
    ``_PALLAS_NORM`` between the forward and the backward changes
    nothing (the RMSNorm Function's forward runs again, not the plain
    norm)."""
    from ray_tpu_torch.ops import rmsnorm as TR
    calls = {"fwd": 0}
    real = TR.rmsnorm_fwd

    def spy(*a, **k):
        calls["fwd"] += 1
        return real(*a, **k)

    monkeypatch.setattr(TR, "rmsnorm_fwd", spy)
    _jcfg, tcfg = _cfgs()
    cfg = dataclasses.replace(tcfg, remat=True)
    params = tgpt.init_params(cfg, device="cpu")
    leaves = [p.requires_grad_(True) for p in ttrain._leaves(params)]
    batch = _to_torch(_jax_batch(7))
    monkeypatch.setattr(tgpt, "_PALLAS_NORM", True)
    loss = tgpt.loss_fn(params, batch, cfg)
    n_fwd = calls["fwd"]
    monkeypatch.setattr(tgpt, "_PALLAS_NORM", False)
    loss.backward()
    assert n_fwd == cfg.n_layers and calls["fwd"] == 2 * n_fwd
    assert all(p.grad is not None for p in leaves)


def test_schedule_matches_optax():
    """The hand-written warmup-cosine schedule against optax's."""
    import optax
    kw = dict(lr=1e-3, warmup=2, total_steps=8)
    ours = ttrain.default_optimizer(**kw)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 8, 1e-4)
    for count in range(12):
        assert ours.schedule(count) == pytest.approx(float(ref(count)),
                                                     rel=1e-6, abs=1e-12)


def test_flops_match_jax():
    """The analytic FLOP count is the reference's; the MFU figure is
    against the H100's dense bf16 peak."""
    jcfg = jgpt.GPTConfig.gpt2(vocab_size=50304, max_seq=1024, ce_chunk=-1)
    tcfg = tgpt.GPTConfig.gpt2(vocab_size=50304, max_seq=1024, ce_chunk=-1)
    for ce in (True, False):
        assert tflops.gpt_train_flops_per_token(
            tcfg, 1024, ce_recompute=ce) == jflops.gpt_train_flops_per_token(
            jcfg, 1024, ce_recompute=ce)
    assert tflops.gpt_fwd_flops_per_token(tcfg, 512) == \
        jflops.gpt_fwd_flops_per_token(jcfg, 512)
    assert tflops.mfu(1e5, 1e9) == pytest.approx(1e14 / 989e12)


def test_synthetic_lm_batch_shifts_targets():
    g = torch.Generator().manual_seed(0)
    batch = ttrain.synthetic_lm_batch(g, 2, 16, 100, device="cpu")
    assert batch["tokens"].shape == batch["targets"].shape == (2, 16)
    assert torch.equal(batch["tokens"][:, 1:], batch["targets"][:, :-1])
    assert int(batch["tokens"].max()) < 100


def test_fused_rope_attention_refuses_a_cache():
    """A cache stores post-RoPE keys, which a fused-RoPE attention never
    sees (the reference raises the same way, models/gpt.py:400-405)."""
    _jcfg, tcfg = _cfgs()
    params = tgpt.init_params(tcfg, device="cpu")
    x = torch.zeros(1, 4, tcfg.d_model)
    attn = TA.make_flash_attention_fn(rope_theta=tcfg.rope_theta)
    with pytest.raises(ValueError, match="post-RoPE"):
        tgpt.layer_apply(tgpt.layer_params(params, 0), x, tcfg,
                         positions=torch.arange(4), attn_fn=attn,
                         cache=object())


@pytest.mark.parametrize("raw", [None, "gpipe", "1f1b", " 1F1B ", "zb-h1",
                                 ""])
def test_pp_schedule_env_matches_jax(raw, monkeypatch, capsys):
    """``RAY_TPU_PP_SCHEDULE``: the same schedule as the JAX package's
    ``default_pp_schedule`` (default gpipe; an unknown name falls back to
    gpipe) and the same stderr warning."""
    if raw is None:
        monkeypatch.delenv("RAY_TPU_PP_SCHEDULE", raising=False)
    else:
        monkeypatch.setenv("RAY_TPU_PP_SCHEDULE", raw)
    got = ttrain.default_pp_schedule()
    got_err = capsys.readouterr().err
    want = jtrain.default_pp_schedule()
    assert got == want
    assert got_err == capsys.readouterr().err


@pytest.mark.parametrize("raw", [None, "", "4", " 8 ", "0", "-2", "x",
                                 "2.5"])
def test_pp_microbatch_env_matches_jax(raw, monkeypatch, capsys):
    """``RAY_TPU_PP_MICROBATCH``: the same count as the JAX package's
    ``default_pp_microbatches`` (unset, non-integers and counts below 1
    give None, the latter two with a warning) and the same stderr; the
    trainer falls back to ``2 * stages``."""
    if raw is None:
        monkeypatch.delenv("RAY_TPU_PP_MICROBATCH", raising=False)
    else:
        monkeypatch.setenv("RAY_TPU_PP_MICROBATCH", raw)
    got = ttrain.default_pp_microbatches()
    got_err = capsys.readouterr().err
    want = jtrain.default_pp_microbatches()
    assert got == want
    assert got_err == capsys.readouterr().err
    if raw in ("x", "0"):
        assert got_err
    from ray_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setenv("RAY_TPU_PP_SCHEDULE", "1f1b")
    _jcfg, cfg = _cfgs()
    fns = ttrain.build_gpt_train_pp(cfg, make_mesh(pp=1), device="cpu",
                                    telemetry=False)
    assert fns["schedule"] == "1f1b"
    assert fns["num_microbatches"] == (want or 2)
