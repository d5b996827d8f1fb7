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


@pytest.mark.parametrize("kw, item", [
    (dict(mesh=type("Mesh", (), {"size": 4})()), "item 9"),
    (dict(sp_impl="ring"), "item 9"),
    (dict(comm_mode="overlap"), "item 9"),
    (dict(comm_quant="int8"), "item 9"),
    (dict(lora=True), "item 11"),
    (dict(telemetry=True), "item 7"),
])
def test_unported_training_options_raise(kw, item):
    _jcfg, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match=item):
        ttrain.build_gpt_train(tcfg, device="cpu", **kw)


def test_remat_and_fused_ce_raise():
    _jcfg, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="remat"):
        ttrain.build_gpt_train(dataclasses.replace(tcfg, remat=True),
                               device="cpu")
    x = torch.zeros(8, 96)
    with pytest.raises(NotImplementedError, match="fused"):
        tgpt._chunked_ce(x, torch.zeros(96, 64), torch.zeros(8).long(),
                         chunk=-1, mode="fused")


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
