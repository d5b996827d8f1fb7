"""Port parity: the bf16-resident-logits CE (``ops/fused_ce.py``,
``ce_mode="fused"``) against the JAX package's ``ray_tpu.ops.fused_ce``.

Both sides round the logits to bf16 whatever the input dtype, so in f32
the inputs are small multiples of powers of two (x in eighths, the head
in 64ths, d = 64): every product and partial sum of the logits matmul is
exact in f32, both libraries get the same bf16 logits, and what is left
is the f32 summation order of lse, the loss and the two gradient
matmuls.  Tolerances:

- f32: the loss within 1e-5 relative; dx and dhead within 1e-5 of each
  tensor's largest value (a dlogits entry that rounds to the other side
  of a bf16 step moves one term of a row by ~2^-8 of that entry, ~1e-6
  of the row's largest value here).
- bf16 (inputs and the gradients' dtype bf16): the loss within 2^-7
  relative; each gradient element within 2^-7 of its value plus 2^-5 of
  its row's rms (one bf16 rounding of the result, and the rounded
  dlogits' error summed along the row).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtrain
from ray_tpu.ops import fused_ce as jfc
from ray_tpu.parallel.mesh import make_mesh
from ray_tpu_torch.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.ops import fused_ce as tfc

N, D, V = 96, 64, 512


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "f32":
        x = rng.integers(-8, 9, (N, D)) / 8.0
        head = rng.integers(-8, 9, (D, V)) / 64.0
    else:
        x = rng.standard_normal((N, D))
        head = rng.standard_normal((D, V)) * D ** -0.5
    targets = rng.integers(0, V, N)
    targets[rng.random(N) < 0.2] = -1            # masked rows
    return x.astype(np.float32), head.astype(np.float32), \
        targets.astype(np.int32)


def _jax(x, head, targets, dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16

    def f(x_, h_):
        s, n = jfc.ce_sum_bf16(x_, h_, jnp.asarray(targets))
        return s, n

    (s, n), vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(head, jdt))
    dx, dh = vjp((jnp.float32(1.0), jnp.float32(0.0)))
    return (float(s), float(n), np.asarray(dx.astype(jnp.float32)),
            np.asarray(dh.astype(jnp.float32)))


def _torch(x, head, targets, dtype):
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ht = torch.from_numpy(head).to(tdt).requires_grad_(True)
    s, n = tfc.ce_sum_bf16(xt, ht, torch.from_numpy(targets).long())
    s.backward()
    assert xt.grad.dtype == tdt and ht.grad.dtype == tdt
    return (float(s.detach()), float(n), xt.grad.float().numpy(),
            ht.grad.float().numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_ce_f32_matches_jax(seed):
    x, head, targets = _inputs(seed, "f32")
    js, jn, jdx, jdh = _jax(x, head, targets, "f32")
    ts, tn, tdx, tdh = _torch(x, head, targets, "f32")
    assert tn == jn == float((targets >= 0).sum())
    assert ts == pytest.approx(js, rel=1e-5)
    for got, want in ((tdx, jdx), (tdh, jdh)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.all(tdx[targets < 0] == 0)         # masked rows: no gradient


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_ce_bf16_matches_jax(seed):
    x, head, targets = _inputs(seed, "bf16")
    js, jn, jdx, jdh = _jax(x, head, targets, "bf16")
    ts, tn, tdx, tdh = _torch(x, head, targets, "bf16")
    assert tn == jn
    assert ts == pytest.approx(js, rel=2 ** -7)
    for got, want in ((tdx, jdx), (tdh, jdh)):
        rms = np.sqrt(np.mean(want.astype(np.float64) ** 2, axis=1,
                              keepdims=True))
        bound = 2 ** -7 * np.abs(want) + 2 ** -5 * rms
        assert np.all(np.abs(got - want) <= bound)


def test_fused_ce_row_blocks_change_nothing(monkeypatch):
    """The row passes run over blocks of ``_ROWS``: a block smaller than
    N (with a ragged last block) gives bit-identical results."""
    x, head, targets = _inputs(3, "bf16")
    full = _torch(x, head, targets, "bf16")
    monkeypatch.setattr(tfc, "_ROWS", 40)
    blocked = _torch(x, head, targets, "bf16")
    assert full[:2] == blocked[:2]
    for a, b in zip(full[2:], blocked[2:]):
        assert np.array_equal(a, b)


def test_chunked_ce_routes_fused_mode():
    """``_chunked_ce(mode="fused")`` takes the bf16-resident CE on the
    no-remat path (chunk < 0) and the dense chunks otherwise, as the
    reference does (``models/gpt.py:_chunked_ce``)."""
    x, head, targets = _inputs(4, "f32")
    xt, ht = torch.from_numpy(x), torch.from_numpy(head)
    tt = torch.from_numpy(targets).long()
    fused = tgpt._chunked_ce(xt, ht, tt, chunk=-1, mode="fused")
    direct = tfc.ce_sum_bf16(xt, ht, tt)
    assert torch.equal(fused[0], direct[0])
    dense = tgpt._chunked_ce(xt, ht, tt, chunk=32, mode="fused")
    xla = tgpt._chunked_ce(xt, ht, tt, chunk=32, mode="xla")
    assert torch.equal(dense[0], xla[0])


def test_fused_ce_step_matches_jax():
    """The whole training step with ``ce_mode="fused"`` (a 2-layer f32
    GPT, ``ce_chunk=-1``): loss within 1e-5 relative and each gradient
    leaf within 1e-4 of its largest value against the JAX package's
    ``loss_fn(ce_mode="fused")``, and two optimizer steps' losses."""
    small = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
                 max_seq=64, ce_chunk=-1)
    jcfg = jgpt.GPTConfig(**small, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**small, dtype=torch.float32)
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    batch = jtrain.synthetic_lm_batch(jax.random.PRNGKey(1), 2, 64, 512)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, batch, jcfg, mesh=mesh,
                               ce_mode="fused"))(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tloss, tgrads = ttrain.value_and_grad(
        lambda p, b: tgpt.loss_fn(p, b, tcfg, ce_mode="fused"),
        tparams, tbatch)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    tl = params_to_numpy(tgrads)
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jgrads)):
        got = tl
        for k in path:
            got = got[k.key]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), path
    tfns = ttrain.build_gpt_train(dataclasses.replace(tcfg), device="cpu",
                                  ce_mode="fused", telemetry=False)
    jfns = jtrain.build_gpt_train(jcfg, mesh, ce_mode="fused",
                                  telemetry=False)
    jstate = jfns["init_fn"](jax.random.PRNGKey(0))
    tstate = tfns["init_fn"](params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params), tcfg, device="cpu"))
    for _ in range(2):
        jstate, jm = jfns["step_fn"](jstate, batch)
        tstate, tm = tfns["step_fn"](tstate, tbatch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
