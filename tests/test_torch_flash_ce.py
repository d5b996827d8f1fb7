"""Port parity: ``ray_tpu_torch.ops.flash_ce`` against the JAX package.

The JAX side is ``ray_tpu.ops.flash_ce`` with its Pallas kernels in
interpret mode (small blocks, as ``tests/test_ops.py`` runs them); the
port side, on CPU tensors, is the autograd.Function the card runs, with
the plain bodies the CUDA kernels are held against.

Tolerance: f32 on both sides.  The loss is a sum of N log-sum-exps over
V logits, held to 1e-5 of itself; each gradient to 1e-4 of its own
largest value (the JAX suite's grad bound, tests/test_ops.py:545).  dhead
sums N rows and dx sums V columns, so summation order moves them by
~1e-6 of their scale, while a wrong mask, a leaked padded column or a
missing rounding point moves them by 1e-3 or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_ce as JC
from ray_tpu_torch.ops import flash_ce as TC

BLOCKS = dict(block_n=128, block_v=256, bwd_block_n=128, bwd_block_v=256)


def _inputs(N, d, V, seed, masked="some"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, d)).astype(np.float32)
    head = (rng.standard_normal((d, V)) * 0.05).astype(np.float32)
    tgt = rng.integers(0, V, N).astype(np.int32)
    if masked == "some":
        tgt[::5] = -1
    elif masked == "all":
        tgt[:] = -1
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, head, tgt, scale


def _run_jax(x, head, tgt, scale, norm):
    def f(x, head, scale):
        if norm:
            s, n = JC.flash_ce_norm_sum(x, head, jnp.asarray(tgt), scale,
                                        eps=1e-6, **BLOCKS)
        else:
            s, n = JC.flash_ce_sum(x, head, jnp.asarray(tgt), **BLOCKS)
        return s / jnp.maximum(n, 1.0), n

    (loss, n), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(a) for a in (x, head, scale)))
    return float(loss), float(n), [np.asarray(g) for g in grads]


def _run_port(x, head, tgt, scale, norm):
    xt, ht, st = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, head, scale))
    if norm:
        s, n = TC.flash_ce_norm_sum(xt, ht, torch.from_numpy(tgt), st,
                                    eps=1e-6)
    else:
        s, n = TC.flash_ce_sum(xt, ht, torch.from_numpy(tgt))
    loss = s / n.clamp_min(1.0)
    loss.backward()
    grads = [t.grad.numpy() if t.grad is not None else np.zeros(t.shape,
                                                                np.float32)
             for t in (xt, ht, st)]
    return float(loss.detach()), float(n), grads


@pytest.mark.parametrize("N, d, V, norm", [
    (256, 128, 512, False),    # exact tiles
    (200, 128, 1000, False),   # ragged rows, V not a multiple of 128
    (64, 256, 384, True),      # d = 256, the norm prologue
    (200, 128, 1000, True),    # the prologue on ragged rows and vocab
])
def test_flash_ce_matches_jax(N, d, V, norm):
    x, head, tgt, scale = _inputs(N, d, V, seed=N + V)
    assert TC.supports(N, d, V) and JC.supports(N, d, V)
    lj, nj, gj = _run_jax(x, head, tgt, scale, norm)
    lt, nt, gt = _run_port(x, head, tgt, scale, norm)
    assert nt == nj == float((tgt >= 0).sum())
    assert lt == pytest.approx(lj, rel=1e-5)
    names = ["dx", "dhead"] + (["dscale"] if norm else [])
    for name, got, want in zip(names, gt, gj):
        err = np.abs(got - want).max() / max(1e-8, np.abs(want).max())
        assert err < 1e-4, (name, err)


@pytest.mark.parametrize("norm", [False, True])
def test_flash_ce_all_masked(norm):
    """Every target -1 (test_ops.py:628, :951): zero loss, zero count
    and zero gradients, with no NaN from the empty normalisation, on
    both sides."""
    x, head, tgt, scale = _inputs(64, 128, 384, seed=7, masked="all")
    lj, nj, gj = _run_jax(x, head, tgt, scale, norm)
    lt, nt, gt = _run_port(x, head, tgt, scale, norm)
    assert lt == lj == 0.0 and nt == nj == 0.0
    for got, want in zip(gt, gj):
        assert np.isfinite(got).all()
        assert np.abs(got).max() == 0.0 and np.abs(want).max() == 0.0


def test_flash_ce_kernel_plain_versions_match_dense():
    """The forward kernel's plain version gives the dense formulation's
    statistics, and the backward's plain version its gradients, with the
    head in the kernel's [V, d] layout (what the card's kernels read)."""
    x, head, tgt, _ = _inputs(96, 128, 300, seed=3)
    xt, wt, tt = (torch.from_numpy(x), torch.from_numpy(head.T.copy()),
                  torch.from_numpy(tgt))
    lse, true = TC.plain_flash_ce_fwd(xt, wt, tt)
    logits = x @ head
    m = logits.max(-1)
    want = m + np.log(np.exp(logits - m[:, None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)
    live = tgt >= 0
    np.testing.assert_allclose(true.numpy()[live],
                               logits[live, tgt[live]], atol=1e-5)
    assert (true.numpy()[~live] == 0).all()


@pytest.mark.parametrize("kw, ok, fragment", [
    ({}, True, "prologue"),
    (dict(enabled=False), False, "fuse_norm"),
    (dict(mode="xla"), False, "declined"),
    (dict(norm="layernorm"), False, "only rmsnorm"),
    (dict(has_bias=True), False, "bias"),
    (dict(n_devices=2), False, "declined"),
])
def test_uses_flash_ce_norm_matches_jax_gate(kw, ok, fragment):
    """The port's gate takes the JAX gate's arguments (with ``enabled``
    pinned, as the model passes it) and reaches the same verdict."""
    args = (2048, 768, 50304)
    want = JC.uses_flash_ce_norm(*args, **{"enabled": True, **kw})
    got = TC.uses_flash_ce_norm(*args, **kw)
    assert bool(got) == bool(want) == ok
    assert fragment in got.reason


def test_flash_ce_declined_shape_takes_the_dense_path():
    """d % 128 != 0: both packages fall back to the dense formulation."""
    x, head, tgt, _ = _inputs(64, 96, 256, seed=6)
    assert not TC.supports(64, 96, 256)
    s, n = TC.flash_ce_sum(*(torch.from_numpy(a) for a in (x, head, tgt)))
    s_j, n_j = JC._xla_ce_sum(*(jnp.asarray(a) for a in (x, head, tgt)))
    assert float(n) == float(n_j)
    assert float(s) == pytest.approx(float(s_j), rel=1e-5)
