"""Port parity: ``ray_tpu_torch.ops.fused_norm`` against the JAX package.

The JAX side is the Pallas ``matmul_residual_norm`` kernel in interpret
mode; the port side, on CPU tensors, is the plain version the CUDA
kernel is held against on the card.  f32 on both sides; they differ only
in the matmul's summation order (K = 128 terms of O(1)), ~1e-6, so the
JAX suite's 2e-5 holds with margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import fused_norm as JF
from ray_tpu_torch.ops import fused_norm as TF

TOL = dict(atol=2e-5, rtol=2e-5)


def _check_fwd(N, K, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, K)).astype(np.float32)
    w = (rng.standard_normal((K, d)) * K ** -0.5).astype(np.float32)
    resid = rng.standard_normal((N, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jargs = [jnp.asarray(x) for x in (a, w, resid, scale)]
    r_j, y_j = JF.matmul_residual_norm(*jargs)
    _r, _y, rstd_j = JF._run_fwd(*jargs, 1e-6, 256)
    r_t, y_t, rstd_t = TF.matmul_residual_norm_fwd(
        *(torch.from_numpy(x) for x in (a, w, resid, scale)))
    assert r_t.shape == y_t.shape == (N, d) and rstd_t.shape == (N,)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), **TOL)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(rstd_t.numpy(), np.asarray(rstd_j), **TOL)


# N = 1, 63 and 65: one row, and one short of and one past the bf16
# kernel's 64-row block, whose ragged rows the plain version must agree
# on as the card's kernel is held to it
@pytest.mark.parametrize("N", [48, 256, 1, 63, 65])
def test_matmul_residual_norm_matches_jax(N):
    _check_fwd(N, 128, 128, N)


@pytest.mark.parametrize("kw, shape, fragment", [
    (dict(seq=2), (16, 128, 128), ""),
    (dict(norm="layernorm"), (128, 128, 128), "only rmsnorm"),
    (dict(has_bias=True), (128, 128, 128), "bias"),
    (dict(seq=1), (8, 128, 128), "decode step"),
    ({}, (128, 96, 128), "K=96"),
    ({}, (128, 128, 192), "d=192"),
    ({}, (128, 1664, 128), "cap 1536"),
    ({}, (0, 128, 128), "no rows"),
    ({}, (128, 768, 768), ""),
])
def test_out_proj_norm_plan_matches_jax_gate(kw, shape, fragment):
    """The port's gate reaches the JAX gate's verdict for the same
    inputs, for the same stated reason.  The port's gate has no knob
    (the JAX one's is pinned on)."""
    base = dict(norm="rmsnorm", has_bias=False, seq=64)
    want = JF.out_proj_norm_plan(*shape, n_devices=1, enabled=True,
                                 **{**base, **kw})
    got = TF.out_proj_norm_plan(*shape, **{**base, **kw})
    assert bool(got) == bool(want), (got, want)
    assert fragment in got.reason and fragment in want.reason


def test_out_proj_norm_plan_ignores_the_jax_knob(monkeypatch):
    """``RAY_TPU_FUSE_NORM=0`` turns off the JAX package's epilogue; it
    does not reach the port's kernel."""
    monkeypatch.setenv("RAY_TPU_FUSE_NORM", "0")
    assert TF.out_proj_norm_plan(128, 768, 768, seq=64)


def test_matmul_residual_norm_rejects_untileable():
    with pytest.raises(ValueError, match="cannot tile"):
        TF.matmul_residual_norm(torch.zeros(8, 96), torch.zeros(96, 128),
                                torch.zeros(8, 128), torch.zeros(128))


def _check_grads(N, K, d, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((N, K)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((K, d)) * K ** -0.5).astype(np.float32)
    resid = rng.standard_normal((N, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    drout = rng.standard_normal((N, d)).astype(np.float32)
    dy = rng.standard_normal((N, d)).astype(np.float32)

    def jfn(a, w, resid, scale):
        return JF.matmul_residual_norm(a, w, resid, scale, block_n=128)

    _out, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (a, w, resid, scale)))
    want = vjp((jnp.asarray(drout), jnp.asarray(dy)))
    args = [torch.from_numpy(x).requires_grad_(True)
            for x in (a, w, resid, scale)]
    r, y = TF.matmul_residual_norm(*args)
    torch.autograd.backward([r, y], [torch.from_numpy(drout),
                                     torch.from_numpy(dy)])
    for name, t, ref in zip("da dw dresid dscale".split(), args, want):
        ref = np.asarray(ref)
        assert t.grad.shape == ref.shape, (name, t.grad.shape, ref.shape)
        err = np.abs(t.grad.numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-4, (name, err)


@pytest.mark.parametrize("N", [64, 200, 1, 65])
def test_matmul_residual_norm_grads_match_jax(N):
    """Every gradient of the fused epilogue (da, dw, dresid, dscale),
    with cotangents into both outputs as in the real block, against the
    JAX custom VJP ``_mrn`` (its Pallas backward in interpret mode, 128-
    row blocks, so N = 200 pads and sums two row-block partials; mirrors
    test_ops.py:849).  N = 1 and 65 are ragged against the card's 64-row
    blocks.  The port side runs the autograd.Function the card runs, with
    the plain bodies.

    Tolerance: each gradient within 1e-4 of its largest value (the JAX
    suite's grad bound); dw and dscale sum N rows, so summation order
    moves them by ~1e-6 of their scale."""
    _check_grads(N, 128, 128, N + 1)


@pytest.mark.parametrize("part", ["forward", "grads"])
def test_matmul_residual_norm_k_ne_d_matches_jax(part):
    """K = 256 against d = 128: a transposed ``w`` (or da and dw taken
    against the wrong side of it) fails to line up or disagrees here,
    where K = d would hide it; the plain versions are what the card's
    kernels are held to."""
    if part == "forward":
        _check_fwd(65, 256, 128, 7)
    else:
        _check_grads(65, 256, 128, 8)


def test_out_proj_norm_plan_takes_fuse_norm():
    off = TF.out_proj_norm_plan(128, 768, 768, seq=64, enabled=False)
    assert not off and "fuse_norm" in off.reason


CUDA = torch.device("cuda")


@pytest.mark.parametrize("d, verdict", [
    (768, "kernel"), (1024, "kernel"), (1280, "kernel"),
    (128, "raise"), (1536, "raise"),     # the JAX gate takes, none built
    (1664, "plain"),                     # the JAX gate declines too
])
def test_cuda_plan_declines_unbuilt_widths(d, verdict):
    """On a CUDA device (constructible without a card) the epilogue's
    gate takes the widths its kernels are built for (gpt2's, gpt2_medium's
    and gpt2_large's), declines what the JAX gate declines, and raises,
    naming the ROADMAP item, for a width the JAX gate takes but no kernel
    is built for: no CUDA tensor goes to the plain epilogue in place of a
    kernel.  On the CPU the JAX gate's verdict stands."""
    def plan(device):
        return TF.out_proj_norm_plan(24576, 768, d, seq=1024, device=device)

    if verdict == "raise":
        with pytest.raises(NotImplementedError, match="Queue 2 item A"):
            plan(CUDA)
    else:
        assert bool(plan(CUDA)) == (verdict == "kernel")
    assert bool(plan("cpu")) == (verdict != "plain")


def test_cuda_gate_and_wrapper_check_agree():
    """The wrappers' CUDA check is ``supports`` on the operands' device,
    so the two cannot disagree: among the widths the JAX gate takes it
    passes exactly those of ``_KERNEL_WIDTHS`` and raises for the rest."""
    for d in range(128, 1537, 128):
        for K in (384, 768, 1536):
            assert TF.supports(4096, K, d)
            if d in TF._KERNEL_WIDTHS:
                assert TF.supports(4096, K, d, device=CUDA)
            else:
                with pytest.raises(NotImplementedError,
                                   match="Queue 2 item A"):
                    TF.supports(4096, K, d, device=CUDA)


def test_layer_apply_asks_the_gate_for_its_device(monkeypatch):
    """The model passes the hidden state's device to the epilogue's gate;
    where that device is a card and no kernel is built for the width
    (d = 128 here), the layer raises rather than run the plain epilogue
    on the card's tensors."""
    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.parallel.ring_attention import local_attention

    seen = []
    gate = TF.out_proj_norm_plan

    def spy(*a, **k):
        seen.append(k.get("device"))
        return gate(*a, **{**k, "device": CUDA})   # as on a card

    def refuse(*_a, **_k):
        raise AssertionError("the fused epilogue was reached")

    cfg = tgpt.GPTConfig(vocab_size=64, d_model=128, n_layers=1, n_heads=2,
                         max_seq=16, dtype=torch.float32)
    params = tgpt.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    tokens = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                           .manual_seed(1))
    monkeypatch.setattr(TF, "out_proj_norm_plan", spy)
    monkeypatch.setattr(TF, "matmul_residual_norm", refuse)
    with pytest.raises(NotImplementedError, match="Queue 2 item A"):
        tgpt.forward(params, tokens, cfg,
                     attn_fn=lambda q, k, v: local_attention(
                         q, k, v, causal=True))
    assert seen == [torch.device("cpu")]
