"""Port parity: ``ray_tpu_torch.ops.fused_norm`` against the JAX package.

The JAX side is the Pallas ``matmul_residual_norm`` kernel in interpret
mode; the port side, on CPU tensors, is the plain version the CUDA
kernel is held against on the card.  f32 on both sides; they differ only
in the matmul's summation order (K = 128 terms of O(1)), ~1e-6, so the
JAX suite's 2e-5 holds with margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import fused_norm as JF
from ray_tpu_torch.ops import fused_norm as TF

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("N", [48, 256])
def test_matmul_residual_norm_matches_jax(N):
    K = d = 128
    rng = np.random.default_rng(N)
    a = rng.standard_normal((N, K)).astype(np.float32)
    w = (rng.standard_normal((K, d)) * K ** -0.5).astype(np.float32)
    resid = rng.standard_normal((N, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jargs = [jnp.asarray(x) for x in (a, w, resid, scale)]
    r_j, y_j = JF.matmul_residual_norm(*jargs)
    _r, _y, rstd_j = JF._run_fwd(*jargs, 1e-6, 256)
    r_t, y_t, rstd_t = TF.matmul_residual_norm_fwd(
        *(torch.from_numpy(x) for x in (a, w, resid, scale)))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), **TOL)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(rstd_t.numpy(), np.asarray(rstd_j), **TOL)


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
