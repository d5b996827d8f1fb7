"""Port parity: ``ray_tpu_torch.ops.rmsnorm`` against ``ray_tpu.ops.rmsnorm``.

The same numpy inputs go through the JAX ``rmsnorm`` (its Pallas forward
and backward in interpret mode) and the port's, which on a CPU tensor
runs the plain versions through the same ``autograd.Function`` the card
runs.  The cotangent is ``cos(y)``, the gradient of ``sum(sin(y))``, as
``tests/test_ops.py:386`` takes it.

Tolerances:
- f32: both sides compute in f32 and differ only in summation order;
  y and dx within 1e-5, ds (a sum over the 80 rows) within 1e-5 of its
  largest value.
- bf16: the JAX suite's own bounds (``tests/test_ops.py:405,420``): y
  within 1e-2, each gradient within 2e-2 of its largest value.  Both
  sides round y and dx to bf16 once, from f32 values that agree to ~1e-6,
  so a rounding-point fault (bf16 statistics, dx rounded before the
  subtraction) shows well above the noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import rmsnorm as JR
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import rmsnorm as TR

SHAPE = (2, 40, 128)


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    return x, s


def _jax(x, s, dtype):
    def loss(x, s):
        return jnp.sum(jnp.sin(JR.rmsnorm(x, s).astype(jnp.float32)))

    jx, js = jnp.asarray(x).astype(dtype), jnp.asarray(s).astype(dtype)
    y = JR.rmsnorm(jx, js)
    dx, ds = jax.grad(loss, argnums=(0, 1))(jx, js)
    return [np.asarray(a.astype(jnp.float32)) for a in (y, dx, ds)]


def _port(x, s, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    ts = torch.from_numpy(s).to(dtype).requires_grad_(True)
    y = TR.rmsnorm(tx, ts)
    y.float().sin().sum().backward()
    assert tx.grad.dtype == dtype and ts.grad.dtype == dtype
    return [a.detach().float().numpy() for a in (y, tx.grad, ts.grad)]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_fwd_bwd_matches_jax(dtype):
    x, s = _inputs(0)
    want = _jax(x, s, getattr(jnp, dtype))
    got = _port(x, s, getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
        assert _rel(got[2], want[2]) < 1e-5
    else:
        assert np.abs(got[0] - want[0]).max() < 1e-2
        assert _rel(got[1], want[1]) < 2e-2
        assert _rel(got[2], want[2]) < 2e-2


def test_plain_rstd_is_a_row_vector():
    """rstd is [N] f32 (the TPU kernel's [N, 128] lane broadcast does not
    port), equal to the JAX forward's first lane."""
    x, s = _inputs(1)
    x2 = x.reshape(-1, SHAPE[-1])
    _y, want = JR._run_fwd(jnp.asarray(x2), jnp.asarray(s), 1e-6)
    _y, got = TR.plain_rmsnorm_fwd(torch.from_numpy(x2), torch.from_numpy(s))
    assert got.shape == (x2.shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                               rtol=1e-6)


def test_model_norm_takes_the_kernel_path_when_flagged(monkeypatch):
    """``gpt._norm`` reads ``_PALLAS_NORM`` at call time and then goes
    through ``ops.rmsnorm.rmsnorm``; off, it never does."""
    calls = []
    real = TR.rmsnorm

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(TR, "rmsnorm", spy)
    x = torch.from_numpy(_inputs(2)[0])
    s = torch.ones(SHAPE[-1])
    off = tgpt._norm(x, s, "rmsnorm")
    assert calls == []
    monkeypatch.setattr(tgpt, "_PALLAS_NORM", True)
    on = tgpt._norm(x, s, "rmsnorm")
    assert calls == [x.shape]
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=1e-6)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("d, ok", [(768, True), (64, True), (1024, True),
                                   (1280, True), (512, False),
                                   (1536, False)])
def test_cuda_gate_declines_unbuilt_widths(d, ok):
    """On a CUDA device the RMSNorm gate takes the widths the kernels are
    built for (the d_model of tiny, gpt2, gpt2_medium and gpt2_large) and
    raises for the rest, naming the ROADMAP item; the CPU's plain
    versions take any width."""
    if ok:
        assert TR.supports(d, device=CUDA)
    else:
        with pytest.raises(NotImplementedError, match="Queue 2 item A"):
            TR.supports(d, device=CUDA)
    assert TR.supports(d, device="cpu") and TR.supports(d)


def test_cuda_gate_and_wrapper_check_agree():
    """The wrappers' check is ``supports`` on the operand's device: on a
    card it passes exactly ``_KERNEL_WIDTHS`` and raises for the rest."""
    import inspect

    assert "supports(d, device=x.device)" in inspect.getsource(
        TR._check_kernel_args)
    for d in range(64, 2049, 64):
        if d in TR._KERNEL_WIDTHS:
            assert TR.supports(d, device=CUDA)
        else:
            with pytest.raises(NotImplementedError, match="Queue 2 item A"):
                TR.supports(d, device=CUDA)


@pytest.mark.parametrize("d", [64, 1024, 1280])
def test_rmsnorm_matches_jax_at_model_widths(d):
    """The plain forward and backward the kernels are held to on the card,
    at the other widths they are built for (tiny's, gpt2_medium's,
    gpt2_large's), against the Pallas rmsnorm and ``jax.grad`` in f32."""
    x, s = _inputs(d, (2, 24, d))
    want = _jax(x, s, jnp.float32)
    got = _port(x, s, torch.float32)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
    assert _rel(got[2], want[2]) < 1e-5
