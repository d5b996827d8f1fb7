"""Port parity: ``ray_tpu_torch.ops.attention`` against the JAX package.

The same numpy inputs go through the JAX function (its Pallas kernels
in interpret mode, as ``tests/test_ops.py`` runs them on the CPU) and
the port's counterpart, which on a CPU tensor is the plain version the
CUDA kernel is held against on the card.

Tolerance: both sides compute in f32 and differ only in summation
order, which moves O(1) outputs by ~1e-6.  2e-5 (the JAX suite's own
kernel-vs-einsum bound) leaves an order of margin and still catches a
wrong mask or rounding point, which moves outputs by 1e-3 or more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as JA
from ray_tpu_torch.ops import attention as TA

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope_rotate_matches_jax(batched_positions):
    """RoPE at [S] (prefill) and [B, S] (decode) positions.  Angles
    reach ~255 rad here, where one f32 ulp of the angle is ~1.5e-5, so
    the rotation is held to 1e-4."""
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 16, 3, 64)
    pos = (rng.integers(0, 256, (2, 16)) if batched_positions
           else np.arange(16) + 200).astype(np.int32)
    want = JA.rope_rotate(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TA.rope_rotate(torch.from_numpy(x), torch.from_numpy(pos),
                         10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", [
    (1, 128, 2, 64),    # JAX takes its pack2 kernel (D=64, even heads)
    (2, 128, 3, 32),    # JAX takes its unpacked _fwd kernel
    (1, 40, 2, 64),     # a ragged bucket: JAX falls back to einsum
])
def test_flash_attention_matches_jax(shape):
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True)
    got = TA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_fwd_lse():
    """The kernel's second output, the row logsumexp kept for the
    backward, against a numpy computation of the same scores."""
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, 1, 64, 2, 32) for _ in range(3))
    _o, lse = TA.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=32 ** -0.5)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * 32 ** -0.5
    s = np.where(np.tril(np.ones((64, 64), bool)), s, -np.inf)
    m = s.max(-1)
    want = m + np.log(np.exp(s - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, **TOL)


def _decode_inputs(rng):
    B, S, H, D = 3, 256, 2, 64
    q = _rand(rng, B, H, D)
    k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, H, D)
    lengths = np.array([1, 100, 256], np.int32)
    return q, k, v, lengths


def test_decode_attention_matches_jax_pallas():
    """Ragged lengths including 1 and the full context."""
    q, k, v, lengths = _decode_inputs(np.random.default_rng(3))
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lengths),
                               impl="pallas")
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_ignores_nan_garbage():
    """Positions at or past a row's length hold garbage (the garbage
    page, padded tails).  Filled with NaN on the port side, the output
    stays finite and equal to the JAX kernel's on clean inputs."""
    q, k, v, lengths = _decode_inputs(np.random.default_rng(4))
    # jnp.asarray may share the numpy buffers and JAX runs async: finish
    # the clean-input reference before any NaN is written, and write
    # the NaN into copies
    want = np.asarray(JA.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        impl="pallas"))
    dead = np.arange(k.shape[1])[None, :] >= lengths[:, None]
    k, v = k.copy(), v.copy()
    k[dead], v[dead] = np.nan, np.nan
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              torch.from_numpy(lengths))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
