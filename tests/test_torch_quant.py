"""Port parity: ``ray_tpu_torch.quant`` against ``ray_tpu.quant``.

Codes and scales must be bit-equal, not close: the int8 KV cache shares
prefix pages between requests on the promise that equal content gives
equal codes, and the two packages' engines are compared token for token
over caches written by these functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import quant as JQ
from ray_tpu_torch import quant as TQ


def _cases():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6, 128)).astype(np.float32) * 3
    zero = x.copy()
    zero[1, 2, :] = 0.0                     # an all-zero block
    # exact .5 ties: amax 127 makes the scale exactly 1, so these codes
    # sit on halves and round to even
    ties = np.tile(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                            np.float32), (2, 16))
    return {"f32": (x, 64, -1), "zero_block": (zero, 64, -1),
            "ties": (ties, 128, -1),
            "ragged": (x[..., :100], 64, -1),     # padded reference path
            "middle_axis": (x, 4, 1)}


@pytest.mark.parametrize("case", sorted(_cases()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_block_bit_equal(case, dtype):
    x, block, axis = _cases()[case]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    wq, ws = JQ.quantize_block(jx, block=block, axis=axis)
    gq, gs = TQ.quantize_block(tx, block=block, axis=axis)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                  np.asarray(ws).view(np.int32))
    if case == "zero_block":
        assert (gs[1, 2] == 0).all() and (gq[1, 2] == 0).all()
    if case == "ties":
        assert gq[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


def test_dequantize_round_trip_within_bound():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(np.float32))
    q, s = TQ.quantize_block(x, block=64)
    back = TQ.dequantize_block(q, s, block=64)
    want = JQ.dequantize_block(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                               block=64)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    amax = x.reshape(3, 5, 4, 64).abs().amax(-1)
    bound = torch.tensor([[[TQ.quant_error_bound(float(a)) for a in row]
                           for row in plane] for plane in amax])
    err = (back - x).abs().reshape(3, 5, 4, 64).amax(-1)
    assert (err <= bound * (1 + 1e-6)).all()
    assert TQ.wire_bytes(1000, block=64) == JQ.wire_bytes(1000, block=64)


def _stochastic_input():
    return np.random.RandomState(0).randn(4, 64).astype(np.float32)


@pytest.mark.parametrize("case", ["aligned", "ragged", "middle_axis"])
def test_stochastic_codes_bit_equal_on_fed_noise(case):
    """``mode="stochastic"`` on the same uniform draws: the JAX package's
    ``quantize_block(key=)`` draws ``jax.random.uniform(key, xb.shape)``
    in the blocked layout; fed that noise, the port's codes and scales
    are bit-equal (the fast path, the padded reference, another axis)."""
    import jax

    x, block, axis = {"aligned": (_stochastic_input(), 32, -1),
                      "ragged": (_stochastic_input()[:, :50], 32, -1),
                      "middle_axis": (np.random.RandomState(1).randn(
                          3, 8, 5).astype(np.float32), 4, 1)}[case]
    xm = np.moveaxis(x, axis, -1)
    nb = -(-xm.shape[-1] // block)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, xm.shape[:-1] + (nb, block),
                                      jnp.float32))
    wq, ws = JQ.quantize_block(jnp.asarray(x), block=block, axis=axis,
                               mode="stochastic", key=key)
    gq, gs = TQ.quantize_block(torch.from_numpy(x), block=block, axis=axis,
                               mode="stochastic", noise=torch.tensor(u))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                  np.asarray(ws).view(np.int32))
    rq, _ = TQ.quantize_block_ref(torch.from_numpy(x), block=block,
                                  axis=axis, mode="stochastic",
                                  noise=np.array(u))
    np.testing.assert_array_equal(rq.numpy(), np.asarray(wq))


def test_stochastic_rounding_unbiased_over_generator_draws():
    """The mean over 512 generator draws of ``dequant(quant_stochastic(x))``
    is within the reference's CLT bound of x (``tests/test_quant.py:
    89-107``: 0.08 of a step), and a single draw within one step."""
    x = torch.from_numpy(_stochastic_input())
    g = TQ.stochastic_generator(5, 0)
    draws = torch.stack([TQ.dequantize_block(*TQ.quantize_block(
        x, block=64, mode="stochastic", generator=g), block=64)
        for _ in range(512)])
    scale = x.abs().amax(-1, keepdim=True) / TQ.INT8_MAX
    assert (draws.mean(0) - x).abs().max() <= 0.08 * scale.max()
    assert ((draws[0] - x).abs() <= scale + 1e-7).all()
    # successive draws differ: the generator advances
    assert not torch.equal(draws[0], draws[1])


def test_stochastic_generators_per_stream_and_rank():
    """Each (base, rank) its own seeded stream: equal pairs draw equal
    noise, other pairs other noise."""
    def draw(base, rank):
        return torch.rand(8, generator=TQ.stochastic_generator(base, rank))

    assert torch.equal(draw(16, 1), draw(16, 1))
    assert not torch.equal(draw(16, 1), draw(16, 2))
    assert not torch.equal(draw(16, 1), draw(17, 1))


def test_stochastic_needs_a_noise_source_and_mode_validates():
    with pytest.raises(ValueError, match="noise source"):
        TQ.quantize_block(torch.zeros(4, 128), mode="stochastic")
    with pytest.raises(ValueError, match="noise source"):
        TQ.quantize_block_ref(torch.zeros(4, 100), mode="stochastic")
    with pytest.raises(ValueError, match="rounding mode"):
        TQ.quantize_block(torch.zeros(4, 128), mode="floor")


def test_data_salt_equals_reference():
    """``data_salt``: the bit pattern of the f32 sum as int32.  Where the
    sum is exact in f32 (whole numbers, halves), whatever the order of
    summation, it equals the reference's bit for bit; elsewhere the two
    sums differ only by their summation order, within f32 rounding."""
    rng = np.random.RandomState(2)
    for x in (rng.randint(-50, 50, (4, 64)).astype(np.float32) * 0.5,
              np.zeros((3, 5), np.float32),
              np.full((7,), -1.5, np.float32)):
        assert int(TQ.data_salt(torch.from_numpy(x))) == \
            int(JQ.data_salt(jnp.asarray(x)))
    x = _stochastic_input()
    got = TQ.data_salt(torch.from_numpy(x))
    assert got.dtype == torch.int32
    want = np.asarray(JQ.data_salt(jnp.asarray(x))).view(np.float32)
    np.testing.assert_allclose(got.reshape(1).view(torch.float32).item(),
                               want, rtol=1e-5)
