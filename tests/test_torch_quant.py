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


def test_stochastic_mode_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 9"):
        TQ.quantize_block(torch.zeros(4, 128), mode="stochastic")
    with pytest.raises(ValueError, match="rounding mode"):
        TQ.quantize_block(torch.zeros(4, 128), mode="floor")
