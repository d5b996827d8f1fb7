"""Block-scaled int8 quantize/dequantize, deterministic rounding.

Counterpart of ``ray_tpu/quant/block_scale.py`` in ``"nearest"`` mode.
A tensor is split into ``block``-element groups along one axis; each
group stores int8 codes in ``[-127, 127]`` plus one f32 scale
(``amax / 127``), and dequantization is ``code * scale``.  The
worst-case per-element error is ``scale / 2`` (:func:`quant_error_bound`).

Codes and scales are bit-identical to the JAX package's, which the int8
KV cache relies on: a prefix hit shares pages that another request
wrote, so equal content must give equal codes.  Three points keep them
so: the quantizer divides by the guarded scale (a reciprocal multiply
rounds differently), ``torch.round`` rounds half to even as
``jnp.round`` does, and an all-zero block stores scale 0.

``mode="stochastic"`` draws its noise from ``jax.random`` on the
multi-GPU int8 wire, which is not ported yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from typing import Tuple

import torch

INT8_MAX = 127


def _check_mode(mode: str) -> None:
    if mode == "stochastic":
        raise NotImplementedError(
            "mode='stochastic' is not ported yet (ROADMAP Queue 1 item 9: "
            "its noise is the multi-GPU int8 wire's jax.random draw)")
    if mode != "nearest":
        raise ValueError(f"unknown rounding mode {mode!r}; "
                         "expected 'nearest' or 'stochastic'")


def _quantize_blocked(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., nb, block] f32 -> ([..., nb, block] int8, [..., nb] f32)."""
    amax = xb.abs().amax(-1)
    scale = amax / INT8_MAX
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(xb / safe[..., None])
    return (q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8),
            scale.to(torch.float32))


def quantize_block_ref(x: torch.Tensor, *, block: int = 128, axis: int = -1,
                       mode: str = "nearest"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded reference: any axis, any size (tail block zero-padded).

    Returns ``(q int8, scales f32)``; ``q`` has ``x``'s shape, the
    scales have ``axis`` replaced by ``ceil(n / block)``."""
    _check_mode(mode)
    axis = axis % x.dim()
    n = x.shape[axis]
    nb = -(-n // block)
    xm = torch.movedim(x, axis, -1).to(torch.float32)
    pad = nb * block - n
    if pad:
        xm = torch.nn.functional.pad(xm, (0, pad))
    q, scale = _quantize_blocked(xm.reshape(xm.shape[:-1] + (nb, block)))
    q = q.reshape(q.shape[:-2] + (nb * block,))[..., :n]
    return torch.movedim(q, -1, axis), torch.movedim(scale, -1, axis)


def quantize_block(x: torch.Tensor, *, block: int = 128, axis: int = -1,
                   mode: str = "nearest"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled int8 quantization: a plain reshape when ``axis`` is
    the trailing one and ``block`` divides it, the padded reference
    otherwise (the two give identical bits where both apply)."""
    _check_mode(mode)
    axis = axis % x.dim()
    n = x.shape[axis]
    if axis != x.dim() - 1 or n % block:
        return quantize_block_ref(x, block=block, axis=axis, mode=mode)
    xb = x.to(torch.float32).reshape(x.shape[:-1] + (n // block, block))
    q, scale = _quantize_blocked(xb)
    return q.reshape(x.shape), scale


def dequantize_block(q: torch.Tensor, scales: torch.Tensor, *,
                     block: int = 128, axis: int = -1,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_block`: ``code * scale`` in f32, cast
    to ``dtype``."""
    axis = axis % q.dim()
    n = q.shape[axis]
    qm = torch.movedim(q, axis, -1).to(torch.float32)
    sm = torch.movedim(scales, axis, -1)
    full = torch.repeat_interleave(sm, block, dim=-1)[..., :n]
    return torch.movedim((qm * full).to(dtype), -1, axis)


def quant_error_bound(x_amax: float, *, mode: str = "nearest") -> float:
    """Worst-case per-element absolute error for a block whose amax is
    ``x_amax``: half a step rounding to nearest, a step stochastic."""
    step = x_amax / INT8_MAX
    return step / 2 if mode == "nearest" else step


def wire_bytes(n_elements: int, *, block: int = 128,
               scale_bytes: int = 4) -> int:
    """Bytes an int8 + per-block-f32-scale payload of ``n_elements``
    occupies (codes plus scales)."""
    nb = -(-n_elements // block)
    return n_elements + nb * scale_bytes
