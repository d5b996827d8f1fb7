"""Block-scaled int8 quantize/dequantize, deterministic and stochastic
rounding.

Counterpart of ``ray_tpu/quant/block_scale.py``.  A tensor is split into
``block``-element groups along one axis; each group stores int8 codes in
``[-127, 127]`` plus one f32 scale (``amax / 127``), and dequantization
is ``code * scale``.  The worst-case per-element error is ``scale / 2``
rounding to nearest and ``scale`` stochastic (:func:`quant_error_bound`).

Rounding modes, as in the reference:

- ``"nearest"``: round half to even.  Codes and scales are bit-identical
  to the JAX package's, which the int8 KV cache relies on: a prefix hit
  shares pages that another request wrote, so equal content must give
  equal codes.  Three points keep them so: the quantizer divides by the
  guarded scale and computes the scale by dividing by a tensor (a
  reciprocal multiply rounds differently, and CUDA divides by a Python
  scalar so),
  ``torch.round`` rounds half to even as ``jnp.round`` does, and an
  all-zero block stores scale 0.
- ``"stochastic"``: ``floor(x / scale + u)`` with ``u`` uniform in
  [0, 1), so the expected code is ``x / scale`` exactly: the gradients'
  rounding on the overlap schedule's int8 wire (``parallel.overlap``),
  where each ring hop requantizes a partial sum and a biased rounding
  would compound over ranks and steps.  ``u`` is the caller's ``noise``
  (the draws in the blocked layout the quantizer reads: ``[..., nb,
  block]``, the block axis moved last and padded) or is drawn from a
  ``torch.Generator``.  The reference draws ``jax.random.uniform`` from
  a key it folds from (base, rank, hop, :func:`data_salt`); a torch
  generator cannot reproduce those draws, so only fed noise gives the
  reference's codes.  :func:`stochastic_generator` gives each (base,
  rank) a generator of its own, which advances with every draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

INT8_MAX = 127


def _check_mode(mode: str, noise, generator) -> None:
    if mode == "stochastic":
        if noise is None and generator is None:
            raise ValueError("mode='stochastic' needs a noise source: "
                             "noise= (uniform draws) or generator= "
                             "(a torch.Generator)")
    elif mode != "nearest":
        raise ValueError(f"unknown rounding mode {mode!r}; "
                         "expected 'nearest' or 'stochastic'")


def _quantize_blocked(xb: torch.Tensor, mode: str = "nearest", noise=None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., nb, block] f32 -> ([..., nb, block] int8, [..., nb] f32)."""
    amax = xb.abs().amax(-1)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which rounds some scales differently
    scale = amax / torch.full_like(amax, INT8_MAX)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    y = xb / safe[..., None]
    if mode == "stochastic":
        if noise is None:
            u = torch.rand(xb.shape, generator=generator, device=xb.device,
                           dtype=torch.float32)
        else:
            u = torch.as_tensor(noise, dtype=torch.float32,
                                device=xb.device).reshape(xb.shape)
        q = torch.floor(y + u)
    else:
        q = torch.round(y)
    return (q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8),
            scale.to(torch.float32))


def quantize_block_ref(x: torch.Tensor, *, block: int = 128, axis: int = -1,
                       mode: str = "nearest", noise=None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded reference: any axis, any size (tail block zero-padded).

    Returns ``(q int8, scales f32)``; ``q`` has ``x``'s shape, the
    scales have ``axis`` replaced by ``ceil(n / block)``."""
    _check_mode(mode, noise, generator)
    axis = axis % x.dim()
    n = x.shape[axis]
    nb = -(-n // block)
    xm = torch.movedim(x, axis, -1).to(torch.float32)
    pad = nb * block - n
    if pad:
        xm = torch.nn.functional.pad(xm, (0, pad))
    q, scale = _quantize_blocked(xm.reshape(xm.shape[:-1] + (nb, block)),
                                 mode, noise, generator)
    q = q.reshape(q.shape[:-2] + (nb * block,))[..., :n]
    return torch.movedim(q, -1, axis), torch.movedim(scale, -1, axis)


def quantize_block(x: torch.Tensor, *, block: int = 128, axis: int = -1,
                   mode: str = "nearest", noise=None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled int8 quantization: a plain reshape when ``axis`` is
    the trailing one and ``block`` divides it, the padded reference
    otherwise (the two give identical bits where both apply).
    ``mode="stochastic"`` takes ``noise`` or ``generator`` (module
    docstring) and raises ``ValueError`` without either."""
    _check_mode(mode, noise, generator)
    axis = axis % x.dim()
    n = x.shape[axis]
    if axis != x.dim() - 1 or n % block:
        return quantize_block_ref(x, block=block, axis=axis, mode=mode,
                                  noise=noise, generator=generator)
    xb = x.to(torch.float32).reshape(x.shape[:-1] + (n // block, block))
    q, scale = _quantize_blocked(xb, mode, noise, generator)
    return q.reshape(x.shape), scale


def dequantize_block(q: torch.Tensor, scales: torch.Tensor, *,
                     block: int = 128, axis: int = -1,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_block`: ``code * scale`` in f32, cast
    to ``dtype``."""
    axis = axis % q.dim()
    n = q.shape[axis]
    if axis == q.dim() - 1 and n % block == 0:
        # each scale broadcast over its block, without an expanded copy
        qb = q.to(torch.float32).reshape(q.shape[:-1] + (n // block, block))
        return (qb * scales[..., None]).reshape(q.shape).to(dtype)
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


def stochastic_generator(base: int, rank: int, device=None
                         ) -> torch.Generator:
    """The generator of the stochastic rounding stream ``(base, rank)``
    on ``device`` (default the CPU): each pair its own seed.  The
    reference's ``stochastic_key(base, *salts)`` folds the rank, the hop
    and a salt of the payload into a fresh key for every draw; here the
    stream advances with every draw instead, so no two hops or steps of
    one stream reuse a pattern, and nothing is read back to the host."""
    g = torch.Generator(device=device if device is not None else "cpu")
    return g.manual_seed((int(base) << 20) ^ int(rank) ^ 0x5EED0000)


def data_salt(x: torch.Tensor) -> torch.Tensor:
    """An int32 scalar from ``x``'s values: the bit pattern of its f32
    sum, as the reference's ``data_salt`` (the salt it folds into a
    stochastic key)."""
    return x.to(torch.float32).sum().reshape(1).view(torch.int32)[0]
