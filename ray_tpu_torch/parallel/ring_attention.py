"""Single-device attention reference.

Counterpart of ``ray_tpu/parallel/ring_attention.py``.  Only
``local_attention`` is ported in this slice: plain causal attention in
the model layout, which is also the plain version the prefill kernel
(``ops/attention.py:flash_attention``) is held against.  The ring
schedule over a sequence-parallel group comes with multi-GPU training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG_INF = -1e9


def _block_attn(q, k, v, mask, scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One blockwise attention step returning (out, row_max, row_sum).

    q: [B, Sq, H, D]  k/v: [B, Sk, H, D]  mask: [Sq, Sk] bool or None.
    Stats in f32: out [B, Sq, H, D] (unnormalised), m/l [B, Sq, H].
    ``p`` is rounded to the value dtype before P.V while ``l`` sums the
    unrounded f32 ``p`` (the JAX formulation's rounding points)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[None, None], scores, _NEG_INF)
    m = scores.amax(-1)                               # [B, H, Sq]
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m.transpose(1, 2), l.transpose(1, 2)


def local_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """q, k, v: [B, S, H, D] -> [B, S, H, D] in q's dtype."""
    S, D = q.shape[1], q.shape[3]
    if scale is None:
        scale = D ** -0.5
    mask = (torch.ones(S, k.shape[1], dtype=torch.bool,
                       device=q.device).tril() if causal else None)
    o, _m, l = _block_attn(q, k, v, mask, scale)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)
