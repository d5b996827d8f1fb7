"""Attention for the port: RoPE, prefill flash attention, decode attention.

Counterpart of ``ray_tpu/ops/attention.py``.  Public functions take the
model layout ``[B, S, H, D]`` as the JAX package does.

- :func:`flash_attention` is causal self-attention for prefill.  On a
  CUDA tensor it launches ``csrc/flash_attention_fwd.cu``, the port of
  the Pallas forward kernels ``_fwd_kernel`` and ``_fwd_pack2_kernel``;
  on a CPU tensor it runs the plain version, the ``local_attention``
  formulation.  RoPE is applied outside (the in-kernel rotation, the
  backward and ``segment_ids`` come with the training slice).
- :func:`decode_attention` is one query token per sequence against the
  gathered paged context, masked by ``lengths``.  On a CUDA tensor it
  launches ``csrc/decode_attention.cu`` (the port of ``_decode_kernel``,
  model-dtype cache); on a CPU tensor it runs
  :func:`plain_decode_attention`.

A CUDA tensor launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.substrate import NEG_INF, check_cuda_args, is_cuda
from ray_tpu_torch.parallel.ring_attention import _block_attn

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head_dim the kernels are built for (GPT-2's); other head dims come
# with the configurations that need them
_KERNEL_HEAD_DIMS = (64,)

flash_attention_kernel = _build.Kernel(
    "flash_attention_fwd", *[_build.PTR] * 5, *[_build.INT] * 4,
    _build.FLOAT, _build.INT, _build.PTR)
decode_attention_kernel = _build.Kernel(
    "decode_attention", *[_build.PTR] * 5, *[_build.INT] * 4,
    _build.FLOAT, _build.INT, _build.PTR)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_kernel_dtype(name: str, t: torch.Tensor, D: int) -> None:
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, "
                         f"got {t.dtype}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {D}")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, D: int, theta: float, dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [S] (or any leading shape) -> (cos2, sinm) each
    [*positions.shape, D]: duplicated tables ``[cos, cos]`` and
    ``[-sin, sin]``, angles in f32, cast to ``dtype``."""
    half = D // 2
    dev = positions.device
    # log(theta) in f32 as the reference takes it, computed on the host:
    # a host-to-device copy here would synchronise the stream every layer
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32)).item()
    idx = torch.arange(half, dtype=torch.float32, device=dev)
    freqs = torch.exp(-log_theta * idx / half)
    angles = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    cos2 = torch.cat([cos, cos], -1).to(dtype)
    sinm = torch.cat([-sin, sin], -1).to(dtype)
    return cos2, sinm


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                theta: float) -> torch.Tensor:
    """x [B, S, H, D] rotated per position, in x's dtype.

    ``positions`` is [S] (one schedule for the batch: prefill) or
    [B, S] (per-sequence absolute positions: decode)."""
    D = x.shape[-1]
    cos2, sinm = rope_tables(positions, D, theta, x.dtype)
    if positions.dim() == 2:                 # [B, S] -> [B, S, 1, D]
        cos2, sinm = cos2[:, :, None, :], sinm[:, :, None, :]
    else:                                    # [S] -> [1, S, 1, D]
        cos2, sinm = cos2[None, :, None, :], sinm[None, :, None, :]
    return x * cos2 + torch.roll(x, D // 2, -1) * sinm


# ---------------------------------------------------------------------------
# prefill: causal flash attention forward
# ---------------------------------------------------------------------------

def plain_flash_attention_fwd(q, k, v, *, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: (o [B,S,H,D] in q's dtype,
    lse [B,H,S] f32), computed by the ``local_attention`` formulation."""
    S = q.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    o, m, l = _block_attn(q, k, v, mask, scale)
    lc = l.clamp_min(1e-30)
    lse = (m + torch.log(lc)).transpose(1, 2).contiguous()
    return (o / lc[..., None]).to(q.dtype), lse


def flash_attention_fwd(q, k, v, *, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention; the kernel on CUDA tensors."""
    if not is_cuda(q):
        return plain_flash_attention_fwd(q, k, v, scale=scale)
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} must "
                         "match (self-attention)")
    check_cuda_args("flash_attention", q, k, v, dtype=q.dtype)
    _check_kernel_dtype("flash_attention", q, D)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        flash_attention_kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, D, scale, _DTYPE_CODES[q.dtype],
            _stream(q))
    return o, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused causal attention.  q, k, v: [B, S, H, D] -> [B, S, H, D].

    Drop-in for ``parallel.ring_attention.local_attention``.  Every
    length takes the kernel on a CUDA tensor: it masks its own ragged
    edge, so there is no shape-based fallback."""
    if not causal:
        raise NotImplementedError(
            "non-causal flash attention is not ported yet (ROADMAP "
            "Queue 2, row 1: comes with the training slice)")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return flash_attention_fwd(q, k, v, scale=scale)[0]


# ---------------------------------------------------------------------------
# decode attention over the gathered paged context
# ---------------------------------------------------------------------------

def plain_decode_attention(q, k, v, lengths, *, scale: float):
    """The kernel's plain version (the JAX masked-einsum formulation).

    Positions >= ``lengths[b]`` take no part: their scores are masked
    and their values are zeroed before P.V, so garbage there, even NaN,
    never reaches the output."""
    S = k.shape[1]
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, None, :]
            < lengths.to(q.device).long()[:, None, None])
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    vz = torch.where(mask.permute(0, 2, 1)[..., None], v.float(), 0.0)
    o = torch.einsum("bhs,bshd->bhd", p.to(v.dtype).float(), vz)
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def decode_attention(q, k, v, lengths, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention against a padded KV context.

    q: [B, H, D], the current token's (rotated) queries; k, v:
    [B, S, H, D], the per-sequence context gathered from the paged
    cache; lengths: [B] int32, valid positions per sequence (including
    the current token, already written).  Returns [B, H, D] in q's
    dtype."""
    B, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if not is_cuda(q):
        return plain_decode_attention(q, k, v, lengths, scale=scale)
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError("decode_attention: lengths must be int32 [B]")
    check_cuda_args("decode_attention", q, k, v, dtype=q.dtype)
    check_cuda_args("decode_attention", q, lengths)
    _check_kernel_dtype("decode_attention", q, D)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k/v must be 16-byte aligned "
                         "(the kernel reads rows in 16-byte vectors)")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        decode_attention_kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), B, S, H, D, scale, _DTYPE_CODES[q.dtype],
            _stream(q))
    return o

