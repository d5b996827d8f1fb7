"""Attention for the port: RoPE, flash attention, decode attention.

Counterpart of ``ray_tpu/ops/attention.py``.  Public functions take the
model layout ``[B, S, H, D]`` as the JAX package does.

- :func:`flash_attention` is self-attention for prefill and training,
  causal or not, differentiable through :class:`FlashAttention`.  On a CUDA
  tensor its forward launches ``csrc/flash_attention_fwd.cu`` (the port
  of the Pallas ``_fwd_kernel`` / ``_fwd_pack2_kernel``) and its
  backward ``csrc/flash_attention_bwd.cu`` (``_bwd`` / ``_bwd_pack2``):
  in bf16 on the tensor cores (``wgmma`` forward, ``mma.sync``
  backward), in f32 on the CUDA cores; on a CPU tensor both run their
  plain versions.  With ``positions`` the
  RoPE rotation happens inside both kernels (the training path, through
  :func:`make_flash_attention_fn`); the serving path rotates q and k
  outside, because its cache stores post-RoPE keys.
- :func:`decode_attention` is one query token per sequence against a
  padded context, masked by ``lengths``, and
  :func:`decode_attention_paged` the same read straight from the paged
  cache through the page table (the engine's decode step).  On a CUDA
  tensor both launch ``csrc/decode_attention.cu`` (the port of
  ``_decode_kernel``, split across blocks): ``decode_attention`` for a
  model-dtype cache, ``decode_attention_int8`` (``quantized=True``) for
  int8 codes with their scales; on a CPU tensor they run
  :func:`plain_decode_attention` and :func:`plain_decode_attention_paged`.

A CUDA tensor launches the kernel or raises; nothing falls back.  The
kernels are built for the head dims in ``_KERNEL_HEAD_DIMS`` (64, GPT-2's,
16, ``GPTConfig.tiny``'s, and 128, Llama's, Mistral's and Qwen2's);
:func:`supports` raises for any other on a CUDA device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.substrate import (NEG_INF, Support, check_cuda_args,
                                         is_cuda, on_cuda, require_built,
                                         supported)
from ray_tpu_torch.parallel.mesh import mesh_axis_size, mesh_groups
from ray_tpu_torch.parallel.ring_attention import _block_attn

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the kernels are built for (GPT-2's 64, GPTConfig.tiny's
# 16, and 128, the public decoders' own), read by supports(), which every
# wrapper's check calls; other head dims: ROADMAP Queue 2 item B
_KERNEL_HEAD_DIMS = (16, 64, 128)

# (..., scale, dtype code, causal, stream)
flash_attention_kernel = _build.Kernel(
    "flash_attention_fwd", *[_build.PTR] * 7, *[_build.INT] * 4,
    _build.FLOAT, _build.INT, _build.INT, _build.PTR)
flash_attention_bwd_kernel = _build.Kernel(
    "flash_attention_bwd", *[_build.PTR] * 12, *[_build.INT] * 4,
    _build.FLOAT, _build.INT, _build.INT, _build.PTR)
# one entry point for both input modes (padded, paged), each launching
# the split and combine kernels: one count per call; the int8 variant is
# its own entry point, so its launches count apart
decode_attention_kernel = _build.Kernel(
    "decode_attention", *[_build.PTR] * 7, *[_build.INT] * 5,
    _build.FLOAT, _build.INT, _build.PTR)
decode_attention_int8_kernel = _build.Kernel(
    "decode_attention_int8", *[_build.PTR] * 9, *[_build.INT] * 5,
    _build.FLOAT, _build.INT, _build.PTR)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def supports(D: int, *, device=None) -> Support:
    """Whether a head dim takes the kernels on ``device``.  On the CPU
    every head dim takes the plain versions; on a CUDA device the head
    dims in ``_KERNEL_HEAD_DIMS``, and any other raises: the wrappers'
    checks call this, so a CUDA tensor launches a kernel or fails."""
    if not on_cuda(device):
        return supported("the plain version (not a CUDA device)")
    require_built("the attention kernels: head_dim", D, _KERNEL_HEAD_DIMS,
                  "B")
    return supported("attention kernels")


def _check_kernel_dtype(name: str, t: torch.Tensor, D: int) -> None:
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, "
                         f"got {t.dtype}")
    supports(D, device="cuda")


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


def _rot(x, cos2, sinm):
    """``attention.py:_rot``: x [B, S, H, D] rotated by the [S, D] tables
    in f32, result in x's dtype (the rounding of the in-kernel RoPE, not
    of :func:`rope_rotate`, which rotates in x's dtype)."""
    D = x.shape[-1]
    xf = x.float()
    c, s = cos2.float()[None, :, None, :], sinm.float()[None, :, None, :]
    return (xf * c + torch.roll(xf, D // 2, -1) * s).to(x.dtype)


def _rot_t(g, cos2, sinm):
    """``attention.py:_rot_t`` on an f32 gradient: the transposed
    rotation, in f32."""
    D = g.shape[-1]
    c, s = cos2.float()[None, :, None, :], sinm.float()[None, :, None, :]
    return g * c - torch.roll(g, D // 2, -1) * s


# ---------------------------------------------------------------------------
# flash attention: forward, backward, autograd
# ---------------------------------------------------------------------------

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _mask(S: int, causal: bool, device) -> torch.Tensor:
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    return mask.tril() if causal else mask


def plain_flash_attention_fwd(q, k, v, *, scale: float, rope: Rope = None,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: (o [B,S,H,D] in q's dtype,
    lse [B,H,S] f32), computed by the ``local_attention`` formulation;
    ``rope`` = (cos2, sinm) [S, D] rotates q and k first."""
    if rope is not None:
        q, k = _rot(q, *rope), _rot(k, *rope)
    o, m, l = _block_attn(q, k, v, _mask(q.shape[1], causal, q.device),
                          scale)
    lc = l.clamp_min(1e-30)
    lse = (m + torch.log(lc)).transpose(1, 2).contiguous()
    return (o / lc[..., None]).to(q.dtype), lse


def plain_flash_attention_bwd(q, k, v, o, lse, do, *, scale: float,
                              rope: Rope = None, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernel's plain version (``_grad_blocks`` and the
    products of ``_bwd_fused_kernel`` over the whole sequence): scores
    and statistics in f32 (in f64 for f64 inputs, a yardstick with no
    summation error of its own), ``p`` and ``ds`` rounded to the input
    dtype before their products, ``_rot_t`` on dq and dk under
    ``rope``."""
    dt = q.dtype
    ct = torch.float64 if dt == torch.float64 else torch.float32
    if rope is not None:
        q, k = _rot(q, *rope), _rot(k, *rope)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    s = torch.where(_mask(q.shape[1], causal, q.device), s, NEG_INF)
    p = torch.exp(s - lse[..., None].to(ct))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(ct), v.to(ct))
    delta = (do.to(ct) * o.to(ct)).sum(-1).transpose(1, 2)   # [B, H, S]
    ds = p * (dp - delta[..., None]) * scale
    p, ds = p.to(dt).to(ct), ds.to(dt).to(ct)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.to(ct))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ct))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(ct))
    if rope is not None:
        dq, dk = _rot_t(dq, *rope), _rot_t(dk, *rope)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_attn_args(name: str, q, k, v, rope: Rope, *more) -> None:
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} must match "
                         "(self-attention)")
    check_cuda_args(name, q, k, v, dtype=q.dtype)
    _check_kernel_dtype(name, q, D)
    if rope is not None:
        check_cuda_args(name, q, *rope, dtype=q.dtype)
        if any(t.shape != (S, D) for t in rope):
            raise ValueError(f"{name}: the RoPE tables must be [S, D] = "
                             f"[{S}, {D}]")
    # the bf16 kernels copy rows into shared memory in 16-byte vectors
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, *(rope or ()), *more)):
        raise ValueError(f"{name}: bf16 q, k, v, do and the RoPE tables "
                         "must be 16-byte aligned (the kernel copies rows "
                         "in 16-byte vectors)")


def flash_attention_fwd(q, k, v, *, scale: float, rope: Rope = None,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of attention; the kernel on CUDA tensors."""
    if not is_cuda(q):
        return plain_flash_attention_fwd(q, k, v, scale=scale, rope=rope,
                                         causal=causal)
    _check_attn_args("flash_attention", q, k, v, rope)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    cos2, sinm = (None, None) if rope is None else rope
    with torch.cuda.device(q.device):
        flash_attention_kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if cos2 is None else cos2.data_ptr(),
            None if sinm is None else sinm.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, D, scale, _DTYPE_CODES[q.dtype],
            int(causal), _stream(q))
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float,
                        rope: Rope = None, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv); the kernel on CUDA tensors."""
    if not is_cuda(q):
        return plain_flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                         rope=rope, causal=causal)
    check_cuda_args("flash_attention_bwd", q, o, do, dtype=q.dtype)
    _check_attn_args("flash_attention_bwd", q, k, v, rope, do)
    B, S, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: o and do must match q")
    check_cuda_args("flash_attention_bwd", q, lse, dtype=None)
    if lse.dtype != torch.float32 or lse.shape != (B, H, S):
        raise ValueError("flash_attention_bwd: lse must be f32 [B, H, S]")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    cos2, sinm = (None, None) if rope is None else rope
    with torch.cuda.device(q.device):
        flash_attention_bwd_kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(),
            None if cos2 is None else cos2.data_ptr(),
            None if sinm is None else sinm.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B, S, H, D,
            scale, _DTYPE_CODES[q.dtype], int(causal), _stream(q))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernel (the custom VJP of
    ``_flash_bhsd`` / ``_flash_pack2`` and their ``_rope`` twins).
    Saves q, k, v, o and lse; delta is recomputed in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, cos2, sinm, scale, causal=True):
        rope = None if cos2 is None else (cos2, sinm)
        o, lse = flash_attention_fwd(q, k, v, scale=scale, rope=rope,
                                     causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, cos2, sinm)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, cos2, sinm = ctx.saved_tensors
        rope = None if cos2 is None else (cos2, sinm)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         scale=ctx.scale, rope=rope,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None, None, None


def segment_attention(q, k, v, segment_ids, *, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Packed-batch attention: block-diagonal masking by segment
    (``attention.py:segment_attention``, plain XLA there and plain
    PyTorch here: it has no Pallas kernel, so no Hopper kernel).

    q, k, v: ``[B, S, H, D]``; ``segment_ids``: ``[B, S]``, the sample
    packer's per-row document index (1-based; ``0`` = padding).
    Position ``i`` attends to ``j`` iff ``seg[i] == seg[j]``, both are
    nonzero, and (``causal``) ``j <= i``.  Scores and the softmax
    statistics are f32 (``preferred_element_type`` there: bf16 products
    are exact in f32); the probabilities are rounded to v's dtype before
    the second product, as the reference rounds them.  Fully masked rows
    (padding queries) normalize against a floor and come out zero, not
    NaN; their targets are ``-1``, so no loss or gradient flows through
    them.  The f32 ``[B, H, S, S]`` scores are the memory cost."""
    B, S, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    seg = segment_ids.to(torch.int32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = ((seg[:, None, :, None] == seg[:, None, None, :])
            & (seg[:, None, :, None] > 0))
    if causal:
        mask = mask & torch.ones(S, S, dtype=torch.bool,
                                 device=q.device).tril()
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l_q = l.transpose(1, 2)                       # [B, S, H, 1]
    return (o / l_q.clamp_min(1e-30)).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, positions=None,
                    rope_theta: float = 10000.0,
                    segment_ids=None) -> torch.Tensor:
    """Fused attention.  q, k, v: [B, S, H, D] -> [B, S, H, D];
    ``causal`` masks the keys after each query (the training path's),
    ``causal=False`` attends to all S keys.

    Drop-in for ``parallel.ring_attention.local_attention``.  Every
    length takes the kernel on a CUDA tensor: it masks its own ragged
    edge, so there is no shape-based fallback.  ``positions`` [S] turns
    on the in-kernel RoPE (q and k arrive unrotated); the tables are
    ``rope_tables(positions, D, rope_theta, q.dtype)``, as in the
    reference (``attention.py:1257``).

    ``segment_ids`` [B, S] (a sample-packed batch) takes
    :func:`segment_attention`, as the reference's gate does
    (``attention.py:1232-1237``): q and k are rotated here by the
    per-row ``positions`` [B, S] when given."""
    if segment_ids is not None:
        if positions is not None:
            if positions.shape[-1] != k.shape[1]:
                raise ValueError(f"rope needs q and kv positions to match: "
                                 f"S={q.shape[1]} vs Sk={k.shape[1]}")
            q = rope_rotate(q, positions, rope_theta)
            k = rope_rotate(k, positions, rope_theta)
        with torch.profiler.record_function("attn/segment"):
            return segment_attention(q, k, v, segment_ids, causal=causal,
                                     scale=scale)
    B, S, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    cos2 = sinm = None
    if positions is not None:
        if positions.dim() != 1 or positions.shape[0] != S:
            raise ValueError(f"positions must be [S] = [{S}] for the fused "
                             f"RoPE, got {tuple(positions.shape)}")
        cos2, sinm = rope_tables(positions, D, rope_theta, q.dtype)
    return FlashAttention.apply(q, k, v, cos2, sinm, scale, causal)


def make_flash_attention_fn(mesh=None, *, causal: bool = True,
                            rope_theta: Optional[float] = None):
    """The training path's attention hook (``attention.py:1496``).  With
    ``rope_theta`` the returned function takes ``positions`` and rotates
    q and k inside the kernels; ``fn.fused_rope`` marks this so the
    model skips its own rotation.  On a mesh each rank runs the kernels
    on its own batch rows and its local heads (``n_heads / tp``), what
    the reference's ``shard_map`` gives each device: attention mixes
    neither rows nor heads.  A mesh with ``sp`` above 1 raises: its
    attention is ring or Ulysses (``parallel.ring_attention``,
    ``parallel.ulysses``), which ``build_gpt_train`` picks by
    ``sp_impl``."""
    if mesh_axis_size(mesh, "sp") > 1:
        raise ValueError(
            "flash attention runs on whole sequences: a mesh with sp="
            f"{mesh_axis_size(mesh, 'sp')} takes ring or Ulysses attention "
            "(parallel.ring_attention.make_ring_attention_fn, "
            "parallel.ulysses.make_ulysses_attention_fn)")
    mesh_groups(mesh)
    fn = functools.partial(flash_attention, causal=causal)
    if rope_theta is not None:
        fn = functools.partial(fn, rope_theta=rope_theta)
    fn.fused_rope = rope_theta is not None
    return fn


# ---------------------------------------------------------------------------
# decode attention: a padded context, or the paged cache read in place
# ---------------------------------------------------------------------------

def plain_decode_attention(q, k, v, lengths, *, scale: float,
                           k_scale=None, v_scale=None):
    """The kernel's plain version (the JAX masked-einsum formulation).

    Positions >= ``lengths[b]`` take no part: their scores are masked
    and their values are zeroed before P.V, so garbage there, even NaN,
    never reaches the output.  With ``k_scale``/``v_scale`` [B, S, H] the
    context is int8 codes, dequantized as the Pallas body does
    (``attention.py:1341-1344``): q, k and v in f32, and p left in f32
    before P.V."""
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
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


def _pages_to_context(pages, page_table):
    """[P, page_size, *rest] x [B, max_pages] -> [B, max_pages*page_size,
    *rest], each row's pages in table order: the padded context the
    paged kernel reads in place (the engine's ``gather_pages``)."""
    B, max_pages = page_table.shape
    ctx = pages[page_table.long()]
    return ctx.reshape((B, max_pages * pages.shape[1]) + pages.shape[2:])


def plain_decode_attention_paged(q, k_pages, v_pages, page_table, lengths,
                                 *, scale: float, k_scale_pages=None,
                                 v_scale_pages=None):
    """The paged kernel's plain version: the pages gathered into the
    padded context, then :func:`plain_decode_attention`."""
    scales = {}
    if k_scale_pages is not None:
        scales = dict(k_scale=_pages_to_context(k_scale_pages, page_table),
                      v_scale=_pages_to_context(v_scale_pages, page_table))
    return plain_decode_attention(
        q, _pages_to_context(k_pages, page_table),
        _pages_to_context(v_pages, page_table), lengths, scale=scale,
        **scales)


@functools.lru_cache(maxsize=None)
def _decode_workspace_elems(B: int, H: int, D: int, capacity: int) -> int:
    return _build.query("decode_attention_workspace", B, H, D, capacity)


def _launch_decode(name, q, k, v, lengths, table, ps, max_pages, scale,
                   k_scale, v_scale) -> torch.Tensor:
    """Check what both input modes share and launch the kernel: ``k``,
    ``v`` hold rows of [H, D] (codes with ``k_scale``/``v_scale`` of one
    f32 per row and head), position p of row b at row ``b * ps + p``
    (``table`` None) or ``table[b, p // ps] * ps + p % ps``."""
    B, H, D = q.shape
    quantized = k_scale is not None
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"{name}: lengths must be int32 [B]")
    check_cuda_args(name, q, k, v, lengths,
                    *(() if table is None else (table,)))
    if k.dtype != v.dtype or k.dtype != (torch.int8 if quantized
                                         else q.dtype):
        raise ValueError(f"{name}: k/v of dtype {k.dtype}, {v.dtype} for q "
                         f"of {q.dtype} (int8 codes take scales)")
    _check_kernel_dtype(name, q, D)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k/v must be 16-byte aligned (the kernel "
                         "reads rows in 16-byte vectors)")
    if ps * max_pages <= 0:
        raise ValueError(f"{name}: the context holds no position")
    if quantized:
        check_cuda_args(name, q, k_scale, v_scale)
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or k_scale.shape != k.shape[:-1] \
                or v_scale.shape != k.shape[:-1]:
            raise ValueError(f"{name}: scales must be f32 "
                             f"{list(k.shape[:-1])}")
    o = torch.empty_like(q)
    ws = torch.empty((_decode_workspace_elems(B, H, D, ps * max_pages),),
                     dtype=torch.float32, device=q.device)
    common = (lengths.data_ptr(),
              None if table is None else table.data_ptr(), o.data_ptr(),
              ws.data_ptr(), B, H, D, ps, max_pages, scale,
              _DTYPE_CODES[q.dtype], _stream(q))
    with torch.cuda.device(q.device):
        if quantized:
            decode_attention_int8_kernel(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), *common)
        else:
            decode_attention_kernel(q.data_ptr(), k.data_ptr(),
                                    v.data_ptr(), *common)
    return o


def _check_scales_paired(k_scale, v_scale) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale/v_scale must be passed together")


def decode_attention(q, k, v, lengths, *, scale: Optional[float] = None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-token decode attention against a padded KV context.

    q: [B, H, D], the current token's (rotated) queries; k, v:
    [B, S, H, D], the per-sequence context; lengths: [B] int32, valid
    positions per sequence (including the current token, already
    written).  Returns [B, H, D] in q's dtype.  ``k_scale``/``v_scale``
    ([B, S, H] f32, both or neither): k and v are int8 codes of the
    ``kv_dtype="int8"`` cache, dequantized inside the kernel
    (``decode_attention_int8``)."""
    B, H, D = q.shape
    _check_scales_paired(k_scale, v_scale)
    if scale is None:
        scale = D ** -0.5
    if not is_cuda(q):
        return plain_decode_attention(q, k, v, lengths, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale)
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    return _launch_decode("decode_attention", q, k, v, lengths, None, S, 1,
                          scale, k_scale, v_scale)


def decode_attention_paged(q, k_pages, v_pages, page_table, lengths, *,
                           scale: Optional[float] = None,
                           k_scale_pages=None,
                           v_scale_pages=None) -> torch.Tensor:
    """Decode attention read straight from one layer of the paged cache.

    q: [B, H, D]; k_pages, v_pages: [P, page_size, H, D], a layer's
    slice of ``KVCache.k``/``v``; page_table: [B, max_pages] int32, row
    b's position p at page ``page_table[b, p // page_size]``, offset
    ``p % page_size``; lengths: [B] int32.  Only table entries below
    ``ceil(lengths[b] / page_size)`` are read, so the garbage page the
    tails point at is never touched.  ``k_scale_pages``/
    ``v_scale_pages`` ([P, page_size, H] f32, both or neither): the
    pages hold int8 codes.  The same kernels as :func:`decode_attention`
    (one body, two input modes); on a CPU tensor
    :func:`plain_decode_attention_paged`, which gathers the pages first.
    Each table entry must name a page of ``k_pages``: the kernel does
    not check them."""
    B, H, D = q.shape
    _check_scales_paired(k_scale_pages, v_scale_pages)
    if scale is None:
        scale = D ** -0.5
    if not is_cuda(q):
        return plain_decode_attention_paged(
            q, k_pages, v_pages, page_table, lengths, scale=scale,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    P, ps = k_pages.shape[:2]
    if k_pages.shape != (P, ps, H, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"decode_attention_paged: pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or \
            page_table.shape[0] != B:
        raise ValueError("decode_attention_paged: page_table must be int32 "
                         "[B, max_pages]")
    return _launch_decode("decode_attention_paged", q, k_pages, v_pages,
                          lengths, page_table, ps, page_table.shape[1], scale,
                          k_scale_pages, v_scale_pages)
