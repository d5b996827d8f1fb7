"""Ring attention over a sequence-parallel group, and the single-device
reference.

Counterpart of ``ray_tpu/parallel/ring_attention.py``.
:func:`local_attention` is plain causal attention in the model layout,
also the plain version the prefill kernel
(``ops/attention.py:flash_attention``) is held against.

:func:`ring_attention` runs on each rank of an ``sp`` group with the
rank's sequence shard of q, k and v ([B, S_local, H, D]): the K/V blocks
travel around the ring (``comm.ring_shift``: send to the next rank,
receive from the previous one, the next block in flight while the
current one is computed) while each rank accumulates its queries'
attention with an online softmax, the statistics in f32 and masked
logits at a large finite negative, as the reference does.  Blocks that
the causal mask hides entirely are skipped; the reference computes them
and scales them by exactly 0, so the result is the same.  ``layout=
"zigzag"`` takes the reference's balanced layout (:func:`zigzag_positions`:
rank i holds chunks i and 2n-1-i of 2n), whose off-diagonal steps are
unmasked half blocks.

The backward (:class:`_RingAttention`) is a second ring pass: the
forward saves q, k, v, the output and the log-sum-exp; each K/V block
travels again with its dk/dv accumulators, every rank adds what its
queries give each block, and after n shifts the accumulators are back
with the block's owner.  It is the gradient of the same function as
autodiff through the reference's ring.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel import comm

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
                    scale: Optional[float] = None, segment_ids=None):
    """q, k, v: [B, S, H, D] -> [B, S, H, D] in q's dtype.
    ``segment_ids`` [B, S] (a sample-packed batch, 0 = pad) takes
    ``ops.attention.segment_attention``."""
    if segment_ids is not None:
        from ray_tpu_torch.ops.attention import segment_attention
        return segment_attention(q, k, v, segment_ids, causal=causal,
                                 scale=scale)
    S, D = q.shape[1], q.shape[3]
    if scale is None:
        scale = D ** -0.5
    mask = (torch.ones(S, k.shape[1], dtype=torch.bool,
                       device=q.device).tril() if causal else None)
    o, _m, l = _block_attn(q, k, v, mask, scale)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def zigzag_positions(rank: int, n: int, s_local: int, device=None
                     ) -> torch.Tensor:
    """Global token positions of rank ``rank``'s shard under the zigzag
    layout: the sequence in ``2n`` chunks, rank i holding chunks ``(i,
    2n-1-i)``, so every rank carries the same share of the causal
    triangle."""
    c = s_local // 2
    ar = torch.arange(c, device=device)
    return torch.cat([rank * c + ar, (2 * n - 1 - rank) * c + ar])


def zigzag_permutation(seq_len: int, n: int):
    """Host-side index map: ``x[:, perm]`` reorders a [B, S, ...] global
    sequence so an even split over ``n`` ranks gives each its zigzag
    shard.  Returns (perm, inverse_perm) as numpy arrays."""
    if seq_len % (2 * n):
        raise ValueError(
            f"zigzag needs seq_len divisible by 2*sp (got seq_len="
            f"{seq_len}, sp={n})")
    s_local = seq_len // n
    perm = np.concatenate([zigzag_positions(r, n, s_local).numpy()
                           for r in range(n)])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return perm, inv


def _positions(layout: str, rank: int, n: int, S: int, device):
    if layout == "zigzag":
        return zigzag_positions(rank, n, S, device)
    return rank * S + torch.arange(S, device=device)


def _plan(layout: str, causal: bool, src: int, my: int, n: int, S: int,
          device):
    """What one ring step computes for the block of rank ``src``:
    (query rows, key rows, mask) with rows as slices, or None when the
    causal mask hides the whole block."""
    every = slice(0, S)
    if not causal:
        return every, every, None
    if layout == "zigzag":
        c = S // 2
        if src == my:
            q_pos = _positions(layout, my, n, S, device)
            kv_pos = _positions(layout, src, n, S, device)
            return every, every, q_pos[:, None] >= kv_pos[None, :]
        if src < my:             # every query sees the early chunk only
            return every, slice(0, c), None
        return slice(c, S), every, None   # the late queries see it all
    if src > my:
        return None
    if src < my:
        return every, every, None
    q_pos = _positions(layout, my, n, S, device)
    return every, every, q_pos[:, None] >= q_pos[None, :]


def _unpack(flat, shape, count: int):
    n = flat.numel() // count
    return [flat[i * n:(i + 1) * n].view(shape) for i in range(count)]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, layout):
        n, my = comm.group_size(group), torch.distributed.get_rank(group)
        B, S, H, D = q.shape
        o = torch.zeros(B, S, H, D, dtype=torch.float32, device=q.device)
        m = torch.full((B, S, H), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(B, S, H, dtype=torch.float32, device=q.device)
        kv = torch.cat([k.reshape(-1), v.reshape(-1)])
        for step in range(n):
            src = (my - step) % n
            nxt, reqs = (comm.ring_shift(kv, group) if step < n - 1
                         else (None, None))
            plan = _plan(layout, causal, src, my, n, S, q.device)
            if plan is not None:
                qs, ks, mask = plan
                k_blk, v_blk = _unpack(kv, k.shape, 2)
                bo, bm, bl = _block_attn(q[:, qs], k_blk[:, ks],
                                         v_blk[:, ks], mask, scale)
                m_new = torch.maximum(m[:, qs], bm)
                alpha = torch.exp(m[:, qs] - m_new)
                beta = torch.exp(bm - m_new)
                l[:, qs] = l[:, qs] * alpha + bl * beta
                o[:, qs] = o[:, qs] * alpha[..., None] + bo * beta[..., None]
                m[:, qs] = m_new
            comm.wait_all(reqs)
            kv = nxt if nxt is not None else kv
        l = l.clamp_min(1e-30)
        out = (o / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.causal, ctx.scale, ctx.layout = (group, causal,
                                                        scale, layout)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, my = comm.group_size(group), torch.distributed.get_rank(group)
        B, S, H, D = q.shape
        q32, do32 = q.float(), dout.float()
        dsum = (do32 * out.float()).sum(-1)             # [B, S, H]
        dq = torch.zeros_like(q32)
        kv = torch.cat([k.reshape(-1), v.reshape(-1)])
        dkv = torch.zeros(2 * k.numel(), dtype=torch.float32,
                          device=q.device)
        for step in range(n):
            src = (my - step) % n
            nxt, reqs = (comm.ring_shift(kv, group) if step < n - 1
                         else (None, None))
            plan = _plan(ctx.layout, ctx.causal, src, my, n, S, q.device)
            if plan is not None:
                qs, ks, mask = plan
                k_blk, v_blk = _unpack(kv, k.shape, 2)
                dk_blk, dv_blk = _unpack(dkv, k.shape, 2)
                kb, vb = k_blk[:, ks].float(), v_blk[:, ks].float()
                s = torch.einsum("bqhd,bkhd->bhqk", q32[:, qs], kb) * scale
                if mask is not None:
                    s = torch.where(mask[None, None], s, _NEG_INF)
                p = torch.exp(s - lse[:, qs].transpose(1, 2)[..., None])
                dob = do32[:, qs]
                dv_blk[:, ks] += torch.einsum("bhqk,bqhd->bkhd", p, dob)
                dp = torch.einsum("bqhd,bkhd->bhqk", dob, vb)
                ds = p * (dp - dsum[:, qs].transpose(1, 2)[..., None])
                dq[:, qs] += torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
                dk_blk[:, ks] += torch.einsum("bhqk,bqhd->bkhd", ds,
                                              q32[:, qs]) * scale
            # the accumulators travel with their block; after n shifts
            # each is back with the block's owner
            dnxt, dreqs = comm.ring_shift(dkv, group)
            comm.wait_all(reqs)
            comm.wait_all(dreqs)
            kv = nxt if nxt is not None else kv
            dkv = dnxt
        dk, dv = _unpack(dkv, k.shape, 2)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, *, group=None, causal: bool = True,
                   scale: Optional[float] = None,
                   layout: str = "contiguous"):
    """Ring attention over the sequence shards of ``group`` (default: the
    world).  q, k, v: [B, S_local, H, D], this rank's shard (its rank in
    the group orders the shards); returns [B, S_local, H, D] in q's
    dtype.  ``layout="zigzag"``: the shards follow
    :func:`zigzag_positions` (feed a :func:`zigzag_permutation`-ordered
    sequence)."""
    if group is None:
        group = torch.distributed.group.WORLD
    S, D = q.shape[1], q.shape[3]
    if scale is None:
        scale = D ** -0.5
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}; expected "
                         "'contiguous' or 'zigzag'")
    if layout == "zigzag" and S % 2:
        raise ValueError(
            f"zigzag layout needs an even local shard, got S_local={S} "
            "(global seq_len must divide by 2*sp)")
    return _RingAttention.apply(q, k, v, group, causal, scale, layout)


def make_ring_attention_fn(mesh, *, causal: bool = True, rules=None,
                           layout: str = "contiguous"):
    """Ring attention over the mesh's ``sp`` group, on each rank's batch
    rows, sequence shard and local heads; plain local attention when the
    mesh has no ``sp`` axis above 1.  ``layout="zigzag"``: the caller
    feeds sequences permuted by :func:`zigzag_permutation`."""
    sp = mesh.shape.get("sp", 1) if mesh is not None else 1
    if sp <= 1:
        return functools.partial(local_attention, causal=causal)
    return functools.partial(ring_attention, group=mesh.get_group("sp"),
                             causal=causal, layout=layout)
