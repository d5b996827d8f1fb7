"""Differentiable collectives for the sharded model and the attention
hooks.

The reference gets these from GSPMD (the shardings of ``models/gpt.py``'s
``constrain`` calls) and from ``shard_map`` bodies (``lax.all_to_all``,
``lax.ppermute``); the port writes each as a ``torch.autograd.Function``
over a ``torch.distributed`` group:

- :func:`all_gather_dim`: all-gather along a dimension, reduce-scatter
  of the gradient (ZeRO-3's gather of an fsdp-sharded weight);
- :func:`copy_to_group`: identity, all-reduce of the gradient (Megatron's
  ``f``, before a column-parallel matmul);
- :func:`reduce_from_group`: all-reduce, identity gradient (Megatron's
  ``g``, after a row-parallel matmul);
- :func:`all_to_all`: ``all_to_all_single`` on dim 0 chunks, its own
  adjoint (Ulysses' resharding);
- :func:`ring_shift`: one step of a ring, no gradient (ring attention's
  own backward moves its gradients).

Every function is the identity when ``group`` is None.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        src = x.movedim(dim, 0).contiguous()
        full = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(full, src, group=group)
        return full.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        src = g.movedim(ctx.dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full tensor from every rank's shard along ``dim`` (in group
    rank order); the gradient is reduce-scattered back (summed over the
    group, each rank keeping its shard)."""
    if group_size(group) == 1:
        return x
    return _GatherDim.apply(x, dim, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over the group (each rank's
    column-parallel matmul contributes its part of the input's
    gradient)."""
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of every rank's ``x``; the gradient passes
    through unchanged (it is the same on every rank)."""
    if group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n, ...]: chunk j goes to group rank j, and the chunk from
    rank j lands at index j.  The exchange is its own adjoint."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group (no gradient)."""
    if group_size(group) == 1:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def ring_shift(flat: torch.Tensor, group) -> "List":
    """Start one ring step: send ``flat`` to the next rank of the group,
    receive the previous rank's into a new buffer.  Returns (buffer,
    requests); wait on every request before reading the buffer."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    recv = torch.empty_like(flat)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, flat, nxt, group),
        dist.P2POp(dist.irecv, recv, prv, group)])
    return recv, reqs


def wait_all(reqs: Optional[List]) -> None:
    for r in reqs or ():
        r.wait()
