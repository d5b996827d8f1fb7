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

The overlap schedule (``parallel/overlap.py``) differentiates each
rank's *distinct share* of the loss, whose sum over the ranks is the
objective, as the reference's ``shard_map`` body does.  Its collectives
therefore transpose as ``lax``'s do:

- :func:`psum`: all-reduce, all-reduce of the gradient (``lax.psum``);
  :func:`all_reduce_max` is its ``pmax`` of a stopped value;
- :func:`psum_scatter`: reduce-scatter along a dimension, all-gather of
  the gradient (``lax.psum_scatter``);
- :func:`ring_shift_start`: a send to the next rank of the group,
  received from the previous one, whose gradient shifts back
  (``lax.ppermute``);
- :func:`all_gather_start`: :func:`all_gather_dim` issued now and waited
  on at first use (the schedule's prefetch).

The two ``*_start`` functions return a :class:`Pending`: the transfer is
in flight once it returns, and ``wait()`` lands it (on a card, the
current stream waits for it) as the output of an autograd node whose
input is the tensor sent, so the gradient flows back to it.

Every function is the identity when ``group`` is None.

The pipeline (``parallel/pipeline.py``) moves activations and their
cotangents between neighbouring stages with :func:`stage_exchange`: one
tick's sends and receives, posted together (``batch_isend_irecv``) and
waited on together.  These are plain transfers, outside autograd: the
pipeline schedules its backward by hand.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The gathered tensor, contiguous (the kernels take contiguous
    operands) whatever ``dim``."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    full = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(full, src, group=group)
    return full.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


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


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of every rank's ``x``; the gradient is the
    sum over the group of every rank's gradient (``lax.psum``: each rank
    differentiates its own share of a summed objective)."""
    if group_size(group) == 1:
        return x
    return _PSum.apply(x, group)


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def psum_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of every rank's ``x``, of which this rank
    keeps its chunk along ``dim`` (chunk r to group rank r); the
    gradient is all-gathered along ``dim`` (``lax.psum_scatter`` with
    ``tiled=True``)."""
    if group_size(group) == 1:
        return x
    return _PSumScatter.apply(x, dim, group)


class Pending:
    """A collective in flight.  ``wait()`` lands it once and returns its
    output, the output of an autograd node whose input is the tensor it
    sent (``_Land``); what the collective holds is released then.
    ``grad(g)`` gives that input's gradient, under the profiler range
    ``name`` when one is given."""

    def __init__(self, x: torch.Tensor, works: List, finish, grad,
                 name: Optional[str] = None):
        self._x, self._works, self._finish = x, works, finish
        self.grad, self.name = grad, name
        self._out: Optional[torch.Tensor] = None

    def wait(self) -> torch.Tensor:
        if self._out is None:
            self._out = _Land.apply(self._x, self)
            self._x = None
        return self._out

    def land(self) -> torch.Tensor:
        wait_all(self._works)
        out = self._finish()
        self._works = self._finish = None
        return out


class _Land(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pending: Pending):
        # the node keeps the gradient rule, not the Pending (whose output
        # would then live as long as the graph)
        ctx.grad, ctx.name = pending.grad, pending.name
        return pending.land()

    @staticmethod
    def backward(ctx, g):
        if ctx.name is None:
            return ctx.grad(g), None
        with torch.profiler.record_function(ctx.name):
            return ctx.grad(g), None


class Landed:
    """What a ``*_start`` returns for a group of one: ``x`` itself."""

    def __init__(self, x: torch.Tensor):
        self._x = x

    def wait(self) -> torch.Tensor:
        return self._x


def all_gather_start(x: torch.Tensor, dim: int, group, *,
                     name: Optional[str] = None) -> Pending:
    """:func:`all_gather_dim` issued now (``async_op``); ``wait()`` gives
    the gathered tensor, whose gradient reduce-scatters back to ``x``
    when autograd reaches the wait."""
    if group_size(group) == 1:
        return Landed(x)
    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    full = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    work = dist.all_gather_into_tensor(full, src, group=group, async_op=True)
    return Pending(x, [work], lambda: full.movedim(0, dim).contiguous(),
                   lambda g: _reduce_scatter(g, dim, group), name=name)


def ring_shift_start(x: torch.Tensor, group) -> Pending:
    """Send ``x`` to the next rank of the group and receive the previous
    rank's (``lax.ppermute`` with ``perm = [(i, i + 1 mod n)]``), posted
    now; ``wait()`` gives the received tensor, whose gradient is shifted
    back to the previous rank when autograd reaches the wait."""
    if group_size(group) == 1:
        return Landed(x)
    flat = x.detach().contiguous()
    recv, reqs = ring_shift(flat, group)
    return Pending(x, reqs, lambda: recv,
                   lambda g: _shift_back(g, group))


def _shift_back(g: torch.Tensor, group) -> torch.Tensor:
    """The adjoint of a shift to the next rank: a shift to the previous
    one."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    g = g.contiguous()
    recv = torch.empty_like(g)
    wait_all(dist.batch_isend_irecv([
        dist.P2POp(dist.isend, g, prv, group),
        dist.P2POp(dist.irecv, recv, nxt, group)]))
    return recv


def stage_exchange(sends: "List[tuple]", recvs: "List[tuple]") -> None:
    """One pipeline tick's point-to-point transfers: ``sends`` are
    ``(tensor, global rank)`` pairs, ``recvs`` ``(buffer, global rank)``
    pairs filled in place.  Every transfer of the tick is posted at once
    and all are waited on before this returns, so two neighbours that
    each send to the other in the same tick cannot block each other (on
    gloo or NCCL); a tick with no transfer does nothing."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer) for buf, peer in recvs]
    if ops:
        wait_all(dist.batch_isend_irecv(ops))
