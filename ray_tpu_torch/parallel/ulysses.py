"""Ulysses sequence parallelism: all-to-all head resharding.

Counterpart of ``ray_tpu/parallel/ulysses.py``.  The alternative to ring
attention: one ``all_to_all`` over the ``sp`` group trades each rank's
sequence shard of all its heads for the whole sequence of ``H / sp`` of
them, every rank runs full-sequence attention on those heads, and a
second ``all_to_all`` restores the sequence sharding.  Two collectives a
layer instead of ``sp`` ring steps.  ``H`` is the rank's local head
count, so it composes with tp (heads split over tp, then sp).  The
exchanges are ``comm.all_to_all``, whose gradient is the same exchange,
so the backward is autograd's.
"""

from __future__ import annotations

import functools
from typing import Optional

from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.ring_attention import local_attention


def _seq_to_heads(x, group, n: int):
    """[B, S/n, H, D] (this rank's sequence shard) -> [B, S, H/n, D] (its
    head chunk of the whole sequence)."""
    B, S, H, D = x.shape
    x = x.reshape(B, S, n, H // n, D).permute(2, 0, 1, 3, 4).contiguous()
    y = comm.all_to_all(x, group)              # [src rank, B, S/n, H/n, D]
    return y.permute(1, 0, 2, 3, 4).reshape(B, n * S, H // n, D)


def _heads_to_seq(x, group, n: int):
    """The inverse of :func:`_seq_to_heads`."""
    B, S, h, D = x.shape
    x = x.reshape(B, n, S // n, h, D).permute(1, 0, 2, 3, 4).contiguous()
    y = comm.all_to_all(x, group)              # [head chunk, B, S/n, h, D]
    return y.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * h, D)


def ulysses_attention(q, k, v, *, group, causal: bool = True,
                      scale: Optional[float] = None, attn_impl=None):
    """q, k, v: [B, S_local, H, D], this rank's sequence shard (ordered
    by its rank in ``group``) -> [B, S_local, H, D]."""
    n = comm.group_size(group)
    inner = attn_impl or local_attention
    H = q.shape[2]
    if H % n:
        raise ValueError(f"heads={H} not divisible by sp={n}")
    q, k, v = (_seq_to_heads(t, group, n) for t in (q, k, v))
    out = inner(q, k, v, causal=causal, scale=scale)
    return _heads_to_seq(out, group, n)


def make_ulysses_attention_fn(mesh, *, causal: bool = True,
                              scale: Optional[float] = None,
                              attn_impl=None):
    """``fn(q, k, v) -> out`` for [B, S, H, D] inputs whose sequence is
    sharded over the mesh's ``sp`` group; a drop-in for
    ``make_ring_attention_fn``.  ``attn_impl(q, k, v, causal=...,
    scale=...)`` runs the full-sequence attention (default: the plain
    ``local_attention``, as in the reference)."""
    sp = mesh.shape.get("sp", 1) if mesh is not None else 1
    if sp <= 1:
        return functools.partial(attn_impl or local_attention,
                                 causal=causal, scale=scale)
    return functools.partial(ulysses_attention, group=mesh.get_group("sp"),
                             causal=causal, scale=scale,
                             attn_impl=attn_impl)
