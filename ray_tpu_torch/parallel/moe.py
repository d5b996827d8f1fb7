"""Mixture-of-Experts with expert parallelism over an ``ep`` mesh axis.

Counterpart of ``ray_tpu/parallel/moe.py``: top-k token routing with a
static capacity, as one-hot dispatch and combine tensors ``[T, E, C]``
filled slot by slot in priority order, and the Switch-style load-balance
loss.  Under an ``ep`` axis (:func:`make_moe_fn`) the dispatched tokens
move to the rank that holds their expert with ``comm.all_to_all`` and come
back the same way, as the reference's ``lax.all_to_all`` moves them.

The reference's einsums are plain XLA (no ``pallas_call``); here they are
plain PyTorch.  Two details are pinned to the reference:

- ``lax.top_k`` breaks ties toward the lower expert index, which
  ``torch.topk`` does not promise; :func:`_top_k` sorts stably.
- ``jax.nn.gelu`` is the tanh approximation; :func:`_expert_ffn` asks
  for it (``F.gelu`` is erf by default).

The model's MoE FFN (``models/gpt.py``) routes the global batch as the
reference's GSPMD step does, while each rank holds only its own rows:
:class:`TokenOrder` gives each local token its place in the global order
(the counts of the ranks and rows before it, per expert), so capacity,
priority and the aux loss's means are the global ones
(:func:`route`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel import comm


class MoEParams(NamedTuple):
    wg: torch.Tensor   # [d, E] router
    w1: torch.Tensor   # [E, d, h]
    w2: torch.Tensor   # [E, h, d]


def init_moe_params(generator: torch.Generator, d_model: int, hidden: int,
                    n_experts: int, dtype=torch.float32,
                    device=None) -> MoEParams:
    """Random parameters at the reference's scales (router and w1 at
    ``d_model ** -0.5``, w2 at ``hidden ** -0.5``), drawn from
    ``generator`` on its device and moved to ``device`` (default: the
    generator's).  ``jax.random`` draws cannot be reproduced here; tests
    feed the reference's values in."""
    g = generator
    dev = device if device is not None else g.device

    def normal(shape, scale):
        x = torch.randn(shape, generator=g, device=g.device) * scale
        return x.to(dtype).to(dev)

    scale = d_model ** -0.5
    return MoEParams(wg=normal((d_model, n_experts), scale),
                     w1=normal((n_experts, d_model, hidden), scale),
                     w2=normal((n_experts, hidden, d_model),
                               hidden ** -0.5))


def capacity(num_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Each expert's buffer: ``max(top_k, int(cf * T * top_k / E))``, in
    the reference's Python float arithmetic."""
    return max(top_k, int(capacity_factor * num_tokens * top_k / n_experts))


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest per row, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


class TokenOrder:
    """Where this process's tokens sit among all tokens routed together.

    ``counts(onehot)`` gives, for each local token and expert, how many
    tokens ahead of it in the global order picked that expert in the
    same slot, and each expert's global count; ``sum`` adds a per-expert
    vector over every holder of tokens (``lax.psum``'s gradient: each
    holder differentiates its share of a summed loss), and
    ``num_tokens`` is the global count.  This base class is one process
    holding every token: a cumulative sum in token order."""

    def __init__(self, num_tokens: int):
        self.num_tokens = num_tokens

    def counts(self, onehot: torch.Tensor):
        """(tokens before each local token per expert, global count per
        expert)."""
        return torch.cumsum(onehot, 0) - onehot, onehot.sum(0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x


class ShardedTokenOrder(TokenOrder):
    """The tokens of a global batch ``[B, S]`` spread over the ranks of
    ``group`` (the mesh's data axes and ``sp``): group rank ``g`` holds
    ``rows`` rows of ``width`` tokens, rows ``data_index * rows ...`` of
    the batch and the ``seq_index``-th chunk of each row, with
    ``g = data_index * seq_shards + seq_index`` (the row-major order of
    the mesh coordinates).  Global token order is the batch's: row by
    row, each row's chunks in sequence order."""

    def __init__(self, group, *, rows: int, width: int, seq_shards: int,
                 num_tokens: int):
        super().__init__(num_tokens)
        self.group, self.rows, self.width = group, rows, width
        self.seq_shards = seq_shards
        self.n = comm.group_size(group)

    def counts(self, onehot: torch.Tensor):
        import torch.distributed as dist
        R, W, E = self.rows, self.width, onehot.shape[1]
        blocks = onehot.view(R, W, E)
        mine = blocks.sum(1)                                    # [R, E]
        every = torch.empty((self.n * R, E), dtype=mine.dtype,
                            device=mine.device)
        dist.all_gather_into_tensor(every, mine.contiguous(),
                                    group=self.group)
        D, SP = self.n // self.seq_shards, self.seq_shards
        # global block order (data rank, row, sequence chunk)
        ordered = every.view(D, SP, R, E).transpose(1, 2).reshape(-1, E)
        starts = torch.cumsum(ordered, 0) - ordered
        me = dist.get_rank(self.group)
        d_me, sp_me = divmod(me, SP)
        idx = (d_me * R + torch.arange(R, device=onehot.device)) * SP + sp_me
        offset = starts[idx]                                    # [R, E]
        within = torch.cumsum(blocks, 1) - blocks
        before = (within + offset[:, None, :]).reshape(R * W, E)
        return before, ordered.sum(0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return comm.psum(x, self.group)


def route(x: torch.Tensor, wg: torch.Tensor, top_k: int, capacity: int,
          order: Optional[TokenOrder] = None, *, gate_group=None):
    """Dispatch [T, E, C] (0/1), combine [T, E, C] (gate weights) and the
    aux loss for the tokens ``x`` [T, d] (``ray_tpu/parallel/moe.py:
    _route``).  Slot by slot, a token's place in its expert's buffer is
    the count of tokens ahead of it (``order``: this process's tokens
    among all routed together; default all of them here) plus what
    earlier slots used; places past ``capacity`` are dropped.  The aux
    loss is ``E * sum(me * ce)``: ``me`` the mean router probability and
    ``ce`` the share of tokens dispatched, per expert, over every
    token.  ``gate_group``: the gate values the combine takes pass
    through ``comm.copy_to_group`` over it (their gradient summed there:
    the ep ranks each combine their own experts), the aux loss's
    probabilities do not."""
    if order is None:
        order = TokenOrder(x.shape[0])
    T, E = x.shape[0], wg.shape[1]
    logits = torch.matmul(x.float(), wg.float())
    probs = torch.softmax(logits, dim=-1)
    _, expert_idx = _top_k(probs.detach(), top_k)
    gate_vals = comm.copy_to_group(probs, gate_group).gather(1, expert_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    slots = torch.arange(capacity, device=x.device)
    dispatch = torch.zeros((T, E, capacity), dtype=torch.float32,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    used = torch.zeros((E,), dtype=torch.long, device=x.device)
    for slot in range(top_k):
        onehot = F.one_hot(expert_idx[:, slot], E)              # [T, E]
        before, total = order.counts(onehot)
        pos = ((before + used[None, :]) * onehot).sum(1)        # [T]
        keep = pos < capacity
        pos_oh = (pos[:, None] == slots[None, :]).float()       # [T, C]
        sel = onehot.float() * keep[:, None].float()
        dispatch = dispatch + sel[:, :, None] * pos_oh[:, None, :]
        combine = combine + (sel * gate_vals[:, slot:slot + 1]
                             )[:, :, None] * pos_oh[:, None, :]
        # what this slot kept of each expert's remaining room
        used = torch.minimum(used + total,
                             torch.full_like(used, capacity))
    n = float(order.num_tokens)
    me = order.sum(probs.sum(0)) / n
    ce = order.sum((dispatch.sum(2) > 0).float().sum(0)).detach() / n
    aux = E * torch.sum(me * ce)
    return dispatch, combine, aux


def _expert_ffn(w1, w2, tokens):
    """tokens [E, C, d] -> [E, C, d] through each expert's FFN (GELU,
    tanh approximation as ``jax.nn.gelu``)."""
    h = torch.einsum("ecd,edh->ech", tokens, w1)
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h, w2)


def moe_layer(params: MoEParams, x: torch.Tensor, *, top_k: int = 2,
              capacity_factor: float = 1.5, group=None,
              expert_ffn: Optional[Callable] = None):
    """Apply an MoE FFN to ``x`` [T, d] (flatten batch and sequence
    first); returns ``(out [T, d] in x's dtype, aux)``.

    With ``group`` (the ``ep`` group, of more than one rank) it runs the
    expert-parallel path: ``x`` is this rank's tokens, ``params.w1`` and
    ``params.w2`` its shard of the experts (the router scores every
    expert); the capacity is local (this rank's T), dispatched tokens
    go to their expert's rank by ``comm.all_to_all`` and back, and the
    aux loss is averaged over the group, as the reference's shard_map
    body does."""
    if expert_ffn is None:
        expert_ffn = _expert_ffn
    T, d = x.shape
    E = params.wg.shape[1]
    n = comm.group_size(group)
    E_local = params.w1.shape[0]
    if E_local * n != E:
        raise ValueError(f"router scores {E} experts, but {n} ranks hold "
                         f"{E_local} each: the router must score all "
                         "global experts")
    cap = capacity(T, E, top_k, capacity_factor)
    dispatch, combine, aux = route(x, params.wg, top_k, cap)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x.float())
    # each expert's tokens to the rank holding it (over a group of one
    # the exchanges are the identity):
    # [E, C, d] -> [n, E_local, C, d] -> (from each rank) [E_local, n*C, d]
    got = comm.all_to_all(expert_in.view(n, E_local, cap, d), group)
    got = got.transpose(0, 1).reshape(E_local, n * cap, d)
    expert_out = expert_ffn(params.w1.float(), params.w2.float(), got)
    # and back: [E_local, n, C, d] -> [n, E_local, C, d] -> [E, C, d]
    back = expert_out.view(E_local, n, cap, d).transpose(0, 1)
    back = comm.all_to_all(back.contiguous(), group).reshape(E, cap, d)
    out = torch.einsum("tec,ecd->td", combine, back)
    return out.to(x.dtype), comm.psum(aux, group) / n


def make_moe_fn(mesh, *, top_k: int = 2, capacity_factor: float = 1.5
                ) -> Callable:
    """The expert-parallel MoE for a mesh with an ``ep`` axis
    (``make_moe_fn`` of the reference): ``fn(params, x) -> (out, aux)``,
    where on ``ep`` above 1 ``x`` is this rank's shard of the tokens
    (rows ``r T/ep ...``, the reference's ``P("ep", None)``) and
    ``params.w1``/``w2`` its shard of the experts (``P("ep")``), and the
    output is this rank's rows.  On ``ep`` of 1 it is the dense layer."""
    from ray_tpu_torch.parallel.mesh import mesh_groups
    g = mesh_groups(mesh)
    if g.size("ep") <= 1:
        def dense(params, x):
            return moe_layer(params, x, top_k=top_k,
                             capacity_factor=capacity_factor)
        return dense

    def fn(params, x):
        return moe_layer(params, x, top_k=top_k,
                         capacity_factor=capacity_factor, group=g.ep)
    return fn
