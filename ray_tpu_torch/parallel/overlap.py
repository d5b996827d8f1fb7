"""The overlap-scheduled training path: every collective written by hand.

Counterpart of ``ray_tpu/parallel/overlap.py``.  The default ("gspmd")
schedule of ``models/training.py`` runs the collectives where GSPMD puts
them in the reference's step: the weight all-gathers where a layer uses
its weights, the gradient reductions once, after the backward.  This
module builds the schedule the reference writes in ``shard_map``, as an
opt-in path beside it (``RAY_TPU_COMM=overlap``, :func:`comm_config`):

1. **Prefetched per-block fsdp weight all-gathers.**  Each rank keeps its
   shards; block i+1's all-gather is issued (``async_op``) before block
   i's compute and waited on when block i+1 starts
   (``comm.all_gather_start``).  With ``cfg.remat`` the gather moves
   inside the recomputed block instead (``torch.utils.checkpoint``):
   only the local shard is saved, and the backward gathers again.
2. **Per-block gradient reduce-scatters.**  The gradient of a gathered
   weight reduce-scatters back to its shard when autograd reaches that
   block's gather, so the reductions run as the backward completes each
   block (the last block's first), not in one pass after it.
3. **Ring all-gather-matmul for tp.**  Activations travel the tp ring
   sequence-sharded; each projection into a tp-sharded dimension (q/k/v,
   the MLP's up and gate, the vocabulary head) is a
   :func:`ring_allgather_matmul`, whose hops each post the send of the
   resident chunk before that chunk's matmuls, and the projections out
   (attention out, MLP down) reduce-scatter back to sequence shards
   (:func:`psum_scatter_tokens`).

Each rank differentiates its *distinct share* of the global mean loss
(:func:`_overlap_local_obj`): the objective is the sum over ranks, so
every collective inside it transposes as ``lax``'s do (``comm.psum``,
``comm.psum_scatter``, the ring shift's shift back), which is not the
convention of the gspmd path's collectives (Megatron's ``g`` there has
an identity gradient).  Leaves replicated over a mesh axis get their
gradient summed over it afterwards (:func:`_missing_axes`), the pod-local
axes first and then the ``dcn`` leg.

``RAY_TPU_COMM_QUANT`` picks the wire per tier: block-scaled int8 codes
plus one f32 scale per :data:`WIRE_BLOCK` elements (``ray_tpu_torch.quant``)
on the fsdp gathers (rounded to nearest) and their transposed
reduce-scatters (rounded stochastically at every hop, accumulated in f32
between hops), and on the ``dcn`` all-reduce leg (:func:`quant_psum`).
The stochastic draws come from one ``torch.Generator`` per (stream,
rank) on the device (``quant.stochastic_generator``), which advances with
every hop and step; they cannot equal the reference's ``jax.random``
draws.

There is no ``shard_map``: each rank runs the local program on its own
shards (``parallel.sharding.shard_params``, ``shard_batch``).
Attention is the per-rank entry point the gspmd path uses
(``ops.attention.make_flash_attention_fn``: the kernels on the card, the
plain version on the CPU) at ``n_heads / tp`` local heads; the norms,
the projections and the vocabulary-parallel CE are plain, as the
reference writes them.

Scope, as the reference's: meshes over ``dcn``, ``dp``, ``fsdp`` and
``tp``, dense blocks.  ``build_gpt_train`` falls back loudly to gspmd
for the rest (:func:`overlap_supported`).  Whether a transfer hides
behind compute can only be measured on several cards.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel import sharding as shd


# ---------------------------------------------------------------------------
# dispatch config: the home of the comm-schedule knobs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommConfig:
    """The comm-schedule knobs, resolved once from the environment.

    - ``RAY_TPU_COMM`` (default ``gspmd``): the schedule of the sharded
      GPT train step on a mesh of several devices: ``gspmd`` (the
      collectives where GSPMD puts them in the reference) or ``overlap``
      (this module's schedule).
    - ``RAY_TPU_COMM_QUANT`` (default ``none``): the overlap schedule's
      wire, per tier: ``none`` (alias ``off``) moves ``cfg.dtype``
      everywhere; ``int8`` (alias ``all``) moves block-scaled int8 on
      the fsdp gathers and reduce-scatters and on the ``dcn`` leg;
      ``dcn`` only on the ``dcn`` leg (the gradient all-reduce across
      nodes).  Only the overlap schedule honours it, so
      ``build_gpt_train`` drops it loudly under gspmd.
    """
    mode: str = "gspmd"
    quant: str = "none"


_CONFIG: Optional[CommConfig] = None


def comm_config(refresh: bool = False) -> CommConfig:
    """The process-wide :class:`CommConfig` (env read once, cached).

    ``refresh=True`` re-reads the environment.  Unknown values are
    printed on stderr and replaced by the defaults, as in the
    reference."""
    global _CONFIG
    if _CONFIG is None or refresh:
        mode = os.environ.get("RAY_TPU_COMM", "gspmd")
        if mode not in ("gspmd", "overlap"):
            print(f"RAY_TPU_COMM={mode!r} unknown; using 'gspmd'",
                  file=sys.stderr)
            mode = "gspmd"
        quant = os.environ.get("RAY_TPU_COMM_QUANT", "none")
        quant = {"off": "none", "all": "int8"}.get(quant, quant)
        if quant not in ("none", "int8", "dcn"):
            print(f"RAY_TPU_COMM_QUANT={quant!r} unknown; using 'none'",
                  file=sys.stderr)
            quant = "none"
        _CONFIG = CommConfig(mode=mode, quant=quant)
    return _CONFIG


def _sizes(mesh) -> Dict[str, int]:
    """A mesh's axis sizes by name: a live mesh, a ``MeshSpec``, or None
    (no axes)."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    return {} if mesh is None else MeshSpec.from_mesh(mesh).to_dict()


def _shape_mesh(mesh):
    """What the spec functions read of a mesh (its ``shape`` by name),
    for a live mesh or a ``MeshSpec`` alike."""
    return types.SimpleNamespace(shape=_sizes(mesh))


def overlap_supported(cfg, mesh) -> Optional[str]:
    """None if the overlap schedule can run this (cfg, mesh); else the
    reason the caller prints when falling back to gspmd."""
    shape = _sizes(mesh)
    for axis in ("sp", "pp", "ep"):
        if shape.get(axis, 1) > 1:
            return f"mesh has {axis}>1 (overlap path covers dp/fsdp/tp)"
    if getattr(cfg, "n_experts", 0) > 0:
        return "MoE blocks not supported by the overlap schedule"
    fsdp = shape.get("fsdp", 1)
    tp = shape.get("tp", 1)
    if cfg.d_model % fsdp:
        return f"d_model={cfg.d_model} not divisible by fsdp={fsdp}"
    if cfg.n_heads % tp:
        return f"n_heads={cfg.n_heads} not divisible by tp={tp}"
    if cfg.ff_dim % tp:
        return f"d_ff={cfg.ff_dim} not divisible by tp={tp}"
    if cfg.vocab_size % tp:
        return f"vocab={cfg.vocab_size} not divisible by tp={tp}"
    return None


# ---------------------------------------------------------------------------
# ring all-gather-matmul
# ---------------------------------------------------------------------------

def ring_allgather_matmul(x: torch.Tensor, ws, group, *, out_dtype=None):
    """All-gather ``x``'s token dimension around the group's ring, fused
    with matmuls.

    ``x``: ``[..., T, K]``, the token dimension sharded over the group;
    each ``w`` in ``ws``: ``[K, *rest]`` (full K, this rank's output
    columns).  Returns ``[..., W*T, *rest]`` per ``w``: numerically
    ``all_gather(x, tokens) @ w``, computed as W ring steps, each of
    which posts the send of the resident chunk to the next rank
    (``comm.ring_shift_start``), multiplies the chunk with every weight
    (writing it at its source rank's token offset) and then waits for
    the next chunk.  Several ``ws`` (q/k/v; the MLP's up and gate) move
    each chunk once for all of them.  The backward is autograd's: the
    shifts shift their gradients back, and each chunk's matmul gives
    its share of the weights' gradients.

    ``group`` None (or of one rank) gives plain matmuls.  ``out_dtype``
    computes the products in that dtype (the vocabulary head's f32
    logits, the reference's ``preferred_element_type``)."""
    single = not isinstance(ws, (list, tuple))
    ws_list: List[torch.Tensor] = [ws] if single else list(ws)

    def mm(chunk, w):
        wf = w.reshape(w.shape[0], -1)
        if out_dtype is not None:
            chunk, wf = chunk.to(out_dtype), wf.to(out_dtype)
        return torch.matmul(chunk, wf).reshape(chunk.shape[:-1]
                                               + w.shape[1:])

    W = comm.group_size(group)
    if W == 1:
        outs = [mm(x, w) for w in ws_list]
        return outs[0] if single else outs
    import torch.distributed as dist
    rank = dist.get_rank(group)
    tok_dim = x.dim() - 2
    parts: List[List[Optional[torch.Tensor]]] = [[None] * W for _ in ws_list]
    chunk = x
    for step in range(W):
        # after `step` hops the resident chunk came from rank - step
        src = (rank - step) % W
        nxt = comm.ring_shift_start(chunk, group) if step != W - 1 else None
        for j, w in enumerate(ws_list):
            parts[j][src] = mm(chunk, w)
        if nxt is not None:
            chunk = nxt.wait()
    outs = [torch.cat(p, dim=tok_dim) for p in parts]
    return outs[0] if single else outs


def psum_scatter_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """Reduce a tp-partial ``[..., W*T, M]`` and scatter its token chunks
    back to their ranks (``[..., T, M]``, chunk r to rank r, the order of
    :func:`ring_allgather_matmul`).  Identity without a ring."""
    return comm.psum_scatter(x, x.dim() - 2, group)


# ---------------------------------------------------------------------------
# spec plumbing
# ---------------------------------------------------------------------------

def _spec_axes(spec) -> set:
    return set(shd.spec_axes(spec))


def _param_specs(cfg, mesh):
    """The spec of each parameter leaf (the gspmd path's rule table)."""
    from ray_tpu_torch.models import gpt as gpt_mod
    return shd.tree_specs(_shape_mesh(mesh), gpt_mod.param_logical_axes(cfg))


def _gather_axis_dims(spec, axis_name: str) -> List[int]:
    return [d for d, entry in enumerate(spec)
            if entry == axis_name
            or (isinstance(entry, tuple) and axis_name in entry)]


def _sorted_leaves(tree, prefix: Tuple[str, ...] = ()) -> List[tuple]:
    """(key path, leaf) of a dict tree in sorted key-path order: the
    reference's flatten order, which every rank shares whatever order
    its tree was built in."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_sorted_leaves(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _rebuild_like(tree, values: Dict[tuple, Any], prefix=()):
    """``tree``'s structure (and key order) with ``values[path]``."""
    return {k: (_rebuild_like(v, values, prefix + (k,))
                if isinstance(v, dict) else values[prefix + (k,)])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the int8 wire
# ---------------------------------------------------------------------------

#: Wire-quantization block: one f32 scale per 128 int8 codes, 1.03125
#: bytes an element against bf16's 2.  ``collective_bytes_per_step`` and
#: the payloads share it.
WIRE_BLOCK = 128


def _to2d(x: torch.Tensor, dim: int):
    """Move ``dim`` to the front and flatten the rest: ``[n, rest]``, the
    wire's layout (scale blocks run along the flattened other axes)."""
    xm = x.movedim(dim, 0)
    return xm.reshape(xm.shape[0], -1), tuple(xm.shape)


def _from2d(x2: torch.Tensor, moved_shape, dim: int) -> torch.Tensor:
    """Inverse of :func:`_to2d`; ``x2``'s leading size may have grown
    (gathered) or shrunk (scattered) against ``moved_shape[0]``."""
    return x2.reshape((x2.shape[0],) + tuple(moved_shape[1:])).movedim(0, dim)


def _quant_ring_reduce_scatter(g2: torch.Tensor, group,
                               generator: torch.Generator) -> torch.Tensor:
    """Wire-quantized ring reduce-scatter of ``[W*T, rest]`` to this
    rank's ``[T, rest]`` chunk sum (f32): the transpose of a tiled
    all-gather along dim 0, every hop carrying int8 codes and per-block
    f32 scales.

    W-1 hops: the partial sum bound for rank b starts at rank b+1 and
    gains one local chunk a hop.  Each hop requantizes the partial sum
    with stochastic rounding (``generator``'s draws), so the rounding is
    unbiased; the sum stays f32 between hops."""
    from ray_tpu_torch.quant import dequantize_block, quantize_block
    W = comm.group_size(group)
    gf = g2.float()
    if W == 1:
        return gf
    import torch.distributed as dist
    rank = dist.get_rank(group)
    T = g2.shape[0] // W

    def chunk(i):
        return gf[i * T:(i + 1) * T]

    acc = chunk((rank - 1) % W)
    for hop in range(1, W):
        q, s = quantize_block(acc, block=WIRE_BLOCK, axis=-1,
                              mode="stochastic", generator=generator)
        q_in, reqs = comm.ring_shift(q.contiguous(), group)
        s_in, reqs_s = comm.ring_shift(s.contiguous(), group)
        local = chunk((rank - 1 - hop) % W)
        comm.wait_all(reqs + reqs_s)
        acc = dequantize_block(q_in, s_in, block=WIRE_BLOCK, axis=-1) + local
    return acc


def quant_all_gather_start(x: torch.Tensor, group, dim: int,
                           generator: torch.Generator, *,
                           name: Optional[str] = None):
    """The int8 wire's all-gather of ``x`` along ``dim``, issued now (the
    reference's ``quant_all_gather`` is this landed at once).

    Forward: the local shard is quantized (rounded to nearest: gathered
    weights are read many times, so bias does not build up) in
    :func:`_to2d` layout, its codes and scales are all-gathered, and
    ``wait()`` dequantizes them to ``x.dtype``; scale blocks never cross
    a shard boundary.  Backward: the gradient reduce-scatters through
    :func:`_quant_ring_reduce_scatter` (stochastic rounding every hop).
    Both move ~1.03 bytes an element."""
    from ray_tpu_torch.quant import dequantize_block, quantize_block
    if comm.group_size(group) == 1:
        return comm.Landed(x)
    out_dtype = x.dtype
    x2, moved = _to2d(x.detach(), dim)
    q, s = quantize_block(x2.float(), block=WIRE_BLOCK, axis=-1,
                          mode="nearest")
    n = comm.group_size(group)
    import torch.distributed as dist
    qg = q.new_empty((n * q.shape[0],) + tuple(q.shape[1:]))
    sg = s.new_empty((n * s.shape[0],) + tuple(s.shape[1:]))
    works = [dist.all_gather_into_tensor(qg, q.contiguous(), group=group,
                                         async_op=True),
             dist.all_gather_into_tensor(sg, s.contiguous(), group=group,
                                         async_op=True)]

    def finish():
        full2 = dequantize_block(qg, sg, block=WIRE_BLOCK, axis=-1)
        return _from2d(full2, moved, dim).to(out_dtype)

    def grad(g):
        g2, g_moved = _to2d(g, dim)
        local2 = _quant_ring_reduce_scatter(g2, group, generator)
        return _from2d(local2, g_moved, dim).to(out_dtype)

    return comm.Pending(x, works, finish, grad, name=name)


def quant_psum(x: torch.Tensor, group,
               generator: torch.Generator) -> torch.Tensor:
    """Wire-quantized all-reduce over ``group`` (no autograd: it runs on
    gradients): a quantized ring reduce-scatter of the payload flattened
    to ``[W, chunk]`` (``chunk`` padded to a multiple of
    :data:`WIRE_BLOCK`; stochastic rounding every hop), then an
    all-gather of the reduced chunk as int8 codes and f32 scales rounded
    to nearest.  The ``dcn`` leg of the gradient reduction."""
    from ray_tpu_torch.quant import dequantize_block, quantize_block
    W = comm.group_size(group)
    if W == 1:
        return x
    shape, dtype = x.shape, x.dtype
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    chunk = -(-n // (W * WIRE_BLOCK)) * WIRE_BLOCK
    pad = W * chunk - n
    if pad:
        flat = F.pad(flat, (0, pad))
    acc = _quant_ring_reduce_scatter(flat.reshape(W, chunk), group,
                                     generator)              # [1, chunk]
    q, s = quantize_block(acc, block=WIRE_BLOCK, axis=-1, mode="nearest")
    with torch.no_grad():
        qg = comm.all_gather_dim(q, 0, group)
        sg = comm.all_gather_dim(s, 0, group)
    full = dequantize_block(qg, sg, block=WIRE_BLOCK, axis=-1).reshape(-1)
    return full[:n].reshape(shape).to(dtype)


def _gather_leaf_start(x: torch.Tensor, spec, group, *, quant: str = "none",
                       generator: Optional[torch.Generator] = None,
                       name: Optional[str] = None):
    """The fsdp all-gather of one leaf (along its one fsdp dimension),
    issued now: a ``comm.Pending`` (or ``comm.Landed`` when the leaf is
    not fsdp-sharded or there is no group)."""
    dims = _gather_axis_dims(spec, "fsdp")
    if group is None or not dims:
        return comm.Landed(x)
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards more than one dimension "
                         "over fsdp")
    if quant == "int8" and x.dim() >= 2:
        # a 1-D leaf would move at its dtype; no GPT leaf is one
        return quant_all_gather_start(x, group, dims[0], generator,
                                      name=name)
    return comm.all_gather_start(x, dims[0], group, name=name)


def _gather_leaf(x, spec, group, *, quant: str = "none", generator=None):
    return _gather_leaf_start(x, spec, group, quant=quant,
                              generator=generator).wait()


# ---------------------------------------------------------------------------
# the overlap-scheduled forward (each rank's local program)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Plan:
    """What the local program reads: the groups (None where an axis is
    1), this rank's tp coordinate, the specs, the attention entry point,
    the fsdp wire and the stochastic generators."""
    tp: Any
    tp_size: int
    tp_rank: int
    fsdp: Any
    reduce: Any
    layer_specs: Dict[str, Any]
    specs: Dict[str, Any]
    attn_fn: Any
    quant: str
    generators: Dict[int, torch.Generator]
    rank: int
    device: torch.device

    def generator(self, base: int) -> torch.Generator:
        """The stochastic stream ``base`` of this rank (made on first
        use, on the plan's device)."""
        if base not in self.generators:
            from ray_tpu_torch.quant import stochastic_generator
            self.generators[base] = stochastic_generator(base, self.rank,
                                                         self.device)
        return self.generators[base]


def _block_apply(lp, x, cfg, *, positions, tp, attn_fn):
    """One transformer block on sequence-sharded activations.

    ``lp``: the layer's weights, fsdp-gathered (full d), heads and MLP
    columns tp-local.  ``x``: ``[B_local, S/tp, d]``.  ``gpt.layer_apply``'s
    numerics with the tp collectives explicit: ring all-gather-matmul
    into the block, reduce-scatter out of it."""
    from ray_tpu_torch.models import gpt as gpt_mod
    eps = gpt_mod.norm_eps(cfg)
    h = gpt_mod._norm(x, lp["ln1"], cfg.norm, bias=lp.get("ln1_b"), eps=eps)
    q, k, v = ring_allgather_matmul(h, [lp["wq"], lp["wk"], lp["wv"]], tp)
    if "bq" in lp:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    if cfg.pos == "rope" and getattr(attn_fn, "fused_rope", False):
        attn = attn_fn(q, k, v, positions=positions)
    else:
        if cfg.pos == "rope":
            q = gpt_mod._rope(q, positions, cfg.rope_theta)
            k = gpt_mod._rope(k, positions, cfg.rope_theta)
        attn = attn_fn(q, k, v)
    B, S, Hn, hd = attn.shape
    proj = torch.matmul(attn.reshape(B, S, Hn * hd),
                        lp["wo"].reshape(Hn * hd, -1))
    proj = psum_scatter_tokens(proj, tp)
    if "bo" in lp:
        proj = proj + lp["bo"]     # after the reduce: once per token
    x = x + proj
    h2 = gpt_mod._norm(x, lp["ln2"], cfg.norm, bias=lp.get("ln2_b"), eps=eps)
    if cfg.act == "swiglu":
        hu, g = ring_allgather_matmul(h2, [lp["w1"], lp["w3"]], tp)
        if "b1" in lp:
            hu = hu + lp["b1"]
            g = g + lp["b3"]
        hmid = F.silu(hu) * g
    else:
        (hu,) = ring_allgather_matmul(h2, [lp["w1"]], tp)
        if "b1" in lp:
            hu = hu + lp["b1"]
        hmid = gpt_mod._gelu(hu)
    down = psum_scatter_tokens(torch.matmul(hmid, lp["w2"]), tp)
    if "b2" in lp:
        down = down + lp["b2"]
    return x + down


def _embed_local(tokens, cfg, *, d_full_table, pos_table, tp, tp_rank,
                 seq_offset: int, s_local: int):
    """Vocabulary-parallel embedding to this rank's sequence shard.

    ``d_full_table``: the embedding's shard with d all-gathered over
    fsdp, ``[V/tp, d]``.  Every tp rank looks up all its rows' tokens in
    its vocabulary slice (zeros outside it), and the partial rows
    reduce-scatter to sequence shards.  Without a tp ring, a lookup.
    ``pos_table`` (learned positions, d gathered): the shard's rows
    ``seq_offset ..`` are added after the reduce."""
    table = d_full_table.to(cfg.dtype)
    if tp is None:
        x = table[tokens]
    else:
        v_local = table.shape[0]
        rel = tokens.long() - tp_rank * v_local
        ok = (rel >= 0) & (rel < v_local)
        x = table[rel.clamp(0, v_local - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        x = psum_scatter_tokens(x, tp)
    if pos_table is not None:
        x = x + pos_table.to(cfg.dtype)[seq_offset:seq_offset + s_local]
    return x


def _vocab_parallel_ce(logits_local, targets, *, tp, tp_rank):
    """Per-token nll ``[N]`` from tp-column-sharded f32 logits ``[N,
    V/tp]`` (every rank holds all N tokens and its vocabulary slice).

    The log-sum-exp combines over the ring with the max of the stopped
    row maxima (``comm.all_reduce_max``: exact gradients, the
    log-sum-exp does not depend on the shift); the sum of exponentials
    and the target logit, which lives on one rank, are ``comm.psum``'d,
    whose gradient is summed over the ring too.  Masked (-1) targets are
    the caller's: the nll is returned unmasked."""
    V_local = logits_local.shape[-1]
    if tp is None:
        m = logits_local.detach().amax(-1)
        z = torch.exp(logits_local - m[:, None]).sum(-1)
        true = logits_local.gather(
            1, targets.long().clamp_min(0)[:, None])[:, 0]
    else:
        m = comm.all_reduce_max(logits_local.detach().amax(-1), tp)
        z = comm.psum(torch.exp(logits_local - m[:, None]).sum(-1), tp)
        rel = targets.long() - tp_rank * V_local
        ok = (rel >= 0) & (rel < V_local)
        picked = logits_local.gather(1, rel.clamp(0, V_local - 1)[:, None])
        true = comm.psum(torch.where(ok, picked[:, 0], 0.0), tp)
    return m + torch.log(z) - true


def _overlap_local_obj(params, tokens, targets, cfg, *, plan: _Plan):
    """This rank's *distinct share* of the global mean NLL.

    ``params``/``tokens``/``targets`` are the local shards; the shares
    sum to the global loss over every rank (rows over dcn/dp/fsdp,
    sequence chunks over tp).  That is what makes each collective's
    gradient rule (``psum`` to ``psum``, all-gather to reduce-scatter,
    shift to shift back) give the true cross-rank gradient; only leaves
    replicated over an axis need the explicit gradient sum of
    :func:`build_overlap_step_fns`."""
    from ray_tpu_torch.models import gpt as gpt_mod
    tp = plan.tp
    B, S = tokens.shape
    if S % plan.tp_size:
        raise ValueError(
            f"overlap path needs seq={S} divisible by tp={plan.tp_size}")
    S_local = S // plan.tp_size
    seq_offset = plan.tp_rank * S_local
    positions = torch.arange(S, device=tokens.device)
    quant = plan.quant
    # the generators' bases are the reference's key_base values: 1 the
    # embedding, 2 the learned positions, 3 the untied head, 16 the
    # layer gathers (one stream for every block)
    embed_full_d = _gather_leaf(params["embed"], plan.specs["embed"],
                                plan.fsdp, quant=quant,
                                generator=plan.generator(1))
    pos_table = None
    if cfg.pos == "learned":
        pos_table = _gather_leaf(params["pos_embed"], plan.specs["pos_embed"],
                                 plan.fsdp, quant=quant,
                                 generator=plan.generator(2))
    with record_function("overlap/embed"):
        x = _embed_local(tokens, cfg, d_full_table=embed_full_d,
                         pos_table=pos_table, tp=tp, tp_rank=plan.tp_rank,
                         seq_offset=seq_offset, s_local=S_local)

    layers = params["layers"]
    keys = sorted(layers)
    L = cfg.n_layers

    def gather_block(i, shards):
        # the prefetched per-block weight all-gather, issued in sorted
        # key order on every rank (one order per group)
        with record_function(f"overlap/gather_block[{i}]"):
            return {k: _gather_leaf_start(
                shards[k].to(cfg.dtype), plan.layer_specs[k], plan.fsdp,
                quant=quant, generator=plan.generator(16),
                name=f"overlap/grad_reduce_scatter[{i}]") for k in keys}

    def block(i, pending, x):
        lp = {k: p.wait() for k, p in pending.items()}
        with record_function(f"overlap/block[{i}]"):
            return _block_apply(lp, x, cfg, positions=positions, tp=tp,
                                attn_fn=plan.attn_fn)

    def shards_of(i):
        return {k: layers[k][i] for k in keys}

    if cfg.remat and torch.is_grad_enabled():
        # the gather inside the recomputed block: its inputs (the local
        # shards and x) are all it saves, and the backward gathers again
        def remat_body(i, shards, x):
            return block(i, gather_block(i, shards), x)

        for i in range(L):
            x = gpt_mod._remat(functools.partial(remat_body, i))(
                shards_of(i), x)
    else:
        # double buffer: block i+1's gather is in flight during block i
        pending = gather_block(0, shards_of(0))
        for i in range(L):
            nxt = gather_block(i + 1, shards_of(i + 1)) if i + 1 < L \
                else None
            x = block(i, pending, x)
            pending = nxt

    x = gpt_mod._norm(x, params["ln_f"], cfg.norm, bias=params.get("ln_f_b"),
                      eps=gpt_mod.norm_eps(cfg))
    if cfg.tie_embeddings:
        head_local = embed_full_d.T.to(cfg.dtype)             # [d, V/tp]
    else:
        head_local = _gather_leaf(params["lm_head"], plan.specs["lm_head"],
                                  plan.fsdp, quant=quant,
                                  generator=plan.generator(3)
                                  ).to(cfg.dtype)
    with record_function("overlap/head_ring"):
        logits = ring_allgather_matmul(x, head_local, tp,
                                       out_dtype=torch.float32)
    logits = logits.reshape(B * S, -1)
    with record_function("overlap/vocab_ce"):
        nll = _vocab_parallel_ce(logits, targets.reshape(B * S), tp=tp,
                                 tp_rank=plan.tp_rank)
    maskf = (targets.reshape(B * S) >= 0).float()
    nll = (nll * maskf).reshape(B, S)
    maskf = maskf.reshape(B, S)
    if tp is not None:
        # this rank's share: its own sequence chunk (every tp rank
        # computed all tokens' nll, each token is counted once)
        nll = nll[:, seq_offset:seq_offset + S_local]
        maskf = maskf[:, seq_offset:seq_offset + S_local]
    # the global count of valid targets, with no gradient: a rank whose
    # rows hold none still divides by it
    n_total = maskf.sum().detach().clone()
    if plan.reduce is not None:
        import torch.distributed as dist
        dist.all_reduce(n_total, group=plan.reduce)
    return nll.sum() / n_total.clamp_min(1.0)


def _missing_axes(spec, mesh) -> Tuple[str, ...]:
    """The mesh axes a gradient of a leaf with this spec is still summed
    over: every batch or model axis (above 1) the leaf is not sharded on
    (the sharded ones were reduced by the all-gathers' reduce-scatters).
    On a ``dcn`` mesh every leaf keeps the ``dcn`` leg: parameters are
    replicated per node, so an fsdp leaf's ``dcn`` sum acts on the
    1/fsdp shard its reduce-scatter left."""
    shape = _sizes(mesh)
    present = _spec_axes(spec)
    return tuple(a for a in ("dcn", "dp", "fsdp", "tp")
                 if shape.get(a, 1) > 1 and a not in present)


def build_overlap_step_fns(cfg, mesh, *, quant: Optional[str] = None,
                           device=None) -> Dict[str, Any]:
    """The overlap-scheduled loss and gradient entry points for
    ``(cfg, mesh)``.

    Returns ``dict(value_and_grad, loss)``, both taking ``(params,
    tokens, targets)``: this rank's parameter shards
    (``sharding.shard_params`` or ``convert.params_from_jax(...,
    mesh=)``) and its rows of the global batch
    (``sharding.shard_batch``).  ``value_and_grad`` returns the global
    loss and the gradients in the parameters' shards (and key order);
    ``loss`` the global loss, without gradients.  Collective: every rank
    of the mesh calls each in step.

    ``quant`` ("none", "int8" or "dcn"; default: :func:`comm_config`)
    picks the wire per tier: "int8" the fsdp gathers and reduce-scatters
    and the ``dcn`` leg, "dcn" only the ``dcn`` leg (:func:`quant_psum`).
    On a ``dcn`` mesh the schedule is hierarchical: the batch shards over
    ``dcn``, parameters are replicated per node, and a gradient is summed
    over the node's axes first and then, already reduced, over ``dcn``.
    Runs on the card unless ``device="cpu"`` (the stochastic generators'
    device)."""
    from ray_tpu_torch.models import gpt as gpt_mod
    from ray_tpu_torch.ops.attention import make_flash_attention_fn
    from ray_tpu_torch.ops.substrate import resolve_device
    from ray_tpu_torch.parallel.mesh import add_axes_groups, mesh_groups
    if quant is None:
        quant = comm_config().quant
    if quant not in ("none", "int8", "dcn"):
        raise ValueError(f"unknown comm quant {quant!r}; "
                         "expected 'none', 'int8' or 'dcn' "
                         "(check RAY_TPU_COMM_QUANT)")
    reason = overlap_supported(cfg, mesh)
    if reason is not None:
        raise ValueError(f"the overlap schedule does not cover this "
                         f"(cfg, mesh): {reason}")
    dev = resolve_device(device)
    groups = mesh_groups(mesh)
    shape = _sizes(mesh)
    specs = _param_specs(cfg, mesh)
    spec_items = _sorted_leaves(specs)
    grad_axes = {p: _missing_axes(s, mesh) for p, s in spec_items}
    if groups.grouped:
        # the pod-local leg of each leaf's gradient sum: one group per
        # axis set, made here, in one order on every rank
        add_axes_groups(mesh, sorted({tuple(a for a in axes if a != "dcn")
                                      for axes in grad_axes.values()}))

    def group(axes):
        return mesh.axes_group(axes) if groups.grouped and axes else None

    reduce_axes = tuple(a for a in ("dcn", "dp", "fsdp", "tp")
                        if shape.get(a, 1) > 1)
    tp_on, fsdp_on = groups.size("tp") > 1, groups.size("fsdp") > 1
    import torch.distributed as dist
    plan = _Plan(
        tp=groups.tp if tp_on else None, tp_size=groups.size("tp"),
        tp_rank=groups.coord("tp"),
        fsdp=groups.fsdp if fsdp_on else None, reduce=group(reduce_axes),
        layer_specs={k: tuple(s)[1:] for k, s in specs["layers"].items()},
        specs=specs,
        attn_fn=make_flash_attention_fn(
            mesh, rope_theta=cfg.rope_theta if cfg.pos == "rope" else None),
        quant="int8" if quant == "int8" else "none", generators={},
        rank=dist.get_rank() if groups.grouped else 0, device=dev)
    dcn_group = group(("dcn",))
    dcn_quant = quant in ("int8", "dcn") and dcn_group is not None

    def tier_psum(g, axes, key_base):
        """A gradient's sum over ``axes``: the pod-local axes first, then
        the ``dcn`` leg on the already-reduced payload (quantized when
        the ``dcn`` wire is on)."""
        ici = tuple(a for a in axes if a != "dcn")
        g = g.contiguous()
        if ici:
            dist.all_reduce(g, group=group(ici))
        if "dcn" in axes:
            with record_function("overlap/dcn_allreduce"):
                if dcn_quant:
                    g = quant_psum(g, dcn_group, plan.generator(key_base))
                else:
                    dist.all_reduce(g, group=dcn_group)
        return g

    def obj(params, tokens, targets):
        return _overlap_local_obj(params, tokens, targets, cfg, plan=plan)

    def global_sum(local):
        total = local.detach().clone()
        if plan.reduce is not None:
            dist.all_reduce(total, group=plan.reduce)
        return total

    def value_and_grad(params, tokens, targets):
        items = _sorted_leaves(params)
        leaves = {p: t.detach().requires_grad_(True) for p, t in items}
        local = obj(_rebuild_like(params, leaves), tokens, targets)
        grads = torch.autograd.grad(local, list(leaves.values()),
                                    allow_unused=True)
        out = {}
        # sharded leaves got their cross-rank sums from the collectives'
        # gradients; replicated ones get the explicit sum here
        with record_function("overlap/grad_psum"):
            for i, ((p, leaf), g) in enumerate(zip(leaves.items(), grads)):
                g = torch.zeros_like(leaf) if g is None else g
                out[p] = tier_psum(g, grad_axes[p], 4096 + i) \
                    if grad_axes[p] else g
            loss = global_sum(local)
        return loss, _rebuild_like(params, out)

    @torch.no_grad()
    def loss(params, tokens, targets):
        return global_sum(obj(params, tokens, targets))

    return {"value_and_grad": value_and_grad, "loss": loss}


# ---------------------------------------------------------------------------
# collective-traffic accounting (bytes per step, per tier)
# ---------------------------------------------------------------------------

#: The price of each tier, GB/s: the H100 SXM's published specification,
#: not a measurement.  ``ici``: the NVLink domain inside a node, NVLink 4
#: at 900 GB/s both ways per GPU, 450 GB/s each way; ``dcn``: the network
#: between nodes, one 400 Gb/s NDR InfiniBand port per GPU, 50 GB/s.
#: ``collective_bytes_per_step`` divides each tier's bytes by them.  (The
#: reference prices its TPU tiers; the port keeps its tier names.)
TIER_BANDWIDTH_GBPS: Dict[str, float] = {"ici": 450.0, "dcn": 50.0}


def tier_seconds(nbytes: int, tier: str) -> float:
    """Seconds to move ``nbytes`` on ``tier`` at the
    :data:`TIER_BANDWIDTH_GBPS` price."""
    return nbytes / (TIER_BANDWIDTH_GBPS[tier] * 1e9)


def collective_bytes_per_step(cfg, mesh, *, batch: int, seq: int,
                              comm_mode: str = "overlap",
                              quant: str = "none") -> Dict[str, Any]:
    """Logical collective bytes moved per train step, **per tier**:
    ``{"ici": {...}, "dcn": {...}, "total": int}``, the reference's
    accounting entry for entry (``batch`` and ``seq`` global).

    Ring cost model: a W-way all-gather or reduce-scatter of an N-byte
    global payload moves ``N (W-1)/W`` bytes per device, an all-reduce
    twice that.  The ``ici`` entries are bytes per device inside a node
    (the NVLink domain); the ``dcn`` entries bytes over each link between
    nodes, with ``flat_equivalent_bytes`` (what a flat schedule, its fsdp
    ring spanning ``dcn * fsdp`` devices, would push over the same link)
    and ``reduction_vs_flat`` (their ratio).  Each tier carries
    ``seconds`` at its :data:`TIER_BANDWIDTH_GBPS` price.  Each
    collective is ``{"bytes", "wire_dtype"}``; ``quant`` (overlap only:
    gspmd is charged unquantized) prices "int8" streams at
    ``quant.wire_bytes`` (codes plus one f32 scale per
    :data:`WIRE_BLOCK`).  ``mesh``: a live mesh or a ``MeshSpec``."""
    from ray_tpu_torch.models import gpt as gpt_mod
    from ray_tpu_torch.quant import wire_bytes as quant_wire_bytes
    shape = _sizes(mesh)
    dcn = shape.get("dcn", 1)
    dp = shape.get("dp", 1)
    fsdp = shape.get("fsdp", 1)
    tp = shape.get("tp", 1)
    act_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    wire_name = str(cfg.dtype).split(".")[-1]
    b_local = max(batch // max(dcn * dp * fsdp, 1), 1)
    d = cfg.d_model
    ici_quant_on = quant == "int8" and comm_mode == "overlap"
    dcn_quant_on = quant in ("int8", "dcn") and comm_mode == "overlap"
    q_name = f"int8+f32/{WIRE_BLOCK}"

    specs = dict(_sorted_leaves(_param_specs(cfg, mesh)))
    fsdp_param_bytes = 0     # global cfg.dtype bytes of fsdp leaves
    fsdp_wire_payload = 0    # the same leaves at the int8 wire
    all_param_bytes = 0
    shard_elems = 0          # per-device gradient elements after the
    #                          node's reduction: the dcn payload
    for path, leaf_shape in _sorted_leaves(gpt_mod.param_shapes(cfg)):
        spec = specs[path]
        size = math.prod(leaf_shape)
        all_param_bytes += size * act_bytes
        div = 1
        for a in _spec_axes(spec):
            div *= shape.get(a, 1)
        shard_elems += size // max(div, 1)
        if "fsdp" in _spec_axes(spec):
            fsdp_param_bytes += size * act_bytes
            if len(leaf_shape) < 2:
                fsdp_wire_payload += size * act_bytes
            else:
                # quant_all_gather_start's _to2d geometry: a row per index of
                # the gathered dimension, scale blocks along the rest
                rows = leaf_shape[_gather_axis_dims(spec, "fsdp")[0]]
                fsdp_wire_payload += rows * quant_wire_bytes(
                    size // rows, block=WIRE_BLOCK)

    def entry(nbytes, dtype_name):
        return {"bytes": int(nbytes), "wire_dtype": dtype_name}

    def tier_total(tier):
        return int(sum(v["bytes"] for v in tier.values()
                       if isinstance(v, dict) and "bytes" in v))

    # ---------------------------------------------------- ICI tier ----
    ici: Dict[str, Any] = {}
    # fsdp: per-block weight all-gather forward (+ the remat re-gather)
    # and the mirrored gradient reduce-scatter backward; inside a node
    ring_frac_num, ring_frac_den = fsdp - 1, max(fsdp, 1)
    payload = fsdp_wire_payload if ici_quant_on else fsdp_param_bytes
    ag = payload * ring_frac_num // ring_frac_den
    regather = ag if cfg.remat else 0
    fsdp_wire = q_name if ici_quant_on else wire_name
    ici["weight_allgather"] = entry(ag + regather, fsdp_wire)
    ici["grad_reduce_scatter"] = entry(ag, fsdp_wire)
    # dp: every leaf's gradient all-reduced over dp (fsdp leaves move
    # their shard), at cfg.dtype in both schedules
    dp_bytes = (all_param_bytes - fsdp_param_bytes
                + fsdp_param_bytes // max(fsdp, 1))
    ici["grad_allreduce_dp"] = entry(
        2 * dp_bytes * (dp - 1) // max(dp, 1), wire_name)

    # tp activations, unquantized in both schedules
    tp_frac = (tp - 1) / max(tp, 1)
    act_x = b_local * seq * d * act_bytes       # one full-seq hidden
    if tp > 1:
        if comm_mode == "overlap":
            # per block: the ring into q/k/v and into the MLP, two
            # reduce-scatters out; the backward mirrors each
            per_block = 4 * act_x * tp_frac * 2
            # embedding reduce-scatter, the head's ring fwd/bwd, the
            # log-sum-exp sums
            head_io = 2 * act_x * tp_frac * 2 + 2 * act_x * tp_frac
            ici["tp_ring"] = entry(cfg.n_layers * per_block + head_io,
                                   wire_name)
        else:
            # gspmd: 2 all-reduces per block forward and 2 backward, and
            # the embedding table's all-gather
            per_block = 2 * (2 * act_x * tp_frac) * 2
            table = cfg.vocab_size * d * act_bytes * tp_frac
            ici["tp_ring"] = entry(cfg.n_layers * per_block + 2 * table,
                                   wire_name)
    else:
        ici["tp_ring"] = entry(0, wire_name)
    ici["total"] = tier_total(ici)
    ici["seconds"] = tier_seconds(ici["total"], "ici")

    # ---------------------------------------------------- DCN tier ----
    # the one cross-node stream: each device's reduced gradient shard
    # all-reduced over the dcn ring (its reduce-scatter and all-gather
    # each carry payload (K-1)/K over every link of a K-node ring)
    dcn_tier: Dict[str, Any] = {}
    if dcn_quant_on:
        dcn_payload = quant_wire_bytes(shard_elems, block=WIRE_BLOCK)
        dcn_wire = q_name
    else:
        dcn_payload = shard_elems * act_bytes
        dcn_wire = wire_name
    dcn_frac_num, dcn_frac_den = dcn - 1, max(dcn, 1)
    dcn_tier["grad_allreduce_dcn"] = entry(
        2 * dcn_payload * dcn_frac_num // dcn_frac_den, dcn_wire)
    dcn_tier["total"] = tier_total(dcn_tier)
    dcn_tier["seconds"] = tier_seconds(dcn_tier["total"], "dcn")
    if dcn > 1:
        # the flat schedule's fsdp ring over all dcn * fsdp devices
        # pushes the full weight gathers and reduce-scatters over every
        # link it crosses; priced at the same wire
        W = dcn * fsdp
        flat_payload = (fsdp_wire_payload if dcn_quant_on
                        else fsdp_param_bytes)
        flat_ag = flat_payload * (W - 1) // W
        flat = flat_ag * (3 if cfg.remat else 2)
        non_fsdp = all_param_bytes - fsdp_param_bytes
        flat += 2 * non_fsdp * (W - 1) // W
        dcn_tier["flat_equivalent_bytes"] = int(flat)
        total = dcn_tier["total"]
        dcn_tier["reduction_vs_flat"] = (
            round(flat / total, 2) if total else None)

    return {"ici": ici, "dcn": dcn_tier,
            "total": ici["total"] + dcn_tier["total"]}
