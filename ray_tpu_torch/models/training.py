"""The training step for the port's GPT, on one card or data-parallel.

Counterpart of ``ray_tpu/models/training.py`` (``build_gpt_train``,
``default_optimizer``, ``_accum_value_and_grad``, ``TrainState``,
``synthetic_lm_batch``, ``_maybe_instrument``).  The step is

    loss, grads = value_and_grad(loss_fn)(params, batch)   # autograd
    params, opt_state = optimizer.update(grads, opt_state, params)

with the loss through the port's kernels: flash attention with in-kernel
RoPE, the fused out-proj epilogue, and flash-CE with the final norm in
its prologue (``models/gpt.py:loss_fn``).  The optimizer is optax's
``clip_by_global_norm -> adamw(warmup_cosine)`` chain written out on
tensors.  ``step_fn`` updates the state's tensors in place (the JAX step
donates its state) and returns the new state.  ``cfg.remat`` recomputes
each block in the backward, ``ce_mode="fused"`` keeps the logits in
bf16 (``ops/fused_ce.py``), and ``telemetry`` wraps the step in a
:class:`~ray_tpu_torch.telemetry.StepTelemetry` recorder.

On a mesh (``parallel.mesh.make_mesh``: one rank per card, NCCL on the
card, gloo on the CPU) over the axes ``dcn``, ``dp``, ``fsdp``, ``sp``
and ``tp``, each rank holds its shards of the parameters and of the
optimizer state (``parallel.sharding``: the reference's rule table) and
its rows of the global batch along the batch axes (dcn, dp, fsdp) and,
under sp, its sequence shard (``fns["shard_batch"]``).  The model runs
the collectives GSPMD puts into the reference's step
(``models/gpt.py``: fsdp gathers, Megatron tp, vocab-parallel
embedding and CE; ring or Ulysses attention under sp).  The loss is the
global masked sum over the global count of valid targets: the ranks
all-reduce their counts over the batch axes and sp (never tp, whose
ranks hold the same tokens), each scales its local mean by its share,
and after the backward (and after accumulation) the gradients are
reduced as one flat buffer per dtype, in their own dtype: the fsdp-
sharded leaves (reduce-scattered over fsdp by the backward) over (dcn,
dp, sp), every other leaf and the loss over (dcn, dp, fsdp, sp); a
tp-sharded leaf stays local, and a tp-replicated one (the norm scales)
is already the same on every tp rank.  The clip's global norm counts
each element once.  Every rank starts from the first rank's parameters
(broadcast by ``init_fn``, then cut into shards).

``comm_mode="overlap"`` (or ``RAY_TPU_COMM=overlap``) takes the loss and
gradients through the overlap schedule instead
(``parallel/overlap.py``: prefetched per-block fsdp gathers, per-block
gradient reduce-scatters, ring all-gather-matmul tp, and the int8 wire
of ``comm_quant``); the optimizer, the global norm and the clip are the
same.  It falls back loudly to gspmd where the reference's does
(:func:`resolve_comm`).  The pipeline (``pp``, ROADMAP Queue 1 item
9b-iii), experts (``ep``, 9b-iv) and LoRA (item 11) raise
``NotImplementedError`` naming the item that ports them.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ray_tpu_torch.models import gpt as gpt_mod
from ray_tpu_torch.ops.attention import make_flash_attention_fn
from ray_tpu_torch.ops.substrate import resolve_device
from ray_tpu_torch.parallel import sharding as shd
from ray_tpu_torch.parallel.mesh import mesh_groups
from ray_tpu_torch.parallel.ring_attention import make_ring_attention_fn
from ray_tpu_torch.parallel.ulysses import make_ulysses_attention_fn

Params = Dict[str, Any]

# AdamW's constants in the reference's optimizer (training.py:109)
B1, B2, EPS = 0.9, 0.95, 1e-8


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: int


def _leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in its (insertion) order."""
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _paths(tree: Params) -> List[tuple]:
    """The key path of each leaf, in :func:`_leaves` order."""
    paths = []

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                paths.append(prefix + (k,))

    walk(tree, ())
    return paths


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _path_order(tree: Params) -> List[int]:
    """Indices into :func:`_leaves` order that sort the leaves by their
    key paths: the order every rank agrees on, whatever order its tree
    was built in (``init_params`` and ``convert.params_from_jax`` build
    the same tree in different key orders)."""
    paths = _paths(tree)
    return sorted(range(len(paths)), key=lambda i: paths[i])


def _rebuild(tree: Params, leaves: List[Any]) -> Params:
    """``tree``'s structure with ``leaves`` (in :func:`_leaves` order)."""
    it = iter(leaves)

    def build(node):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in node.items()}

    return build(tree)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (``optax.global_norm``),
    in f32."""
    return torch.sqrt(sum((t.float().square().sum() for t in _leaves(tree)),
                          torch.zeros((), dtype=torch.float32,
                                      device=_leaves(tree)[0].device)))


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class DefaultOptimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    b1=0.9, b2=0.95, weight_decay))`` with ``schedule =
    warmup_cosine_decay_schedule(0, lr, warmup, max(total_steps,
    warmup + 1), lr * 0.1)`` (``training.py:102-111``).

    Decoupled weight decay applies to every parameter, as in the
    reference (no parameter groups).  The moments are kept in each
    parameter's dtype (optax's ``zeros_like(params)``); the arithmetic is
    f32.  The clip divides by the norm exactly (no ``+1e-6``)."""
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup: int = 100
    total_steps: int = 10000
    grad_clip: float = 1.0

    def schedule(self, count: int) -> float:
        """The learning rate of update number ``count`` (from 0)."""
        if count < self.warmup:                      # linear 0 -> lr
            frac = 1.0 - min(max(count, 0), self.warmup) / self.warmup
            return -self.lr * frac + self.lr
        decay = max(self.total_steps, self.warmup + 1) - self.warmup
        t = min(count - self.warmup, decay)
        alpha = 0.1
        cos = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return self.lr * ((1.0 - alpha) * cos + alpha)

    def init(self, params: Params) -> AdamWState:
        return AdamWState(0, _rebuild(params, [torch.zeros_like(p) for p in
                                               _leaves(params)]),
                          _rebuild(params, [torch.zeros_like(p) for p in
                                            _leaves(params)]))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params,
               g_norm: Optional[torch.Tensor] = None) -> AdamWState:
        """One update, written into ``params`` and the state's moments in
        place; returns the state with its count advanced.  ``g_norm``:
        the gradients' global norm when they are shards (default: the
        norm of ``grads`` as they are)."""
        if g_norm is None:
            g_norm = global_norm(grads)
        keep = g_norm < self.grad_clip
        count_inc = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(B1) ** f32(count_inc))
        bc2 = float(f32(1) - f32(B2) ** f32(count_inc))
        step_size = -self.schedule(state.count)
        for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                                _leaves(state.mu), _leaves(state.nu)):
            g = g.float()
            g = torch.where(keep, g, g / g_norm * self.grad_clip)
            mu.copy_((1 - B1) * g + B1 * mu.float())
            nu.copy_((1 - B2) * g.square() + B2 * nu.float())
            u = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2) + EPS)
            u = (u + self.weight_decay * p.float()) * step_size
            p.copy_(p.float() + u)
        return AdamWState(count_inc, state.mu, state.nu)


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, total_steps: int = 10000,
                      grad_clip: float = 1.0) -> DefaultOptimizer:
    return DefaultOptimizer(lr=lr, weight_decay=weight_decay, warmup=warmup,
                            total_steps=total_steps, grad_clip=grad_clip)


def value_and_grad(loss: Callable, params: Params, batch
                   ) -> "tuple[torch.Tensor, Params]":
    """(loss, grads) of ``loss(params, batch)`` by autograd; a leaf the
    loss does not reach gets a zero gradient."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    val = loss(_rebuild(params, leaves), batch)
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return val.detach(), _rebuild(params, grads)


def _split_microbatches(batch: Dict[str, Any], accum_steps: int):
    sizes = {k: v.shape[0] for k, v in batch.items()}
    bad = {k: b for k, b in sizes.items() if b % accum_steps}
    if bad:
        raise ValueError(
            f"batch dims {bad} not divisible by accum_steps={accum_steps}: "
            "gradient accumulation runs whole microbatches")
    return [{k: v.chunk(accum_steps)[i] for k, v in batch.items()}
            for i in range(accum_steps)]


def _accum_value_and_grad(loss: Callable, params: Params, batch,
                          accum_steps: int, weights=None):
    """``value_and_grad`` over ``accum_steps`` microbatches, one after
    another (the reference's ``lax.scan``), with the partial gradients
    summed in f32 whatever the model dtype; returns the mean loss and
    the mean gradients cast to each parameter's dtype.  ``weights``
    [accum_steps] scales each microbatch's loss (the data-parallel
    step's share of the global count)."""
    loss_sum = None
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in _leaves(params)]
    for i, mb in enumerate(_split_microbatches(batch, accum_steps)):
        fn = loss if weights is None else _weighted(loss, weights[i])
        val, grads = value_and_grad(fn, params, mb)
        for a, g in zip(acc, _leaves(grads)):
            a.add_(g.float())
        val = val.float()
        loss_sum = val if loss_sum is None else loss_sum + val
    inv_k = 1.0 / accum_steps
    grads = [(a * inv_k).to(p.dtype) for a, p in zip(acc, _leaves(params))]
    return loss_sum * inv_k, _rebuild(params, grads)


def _weighted(loss: Callable, w) -> Callable:
    return lambda p, b: loss(p, b) * w


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


def _flat_collective(tensors: List[torch.Tensor], op: Callable
                     ) -> List[torch.Tensor]:
    """``op(flat)`` on one flat buffer per dtype of ``tensors`` (in
    place, in that dtype); returns views of the buffers shaped as
    ``tensors``."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = list(tensors)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        op(flat)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def resolve_comm(cfg, mesh, comm_mode: Optional[str] = None,
                 comm_quant: Optional[str] = None, *, lora=None,
                 accum_steps: int = 1) -> "tuple[str, str]":
    """The (schedule, wire) a step of ``cfg`` on ``mesh`` runs, resolved
    as the reference's ``build_gpt_train`` resolves them
    (``ray_tpu/models/training.py:292-331``): None reads
    ``overlap.comm_config()``, unknown values raise ``ValueError``, and
    "overlap" falls back to "gspmd" with ``lora``, on a mesh of one
    device (silently), with ``accum_steps > 1`` and for any reason
    ``overlap_supported`` gives; a wire other than "none" is dropped
    under gspmd.  Each loud fallback is printed on stderr."""
    from ray_tpu_torch.parallel import overlap as ovl
    if comm_mode is None:
        comm_mode = ovl.comm_config().mode
    if comm_mode not in ("gspmd", "overlap"):
        raise ValueError(f"unknown comm_mode {comm_mode!r}; "
                         "expected 'gspmd' or 'overlap'")
    if comm_mode == "overlap":
        if lora:
            print("comm_mode=overlap has no trainable-adapter formulation "
                  "(the schedule gathers base weights per block); falling "
                  "back to gspmd", file=sys.stderr)
            comm_mode = "gspmd"
        elif int(getattr(mesh, "size", 1)) <= 1:
            comm_mode = "gspmd"   # one device: nothing to schedule
        elif accum_steps > 1:
            print(f"comm_mode=overlap does not support accum_steps="
                  f"{accum_steps} (the schedule's prefetch would nest "
                  "inside the microbatch loop); falling back to gspmd",
                  file=sys.stderr)
            comm_mode = "gspmd"
        else:
            reason = ovl.overlap_supported(cfg, mesh)
            if reason is not None:
                print(f"comm_mode=overlap unsupported ({reason}); falling "
                      "back to gspmd", file=sys.stderr)
                comm_mode = "gspmd"
    if comm_quant is None:
        comm_quant = ovl.comm_config().quant
    if comm_quant not in ("none", "int8", "dcn"):
        raise ValueError(f"unknown comm_quant {comm_quant!r}; "
                         "expected 'none', 'int8' or 'dcn'")
    if comm_quant != "none" and comm_mode != "overlap":
        print(f"comm_quant={comm_quant} needs the overlap schedule "
              f"(comm_mode is {comm_mode!r}); wire stays "
              f"{str(cfg.dtype).split('.')[-1]}", file=sys.stderr)
        comm_quant = "none"
    return comm_mode, comm_quant


@torch.no_grad()
def _broadcast_from_first(params: Params, group) -> None:
    """Every rank's parameters become the group's first rank's, in place,
    in sorted key-path order."""
    import torch.distributed as dist
    src = dist.get_global_rank(group, 0)
    leaves = [_leaves(params)[i] for i in _path_order(params)]
    got = _flat_collective(
        leaves, lambda f: dist.broadcast(f, src=src, group=group))
    for t, g in zip(leaves, got):
        t.copy_(g)


def _maybe_instrument(fns: Dict[str, Any], cfg, mesh, *,
                      ce_mode: Optional[str] = None,
                      telemetry: Optional[bool] = None) -> Dict[str, Any]:
    """Wrap ``fns["step_fn"]`` with a ``StepTelemetry`` recorder.

    ``telemetry``: None follows ``RAY_TPU_TELEMETRY`` (default on),
    False skips, True forces on.  When on, the dict gains ``telemetry``
    (the recorder) and ``raw_step_fn``."""
    if telemetry is False:
        return fns
    from ray_tpu_torch import telemetry as tel_mod
    config = None
    if telemetry is True:
        config = tel_mod.TelemetryConfig(
            enabled=True,
            profile_dir=tel_mod.telemetry_config().profile_dir)
    return tel_mod.instrument(fns, cfg, mesh, comm_mode=fns["comm_mode"],
                              comm_quant=fns["comm_quant"],
                              ce_mode=ce_mode, config=config)


def build_gpt_train(cfg: "gpt_mod.GPTConfig", mesh=None, *,
                    optimizer: Optional[DefaultOptimizer] = None,
                    ce_mode: Optional[str] = None,
                    fuse_norm: Optional[bool] = None,
                    accum_steps: int = 1, device=None,
                    sp_impl: str = "ring",
                    comm_mode: Optional[str] = None,
                    comm_quant: Optional[str] = None,
                    telemetry: Optional[bool] = None,
                    lora=None) -> Dict[str, Any]:
    """Returns dict(init_fn, step_fn, loss_fn, forward_fn, attn_fn,
    value_and_grad_fn, shard_batch, accum_steps, comm_mode, comm_quant),
    and
    ``telemetry`` and ``raw_step_fn`` when the step recorder is on.

    ``init_fn(generator=None, *, params=None) -> TrainState``: random
    parameters from ``generator`` or the given tree, fresh optimizer
    state, step 0.  A full tree is broadcast from the first rank and cut
    into this rank's shards; a tree of shards
    (``convert.params_from_jax(..., mesh=)``) is taken as it is.
    ``step_fn(state, batch) -> (state, {"loss", "grad_norm", "step"})``
    with batch = dict(tokens, targets), this rank's part of the global
    batch (``shard_batch(global_batch)``); ``grad_norm`` is the global
    norm before the clip, as the reference reports it;
    ``value_and_grad_fn(params, batch) -> (loss, grads)`` is its loss
    and reduced gradients (this rank's shards), before the update.
    ``ce_mode``
    ("flash" default, "fused" with ``cfg.ce_chunk < 0``, or "xla") and
    ``fuse_norm`` (None means on) pin the loss head and the fused
    epilogues; ``accum_steps`` runs the step as that many microbatches
    with f32 gradient accumulation and one update; ``cfg.remat``
    recomputes each block in the backward.  ``mesh``: a mesh of
    ``parallel.mesh.make_mesh`` over ``dcn``, ``dp``, ``fsdp``, ``sp``
    and ``tp``; under sp above 1 attention is ring (``sp_impl="ring"``,
    the default) or Ulysses (``"ulysses"``), the sequence shards
    contiguous.  ``comm_mode`` (None: ``RAY_TPU_COMM``) is "gspmd" (the
    collectives where GSPMD puts them; gradients reduced once, after the
    backward) or "overlap" (``parallel.overlap.build_overlap_step_fns``
    takes ``value_and_grad_fn``, ``step_fn``'s gradients and ``loss_fn``;
    a packed batch raises), and ``comm_quant`` (None:
    ``RAY_TPU_COMM_QUANT``) its wire, "none", "int8" or "dcn";
    :func:`resolve_comm` gives the fallbacks, and ``fns["comm_mode"]``
    and ``fns["comm_quant"]`` what runs.  ``telemetry``
    (None: ``RAY_TPU_TELEMETRY``, default on) wraps ``step_fn`` in a
    ``StepTelemetry``.  Runs on the card unless ``device="cpu"``."""
    groups = mesh_groups(mesh)
    if sp_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_impl {sp_impl!r}; expected 'ring' or "
                         "'ulysses'")
    if lora:
        raise _unported("trainable-adapter mode (lora=)", "11")
    accum_steps = int(accum_steps)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    gpt_mod.check_supported(cfg)
    comm_mode, comm_quant = resolve_comm(cfg, mesh, comm_mode, comm_quant,
                                         accum_steps=accum_steps)
    dev = resolve_device(device)
    overlap_fns = None
    if comm_mode == "overlap":
        from ray_tpu_torch.parallel.overlap import build_overlap_step_fns
        overlap_fns = build_overlap_step_fns(cfg, mesh, quant=comm_quant,
                                             device=dev)
    tx = optimizer or default_optimizer()
    sp = groups.size("sp")
    if sp > 1:
        attn_fn = (make_ulysses_attention_fn(mesh) if sp_impl == "ulysses"
                   else make_ring_attention_fn(mesh))
    else:
        attn_fn = make_flash_attention_fn(
            mesh, rope_theta=cfg.rope_theta if cfg.pos == "rope" else None)
    logical = gpt_mod.param_logical_axes(cfg)
    specs = (shd.tree_specs(mesh, logical) if mesh is not None
             else shd.tree_map(lambda _a: (), logical))
    full_shapes = gpt_mod.param_shapes(cfg)
    sharded = any(shd.spec_axes(_at(specs, p)) for p in _paths(specs))
    mesh_axes = [a for a, n in groups.sizes.items() if n > 1]

    def loss(params, batch):
        if sp > 1:
            if batch.get("segment_ids") is not None:
                raise ValueError(
                    "sample-packed batches (segment_ids) are not supported "
                    "by sequence-parallel attention (sp>1)")
            S = batch["tokens"].shape[1]
            batch = dict(batch, positions=groups.coord("sp") * S
                         + torch.arange(S, device=batch["tokens"].device))
        return gpt_mod.loss_fn(params, batch, cfg, attn_fn=attn_fn,
                               ce_mode=ce_mode, fuse_norm=fuse_norm,
                               mesh=mesh)

    def local_tree(params) -> bool:
        """Whether ``params`` are shards (else the full tree)."""
        full = [tuple(t.shape) == _at(full_shapes, p)
                for p, t in zip(_paths(params), _leaves(params))]
        if all(full):
            return False
        for p, t in zip(_paths(params), _leaves(params)):
            want = shd.local_shape(_at(full_shapes, p), _at(specs, p), mesh)
            if tuple(t.shape) != want:
                raise ValueError(f"parameter {'/'.join(p)} of shape "
                                 f"{tuple(t.shape)} is neither the full "
                                 f"{_at(full_shapes, p)} nor this rank's "
                                 f"shard {want}")
        return True

    def init(generator: Optional[torch.Generator] = None, *,
             params: Optional[Params] = None) -> TrainState:
        if params is None:
            params = gpt_mod.init_params(cfg, generator, device=dev)
        if not local_tree(params):
            if groups.grouped:
                import torch.distributed as dist
                _broadcast_from_first(params, dist.group.WORLD)
            if sharded:
                params = shd.shard_params(params, mesh, logical)
        return TrainState(params, tx.init(params), 0)

    def count_weights(batch):
        """Each microbatch's share of the global count of valid
        targets, for this rank's tokens."""
        import torch.distributed as dist
        n = torch.stack([(t >= 0).sum() for t in
                         batch["targets"].chunk(accum_steps)]).float()
        total = n.clone()
        dist.all_reduce(total, group=groups.count)
        return n / total.clamp_min(1.0)

    def reduce_grads(grads, loss_val):
        import torch.distributed as dist
        paths, flat = _paths(grads), _leaves(grads)
        order = _path_order(grads)
        by_fsdp = {False: [], True: []}
        for i in order:
            by_fsdp["fsdp" in shd.spec_axes(_at(specs, paths[i]))].append(i)
        for on_fsdp, group in ((False, groups.count), (True, groups.grad)):
            idx = by_fsdp[on_fsdp]
            extra = [] if on_fsdp else [loss_val.float()]
            if group is None or not idx + extra:
                continue
            got = _flat_collective(
                [flat[i] for i in idx] + extra,
                lambda f, g=group: dist.all_reduce(f, group=g))
            if extra:
                loss_val = got.pop()
            for i, t in zip(idx, got):
                flat[i] = t
        return _rebuild(grads, flat), loss_val

    def grad_norm(grads):
        """The global norm, each element counted once: a leaf's sum of
        squares comes from the ranks at coordinate 0 along the mesh axes
        that replicate it, summed over the world."""
        if not sharded:
            return global_norm(grads)
        import torch.distributed as dist
        parts = []
        for p, g in zip(_paths(grads), _leaves(grads)):
            axes = shd.spec_axes(_at(specs, p))
            owner = all(groups.coord(a) == 0 for a in mesh_axes
                        if a not in axes)
            parts.append(g.float().square().sum() if owner else
                         torch.zeros((), dtype=torch.float32,
                                     device=g.device))
        total = torch.stack(parts)
        dist.all_reduce(total)
        return torch.sqrt(total.sum())

    def check_unpacked(batch):
        if "segment_ids" in batch:
            # training a packed batch without its mask would let
            # co-packed documents attend to each other
            raise ValueError(
                "sample-packed batches (segment_ids) are not supported by "
                "the overlap schedule yet: build with comm_mode='gspmd' "
                "for streamed packed input")

    def loss_and_grads(params, batch):
        if overlap_fns is not None:
            check_unpacked(batch)
            return overlap_fns["value_and_grad"](params, batch["tokens"],
                                                 batch["targets"])
        w = count_weights(batch) if groups.count is not None else None
        if accum_steps > 1:
            loss_val, grads = _accum_value_and_grad(
                loss, params, batch, accum_steps, weights=w)
        else:
            fn = loss if w is None else _weighted(loss, w[0])
            loss_val, grads = value_and_grad(fn, params, batch)
        if groups.grouped:
            grads, loss_val = reduce_grads(grads, loss_val)
        return loss_val, grads

    def step(state: TrainState, batch):
        loss_val, grads = loss_and_grads(state.params, batch)
        gnorm = grad_norm(grads)
        opt_state = tx.update(grads, state.opt_state, state.params,
                              g_norm=gnorm)
        return (TrainState(state.params, opt_state, state.step + 1),
                {"loss": loss_val.float(), "grad_norm": gnorm,
                 "step": state.step + 1})

    @torch.no_grad()
    def loss_eval(params, batch):
        if overlap_fns is not None:
            check_unpacked(batch)
            return overlap_fns["loss"](params, batch["tokens"],
                                       batch["targets"])
        return loss(params, batch)

    @torch.no_grad()
    def forward_logits(params, batch):
        S = batch["tokens"].shape[1]
        positions = (groups.coord("sp") * S + torch.arange(
            S, device=batch["tokens"].device)) if sp > 1 else None
        logits, _ = gpt_mod.forward(params, batch["tokens"], cfg,
                                    attn_fn=attn_fn, fuse_norm=fuse_norm,
                                    positions=positions, mesh=mesh)
        return logits

    def shard_batch(batch):
        if mesh is None:
            return batch
        return shd.shard_batch(batch, mesh, accum_steps=accum_steps)

    fns = {"init_fn": init, "step_fn": step, "loss_fn": loss_eval,
           "forward_fn": forward_logits, "attn_fn": attn_fn,
           "value_and_grad_fn": loss_and_grads,
           "shard_batch": shard_batch, "accum_steps": accum_steps,
           "comm_mode": comm_mode, "comm_quant": comm_quant}
    return _maybe_instrument(fns, cfg, mesh, ce_mode=ce_mode,
                             telemetry=telemetry)


def synthetic_lm_batch(generator: torch.Generator, batch_size: int,
                       seq_len: int, vocab: int, *, device=None
                       ) -> Dict[str, torch.Tensor]:
    """Random tokens from ``generator`` (on its device), moved to
    ``device`` (the card unless ``device="cpu"``): targets are the
    tokens shifted by one."""
    dev = resolve_device(device)
    tokens = torch.randint(0, vocab, (batch_size, seq_len + 1),
                           generator=generator, device=generator.device)
    tokens = tokens.to(dev)
    return {"tokens": tokens[:, :-1].contiguous(),
            "targets": tokens[:, 1:].contiguous()}
