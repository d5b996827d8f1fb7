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
(:func:`resolve_comm`).  ``lora=`` with ``base_params`` trains an
adapter alone over a frozen base (:func:`build_gpt_train`).

A MoE config (``cfg.n_experts``) trains on any of these meshes and on
``ep``: each rank holds its experts' shard (their hidden dimension split
over tp), and the router decides over the global batch
(``models/gpt.py:_moe_ffn``).  :func:`build_gpt_train_pp` is the
pipeline's trainer: stages over ``pp`` (or ``dcn``), GPipe or 1F1B
(``parallel/pipeline.py``).
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
from ray_tpu_torch.parallel.mesh import MeshSpec, mesh_groups
from ray_tpu_torch.parallel.ring_attention import make_ring_attention_fn
from ray_tpu_torch.parallel.ulysses import make_ulysses_attention_fn

Params = Dict[str, Any]

# AdamW's constants in the reference's optimizer (training.py:109)
B1, B2, EPS = 0.9, 0.95, 1e-8


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: int


def _items(node):
    """(key, child) pairs of a tree node: a dict's in insertion order, a
    list's by index (the rllib modules' layer lists)."""
    return node.items() if isinstance(node, dict) else enumerate(node)


def _is_node(v) -> bool:
    return isinstance(v, (dict, list))


def _leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in its (insertion) order."""
    out = []
    for _k, v in _items(tree):
        out.extend(_leaves(v) if _is_node(v) else [v])
    return out


def _paths(tree: Params) -> List[tuple]:
    """The key path of each leaf, in :func:`_leaves` order."""
    paths = []

    def walk(node, prefix):
        for k, v in _items(node):
            if _is_node(v):
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
        if isinstance(node, list):
            return [build(v) if _is_node(v) else next(it) for v in node]
        return {k: build(v) if _is_node(v) else next(it)
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


def _adam_init(params: Params) -> AdamWState:
    """Count 0 and zero moments in each parameter's dtype (optax's
    ``zeros_like(params)``)."""
    return AdamWState(0, _rebuild(params, [torch.zeros_like(p) for p in
                                           _leaves(params)]),
                      _rebuild(params, [torch.zeros_like(p) for p in
                                        _leaves(params)]))


@dataclasses.dataclass(frozen=True)
class DefaultOptimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    b1=0.9, b2=b2, weight_decay))`` with ``schedule =
    warmup_cosine_decay_schedule(0, lr, warmup, max(total_steps,
    warmup + 1), lr * 0.1)`` (``training.py:102-111``; ``b2`` 0.95
    there, 0.999 in the HF fine-tune's chain).

    Decoupled weight decay applies to every parameter, as in the
    reference (no parameter groups).  The moments are kept in each
    parameter's dtype (optax's ``zeros_like(params)``); the arithmetic is
    f32.  The clip divides by the norm exactly (no ``+1e-6``)."""
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup: int = 100
    total_steps: int = 10000
    grad_clip: float = 1.0
    b2: float = B2

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
        return _adam_init(params)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params,
               g_norm: Optional[torch.Tensor] = None) -> AdamWState:
        """One update, written into ``params`` and the state's moments in
        place; returns the state with its count advanced.  ``g_norm``:
        the gradients' global norm when they are shards (default: the
        norm of ``grads`` as they are)."""
        return _clipped_adam(grads, state, params, g_norm,
                             grad_clip=self.grad_clip, b2=self.b2,
                             lr=self.schedule(state.count),
                             weight_decay=self.weight_decay)


def _clipped_adam(grads: Params, state: AdamWState, params: Params,
                  g_norm: Optional[torch.Tensor], *, grad_clip: float,
                  b2: float, lr: float, weight_decay: float) -> AdamWState:
    """``clip_by_global_norm(grad_clip)`` then Adam (b1 ``B1``, ``b2``,
    eps ``EPS``) at ``lr``, with decoupled ``weight_decay`` when it is
    not 0, written into ``params`` and the moments in place."""
    if g_norm is None:
        g_norm = global_norm(grads)
    keep = g_norm < grad_clip
    count_inc = state.count + 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(B1) ** f32(count_inc))
    bc2 = float(f32(1) - f32(b2) ** f32(count_inc))
    for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                            _leaves(state.mu), _leaves(state.nu)):
        g = g.float()
        g = torch.where(keep, g, g / g_norm * grad_clip)
        mu.copy_((1 - B1) * g + B1 * mu.float())
        nu.copy_((1 - b2) * g.square() + b2 * nu.float())
        u = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2) + EPS)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.copy_(p.float() + u * -lr)
    return AdamWState(count_inc, state.mu, state.nu)


@dataclasses.dataclass(frozen=True)
class RLOptimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``, the RL
    learner's optimizer (``ray_tpu/rl/learner.py:_rl_optimizer``): b1
    0.9, b2 0.999, eps 1e-8, a constant learning rate and no weight
    decay.  Not :class:`DefaultOptimizer`: its warmup starts at lr 0, so
    an RL run's first steps would move nothing.  The clip divides by the
    norm exactly."""
    lr: float = 3e-4
    grad_clip: float = 1.0

    def init(self, params: Params) -> AdamWState:
        return _adam_init(params)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params,
               g_norm: Optional[torch.Tensor] = None) -> AdamWState:
        return _clipped_adam(grads, state, params, g_norm,
                             grad_clip=self.grad_clip, b2=0.999, lr=self.lr,
                             weight_decay=0.0)


def rl_optimizer(lr: float = 3e-4, grad_clip: float = 1.0) -> RLOptimizer:
    return RLOptimizer(lr=lr, grad_clip=grad_clip)


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, total_steps: int = 10000,
                      grad_clip: float = 1.0, b2: float = B2
                      ) -> DefaultOptimizer:
    return DefaultOptimizer(lr=lr, weight_decay=weight_decay, warmup=warmup,
                            total_steps=total_steps, grad_clip=grad_clip,
                            b2=b2)


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


def default_accum_steps() -> int:
    """``RAY_TPU_ACCUM`` (default 1): the microbatch count
    :func:`build_gpt_train` takes when ``accum_steps`` is not pinned
    (``training.py:default_accum_steps``) — the global-batch knob of
    elastic training: a mesh that shrinks by k multiplies it by k."""
    import os
    raw = os.environ.get("RAY_TPU_ACCUM", "1")
    try:
        k = int(raw)
    except ValueError:
        print(f"RAY_TPU_ACCUM={raw!r} is not an integer; using 1",
              file=sys.stderr)
        return 1
    if k < 1:
        print(f"RAY_TPU_ACCUM={k} must be >= 1; using 1", file=sys.stderr)
        return 1
    return k


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


def _resolve_lora(lora, base_params):
    """``lora=`` -> the effective ``LoraConfig`` (None when off), with
    the base requirement enforced up front, as the reference's
    ``_resolve_lora``: adapter-only training differentiates through a
    frozen base, so there must be one to freeze."""
    if not lora:
        return None
    from ray_tpu_torch.adapters import LoraConfig, lora_config
    lcfg = lora if isinstance(lora, LoraConfig) else lora_config()
    if base_params is None:
        raise ValueError(
            "trainable-adapter mode (lora=...) needs base_params — the "
            "frozen base weights the adapter is trained against (e.g. "
            "gpt.init_params(...) or a served checkpoint)")
    return lcfg


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


def _sharded_global_norm(grads: Params, specs, groups) -> torch.Tensor:
    """The global norm of a tree of shards, each element counted once: a
    leaf's sum of squares comes from the ranks at coordinate 0 along the
    mesh axes that replicate it (those its spec does not name), summed
    over the mesh's ranks."""
    import torch.distributed as dist
    mesh_axes = [a for a, n in groups.sizes.items() if n > 1]
    parts = []
    for p, g in zip(_paths(grads), _leaves(grads)):
        axes = shd.spec_axes(_at(specs, p))
        owner = all(groups.coord(a) == 0 for a in mesh_axes
                    if a not in axes)
        parts.append(g.float().square().sum() if owner else
                     torch.zeros((), dtype=torch.float32, device=g.device))
    total = torch.stack(parts)
    if groups.mesh is not None:
        dist.all_reduce(total, group=groups.mesh)
    return torch.sqrt(total.sum())


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
                      comm_mode: Optional[str] = None,
                      comm_quant: Optional[str] = None,
                      ce_mode: Optional[str] = None,
                      label: str = "train",
                      batch_axes=("dcn", "dp", "fsdp"),
                      telemetry: Optional[bool] = None) -> Dict[str, Any]:
    """Wrap ``fns["step_fn"]`` with a ``StepTelemetry`` recorder.

    ``telemetry``: None follows ``RAY_TPU_TELEMETRY`` (default on),
    False skips, True forces on.  When on, the dict gains ``telemetry``
    (the recorder) and ``raw_step_fn``.  ``batch_axes``: the mesh axes
    the step's batch rows are split over (the recorder's global batch
    is its rank's rows times their sizes)."""
    if telemetry is False:
        return fns
    from ray_tpu_torch import telemetry as tel_mod
    config = None
    if telemetry is True:
        config = tel_mod.TelemetryConfig(
            enabled=True,
            profile_dir=tel_mod.telemetry_config().profile_dir)
    return tel_mod.instrument(fns, cfg, mesh, comm_mode=comm_mode,
                              comm_quant=comm_quant, ce_mode=ce_mode,
                              label=label, batch_axes=batch_axes,
                              config=config)


def build_gpt_train(cfg: "gpt_mod.GPTConfig", mesh=None, *,
                    optimizer: Optional[DefaultOptimizer] = None,
                    ce_mode: Optional[str] = None,
                    fuse_norm: Optional[bool] = None,
                    accum_steps: Optional[int] = None, device=None,
                    sp_impl: str = "ring",
                    comm_mode: Optional[str] = None,
                    comm_quant: Optional[str] = None,
                    telemetry: Optional[bool] = None,
                    lora=None, base_params: Optional[Params] = None
                    ) -> Dict[str, Any]:
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
    epilogues; ``accum_steps`` (None: ``RAY_TPU_ACCUM``,
    :func:`default_accum_steps`) runs the step as that many microbatches
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
    ``StepTelemetry``.  Runs on the card unless ``device="cpu"``.

    ``lora`` (an ``adapters.LoraConfig``, or True for the env's) trains
    an adapter alone: ``TrainState.params`` is the A/B factor tree
    (``init_fn`` draws the standard LoRA init from its generator, so
    step 0 is exactly the base model), ``base_params`` (required) stay
    frozen and get no gradient, and the optimizer state is adapter
    sized.  The overlap schedule has no adapter formulation and falls
    back to gspmd, as the reference's does.  On a mesh that shards the
    parameters the base (always the full tree) is cut into this rank's
    shards as the model is, and the adapter is
    whole on every rank, its gradient summed over tp inside the layers
    (``gpt._col_delta``/``_row_delta``) and averaged over the data ranks
    like any replicated leaf's.  ``fns["lora"]`` is the effective config
    (None when off)."""
    groups = mesh_groups(mesh)
    if sp_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_impl {sp_impl!r}; expected 'ring' or "
                         "'ulysses'")
    lcfg = _resolve_lora(lora, base_params)
    accum_steps = (default_accum_steps() if accum_steps is None
                   else int(accum_steps))
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    comm_mode, comm_quant = resolve_comm(cfg, mesh, comm_mode, comm_quant,
                                         lora=lcfg, accum_steps=accum_steps)
    dev = resolve_device(device)
    base = None
    if lcfg is not None:
        from ray_tpu_torch.adapters import lora as lora_mod
        base = shd.tree_map(lambda t: t.detach().to(dev), base_params)
        if mesh is not None:
            # the frozen base is sharded as the model is
            base = shd.shard_params(base, mesh,
                                    gpt_mod.param_logical_axes(cfg))
        adapter_keys = [k for t in lora_mod.effective_targets(cfg, lcfg)
                        for k in (f"{t}_a", f"{t}_b")]
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
    if lcfg is not None:
        # the adapter is replicated: every rank holds all of it
        specs = {k: () for k in adapter_keys}
    elif mesh is not None:
        specs = shd.tree_specs(mesh, logical)
    else:
        specs = shd.tree_map(lambda _a: (), logical)
    full_shapes = gpt_mod.param_shapes(cfg)
    sharded = any(shd.spec_axes(_at(specs, p)) for p in _paths(specs))

    def loss(params, batch):
        if sp > 1:
            if batch.get("segment_ids") is not None:
                raise ValueError(
                    "sample-packed batches (segment_ids) are not supported "
                    "by sequence-parallel attention (sp>1)")
            S = batch["tokens"].shape[1]
            batch = dict(batch, positions=groups.coord("sp") * S
                         + torch.arange(S, device=batch["tokens"].device))
        model, adapter = model_of(params)
        return gpt_mod.loss_fn(model, batch, cfg, attn_fn=attn_fn,
                               ce_mode=ce_mode, fuse_norm=fuse_norm,
                               mesh=mesh, lora=adapter)

    def model_of(params):
        """(the model's tree, the ``lora=`` tree): in adapter mode the
        frozen base and the trained factors with their scale."""
        if lcfg is None:
            return params, None
        return base, {**params, "scale": lcfg.scale}

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
        if lcfg is not None:
            params = (lora_mod.init_adapter(cfg, lcfg, generator,
                                            device=dev)
                      if params is None else
                      {k: v.detach().to(dev).clone()
                       for k, v in params.items()})
            if groups.grouped and groups.mesh is not None:
                _broadcast_from_first(params, groups.mesh)
            return TrainState(params, tx.init(params), 0)
        if params is None:
            params = gpt_mod.init_params(cfg, generator, device=dev)
        if not local_tree(params):
            if groups.grouped and groups.mesh is not None:
                _broadcast_from_first(params, groups.mesh)
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
        if not sharded:
            return global_norm(grads)
        return _sharded_global_norm(grads, specs, groups)

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
        model, adapter = model_of(params)
        logits, _ = gpt_mod.forward(model, batch["tokens"], cfg,
                                    attn_fn=attn_fn, fuse_norm=fuse_norm,
                                    positions=positions, mesh=mesh,
                                    lora=adapter)
        return logits

    def shard_batch(batch):
        if mesh is None:
            return batch
        return shd.shard_batch(batch, mesh, accum_steps=accum_steps)

    fns = {"init_fn": init, "step_fn": step, "loss_fn": loss_eval,
           "forward_fn": forward_logits, "attn_fn": attn_fn,
           "value_and_grad_fn": loss_and_grads,
           "shard_batch": shard_batch, "accum_steps": accum_steps,
           "comm_mode": comm_mode, "comm_quant": comm_quant,
           "lora": lcfg,
           # the machinery another loss builds on (build_gpt_rl_train)
           "model_of": model_of, "reduce_grads": reduce_grads,
           "grad_norm_fn": grad_norm, "groups": groups, "device": dev}
    return _maybe_instrument(fns, cfg, mesh, comm_mode=comm_mode,
                             comm_quant=comm_quant, ce_mode=ce_mode,
                             telemetry=telemetry)


def rl_advantages(rewards, baseline: str = "rloo") -> torch.Tensor:
    """Per-trajectory advantages from scalar rewards ([B] -> [B] f32),
    the reference's ``rl_advantages``:

    - ``rloo``: the leave-one-out baseline, ``(B r_b - sum r) / (B -
      1)``; raw rewards at B = 1, where there is no other trajectory;
    - ``mean``: the batch mean subtracted;
    - ``none``: the raw rewards (plain REINFORCE).

    ``rewards``: a tensor or a numpy array."""
    r = (rewards if isinstance(rewards, torch.Tensor)
         else torch.from_numpy(np.asarray(rewards))).float()
    B = r.shape[0]
    if baseline == "rloo" and B > 1:
        return (B * r - r.sum()) / (B - 1)
    if baseline == "mean":
        return r - r.mean()
    if baseline in ("rloo", "none"):
        return r
    raise ValueError(f"unknown baseline {baseline!r}; "
                     "expected 'rloo', 'mean' or 'none'")


def build_gpt_rl_train(cfg: "gpt_mod.GPTConfig", mesh=None, *,
                       optimizer=None, baseline: str = "rloo",
                       accum_steps: int = 1, lora=None,
                       base_params: Optional[Params] = None,
                       device=None) -> Dict[str, Any]:
    """The policy-gradient (REINFORCE/RLOO) step for the GPT family, the
    learner half of ``ray_tpu_torch.rl`` (``ray_tpu/models/training.py:
    build_gpt_rl_train``), built on :func:`build_gpt_train`'s parameters,
    shardings, attention and reduction: dp, fsdp, tp and sp meshes and
    ``lora=``/``base_params=`` come with it.

    Batch: ``tokens`` [B, S] (prompt and sampled completion, padded),
    ``targets`` [B, S] (the sampled token at position ``t + 1`` where it
    is part of the completion, else -1) and ``rewards`` [B].  The loss is
    the reference's step for step: the forward's f32 logits, a plain f32
    ``log_softmax``, the chosen log-probabilities gathered at
    ``clamp(targets, 0)`` and masked at ``targets >= 0``, and ``loss =
    -mean_b(adv_b * sum_t logp)`` with :func:`rl_advantages` of the whole
    batch.  Flash-CE is not used: the reference has no
    advantage-weighted variant, so the logits materialise as in the
    reference.  Metrics: ``pg_loss``, ``reward_mean``, ``reward_max``,
    ``logp_mean``, ``entropy`` (mean over action positions),
    ``action_tokens``, then ``step`` and ``grad_norm`` (the global norm
    before the clip).

    ``accum_steps > 1`` computes the advantages over the full batch
    first, then sums the microbatches' partial losses, each already
    scaled by ``1 / B``, and their gradients in f32: the same gradient
    up to summation order.  The optimizer defaults to
    ``rl_optimizer()`` (clip 1.0, Adam at 3e-4).

    On a mesh, ``fns["shard_batch"](global_batch)`` gives this rank's
    rows and sequence shard with their advantages (computed over the
    global batch) and keeps the global ``rewards`` for the metrics;
    each rank's loss is its rows' share of the global sum, the sums are
    reduced over the batch axes and sp, and under tp (where every rank
    holds the whole vocabulary's logits) each rank differentiates
    ``1 / tp`` of it, since the logits' gather sums its gradient over
    tp.

    Returns dict(init_fn, step_fn, loss_fn, pg_grad_fn, apply_grads_fn,
    optimizer, baseline, accum_steps, lora, shard_batch, attn_fn,
    device): ``pg_grad_fn(params, batch) -> ((loss, metrics), grads)``
    (the reduced gradients, before the update) and
    ``apply_grads_fn(params, opt_state, grads) -> (params, opt_state)``
    (in place) are the split step a learner group allreduces between.
    Runs on the card unless ``device="cpu"``."""
    import torch.distributed as dist

    rl_advantages(torch.zeros(2), baseline)      # validate loudly, once
    accum_steps = int(accum_steps)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    tx = optimizer or rl_optimizer()
    base = build_gpt_train(cfg, mesh, optimizer=tx, accum_steps=1,
                           device=device, comm_mode="gspmd",
                           comm_quant="none", telemetry=False, lora=lora,
                           base_params=base_params)
    groups, model_of, attn_fn = (base["groups"], base["model_of"],
                                 base["attn_fn"])
    dev = base["device"]
    tp, sp = groups.size("tp"), groups.size("sp")

    def positions_of(tokens):
        if sp <= 1:
            return None
        S = tokens.shape[1]
        return groups.coord("sp") * S + torch.arange(S, device=tokens.device)

    def micro_terms(params, mb, b_global):
        """(-sum_b adv_b seq_logp_b / B, [sum of chosen logp, entropy
        sum, action count]) of one microbatch of this rank's rows."""
        tokens, targets = mb["tokens"], mb["targets"]
        model, adapter = model_of(params)
        logits, _aux = gpt_mod.forward(model, tokens, cfg, attn_fn=attn_fn,
                                       positions=positions_of(tokens),
                                       mesh=mesh, lora=adapter)
        logp = torch.log_softmax(logits.float(), dim=-1)   # [b, S, V] f32
        chosen = logp.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
        mask = (targets >= 0).float()
        seq_logp = (chosen * mask).sum(-1)                 # [b]
        part = -(mb["adv"][:, 0] * seq_logp).sum() / b_global
        ent_sum = -((logp.exp() * logp).sum(-1) * mask).sum()
        return part, torch.stack([(chosen * mask).sum(), ent_sum,
                                  mask.sum()]).detach()

    def pg_value_and_grad(params, batch, *, with_grads: bool = True):
        if "adv" not in batch:
            if groups.grouped:
                raise ValueError("a batch on a mesh comes from "
                                 "fns['shard_batch'] (each row carries its "
                                 "advantage over the global batch)")
            batch = shard_batch(batch)
        rewards = batch["rewards"]
        micro = _split_microbatches(
            {k: batch[k] for k in ("tokens", "targets", "adv")},
            accum_steps)
        leaves = [p.detach().requires_grad_(with_grads)
                  for p in _leaves(params)]
        tree = _rebuild(params, leaves)
        loss = sums = acc = None
        for mb in micro:
            part, s = micro_terms(tree, mb, rewards.shape[0])
            loss = part.detach() if loss is None else loss + part.detach()
            sums = s if sums is None else sums + s
            if not with_grads:
                continue
            got = torch.autograd.grad(part / tp if tp > 1 else part, leaves,
                                      allow_unused=True)
            got = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, got)]
            if accum_steps == 1:
                acc = got
            elif acc is None:
                acc = [g.float() for g in got]
            else:
                for a, g in zip(acc, got):
                    a.add_(g.float())
        grads = None if not with_grads else _rebuild(
            params, [a.to(p.dtype) for a, p in zip(acc, _leaves(params))])
        if groups.count is not None:
            dist.all_reduce(sums, group=groups.count)
            if grads is not None:
                grads, loss = base["reduce_grads"](grads, loss)
            else:
                dist.all_reduce(loss, group=groups.count)
        n_act = sums[2].clamp_min(1.0)
        metrics = {"pg_loss": loss.float(),
                   "reward_mean": rewards.mean(),
                   "reward_max": rewards.max(),
                   "logp_mean": sums[0] / n_act,
                   "entropy": sums[1] / n_act,
                   "action_tokens": sums[2]}
        return (loss.float(), metrics), grads

    def step(state: TrainState, batch):
        (_loss, metrics), grads = pg_value_and_grad(state.params, batch)
        gnorm = base["grad_norm_fn"](grads)
        opt_state = tx.update(grads, state.opt_state, state.params,
                              g_norm=gnorm)
        metrics.update(step=state.step + 1, grad_norm=gnorm)
        return TrainState(state.params, opt_state, state.step + 1), metrics

    def pg_grad_fn(params, batch):
        return pg_value_and_grad(params, batch)

    def apply_grads(params, opt_state, grads):
        opt_state = tx.update(grads, opt_state, params,
                              g_norm=base["grad_norm_fn"](grads))
        return params, opt_state

    @torch.no_grad()
    def loss_eval(params, batch):
        return pg_value_and_grad(params, batch, with_grads=False)[0][0]

    def shard_batch(batch):
        """This rank's rows of a global batch (tensors or numpy), on the
        step's device, each row with its advantage over the global
        batch, and the global ``rewards``."""
        def on_dev(x, dtype):
            # (a copy of a numpy array: one read from the object store is
            # read-only)
            x = x if isinstance(x, torch.Tensor) else torch.tensor(
                np.asarray(x))
            return x.to(dev, dtype)

        host = batch["rewards"]
        host = (host.detach().cpu() if isinstance(host, torch.Tensor)
                else torch.tensor(np.asarray(host)))
        # the advantages are computed on the host: on the card a division
        # by a scalar multiplies by its reciprocal, so RLOO's (B r - sum
        # r) / (B - 1) would part by an ulp from the host's, and an
        # in-process learner's step from a group-hosted one's (whose
        # driver computes them, ``LearnerGroupAdapter``)
        adv = rl_advantages(host, baseline).to(dev)
        rewards = host.to(dev, torch.float32)
        tokens = on_dev(batch["tokens"], torch.long)
        rows = {"tokens": tokens,
                "targets": on_dev(batch["targets"], torch.long),
                "adv": adv[:, None].expand(tokens.shape)}
        if groups.grouped:
            rows = shd.shard_batch(rows, mesh, accum_steps=accum_steps)
        return dict(rows, rewards=rewards)

    return {"init_fn": base["init_fn"], "step_fn": step,
            "loss_fn": loss_eval, "pg_grad_fn": pg_grad_fn,
            "apply_grads_fn": apply_grads, "optimizer": tx,
            "baseline": baseline, "accum_steps": accum_steps,
            "lora": base["lora"], "shard_batch": shard_batch,
            "attn_fn": attn_fn, "device": dev}


def default_pp_schedule() -> str:
    """``RAY_TPU_PP_SCHEDULE`` (default ``gpipe``): the pipeline
    microbatch schedule ``build_gpt_train_pp`` uses when ``schedule``
    is not pinned: ``gpipe`` (all forwards, then all backwards; in
    flight M) or ``1f1b`` (one forward, one backward; in flight at most
    ``2 stages - 1``)."""
    import os
    raw = os.environ.get("RAY_TPU_PP_SCHEDULE", "gpipe").strip().lower()
    if raw not in ("gpipe", "1f1b"):
        print(f"RAY_TPU_PP_SCHEDULE={raw!r} unknown (want 'gpipe' or "
              "'1f1b'); using gpipe", file=sys.stderr)
        return "gpipe"
    return raw


def default_pp_microbatches() -> Optional[int]:
    """``RAY_TPU_PP_MICROBATCH`` (default unset): the microbatch count
    of ``build_gpt_train_pp`` when ``num_microbatches`` is not pinned;
    unset falls back to ``2 * stages``."""
    import os
    raw = os.environ.get("RAY_TPU_PP_MICROBATCH", "").strip()
    if not raw:
        return None
    try:
        m = int(raw)
    except ValueError:
        print(f"RAY_TPU_PP_MICROBATCH={raw!r} is not an integer; "
              "ignoring", file=sys.stderr)
        return None
    if m < 1:
        print(f"RAY_TPU_PP_MICROBATCH={m} must be >= 1; ignoring",
              file=sys.stderr)
        return None
    return m


def stack_stages(params: Params, stages: int) -> Params:
    """A full tree (layers ``[L, ...]``) -> the stage-stacked one (layers
    ``[stages, L / stages, ...]``), the reference's ``init_fn`` layout."""
    out = dict(params)
    out["layers"] = {k: v.reshape((stages, v.shape[0] // stages)
                                  + tuple(v.shape[1:]))
                     for k, v in params["layers"].items()}
    return out


def build_gpt_train_pp(cfg: "gpt_mod.GPTConfig", mesh, *,
                       num_microbatches: Optional[int] = None,
                       schedule: Optional[str] = None,
                       optimizer: Optional[DefaultOptimizer] = None,
                       telemetry: Optional[bool] = None,
                       device=None) -> Dict[str, Any]:
    """Pipeline-parallel GPT training over a ``pp`` (or ``dcn``) axis
    (``ray_tpu/models/training.py:760``).

    The layer stack ``[L, ...]`` is cut into ``[stages, L / stages,
    ...]`` and each rank holds its stage's slice (``[1, L / stages,
    ...]``, its shards of the reference's stage-stacked tree; the
    embedding and final norm on every stage).  Two schedules
    (``parallel/pipeline.py``): ``gpipe`` (default; ``pp`` axis only)
    and ``1f1b`` (in flight at most ``2 stages - 1``), staged over ``pp``
    when the mesh has it, else over ``dcn`` above 1.  The first stage
    embeds, the last computes the loss; inside a stage the blocks run
    as in ``build_gpt_train``: flash attention with in-kernel RoPE, the
    fused epilogue, flash-CE with the norm prologue, and the fsdp
    gathers and Megatron tp of the mesh's other axes.  The batch's rows
    split over the data axes but the stage axis (``fns["shard_batch"]``),
    microbatch by microbatch, so each microbatch visits every stage
    whole; under ``sp`` above 1 each rank holds its contiguous sequence
    shard (the reference's ``_pp_batch_sharding``, ``P(data, "sp")``),
    attention is ring attention over sp with the shard's global
    positions, and the stage-to-stage transfers carry each rank's
    shard.

    Each microbatch's loss is weighted by its share of the global count
    of valid targets (``n_u / n_total``), so the weighted sum is the
    global masked mean; the f32 stage gradients and the stage-summed
    shared gradients are then reduced over the data axes (an fsdp-sharded
    leaf's over them but fsdp: its gather's backward reduce-scatters) and
    cast to each parameter's dtype, as the reference's.

    ``schedule`` defaults to ``RAY_TPU_PP_SCHEDULE`` (gpipe),
    ``num_microbatches`` to ``RAY_TPU_PP_MICROBATCH``, else ``2 *
    stages``.  Returns dict(init_fn, step_fn, loss_fn, value_and_grad_fn,
    shard_batch, gather_params, attn_fn, num_microbatches, schedule,
    stage_axis, bubble_fraction, in_flight_microbatches), with
    ``telemetry`` and ``raw_step_fn`` when the ``train_pp`` recorder is
    on.  ``init_fn(generator=None, *, params=None)`` takes a full tree,
    a stage-stacked one (broadcast from the first rank and cut) or this
    rank's shards (``convert.params_from_jax(..., mesh=)`` of a stacked
    tree); ``gather_params(params)`` gives back the stage-stacked full
    tree on every rank.  Runs on the card unless ``device="cpu"``."""
    from ray_tpu_torch.parallel import pipeline as pipe
    from ray_tpu_torch.parallel.mesh import add_axes_groups

    if schedule is None:
        schedule = default_pp_schedule()
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         "expected 'gpipe' or '1f1b'")
    shape = MeshSpec.from_mesh(mesh).to_dict() if mesh is not None else {}
    if schedule == "gpipe":
        if "pp" not in shape:
            raise ValueError("schedule='gpipe' needs a 'pp' mesh axis "
                             "(1f1b can also stage over 'dcn')")
        stage_axis = "pp"
    elif shape.get("pp", 1) > 1 or "pp" in shape:
        stage_axis = "pp"
    elif shape.get("dcn", 1) > 1:
        stage_axis = "dcn"
    else:
        raise ValueError(
            "schedule='1f1b' needs a 'pp' axis or a 'dcn' axis > 1 to "
            f"stage over; mesh has {shape}")
    pp = shape[stage_axis]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"stages={pp} (axis {stage_axis!r})")
    if cfg.n_experts > 0:
        raise ValueError("MoE + pipeline parallelism not supported yet")
    groups = mesh_groups(mesh)
    M = num_microbatches or default_pp_microbatches() or 2 * pp
    tx = optimizer or default_optimizer()
    stats = pipe.pipeline_schedule_stats(pp, M, schedule)
    dev = resolve_device(device)
    rules = shd.pp_rules(stage_axis)
    logical = shd.stage_stacked_axes(gpt_mod.param_logical_axes(cfg))
    specs = shd.tree_specs(mesh, logical, rules)
    full = gpt_mod.param_shapes(cfg)
    stacked_shapes = dict(full, layers={
        k: (pp, v[0] // pp) + tuple(v[1:]) for k, v in full["layers"].items()})
    # the axes whose ranks hold distinct tokens of a microbatch: its
    # rows' (the data axes but the stage axis) and its sequence's (sp)
    data = tuple(a for a in ("dcn", "dp", "fsdp", "sp")
                 if a != stage_axis and groups.size(a) > 1)
    data_nf = tuple(a for a in data if a != "fsdp")
    if groups.grouped:
        add_axes_groups(mesh, (data, data_nf))
    g_data = mesh.axes_group(data) if data and groups.grouped else None
    g_data_nf = (mesh.axes_group(data_nf) if data_nf and groups.grouped
                 else None)
    if groups.size("sp") > 1:
        attn_fn = make_ring_attention_fn(mesh)
    else:
        attn_fn = make_flash_attention_fn(
            mesh, rope_theta=cfg.rope_theta if cfg.pos == "rope" else None)
    first = groups.coord(stage_axis) == 0
    last = groups.coord(stage_axis) == pp - 1

    def stage_fn(stage_params, shared, act, mb):
        tokens = mb["tokens"]
        S = tokens.shape[1]
        positions = groups.coord("sp") * S + torch.arange(
            S, device=tokens.device)
        x = gpt_mod.embed_tokens(shared, tokens, cfg, mesh=mesh,
                                 positions=positions) if first else act
        x, _aux = gpt_mod.run_layers(
            {k: v[0] for k, v in stage_params.items()}, x, cfg,
            positions=positions, attn_fn=attn_fn, mesh=mesh)
        if not last:
            return x, None
        ce_norm = gpt_mod.uses_ce_norm(cfg, tokens.numel(), tokens.device,
                                       mesh=mesh)
        h = x if ce_norm else gpt_mod._norm(
            x, shared["ln_f"], cfg.norm, bias=shared.get("ln_f_b"),
            eps=gpt_mod.norm_eps(cfg))
        loss_u = gpt_mod.loss_from_hidden(
            shared, h, mb["targets"], cfg,
            norm_scale=shared["ln_f"] if ce_norm else None, mesh=mesh)
        return x, loss_u

    def check_batch(batch):
        B = batch["tokens"].shape[0]
        if B % M:
            raise ValueError(f"batch={B} not divisible by microbatches={M}")
        if "segment_ids" in batch:
            # dropping the mask would let co-packed documents attend to
            # each other (the overlap schedule's guard)
            raise ValueError(
                "sample-packed batches (segment_ids) are not supported "
                "by the pipeline-parallel trainer yet — stream unpacked "
                "(RAY_TPU_DATA_PACK=0) or use build_gpt_train")

    def microbatches(params, batch):
        """The stage runner's arguments: the [M, ...] inputs, each
        microbatch's weight (its share of the global count of valid
        targets) and the activation's template."""
        check_batch(batch)
        tokens, targets = batch["tokens"], batch["targets"]
        B, S = tokens.shape
        mbs = {"tokens": tokens.reshape(M, B // M, S),
               "targets": targets.reshape(M, B // M, S)}
        n_u = (mbs["targets"] >= 0).sum((1, 2)).float()
        total = n_u.sum()
        if g_data is not None:
            import torch.distributed as dist
            total = total.clone()
            dist.all_reduce(total, group=g_data)
        act = torch.empty((B // M, S, cfg.d_model), dtype=cfg.dtype,
                          device=tokens.device)
        shared = {k: v for k, v in params.items() if k != "layers"}
        return shared, mbs, n_u / total.clamp_min(1.0), act

    def reduce(grads, loss):
        """The gradients and the loss summed over the data axes (the
        fsdp-sharded leaves' over them but fsdp), in f32."""
        import torch.distributed as dist
        paths, flat = _paths(grads), _leaves(grads)
        by_fsdp = {False: [], True: []}
        for i in _path_order(grads):
            by_fsdp["fsdp" in shd.spec_axes(_at(specs, paths[i]))].append(i)
        for on_fsdp, group in ((False, g_data), (True, g_data_nf)):
            idx = by_fsdp[on_fsdp]
            extra = [] if on_fsdp else [loss]
            if group is None or not idx + extra:
                continue
            got = _flat_collective(
                [flat[i] for i in idx] + extra,
                lambda f, g=group: dist.all_reduce(f, group=g))
            if extra:
                loss = got.pop()
            for i, t in zip(idx, got):
                flat[i] = t
        return _rebuild(grads, flat), loss

    runner = (pipe.pipeline_1f1b_value_and_grad if schedule == "1f1b"
              else pipe.pipeline_gpipe_value_and_grad)

    def loss_and_grads(params, batch):
        shared, mbs, w, act = microbatches(params, batch)
        loss, g_stage, g_shared = runner(
            stage_fn, params["layers"], shared, mbs, mesh=mesh,
            num_microbatches=M, act_example=act, axis=stage_axis,
            cot_weights=w)
        grads = {k: g_stage if k == "layers" else g_shared[k]
                 for k in params}
        grads, loss = reduce(grads, loss)
        grads = _rebuild(grads, [g.to(p.dtype) for g, p in
                                 zip(_leaves(grads), _leaves(params))])
        return loss, grads

    def grad_norm(grads):
        if not groups.grouped:
            return global_norm(grads)
        return _sharded_global_norm(grads, specs, groups)

    def step(state: TrainState, batch):
        loss_val, grads = loss_and_grads(state.params, batch)
        gnorm = grad_norm(grads)
        opt_state = tx.update(grads, state.opt_state, state.params,
                              g_norm=gnorm)
        return (TrainState(state.params, opt_state, state.step + 1),
                {"loss": loss_val, "grad_norm": gnorm,
                 "step": state.step + 1})

    @torch.no_grad()
    def loss_eval(params, batch):
        shared, mbs, w, act = microbatches(params, batch)
        loss = pipe.pipeline_forward_loss(
            stage_fn, params["layers"], shared, mbs, mesh=mesh,
            num_microbatches=M, act_example=act, axis=stage_axis,
            cot_weights=w)
        if g_data is not None:
            import torch.distributed as dist
            dist.all_reduce(loss, group=g_data)
        return loss

    def tree_kind(params) -> str:
        """"local" (this rank's shards), "stacked" or "full"."""
        if params["layers"]["wq"].dim() == 4:
            return "full"
        local = all(tuple(t.shape) == shd.local_shape(_at(stacked_shapes, p),
                                                      _at(specs, p), mesh)
                    for p, t in zip(_paths(params), _leaves(params)))
        return "local" if local else "stacked"

    def init(generator: Optional[torch.Generator] = None, *,
             params: Optional[Params] = None) -> TrainState:
        kind = "full" if params is None else tree_kind(params)
        if params is None:
            params = gpt_mod.init_params(cfg, generator, device=dev)
        if kind != "local":
            if groups.grouped and groups.mesh is not None:
                _broadcast_from_first(params, groups.mesh)
            if kind == "full":
                params = stack_stages(params, pp)
            params = shd.shard_params(params, mesh, logical, rules)
        return TrainState(params, tx.init(params), 0)

    def shard_batch(batch):
        check_batch(batch)
        if mesh is None:
            return batch
        return shd.shard_batch(batch, mesh, accum_steps=M,
                               exclude=stage_axis)

    def gather_params(params):
        return shd.gather_params(params, mesh, logical, rules)

    fns = {"init_fn": init, "step_fn": step, "loss_fn": loss_eval,
           "value_and_grad_fn": loss_and_grads, "shard_batch": shard_batch,
           "gather_params": gather_params, "attn_fn": attn_fn,
           "num_microbatches": M, "schedule": schedule,
           "stage_axis": stage_axis,
           "bubble_fraction": stats["bubble_fraction"],
           "in_flight_microbatches": stats["in_flight_microbatches"]}
    return _maybe_instrument(fns, cfg, mesh, label="train_pp",
                             telemetry=telemetry,
                             batch_axes=pp_batch_axes(stage_axis))


def pp_batch_axes(stage_axis: str) -> tuple:
    """The axes a pipeline's batch rows split over: the data axes but
    the stage axis."""
    return tuple(a for a in ("dcn", "dp", "fsdp") if a != stage_axis)


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
