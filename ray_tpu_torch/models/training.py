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

Over a data-parallel mesh (``parallel.mesh.make_mesh``: one rank per
card, NCCL on the card, gloo on the CPU) each rank's step takes its own
rows of the global batch.  The reference's GSPMD step takes the loss as
the global masked sum over the global count of valid targets; here the
ranks first all-reduce their counts, each scales its local mean by its
share of the global count, and after the backward (and after
accumulation) the gradients and the loss are all-reduced as one flat
buffer per dtype, in their own dtype.  Every rank then holds the global
batch's loss, gradient norm and update.  Every rank starts from rank
0's parameters (broadcast by ``init_fn``).

Sequence parallelism, the overlap schedule and its wire quantisation,
meshes with axes other than ``dp`` (ROADMAP Queue 1 item 9b) and LoRA
(item 11) raise ``NotImplementedError`` naming the item that ports them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ray_tpu_torch.models import gpt as gpt_mod
from ray_tpu_torch.ops.attention import make_flash_attention_fn
from ray_tpu_torch.ops.substrate import resolve_device
from ray_tpu_torch.parallel.mesh import dp_group

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


def _path_order(tree: Params) -> List[int]:
    """Indices into :func:`_leaves` order that sort the leaves by their
    key paths: the order every rank agrees on, whatever order its tree
    was built in (``init_params`` and ``convert.params_from_jax`` build
    the same tree in different key orders)."""
    paths = []

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                paths.append(prefix + (k,))

    walk(tree, ())
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
    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> AdamWState:
        """One update, written into ``params`` and the state's moments in
        place; returns the state with its count advanced."""
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
                              ce_mode=ce_mode, config=config)


def build_gpt_train(cfg: "gpt_mod.GPTConfig", mesh=None, *,
                    optimizer: Optional[DefaultOptimizer] = None,
                    ce_mode: Optional[str] = None,
                    fuse_norm: Optional[bool] = None,
                    accum_steps: int = 1, device=None,
                    sp_impl: Optional[str] = None,
                    comm_mode: Optional[str] = None,
                    comm_quant: Optional[str] = None,
                    telemetry: Optional[bool] = None,
                    lora=None) -> Dict[str, Any]:
    """Returns dict(init_fn, step_fn, loss_fn, forward_fn, attn_fn,
    accum_steps, comm_mode), and ``telemetry`` and ``raw_step_fn``
    when the step recorder is on.

    ``init_fn(generator=None, *, params=None) -> TrainState``: random
    parameters from ``generator`` (or the given tree), fresh optimizer
    state, step 0; over a process group, rank 0's parameters on every
    rank.  ``step_fn(state, batch) -> (state, {"loss", "grad_norm",
    "step"})`` with batch = dict(tokens, targets) [B, S], this rank's
    rows; ``grad_norm`` is the global norm before the clip, as the
    reference reports it.  ``ce_mode`` ("flash" default, "fused" with
    ``cfg.ce_chunk < 0``, or "xla") and ``fuse_norm`` (None means on)
    pin the loss head and the fused epilogues; ``accum_steps`` runs the
    step as that many microbatches with f32 gradient accumulation and
    one update; ``cfg.remat`` recomputes each block in the backward.
    ``mesh``: a data-parallel mesh (``parallel.mesh.make_mesh``); over a
    live process group the gradients and loss are all-reduced over its
    ``dp`` group, of any size, one included.  ``telemetry`` (None:
    ``RAY_TPU_TELEMETRY``, default on) wraps ``step_fn`` in a
    ``StepTelemetry``.  Runs on the card unless ``device="cpu"``."""
    group, dp = dp_group(mesh)
    if sp_impl is not None:
        raise _unported(f"sequence parallelism (sp_impl={sp_impl!r})", "9b")
    if comm_mode not in (None, "gspmd") or comm_quant not in (None, "none"):
        raise _unported("the overlap schedule and its wire quantisation",
                        "9b")
    if lora:
        raise _unported("trainable-adapter mode (lora=)", "11")
    if dp > 1 and group is None:
        raise ValueError(f"a mesh of dp={dp} needs a live process group "
                         "(parallel.mesh.make_mesh inside the workers)")
    accum_steps = int(accum_steps)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    gpt_mod.check_supported(cfg)
    dev = resolve_device(device)
    tx = optimizer or default_optimizer()
    attn_fn = make_flash_attention_fn(
        mesh, rope_theta=cfg.rope_theta if cfg.pos == "rope" else None)

    def loss(params, batch):
        return gpt_mod.loss_fn(params, batch, cfg, attn_fn=attn_fn,
                               ce_mode=ce_mode, fuse_norm=fuse_norm)

    def init(generator: Optional[torch.Generator] = None, *,
             params: Optional[Params] = None) -> TrainState:
        if params is None:
            params = gpt_mod.init_params(cfg, generator, device=dev)
        if group is not None:
            _broadcast_from_first(params, group)
        return TrainState(params, tx.init(params), 0)

    def dp_weights(batch):
        """Each microbatch's share of the global count of valid
        targets, for this rank's rows."""
        import torch.distributed as dist
        n = torch.stack([(t >= 0).sum() for t in
                         batch["targets"].chunk(accum_steps)]).float()
        total = n.clone()
        dist.all_reduce(total, group=group)
        return n / total.clamp_min(1.0)

    def step(state: TrainState, batch):
        w = dp_weights(batch) if group is not None else None
        if accum_steps > 1:
            loss_val, grads = _accum_value_and_grad(
                loss, state.params, batch, accum_steps, weights=w)
        else:
            fn = loss if w is None else _weighted(loss, w[0])
            loss_val, grads = value_and_grad(fn, state.params, batch)
        if group is not None:
            import torch.distributed as dist
            order = _path_order(grads)
            flat = _leaves(grads)
            *reduced, loss_val = _flat_collective(
                [flat[i] for i in order] + [loss_val.float()],
                lambda f: dist.all_reduce(f, group=group))
            for i, t in zip(order, reduced):
                flat[i] = t
            grads = _rebuild(grads, flat)
        gnorm = global_norm(grads)
        opt_state = tx.update(grads, state.opt_state, state.params)
        return (TrainState(state.params, opt_state, state.step + 1),
                {"loss": loss_val.float(), "grad_norm": gnorm,
                 "step": state.step + 1})

    @torch.no_grad()
    def loss_eval(params, batch):
        return loss(params, batch)

    @torch.no_grad()
    def forward_logits(params, batch):
        logits, _ = gpt_mod.forward(params, batch["tokens"], cfg,
                                    attn_fn=attn_fn, fuse_norm=fuse_norm)
        return logits

    # "gspmd": the reference's name for the default schedule, in which
    # the gradients are reduced once, after the backward
    fns = {"init_fn": init, "step_fn": step, "loss_fn": loss_eval,
           "forward_fn": forward_logits, "attn_fn": attn_fn,
           "accum_steps": accum_steps, "comm_mode": "gspmd"}
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
