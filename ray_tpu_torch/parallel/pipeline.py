"""Pipeline parallelism over a ``pp`` (or ``dcn``) mesh axis.

Counterpart of ``ray_tpu/parallel/pipeline.py``.  The reference runs
every stage as one SPMD program (a ``shard_map`` over the stage axis,
activations moved by ``ppermute``) and differentiates GPipe's forward
scan with autodiff.  Here each rank is one stage: it holds only its own
stage's parameters, and activations and their cotangents move between
neighbouring stages by point-to-point transfers
(``comm.stage_exchange``).  Autograd does not cross processes, so both
schedules are scheduled by hand, forward and backward, in *ticks*:

* GPipe (:func:`pipeline_gpipe_value_and_grad`): a forward sweep of
  ``M + pp - 1`` ticks, microbatch ``u`` on stage ``s`` at tick
  ``u + s``, every microbatch's graph kept (in flight: ``M``); then a
  backward sweep of as many ticks, microbatch ``u`` on stage ``s`` at
  tick ``u + pp - 1 - s``, each stage seeding its output with the
  cotangent the next stage sent.
* 1F1B (:func:`pipeline_1f1b_value_and_grad`, arXiv:2011.03641):
  ``M + 2 pp - 2`` ticks, microbatch ``u``'s forward on stage ``s`` at
  tick ``u + s`` (without a graph) and its backward at tick
  ``u + 2 pp - 2 - s``, which recomputes the stage's forward from its
  saved *input* under autograd.  At most ``K = min(M, 2 pp - 1)`` inputs
  are saved at once, whatever M.

Why no tick can deadlock: at the start of each tick every rank posts, in
one ``batch_isend_irecv``, each transfer that tick holds for it (the
previous tick's output to the next stage, this tick's input from the
previous one, and for the backward the cotangents the other way) and
waits for all of them before it computes.  A transfer is in a tick's set
on the sender exactly when the matching receive is in the same tick's
set on the receiver (both conditions are the same inequality on the
microbatch index), every rank runs the same ticks in the same order, and
the stage computation between two exchanges waits on no other stage
(its collectives run inside the stage's own tp or fsdp group, whose
ranks run the same stage).  Only neighbours exchange: the reference's
ring wrap from the last stage to stage 0 is garbage it masks, and is
not sent.

Gradient convention (the pipeline's own; neither 9b-i's Megatron rule
nor the overlap schedule's psum-of-a-psum): the objective is the last
stage's weighted sum of its microbatch losses; each stage
differentiates it through its own stage function, seeding its output
with the received cotangent, and accumulates its stage gradients over
the microbatches in f32.  The shared parameters' gradients (the
embedding on the first stage, the head and final norm on the last) are
summed over the stage group, as the reference's ``psum(gh)``, and so is
the loss.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ray_tpu_torch.parallel import comm


def pipeline_schedule_stats(pp: int, num_microbatches: int,
                            schedule: str = "1f1b") -> Dict[str, Any]:
    """Analytic schedule figures, the reference's: the bubble fraction
    and the peak in-flight microbatches (the activation-memory driver).

    GPipe idles ``pp - 1`` of ``M + pp - 1`` ticks and holds all ``M``
    microbatches' activations at peak; 1F1B idles ``2 pp - 2`` of
    ``M + 2 pp - 2`` ticks but holds at most ``2 pp - 1``."""
    M = int(num_microbatches)
    pp = int(pp)
    if schedule == "gpipe":
        ticks = M + pp - 1
        bubble = (pp - 1) / ticks
        in_flight = M
    elif schedule == "1f1b":
        ticks = M + 2 * pp - 2
        bubble = (2 * pp - 2) / max(ticks, 1)
        in_flight = min(M, 2 * pp - 1)
    else:
        raise ValueError(
            f"unknown pipeline schedule {schedule!r} "
            "(want 'gpipe' or '1f1b')")
    return {"schedule": schedule, "stages": pp, "num_microbatches": M,
            "ticks": ticks, "bubble_fraction": bubble,
            "in_flight_microbatches": in_flight}


class _Stage:
    """This rank's place on the stage axis: its index, the stage count,
    the stage group and the global ranks of its neighbours."""

    def __init__(self, mesh, axis: str):
        from ray_tpu_torch.parallel.mesh import mesh_groups
        g = mesh_groups(mesh)
        self.n = g.size(axis)
        self.s = g.coord(axis)
        self.prev, self.next = g.stage_neighbours(axis)
        self.group = mesh.axes_group((axis,)) if self.n > 1 else None
        self.first = self.s == 0
        self.last = self.s == self.n - 1

    def exchange(self, *, to_next=None, from_prev=None, to_prev=None,
                 from_next=None) -> None:
        """One tick's transfers: tensors to send and buffers to fill."""
        sends, recvs = [], []
        if to_next is not None:
            sends.append((to_next, self.next))
        if to_prev is not None:
            sends.append((to_prev, self.prev))
        if from_prev is not None:
            recvs.append((from_prev, self.prev))
        if from_next is not None:
            recvs.append((from_next, self.next))
        comm.stage_exchange(sends, recvs)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return x
        import torch.distributed as dist
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x


def _flat(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    return [tree]


def _rebuild(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)

    return build(tree)


def _mb_at(mb_inputs, u: int):
    return {k: v[u] for k, v in mb_inputs.items()}


class _Grads:
    """f32 accumulators for the stage and shared parameters, fed one
    microbatch's backward at a time."""

    def __init__(self, stage_params, shared_params):
        self.stage_tree, self.shared_tree = stage_params, shared_params
        self.stage = [p.detach().requires_grad_(True)
                      for p in _flat(stage_params)]
        self.shared = [p.detach().requires_grad_(True)
                       for p in _flat(shared_params)]
        self.acc = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                    for p in self.stage + self.shared]

    def params(self):
        return (_rebuild(self.stage_tree, self.stage),
                _rebuild(self.shared_tree, self.shared))

    def backward(self, out: torch.Tensor, seed: Optional[torch.Tensor],
                 act_in: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Accumulate d(out . seed) into the accumulators and return the
        cotangent of ``act_in`` (None when it is None)."""
        leaves = self.stage + self.shared
        inputs = leaves + ([act_in] if act_in is not None else [])
        got = torch.autograd.grad(out, inputs, grad_outputs=seed,
                                  allow_unused=True)
        for a, g in zip(self.acc, got[:len(leaves)]):
            if g is not None:
                a.add_(g.float())
        return got[len(leaves)] if act_in is not None else None

    def result(self, stage: _Stage):
        n = len(self.stage)
        stage_grads = _rebuild(self.stage_tree, self.acc[:n])
        shared_grads = _rebuild(self.shared_tree,
                                [stage.psum(a) for a in self.acc[n:]])
        return stage_grads, shared_grads


def _weights(cot_weights, M: int, device) -> torch.Tensor:
    if cot_weights is None:
        return torch.full((M,), 1.0 / M, dtype=torch.float32, device=device)
    return torch.as_tensor(cot_weights, dtype=torch.float32, device=device)


def _check(mb_inputs, M: int) -> None:
    if M < 1:
        raise ValueError(f"num_microbatches={M} must be >= 1")
    for leaf in mb_inputs.values():
        if leaf.shape[0] != M:
            raise ValueError(f"mb_inputs leading dim {leaf.shape[0]} != "
                             f"num_microbatches {M}")


def pipeline_1f1b_value_and_grad(
        stage_fn: Callable, stage_params, shared_params, mb_inputs, *,
        mesh, num_microbatches: int, act_example: torch.Tensor,
        axis: str = "pp", cot_weights=None):
    """One-forward-one-backward pipeline step: loss and gradients in one
    hand-scheduled sweep (``ray_tpu/parallel/pipeline.py:140``).

    ``stage_fn(stage_params, shared_params, act_in, mb) -> (act_out,
    loss)`` is THIS rank's stage (the first stage ignores ``act_in`` and
    embeds from ``mb``; ``loss``, this microbatch's mean over its own
    valid tokens, is read on the last stage only, and may be None
    elsewhere).  ``stage_params``: this stage's parameter tree;
    ``shared_params``: the tree every stage holds (embedding, final
    norm); ``mb_inputs``: dict of ``[M, ...]`` tensors (every stage
    holds all of them); ``act_example``: a tensor of the activation's
    shape and dtype (the receive buffers); ``cot_weights`` [M]: each
    microbatch's loss weight (default ``1/M``; ``n_u / n_total`` for
    masked targets makes the weighted sum the masked mean).

    Microbatch ``u`` runs forward on stage ``s`` at tick ``u + s``
    without a graph, its input saved, and backward at tick
    ``u + 2 pp - 2 - s``, recomputing the stage from that input under
    autograd; at most ``min(M, 2 pp - 1)`` inputs are saved.  The last
    stage's two ticks of a microbatch are one, so it runs that
    microbatch's forward once, under autograd, and reads the loss
    there.

    Returns ``(loss, stage_grads, shared_grads)``, f32: the loss and the
    shared gradients summed over the stage group, the stage gradients
    this stage's."""
    stage = _Stage(mesh, axis)
    pp, s = stage.n, stage.s
    M = int(num_microbatches)
    _check(mb_inputs, M)
    K = min(M, 2 * pp - 1)
    w = _weights(cot_weights, M, act_example.device)
    grads = _Grads(stage_params, shared_params)
    p_stage, p_shared = grads.params()
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=act_example.device)
    saved: Dict[int, Optional[torch.Tensor]] = {}
    out_prev = cot_prev = None
    for t in range(M + 2 * pp - 2):
        u_f, u_b = t - s, t - (2 * pp - 2 - s)
        f_valid, b_valid = 0 <= u_f < M, 0 <= u_b < M
        recv_act = (torch.empty_like(act_example)
                    if f_valid and not stage.first else None)
        recv_cot = (torch.empty_like(act_example)
                    if b_valid and not stage.last else None)
        stage.exchange(to_next=out_prev, from_prev=recv_act,
                       to_prev=cot_prev, from_next=recv_cot)
        out_prev = cot_prev = None
        if f_valid:
            saved[u_f] = recv_act
            if len(saved) > K:
                raise AssertionError(f"{len(saved)} saved inputs > {K}")
            if not stage.last:   # (the last stage's is its backward's)
                with torch.no_grad():
                    out_prev, _ = stage_fn(p_stage, p_shared, recv_act,
                                           _mb_at(mb_inputs, u_f))
        if b_valid:
            act_in = saved.pop(u_b)
            if act_in is not None:
                act_in = act_in.requires_grad_(True)
            out, loss_u = stage_fn(p_stage, p_shared, act_in,
                                   _mb_at(mb_inputs, u_b))
            if stage.last:
                loss_acc = loss_acc + loss_u.detach().float() * w[u_b]
                cot_prev = grads.backward(loss_u.float() * w[u_b], None,
                                          act_in)
            else:
                cot_prev = grads.backward(out, recv_cot, act_in)
            del out, loss_u
    stage_grads, shared_grads = grads.result(stage)
    return stage.psum(loss_acc), stage_grads, shared_grads


def pipeline_gpipe_value_and_grad(
        stage_fn: Callable, stage_params, shared_params, mb_inputs, *,
        mesh, num_microbatches: int, act_example: torch.Tensor,
        axis: str = "pp", cot_weights=None):
    """GPipe's loss and gradients, the same contract as
    :func:`pipeline_1f1b_value_and_grad`: the forward sweep of
    :func:`pipeline_apply` with every microbatch's graph kept, then the
    backward sweep in the mirrored order (microbatch ``u`` on stage
    ``s`` at backward tick ``u + pp - 1 - s``: the last stage first),
    each stage seeding its output with the cotangent the next stage
    sent and sending its input's cotangent to the previous one.  This is
    the reference's autodiff of ``pipeline_apply`` written out."""
    stage = _Stage(mesh, axis)
    pp, s = stage.n, stage.s
    M = int(num_microbatches)
    _check(mb_inputs, M)
    w = _weights(cot_weights, M, act_example.device)
    grads = _Grads(stage_params, shared_params)
    p_stage, p_shared = grads.params()
    kept = _sweep_forward(stage, stage_fn, p_stage, p_shared, mb_inputs, M,
                          act_example, keep_graph=True)
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=act_example.device)
    cot_prev = None
    for t in range(M + pp - 1):
        u = t - (pp - 1 - s)
        valid = 0 <= u < M
        recv_cot = (torch.empty_like(act_example)
                    if valid and not stage.last else None)
        stage.exchange(to_prev=cot_prev, from_next=recv_cot)
        cot_prev = None
        if valid:
            act_in, out, loss_u = kept.pop(u)
            if stage.last:
                loss_acc = loss_acc + loss_u.detach().float() * w[u]
                cot_prev = grads.backward(loss_u.float() * w[u], None,
                                          act_in)
            else:
                cot_prev = grads.backward(out, recv_cot, act_in)
            del out, loss_u
    stage_grads, shared_grads = grads.result(stage)
    return stage.psum(loss_acc), stage_grads, shared_grads


def _sweep_forward(stage: _Stage, stage_fn: Callable, p_stage, p_shared,
                   mb_inputs, M: int, act_example: torch.Tensor, *,
                   keep_graph: bool) -> Dict[int, tuple]:
    """GPipe's forward sweep: microbatch ``u`` on stage ``s`` at tick
    ``u + s``; returns ``{u: (stage input, stage output, loss)}``, the
    input a leaf that requires grad when ``keep_graph`` (None on the
    first stage)."""
    kept: Dict[int, tuple] = {}
    out_prev = None
    for t in range(M + stage.n - 1):
        u = t - stage.s
        valid = 0 <= u < M
        recv_act = (torch.empty_like(act_example)
                    if valid and not stage.first else None)
        stage.exchange(to_next=out_prev, from_prev=recv_act)
        out_prev = None
        if valid:
            act_in = recv_act
            if act_in is not None and keep_graph:
                act_in = act_in.requires_grad_(True)
            with torch.set_grad_enabled(keep_graph and
                                        torch.is_grad_enabled()):
                out, loss_u = stage_fn(p_stage, p_shared, act_in,
                                       _mb_at(mb_inputs, u))
            if not stage.last:
                out_prev = out.detach()
            kept[u] = (act_in, out, loss_u)
    return kept


def pipeline_forward_loss(stage_fn: Callable, stage_params, shared_params,
                          mb_inputs, *, mesh, num_microbatches: int,
                          act_example: torch.Tensor, axis: str = "pp",
                          cot_weights=None) -> torch.Tensor:
    """The weighted loss of GPipe's forward sweep alone, without a graph
    (both schedules compute this value), summed over the stage group."""
    stage = _Stage(mesh, axis)
    M = int(num_microbatches)
    _check(mb_inputs, M)
    w = _weights(cot_weights, M, act_example.device)
    with torch.no_grad():
        kept = _sweep_forward(stage, stage_fn, stage_params, shared_params,
                              mb_inputs, M, act_example, keep_graph=False)
    loss = torch.zeros((), dtype=torch.float32, device=act_example.device)
    if stage.last:
        for u in range(M):
            loss = loss + kept[u][2].float() * w[u]
    return stage.psum(loss)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, num_microbatches: int, axis: str = "pp"
                   ) -> torch.Tensor:
    """Run a GPipe forward sweep (``ray_tpu/parallel/pipeline.py:69``).

    ``stage_fn(stage_params, activation) -> activation`` is this rank's
    stage, with the same activation shape on every stage;
    ``stage_params`` this stage's tree; ``x`` ``[M, mb, ...]`` the
    microbatched input (read on the first stage; every stage passes a
    tensor of its shape).  Returns the last stage's outputs ``[M, mb,
    ...]`` on every stage of the group (broadcast from the last, as the
    reference's masked psum does).  No graph crosses stages: the
    trainer differentiates through
    :func:`pipeline_gpipe_value_and_grad`."""
    stage = _Stage(mesh, axis)
    M = int(num_microbatches)
    if x.shape[0] != M:
        raise ValueError(f"x leading dim {x.shape[0]} != "
                         f"num_microbatches {M}")

    def fn(p, _shared, a, mb):
        return stage_fn(p, mb["x"] if a is None else a), None

    with torch.no_grad():
        kept = _sweep_forward(stage, fn, stage_params, {}, {"x": x}, M,
                              torch.empty_like(x[0]), keep_graph=False)
    outs = (torch.stack([kept[u][1] for u in range(M)]) if stage.last
            else torch.empty_like(x))
    if stage.group is not None:
        import torch.distributed as dist
        src = dist.get_global_rank(stage.group, stage.n - 1)
        dist.broadcast(outs, src=src, group=stage.group)
    return outs


def pipeline_loss_fn(stage_fn: Callable, loss_fn: Callable):
    """Compose a pipeline forward with a loss on the final activations."""
    def fn(stage_params, x, targets, *, mesh, num_microbatches):
        out = pipeline_apply(stage_fn, stage_params, x, mesh=mesh,
                             num_microbatches=num_microbatches)
        return loss_fn(out, targets)
    return fn


def stack_stage_params(per_stage_params):
    """``[{...}, {...}]`` -> one tree with a leading stage dimension."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(list(per_stage_params))
