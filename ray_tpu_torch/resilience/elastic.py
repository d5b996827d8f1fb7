"""Elastic training: survive a mesh that comes back *smaller*.

Counterpart of ``ray_tpu/resilience/elastic.py``: restore a checkpoint
written on n ranks onto fewer, keep training with an **unchanged global
batch**, and re-expand when capacity returns.  Three pieces:

- :func:`reshard_state` — place a
  :class:`~ray_tpu_torch.models.training.TrainState` (a full host tree:
  :func:`host_state` of a live one, or a checkpoint's snapshot) onto any
  mesh whose axes divide the leaf shapes: divisibility is validated leaf
  by leaf first (typed :class:`ReshardError` naming the leaf and axes),
  then each rank takes its shards (``parallel.sharding.shard_params``)
  on its device.  :class:`StateShardings` stands for the reference's
  tree of ``NamedSharding``.

- **global-batch invariance** — ``build_gpt_train(accum_steps=k)`` runs
  the step as ``k`` microbatches with f32 gradient accumulation and one
  update, so a shrink by f multiplies ``k`` by f instead of cutting the
  global batch.

- :func:`run_elastic_train_loop` — the supervisor: the deterministic
  ``mesh.loss`` / ``mesh.restore`` / ``mesh.step`` chaos sites drive
  shrink -> degraded steps -> expand.

A mesh is a set of ranks of one ``torch.distributed`` world.  A shrunk
mesh is the world's first n ranks (``make_mesh(ranks=n)``, the
reference's ``devices[:n]``); every rank of the world runs the loop in
step, because creating a mesh's process groups and moving the state are
collective over the world.  The ranks outside the live mesh skip the
steps (their cursor still advances: batches are a pure function of it)
and rejoin at ``mesh.restore``.  A transition gathers the full state
over the old mesh (:func:`host_state`; or restores it from the
checkpoint on rank 0 after a hard loss), broadcasts it from rank 0 to
the world, and shards it onto the new mesh.  Rank 0 writes the
checkpoints, of the full state.

Bit-exactness ends at the reduction order: a degraded mesh sums the same
per-example gradients over another partition, so the loss sequence
tracks the uninterrupted run only within rounding; the *data* sequence
is exact (``batch_cursors``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.parallel.mesh import MeshSpec, validate_divisibility
from ray_tpu_torch.resilience.config import resilience_config
from ray_tpu_torch.util import chaos


class ElasticError(RuntimeError):
    """Base for elastic-training failures (typed, never a bare assert)."""


class MeshMismatchError(ElasticError):
    """A checkpoint written on one mesh was asked to restore onto a
    different one without ``reshard=True``."""

    def __init__(self, recorded: MeshSpec, current: MeshSpec):
        super().__init__(
            f"checkpoint was written on mesh [{recorded.describe()}] "
            f"but restore targets [{current.describe()}] — pass "
            "reshard=True (restore_latest) / use reshard_state to "
            "move it deliberately")
        self.recorded = recorded
        self.current = current

    def __reduce__(self):
        return (MeshMismatchError, (self.recorded, self.current))


class ReshardError(ElasticError):
    """A state leaf cannot shard evenly onto the target mesh — raised
    before any copy, naming the first offending leaf, its shape, and the
    axis product that fails to divide it."""


@dataclasses.dataclass(frozen=True)
class StateShardings:
    """How a train state lies on a mesh: the mesh, the model's logical
    axes (``models.gpt.param_logical_axes``) and the device.  Every
    parameter-shaped tree of the state (the parameters, the optimizer's
    moments) shards by those axes; other leaves are replicated."""

    mesh: Any
    logical: Dict[str, Any]
    device: Any = None


def state_shardings(cfg, mesh, device=None) -> StateShardings:
    """The :class:`StateShardings` of ``build_gpt_train(cfg, mesh)``'s
    state."""
    from ray_tpu_torch.models import gpt as gpt_mod
    from ray_tpu_torch.ops.substrate import resolve_device
    return StateShardings(mesh, gpt_mod.param_logical_axes(cfg),
                          resolve_device(device))


def _paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]


def _map_param_trees(state, params, fn):
    """``state`` with ``fn(tree, name)`` applied to every dict shaped
    like ``params`` (the parameters and each optimizer moment)."""
    shape = _paths(params)

    def walk(node, name):
        if isinstance(node, dict) and _paths(node) == shape:
            return fn(node, name)
        if isinstance(node, dict):
            return {k: walk(v, f"{name}/{k}") for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, f"{name}.{f}")
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{name}[{i}]")
                              for i, v in enumerate(node))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name), f"{name}.{f.name}")
                for f in dataclasses.fields(node) if f.init})
        return node

    return walk(state, "state")


def validate_resharding(state, shardings: StateShardings) -> None:
    """Raise :class:`ReshardError` unless every parameter-shaped leaf of
    the full ``state`` divides evenly over the target mesh's axes."""
    from ray_tpu_torch.parallel import sharding as shd
    mesh = shardings.mesh
    if mesh is None:
        return
    specs = shd.tree_specs(mesh, shardings.logical)

    def check(tree, name):
        def walk(node, spec, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, spec[k], f"{path}/{k}")
                return
            shape = tuple(node.shape)
            for dim, entry in enumerate(spec):
                axes = entry if isinstance(entry, tuple) else (
                    () if entry is None else (entry,))
                div = int(np.prod([mesh.shape.get(a, 1) for a in axes]))
                if div > 1 and dim < len(shape) and shape[dim] % div:
                    raise ReshardError(
                        f"state leaf {path} dim {dim} (size {shape[dim]}) "
                        f"does not divide over mesh axes {entry} (product "
                        f"{div}) — this state cannot reshard onto "
                        f"[{MeshSpec.from_mesh(mesh).describe()}]")
        walk(tree, specs, name)
        return tree

    _map_param_trees(state, state.params, check)


def host_state(state, shardings: Optional[StateShardings] = None):
    """The full state on the host: each parameter-shaped tree gathered
    over ``shardings.mesh`` (collective over the mesh's ranks), every
    tensor copied to fresh host memory — the consistent cut the
    checkpointer snapshots."""
    from ray_tpu_torch.parallel import sharding as shd
    from ray_tpu_torch.resilience.checkpoint import _host_tree
    if shardings is not None and shardings.mesh is not None:
        mesh, logical = shardings.mesh, shardings.logical
        state = _map_param_trees(
            state, state.params,
            lambda tree, _n: shd.gather_params(tree, mesh, logical))
    return _host_tree(state)


def reshard_state(state, shardings: StateShardings):
    """Place a full host ``state`` onto ``shardings``' mesh: validate
    divisibility up front (:func:`validate_resharding`, typed), then this
    rank's shards of every parameter-shaped tree, copied to its device.
    A live state is first :func:`host_state`-ed by the caller (a
    collective over the old mesh)."""
    from ray_tpu_torch.parallel import sharding as shd
    from ray_tpu_torch.train.checkpoint import map_tensors
    validate_resharding(state, shardings)
    mesh, logical = shardings.mesh, shardings.logical
    if mesh is not None:
        state = _map_param_trees(
            state, state.params,
            lambda tree, _n: shd.shard_params(tree, mesh, logical))
    return map_tensors(state, lambda t: t.to(shardings.device, copy=True))


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _broadcast_host(tree, extra: List[int], device):
    """Rank 0's host ``tree`` and ints ``extra`` on every rank of the
    world (every rank passes a tree of the same shapes)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.training import _flat_collective
    from ray_tpu_torch.train.checkpoint import map_tensors
    tensors: List[torch.Tensor] = []

    def collect(t):
        tensors.append(t)
        return t

    map_tensors(tree, collect)
    ints = torch.tensor(extra, dtype=torch.int64)
    moved = [t.to(device) for t in tensors + [ints]]
    got = _flat_collective(moved, lambda f: dist.broadcast(f, src=0))
    it = iter([g.to("cpu", copy=True) for g in got])
    out = map_tensors(tree, lambda _t: next(it))
    return out, [int(v) for v in next(it).tolist()]


def _agree(flag: bool, device) -> bool:
    """Whether any rank of the world raised ``flag``."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([int(flag)], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _shrink_target(current: int, min_devices: int) -> int:
    """Surviving size after a mesh-loss event: half the mesh, floored at
    ``min_devices``."""
    return max(min_devices, current // 2)


def _default_batch_fn(seed: int, batch_size: int, seq_len: int,
                      vocab: int) -> Callable[[int], Dict[str, Any]]:
    """Batch ``cursor`` of the port's own stream: a pure function of
    (seed, cursor)."""
    import torch

    from ray_tpu_torch.models import training

    def batch_fn(cursor: int):
        gen = torch.Generator().manual_seed(
            (int(seed) + 1) * 1_000_003 + int(cursor))
        return training.synthetic_lm_batch(gen, batch_size, seq_len, vocab,
                                           device="cpu")

    return batch_fn


def run_elastic_train_loop(cfg, *, steps: int,
                           batch_size: int = 8, seq_len: int = 32,
                           seed: int = 0,
                           axis: str = "fsdp",
                           degraded_devices: Optional[int] = None,
                           accum_steps: int = 1,
                           optimizer=None,
                           ckpt=None,
                           graceful: Optional[bool] = None,
                           min_devices: Optional[int] = None,
                           telemetry: Optional[bool] = None,
                           straggler=None,
                           on_step: Optional[Callable[[int], None]] = None,
                           topologies: Optional[Dict[int, Dict[str, Any]]]
                           = None,
                           params=None,
                           batch_fn: Optional[Callable[[int], Dict]] = None,
                           device=None) -> Dict[str, Any]:
    """A training loop that survives mesh shrink and expand
    (``elastic.py:run_elastic_train_loop``), run by every rank of the
    world (the full mesh is the world, over ``axis``).

    Topology events come from the chaos sites, one hit per step each, on
    every rank alike:

    - ``mesh.loss`` — the mesh loses ranks: the loop takes the state off
      the old mesh (``graceful=True``: zero lost steps) or restores the
      latest retained checkpoint (hard loss: the cursor rolls back with
      it), rebuilds at ``degraded_devices`` (default: half, floored at
      ``min_devices``) with ``accum_steps`` scaled by the shrink factor
      so the **global batch is unchanged**, and reshards;
    - ``mesh.restore`` — capacity returned: the same back to the full
      mesh;
    - ``mesh.step`` — a ``:delay=S`` window stretches the step wall (a
      straggling rank).  With a straggler supervisor armed
      (``straggler=True`` / a :class:`~ray_tpu_torch.resilience.
      straggler.StragglerSupervisor` / ``RAY_TPU_STRAGGLER_FACTOR`` > 0)
      a sustained straggle, on any rank, becomes a graceful shrink; at
      the ``min_devices`` floor it is logged and ridden out.

    ``params``: the initial full parameter tree (default: ``init_fn``
    from a generator seeded with ``seed``); ``batch_fn(cursor)`` the
    global batch at a cursor (default: the port's own synthetic stream),
    so a test can feed the reference's parameters and batches.  Every
    rank passes a ``ckpt`` of the same cadence (or none): the state is
    gathered at each snapshot step, rank 0's checkpointer writes it and
    reads it back on a hard loss.  ``topologies``: a cache shared across runs of the
    same geometry (the reference's).  Runs on the card unless
    ``device="cpu"``.  Every rank returns the loop's record; ``losses``
    are the mesh's (the same on each of its ranks) and are None on a
    rank outside it."""
    import torch

    from ray_tpu_torch.models import gpt as gpt_mod
    from ray_tpu_torch.models import training
    from ray_tpu_torch.ops.substrate import resolve_device
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.resilience.straggler import StragglerSupervisor
    from ray_tpu_torch.train.checkpoint import map_tensors
    from ray_tpu_torch.telemetry.config import TelemetryConfig
    from ray_tpu_torch.telemetry.elastic import ElasticTelemetry

    rcfg = resilience_config()
    if graceful is None:
        graceful = rcfg.elastic_graceful
    if min_devices is None:
        min_devices = rcfg.elastic_min_devices
    dev = resolve_device(device)
    n_full, rank = _world()
    if degraded_devices is None:
        degraded_devices = _shrink_target(n_full, min_devices)
    if degraded_devices < min_devices:
        raise ElasticError(
            f"degraded_devices={degraded_devices} is below "
            f"min_devices={min_devices} "
            "(RAY_TPU_ELASTIC_MIN_DEVICES) — a loss this deep is "
            "declared fatal, not a target")
    tel_config = (TelemetryConfig(enabled=bool(telemetry))
                  if isinstance(telemetry, bool) else None)
    tel = ElasticTelemetry(config=tel_config)
    tx = optimizer or training.default_optimizer()
    if isinstance(straggler, StragglerSupervisor):
        watch = straggler
    elif straggler is None:
        watch = StragglerSupervisor()      # env-armed (factor 0 = off)
    elif straggler:
        watch = StragglerSupervisor(factor=rcfg.straggler_factor or 3.0)
    else:
        watch = StragglerSupervisor(factor=0.0)
    if batch_fn is None:
        batch_fn = _default_batch_fn(seed, batch_size, seq_len,
                                     cfg.vocab_size)
    if topologies is None:
        topologies = {}
    builds: List[int] = []

    def topology(n: int) -> Dict[str, Any]:
        if n in topologies:
            return topologies[n]
        if n < 1 or n > n_full:
            raise ElasticError(f"cannot build a {n}-device mesh from "
                               f"{n_full} devices")
        if n_full % n:
            raise ElasticError(
                f"surviving device count {n} does not divide the full "
                f"mesh ({n_full}): the accumulation factor that keeps "
                "the global batch would not be whole")
        k = accum_steps * (n_full // n)
        # collective over the world: every rank builds every topology
        mesh = make_mesh(**{axis: n}, ranks=n)
        fns = None
        if mesh.member:
            validate_divisibility(mesh, batch=batch_size, accum_steps=k)
            fns = training.build_gpt_train(cfg, mesh, optimizer=tx,
                                           accum_steps=k, telemetry=False,
                                           device=device)
        topologies[n] = {"mesh": mesh, "fns": fns, "n": n,
                         "spec": MeshSpec.from_mesh(mesh),
                         "accum_steps": k,
                         "shardings": state_shardings(cfg, mesh, device)}
        builds.append(n)
        return topologies[n]

    topo = topology(n_full)
    if params is None:
        params = gpt_mod.init_params(
            cfg, torch.Generator().manual_seed(int(seed)), device="cpu")
    # a copy: init_fn keeps a full tree's unsharded leaves as they are,
    # and the step updates them in place
    state = topo["fns"]["init_fn"](
        params=map_tensors(params, lambda t: t.to(dev, copy=True)))
    stale = None                # a left-out rank's copy of the full state
    cursor = 0
    tel.record_mesh(n_full)

    losses: List[Optional[float]] = []
    batch_cursors: List[int] = []
    transitions: List[Dict[str, Any]] = []
    straggler_events: List[int] = []

    def transition(kind: str, target: int, cause: str = "fault"):
        nonlocal state, topo, cursor, stale
        src = topo["n"]
        if target == src:
            return
        t0 = time.monotonic()
        if kind == "shrink" and not graceful and cause != "straggler":
            if ckpt is None:
                raise ElasticError(
                    "hard mesh loss (graceful=False) needs a "
                    "TrainCheckpointer to fall back to")
            snapshot = (host_state(state, topo["shardings"])
                        if topo["mesh"].member else stale)
            restored = None
            if rank == 0:
                example = {"state": snapshot,
                           "extras": {"data_cursor": np.asarray(0)}}
                restored = ckpt.restore_latest(example=example,
                                               reshard=True)
            found = int(restored is not None)
            if n_full > 1:
                found = int(_agree(bool(found), dev))
            if not found:
                raise ElasticError(
                    "hard mesh loss with nothing restorable: the run "
                    "is lost (checkpoint before arming mesh.loss)")
            if rank == 0:
                snapshot = restored["state"]
                cursor = int(np.asarray(restored["extras"]["data_cursor"]))
        else:
            # graceful: the state off the old mesh (a gather over its
            # ranks; the left-out ranks hold the copy they were given)
            snapshot = (host_state(state, topo["shardings"])
                        if topo["mesh"].member else stale)
        if n_full > 1:
            snapshot, (cursor,) = _broadcast_host(snapshot, [cursor], dev)
        new = topology(target)
        if new["mesh"].member:
            state = reshard_state(snapshot, new["shardings"])
            stale = None
        else:
            state, stale = None, snapshot
        dt = time.monotonic() - t0
        topo = new
        transitions.append({"kind": kind, "step": cursor,
                            "from": src, "to": target,
                            "cause": cause,
                            "reshard_s": round(dt, 6)})
        tel.record_transition(kind, dt, n_devices=target)
        watch.reset()

    while cursor < steps:
        if chaos.should_fire("mesh.loss"):
            target = (_shrink_target(topo["n"], min_devices)
                      if degraded_devices >= topo["n"]
                      else degraded_devices)
            if target >= topo["n"]:
                raise ElasticError(
                    f"mesh.loss at the min_devices floor: the "
                    f"{topo['n']}-device mesh cannot shrink below "
                    f"min_devices={min_devices} "
                    "(RAY_TPU_ELASTIC_MIN_DEVICES) — the loss is "
                    "fatal; resume from the latest checkpoint when "
                    "capacity returns")
            transition("shrink", target)
        if chaos.should_fire("mesh.restore"):
            transition("expand", n_full)
        batch_cursors.append(cursor)
        t_step = time.monotonic()
        chaos.maybe_fail("mesh.step")
        if topo["mesh"].member:
            fns = topo["fns"]
            batch = {k: torch.as_tensor(np.asarray(v)).to(dev)
                     for k, v in batch_fn(cursor).items()}
            state, metrics = fns["step_fn"](state, fns["shard_batch"](batch))
            losses.append(float(metrics["loss"]))   # blocks: wall is real
        else:
            losses.append(None)
        step_wall = time.monotonic() - t_step
        cursor += 1
        step_tier = ("dcn" if topo["mesh"].shape.get("dcn", 1) > 1
                     else "ici")
        slow = topo["mesh"].member and watch.observe(step_wall,
                                                     tier=step_tier)
        if n_full > 1 and watch.enabled:
            slow = _agree(slow, dev)
        if slow:
            straggler_events.append(cursor - 1)
            tel.record_straggler()
            target = (_shrink_target(topo["n"], min_devices)
                      if degraded_devices >= topo["n"]
                      else degraded_devices)
            if target < topo["n"]:
                transition("shrink", target, cause="straggler")
        if ckpt is not None and ckpt.due(cursor):
            full = (host_state(state, topo["shardings"])
                    if topo["mesh"].member else None)
            if rank == 0:
                ckpt.save(full, step=cursor,
                          extras={"data_cursor": np.asarray(cursor)},
                          mesh=topo["spec"],
                          accum_steps=topo["accum_steps"])
        if on_step is not None:
            on_step(cursor)
    if ckpt is not None:
        ckpt.flush()
    return {
        "losses": losses,
        "batch_cursors": batch_cursors,
        "transitions": transitions,
        "straggler_events": straggler_events,
        "builds": builds,
        "final_step": None if state is None else int(state.step),
        "final_devices": topo["n"],
        "accum_steps": topo["accum_steps"],
        "state": state,
        "elastic": tel.summary(),
        "checkpoint": (ckpt.telemetry.summary() if ckpt is not None
                       else {"enabled": False}),
    }
