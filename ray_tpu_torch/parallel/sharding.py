"""Logical-axis sharding rules, and each rank's shards of a tree.

Counterpart of ``ray_tpu/parallel/sharding.py``.  Model code names the
dimensions of a parameter by logical axes (``("vocab", "embed_fsdp")``);
a rule table maps those to mesh axes.  The table (``DEFAULT_RULES``),
``rules_dict``, ``logical_to_spec``, ``tree_specs`` and ``data_axes`` are
the reference's, copied; a spec is a plain tuple with one entry per
leading dimension (a mesh-axis name, a tuple of names, or None), the
``PartitionSpec`` counterpart, with axes that are missing from the mesh
or of size 1 degraded to replication and trailing Nones trimmed, as
there.

Where the reference hands a spec to GSPMD, the port places tensors
itself: :func:`shard_params` cuts a full tree into this rank's shards by
its mesh coordinate, :func:`gather_params` all-gathers them back, and
:func:`shard_batch` takes this rank's rows and sequence shard of a
global batch.  A dimension sharded over several axes takes the row-major
index of the rank's coordinates along them, as a JAX mesh orders its
devices.

Not ported: ``constrain``, ``named_sharding`` and ``tree_shardings``
have no torch meaning, since nothing propagates shardings here: the
model runs its collectives where GSPMD would put them
(``models/gpt.py``).  ``ray_tpu/parallel/compat.py`` is a JAX
``shard_map`` shim and has no counterpart: the port calls
``torch.distributed`` directly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch.parallel import comm

Rules = Tuple[Tuple[str, Union[str, Tuple[str, ...], None]], ...]
Spec = Tuple[Union[str, Tuple[str, ...], None], ...]

# the reference's rule table (ray_tpu/parallel/sharding.py:25): fsdp
# shards parameters along d_model (ZeRO-3), tp follows Megatron, the
# batch shards over (dcn, dp, fsdp) and the sequence over sp
DEFAULT_RULES: Rules = (
    ("batch", ("dcn", "dp", "fsdp")),
    ("seq", "sp"),
    ("kv_seq", None),
    ("embed", None),
    ("embed_fsdp", "fsdp"),
    ("vocab", "tp"),
    ("heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("experts", "ep"),
    ("expert_mlp", "tp"),
    ("stage", "pp"),
    ("conv_in", None),
    ("conv_out", "tp"),
)


def rules_dict(rules: Optional[Rules] = None) -> Dict[str, object]:
    return dict(rules if rules is not None else DEFAULT_RULES)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Optional[Rules] = None, mesh=None) -> Spec:
    """Map logical axis names to a spec tuple.  Axes mapped to mesh axes
    that ``mesh`` lacks (or holds at size 1) degrade to replication, so
    one rule table serves every mesh shape."""
    table = rules_dict(rules)
    out = []
    for name in logical_axes:
        target = None if name is None else table.get(name)
        if target is not None and mesh is not None:
            if isinstance(target, tuple):
                target = tuple(a for a in target
                               if mesh.shape.get(a, 1) > 1) or None
                if isinstance(target, tuple) and len(target) == 1:
                    target = target[0]
            elif mesh.shape.get(target, 1) <= 1:
                target = None
        out.append(target)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def tree_map(fn, tree, *others):
    """``fn`` over the leaves of a dict tree and the matching leaves of
    ``others`` (trees of the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def tree_specs(mesh, logical_tree, rules: Optional[Rules] = None):
    """A tree of logical-axis tuples -> the tree of spec tuples."""
    if _is_axes_leaf(logical_tree):
        return logical_to_spec(logical_tree, rules, mesh)
    return {k: tree_specs(mesh, v, rules) for k, v in logical_tree.items()}


def data_axes(mesh):
    """The mesh axes a batch dimension shards over: (dcn, dp, fsdp)
    present with size > 1, one name when alone, or None."""
    axes = tuple(a for a in ("dcn", "dp", "fsdp")
                 if mesh.shape.get(a, 1) > 1)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for e in spec for a in _axes(e))


def shard_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's shard index, shard count) along ``axes`` together:
    the row-major index of its coordinates along them."""
    idx, n = 0, 1
    for a in axes:
        size = mesh.shape.get(a, 1)
        idx = idx * size + mesh.coordinate(a)
        n *= size
    return idx, n


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one shard of a tensor of ``shape`` under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(mesh.shape.get(a, 1) for a in _axes(entry))
        if out[dim] % n:
            raise ValueError(f"dimension {dim} of size {out[dim]} does not "
                             f"split over mesh axes {_axes(entry)} "
                             f"(product {n})")
        out[dim] //= n
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec``; ``t``
    itself when the spec shards nothing, else a copy."""
    if not spec_axes(spec):
        return t
    local_shape(t.shape, spec, mesh)       # divisibility
    out = t
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        idx, n = shard_index(mesh, axes)
        size = t.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out.contiguous().clone()


def shard_params(params, mesh, logical_tree, rules: Optional[Rules] = None):
    """A full parameter tree -> this rank's shards, leaf by leaf."""
    specs = tree_specs(mesh, logical_tree, rules)
    return tree_map(lambda t, s: shard_tensor(t, s, mesh), params, specs)


def gather_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: all-gathers every sharded
    dimension over its axes' group (collective over the mesh)."""
    out = t
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes:
            out = comm.all_gather_dim(out, dim, mesh.axes_group(axes))
    return out.contiguous()


def gather_params(params, mesh, logical_tree,
                  rules: Optional[Rules] = None):
    """This rank's shards -> the full tree, on every rank."""
    specs = tree_specs(mesh, logical_tree, rules)
    return tree_map(lambda t, s: gather_tensor(t, s, mesh), params, specs)


def pp_rules(stage_axis: str) -> Rules:
    """The pipeline trainers' rule table: ``stage`` follows the stage
    axis and the batch never splits over it (``DEFAULT_RULES`` when
    staging over pp)."""
    return tuple(
        ("stage", stage_axis) if k == "stage" else
        (("batch", tuple(a for a in ("dcn", "dp", "fsdp")
                         if a != stage_axis)) if k == "batch" else (k, v))
        for k, v in DEFAULT_RULES)


def stage_stacked_axes(logical_tree) -> Dict[str, Any]:
    """A model's logical-axes tree for its stage-stacked parameters:
    every layer leaf ``[stages, L / stages, ...]``, its first dimension
    ``stage``."""
    out = dict(logical_tree)
    out["layers"] = {k: ("stage",) + v
                     for k, v in logical_tree["layers"].items()}
    return out


def shard_batch(batch: Dict[str, Any], mesh, *, accum_steps: int = 1,
                exclude: Optional[str] = None) -> Dict[str, Any]:
    """This rank's part of a global batch (leaves [B, S, ...]): its rows
    along the data axes (``data_axes``) and, when ``sp`` > 1, its
    contiguous sequence shard, as the reference's ``_batch_sharding``
    lays a batch out.  With ``accum_steps`` k the rows are those of its
    data-axes shard of each of the k microbatches (rows ``[i B/k, (i+1)
    B/k)`` for microbatch i), in microbatch order, as the reference's
    accumulation splits a sharded batch.  ``exclude``: a data axis the
    rows do not split over (a pipeline's stage axis, the reference's
    ``_pp_batch_sharding``: each microbatch visits every stage whole)."""
    axes = tuple(a for a in _axes(data_axes(mesh)) if a != exclude)
    d_idx, d_n = shard_index(mesh, axes)
    sp = mesh.shape.get("sp", 1)
    sp_idx = mesh.coordinate("sp") if sp > 1 else 0
    out = {}
    for name, v in batch.items():
        B = v.shape[0]
        if B % (accum_steps * d_n):
            raise ValueError(f"batch {name!r} of {B} rows does not split "
                             f"into {accum_steps} microbatches over data "
                             f"axes {axes} (product {d_n})")
        share, micro = B // (accum_steps * d_n), B // accum_steps
        rows = [i * micro + d_idx * share + j for i in range(accum_steps)
                for j in range(share)]
        part = v[rows] if d_n > 1 or accum_steps > 1 else v
        if sp > 1:
            S = part.shape[1]
            if S % sp:
                raise ValueError(f"sequence of {S} does not split over "
                                 f"sp={sp}")
            part = part[:, sp_idx * (S // sp):(sp_idx + 1) * (S // sp)]
        out[name] = part
    return out
