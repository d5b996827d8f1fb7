"""Device meshes for the port: named axes over a process group.

Counterpart of ``ray_tpu/parallel/mesh.py``.  The axis bookkeeping is
the reference's, copied (``AXIS_ORDER``, :class:`MeshAxisError`,
:class:`MeshSpec`, :func:`parse_mesh_axes`, :func:`mesh_axis_size`,
:func:`suggest_accum_steps`, :func:`validate_divisibility`).  Where the
reference builds a ``jax.sharding.Mesh`` over the global device set,
:func:`make_mesh` builds a ``torch.distributed.device_mesh.DeviceMesh``
over the live process group: one rank per device, so the group's world
is the mesh (one rank and no group: a mesh of 1).  The returned mesh is
a :class:`Mesh`, a ``DeviceMesh`` whose ``size`` is an int (still
callable as ``DeviceMesh.size(dim)``), whose ``shape`` also answers by
axis name (``mesh.shape["dp"]``, ``.get``, ``.items``), as the
reference's callers read a JAX mesh, and which gives each axis's process
group (``get_group``), this rank's coordinate (``coordinate``) and the
group of several axes together (``axes_group``).

Every axis of ``AXIS_ORDER`` is ported: ``dcn``, ``dp``, ``fsdp``,
``sp`` and ``tp`` for the training step and the model, ``pp`` (or
``dcn``) for the pipeline's stages (``parallel/pipeline.py``) and ``ep``
for the experts (``parallel/moe.py``).  :func:`mesh_groups` gives what
the training step, the model and the attention hooks read of a mesh,
the ``pp`` and ``ep`` groups and this rank's stage neighbours included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "sp", "ep", "tp")

# Axes of one host's fabric; "dcn" is the only cross-host axis
ICI_AXES = tuple(a for a in AXIS_ORDER if a != "dcn")


class MeshAxisError(ValueError):
    """A mesh-axis string was malformed; ``axis`` names the offender."""

    def __init__(self, msg: str, *, axis: Optional[str] = None):
        super().__init__(msg)
        self.axis = axis


@dataclass(frozen=True)
class MeshSpec:
    """A named logical mesh shape, resolvable against any device count."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def create(cls, **sizes: int) -> "MeshSpec":
        unknown = set(sizes) - set(AXIS_ORDER)
        if unknown:
            bad = sorted(unknown)[0]
            raise MeshAxisError(
                f"unknown mesh axis {bad!r}; valid: {AXIS_ORDER}",
                axis=bad)
        axes = tuple((a, int(sizes[a])) for a in AXIS_ORDER if a in sizes)
        return cls(axes)

    @classmethod
    def from_mesh(cls, mesh) -> "MeshSpec":
        """The logical shape of a live mesh (or a MeshSpec, passed
        through)."""
        if isinstance(mesh, cls):
            return mesh
        return cls(tuple((str(a), int(s))
                         for a, s in dict(mesh.shape.items()).items()))

    def to_dict(self) -> Dict[str, int]:
        return {a: s for a, s in self.axes}

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "MeshSpec":
        return cls(tuple((str(a), int(s)) for a, s in d.items()))

    def describe(self) -> str:
        return ",".join(f"{a}={s}" for a, s in self.axes) or "dp=1"

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes) if self.axes else 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    def resolve(self, num_devices: int) -> "MeshSpec":
        """Fill at most one ``-1`` axis from the device count."""
        wild = [a for a, s in self.axes if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for _, s in self.axes if s != -1)
        if wild:
            if num_devices % fixed:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            fill = num_devices // fixed
            return MeshSpec(tuple((a, fill if s == -1 else s)
                                  for a, s in self.axes))
        if fixed > num_devices:
            raise ValueError(
                f"mesh size {fixed} exceeds device count {num_devices}")
        return self

    def tier_split(self) -> Tuple[int, int]:
        """``(dcn_size, per-host size)``."""
        d = dict(self.axes)
        dcn = int(d.get("dcn", 1))
        return dcn, self.size // max(dcn, 1)


def parse_mesh_axes(arg: str) -> Dict[str, int]:
    """``"dcn=2,fsdp=4"`` -> ``{"dcn": 2, "fsdp": 4}``.

    Rejections raise :class:`MeshAxisError` naming the offending axis:
    unknown names, duplicates, non-positive sizes (``-1`` is the one
    wildcard), and ``dcn`` anywhere but first."""
    sizes: Dict[str, int] = {}
    order: List[str] = []
    for part in arg.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise MeshAxisError(
                f"bad mesh axis {part!r} (want e.g. 'dcn=2,fsdp=4')",
                axis=part)
        name, _, value = part.partition("=")
        name = name.strip()
        try:
            size = int(value)
        except ValueError:
            raise MeshAxisError(
                f"mesh axis {name!r} has non-integer size {value!r}",
                axis=name) from None
        if name in sizes:
            raise MeshAxisError(f"duplicate mesh axis {name!r}", axis=name)
        if size == 0 or size < -1:
            raise MeshAxisError(
                f"mesh axis {name!r} has non-positive size {size} "
                "(only -1 is allowed as a wildcard)", axis=name)
        sizes[name] = size
        order.append(name)
    if "dcn" in order and order.index("dcn") != 0:
        raise MeshAxisError(
            "mesh axis 'dcn' must be outermost (first): the cross-pod "
            f"tier is the slowest axis, got order {order}", axis="dcn")
    MeshSpec.create(**sizes)   # validates axis names
    return sizes


class MeshShape(tuple):
    """A mesh's axis sizes: a tuple (``DeviceMesh.shape``) that also
    answers by axis name, as a JAX mesh's ``shape`` dict does."""

    def __new__(cls, names, sizes):
        out = super().__new__(cls, sizes)
        out.names = tuple(names)
        return out

    def __getitem__(self, key):
        if isinstance(key, str):
            return dict(self.items())[key]
        return super().__getitem__(key)

    def get(self, key, default=None):
        return dict(self.items()).get(key, default)

    def keys(self):
        return self.names

    def items(self):
        return tuple(zip(self.names, tuple(self)))


def _device_mesh_cls():
    from torch.distributed.device_mesh import DeviceMesh

    class _Size(int):
        """The mesh's device count, still callable as
        ``DeviceMesh.size(mesh_dim=None)``."""

        def __new__(cls, value, mesh):
            out = super().__new__(cls, value)
            out._mesh = mesh
            return out

        def __call__(self, mesh_dim=None):
            return DeviceMesh.size(self._mesh, mesh_dim)

    class Mesh(DeviceMesh):
        @property
        def size(self):
            return _Size(self.mesh.numel(), self)

        @property
        def shape(self):
            return MeshShape(self.mesh_dim_names, self.mesh.shape)

        @property
        def axis_names(self):
            return tuple(self.mesh_dim_names)

        @property
        def member(self) -> bool:
            """Whether this rank is one of the mesh's (a mesh over the
            first ``ranks`` ranks leaves the others out)."""
            return self._coords is not None

        @property
        def group(self):
            """The process group of the ``dp`` axis, or None for a mesh
            built without a live process group."""
            return self.get_group("dp") if self._with_group else None

        def coordinate(self, axis: str) -> int:
            """This rank's index along ``axis`` (0 for an absent axis)."""
            names = self.axis_names
            if axis not in names:
                return 0
            return self._coords[names.index(axis)]

        def axes_group(self, axes):
            """The process group over the axes ``axes`` taken together
            (this rank's ranks that differ only along them, in rank
            order: the row-major order of their coordinates), or None
            when they span one rank outside a world of one, or no
            group is live."""
            return _axes_group(self, tuple(axes))

    return Mesh


_MESH_CLS = None


def _mesh_cls():
    global _MESH_CLS
    if _MESH_CLS is None:
        _MESH_CLS = _device_mesh_cls()
    return _MESH_CLS


# the axis sets training reduces over, besides the single axes: the loss
# and its count and every fsdp-replicated gradient over the batch axes
# and sp; the fsdp-sharded gradients over the batch axes but fsdp, and sp
COUNT_AXES = ("dcn", "dp", "fsdp", "sp")
GRAD_AXES = ("dcn", "dp", "sp")
# and every rank of the mesh (the world, unless the mesh spans fewer)
_PRECREATED = (COUNT_AXES, GRAD_AXES, AXIS_ORDER)


def _axes_group(mesh, axes: Tuple[str, ...]):
    if not mesh._with_group:
        return None
    present = tuple(a for a in mesh.axis_names if a in axes)
    if not present:
        return None
    if len(present) == 1:
        return mesh.get_group(present[0])
    size = math.prod(mesh.shape[a] for a in present)
    import torch.distributed as dist
    if size == dist.get_world_size():
        return dist.group.WORLD
    if size == 1 or not mesh.member:
        return None
    if present not in mesh._groups:
        raise ValueError(f"no process group over {present} on this mesh: "
                         f"make_mesh creates those of {_PRECREATED}, "
                         "add_axes_groups the others")
    return mesh._groups[present]


def _member_sets(shape: Tuple[int, ...], names: Tuple[str, ...],
                 present: Tuple[str, ...]) -> List[List[int]]:
    """Every set of ranks that differ only along ``present``, each in
    rank order, the sets in the order of their first rank."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    inner = [names.index(a) for a in present]
    outer = [i for i in range(len(names)) if i not in inner]
    ranks = ranks.transpose(outer + inner).reshape(
        -1, math.prod(shape[i] for i in inner))
    return [row.tolist() for row in ranks]


def _create_groups(mesh) -> None:
    """The process groups of the axis sets in ``_PRECREATED``."""
    mesh._groups = {}
    add_axes_groups(mesh, _PRECREATED)


def add_axes_groups(mesh, axis_sets) -> None:
    """Create the process groups of the axis sets in ``axis_sets`` that
    neither one axis's group, the world nor an earlier call covers, for
    ``Mesh.axes_group``.  Collective: every rank of the world calls it
    with the same sets in one order, and creates every set's group
    (``new_group``), the ranks outside a mesh of fewer ranks too.  A
    mesh without a live process group needs none."""
    if not mesh._with_group:
        return
    import torch.distributed as dist
    world = dist.get_world_size()
    for axes in axis_sets:
        present = tuple(a for a in mesh.axis_names if a in axes)
        size = math.prod(mesh.shape[a] for a in present)
        if len(present) < 2 or size in (1, world) or present in mesh._groups:
            continue
        mine = None
        for members in _member_sets(tuple(mesh.shape), mesh.axis_names,
                                    present):
            g = dist.new_group(members)
            if dist.get_rank() in members:
                mine = g
        mesh._groups[present] = mine


@dataclass(frozen=True)
class MeshGroups:
    """What a training step and the model read of a mesh: each axis's
    size and this rank's coordinate, the process group of all its ranks
    (``mesh``), the process groups of ``fsdp``,
    ``tp`` and ``ep`` (the model's), of ``pp`` (the pipeline's) and of
    the two axis sets training reduces over (``COUNT_AXES``,
    ``GRAD_AXES``), and this rank's neighbours along each axis a
    pipeline can stage over (``pp``, ``dcn``); the attention hooks take
    the ``sp`` group from the mesh.  A group is None where no process
    group is live or the axes span one rank (outside a world of one)."""

    sizes: Dict[str, int]
    coords: Dict[str, int]
    grouped: bool
    mesh: Any = None
    fsdp: Any = None
    tp: Any = None
    count: Any = None
    grad: Any = None
    pp: Any = None
    ep: Any = None
    neighbours: Dict[str, Tuple[Optional[int], Optional[int]]] = field(
        default_factory=dict)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def stage_neighbours(self, axis: str = "pp"
                         ) -> Tuple[Optional[int], Optional[int]]:
        """The global ranks of this rank's previous and next stage along
        ``axis`` (None at either end, and for an axis of one)."""
        return self.neighbours.get(axis, (None, None))


STAGE_AXES = ("pp", "dcn")


def _neighbours(mesh, axis: str) -> Tuple[Optional[int], Optional[int]]:
    import torch.distributed as dist
    n, me = mesh.shape[axis], mesh.coordinate(axis)
    group = mesh.get_group(axis)
    return (dist.get_global_rank(group, me - 1) if me > 0 else None,
            dist.get_global_rank(group, me + 1) if me < n - 1 else None)


def mesh_groups(mesh) -> MeshGroups:
    """The one place the port reads a mesh for training: axis sizes,
    this rank's coordinates, the groups and the stage neighbours
    (:class:`MeshGroups`).  No mesh, or one outside a process group,
    gives sizes of 1 and no groups.  A mesh of several devices without
    named axes raises."""
    if mesh is None:
        return MeshGroups({}, {}, False)
    cached = getattr(mesh, "_mesh_groups", None)
    if cached is not None:
        return cached
    shape = getattr(mesh, "shape", None)
    if not hasattr(shape, "items"):
        n = int(getattr(mesh, "size", 1))
        if n > 1:
            raise ValueError(f"a mesh of {n} devices must name its axes "
                             "(parallel.mesh.make_mesh)")
        return MeshGroups({}, {}, False)
    sizes = {a: int(n) for a, n in dict(shape.items()).items()}
    if not getattr(mesh, "member", True):
        raise ValueError(f"this rank is not in the mesh {sizes}: it "
                         "takes no part in its step")
    coord = getattr(mesh, "coordinate", None)
    coords = {a: (coord(a) if coord else 0) for a in sizes}
    grouped = bool(getattr(mesh, "_with_group", False))
    if not grouped:
        if math.prod(sizes.values()) > 1:
            raise ValueError(f"a mesh of {sizes} needs a live process group "
                             "(parallel.mesh.make_mesh inside the workers)")
        return MeshGroups(sizes, coords, False)
    # the model reads this at every layer: kept on the mesh, since
    # looking up its groups costs ~0.5 ms a call on a 4-axis mesh
    mesh._mesh_groups = MeshGroups(sizes, coords, True,
                                   mesh=mesh.axes_group(AXIS_ORDER),
                                   fsdp=mesh.axes_group(("fsdp",)),
                                   tp=mesh.axes_group(("tp",)),
                                   count=mesh.axes_group(COUNT_AXES),
                                   grad=mesh.axes_group(GRAD_AXES),
                                   pp=mesh.axes_group(("pp",)),
                                   ep=mesh.axes_group(("ep",)),
                                   neighbours={
                                       a: _neighbours(mesh, a)
                                       for a in STAGE_AXES
                                       if sizes.get(a, 1) > 1})
    return mesh._mesh_groups


def make_mesh(spec: Optional[MeshSpec] = None, devices=None,
              ranks: Optional[int] = None, **sizes: int):
    """A :class:`Mesh` over the live process group, its axes in
    ``AXIS_ORDER`` order.

    ``make_mesh(fsdp=2, tp=2)``; one axis may be ``-1`` to take the rest
    of the world (``make_mesh(dp=-1)``: every rank data-parallel, a mesh
    of 1 without a group).  The mesh spans the whole world, and rank r
    sits at ``np.arange(world).reshape(shape)``'s coordinate of r, ``tp``
    varying fastest: the reference's device order
    (``ray_tpu/parallel/mesh.py:211``), so rank r holds the shard JAX
    device r holds.  ``devices``: a ``torch.device`` or device type for
    the mesh (default: ``"cuda"`` when the group's backend is NCCL, else
    ``"cpu"``).

    ``ranks``: a mesh over the world's first ``ranks`` ranks only (the
    reference's ``make_mesh(..., devices=devices[:n])``, an elastic
    loop's shrunk mesh).  Creating it is collective over the whole
    world: every rank calls ``make_mesh`` with the same arguments, and
    the ranks left out get a mesh whose ``member`` is False, which they
    must not step on."""
    import torch
    import torch.distributed as dist

    if spec is None:
        if not sizes:
            sizes = {"dp": -1}
        spec = MeshSpec.create(**sizes)
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = world if ranks is None else int(ranks)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh over {n} ranks in a world of {world}")
    spec = spec.resolve(n)
    if spec.size != n:
        span = ("the whole process group" if ranks is None
                else f"the first {n} ranks")
        raise ValueError(f"a mesh spans {span}: {spec.describe()} holds "
                         f"{spec.size} ranks but the world has {world}")
    if devices is None:
        devices = ("cuda" if grouped and dist.get_backend() == "nccl"
                   else "cpu")
    dev_type = torch.device(devices).type if not isinstance(
        devices, (list, tuple)) else torch.device(devices[0]).type
    shape = tuple(s for _, s in spec.axes) or (1,)
    names = spec.axis_names or ("dp",)
    rank_grid = torch.arange(n).reshape(shape)
    cls = _mesh_cls()
    if grouped:
        mesh = cls(dev_type, rank_grid, mesh_dim_names=names)
        rank = dist.get_rank()
    else:
        mesh = cls(dev_type, rank_grid, mesh_dim_names=names,
                   _init_backend=False, _rank=0)
        rank = 0
    mesh._with_group = grouped
    mesh._coords = (tuple(int(c) for c in np.unravel_index(rank, shape))
                    if rank < n else None)
    mesh._groups = {}
    if grouped:
        _create_groups(mesh)
    return mesh


def single_device_mesh(device=None):
    """A mesh of one device outside any process group."""
    import torch
    dev_type = torch.device(device).type if device is not None else "cpu"
    mesh = _mesh_cls()(dev_type, torch.arange(1), mesh_dim_names=("dp",),
                       _init_backend=False, _rank=0)
    mesh._with_group = False
    mesh._coords = (0,)
    mesh._groups = {}
    return mesh


def mesh_axis_size(mesh, axis: str) -> int:
    """``axis``'s size on a live mesh or a :class:`MeshSpec` (1 when
    absent)."""
    if isinstance(mesh, MeshSpec):
        return mesh.to_dict().get(axis, 1)
    return mesh.shape.get(axis, 1) if hasattr(mesh, "shape") else 1


def suggest_accum_steps(batch: int, div: int,
                        prefer: int = 1) -> Optional[int]:
    """The gradient-accumulation factor that would make ``batch`` legal
    on a mesh whose data axes multiply to ``div``: the divisors of
    ``batch // div``, the one closest to ``prefer`` (ties go up), or
    None when ``div`` does not divide ``batch``."""
    if div <= 0 or batch % div:
        return None
    per = batch // div
    legal = [k for k in range(1, per + 1) if per % k == 0]
    return min(legal, key=lambda k: (abs(k - prefer), -k))


def validate_divisibility(mesh, *, batch: Optional[int] = None,
                          seq: Optional[int] = None,
                          d_model: Optional[int] = None,
                          n_heads: Optional[int] = None,
                          accum_steps: int = 1) -> None:
    """Fail fast on shape/axis mismatches, naming the failing axes and,
    for the batch, the ``accum_steps`` that would make the mesh legal."""
    accum_steps = int(accum_steps)
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps} must be >= 1")
    checks = [
        (seq, ("sp",), "sequence length"),
        (n_heads, ("tp",), "attention heads"),
        (d_model, ("tp",), "d_model"),
    ]
    for value, axes, label in checks:
        if value is None:
            continue
        div = math.prod(mesh.shape.get(a, 1) for a in axes)
        if value % div:
            present = ", ".join(
                f"{a}={mesh.shape.get(a, 1)}" for a in axes
                if mesh.shape.get(a, 1) > 1) or "all size 1"
            raise ValueError(
                f"{label}={value} not divisible by mesh axes {axes} "
                f"({present}; product {div})")
    if batch is None:
        return
    axes = ("dcn", "dp", "fsdp")
    div = math.prod(mesh.shape.get(a, 1) for a in axes)
    if batch % (div * accum_steps) == 0:
        return
    present = ", ".join(f"{a}={mesh.shape.get(a, 1)}" for a in axes
                        if mesh.shape.get(a, 1) > 1) or "all size 1"
    suggestion = suggest_accum_steps(batch, div, prefer=accum_steps)
    if suggestion is None:
        hint = (f"no accum_steps can fix this — the data axes "
                f"(product {div}) do not divide the global batch; "
                "change the batch or the mesh")
    else:
        hint = (f"accum_steps={suggestion} would make this mesh "
                f"legal (microbatch {batch // suggestion})")
    raise ValueError(
        f"batch={batch} with accum_steps={accum_steps} not divisible "
        f"by mesh data axes {axes} ({present}; product {div}): each "
        f"microbatch must be whole and shard evenly — {hint}")
