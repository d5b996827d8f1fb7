"""Checkpoint — a directory of files plus metadata.

Counterpart of ``ray_tpu/train/checkpoint.py`` (parity: the reference's
``python/ray/train/_checkpoint.py``: from_directory / to_directory /
as_directory, from_dict / to_dict, metadata, persist).  Storage is a
local path or any fsspec URI (:mod:`.storage`).

:func:`save_pytree` / :func:`load_pytree` keep a tree of torch tensors
(dicts, lists, tuples, NamedTuples and dataclasses such as a
``TrainState``; bf16 leaves included) as one ``torch.save`` file,
``<name>.pt``, with every tensor moved to the host.  :func:`load_pytree`
also reads the JAX package's npz checkpoints (``<name>.npz`` and its
``<name>.treedef.pkl``, ``ray_tpu/train/checkpoint.py:save_pytree``'s
fallback writer) and its orbax directories (``<name>/``, what it writes
where ``orbax.checkpoint`` imports: the tree's key paths in
``_METADATA``, each array a zarr array in an OCDBT key-value store)
without importing JAX or orbax: the arrays are read through
``tensorstore``, which is imported only when such a directory is read.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Optional

_METADATA_FILE = ".metadata.json"


class Checkpoint:
    def __init__(self, path: str):
        from ray_tpu_torch.train.storage import is_remote_uri
        self._remote = is_remote_uri(path)
        self.path = path if self._remote else os.path.abspath(path)

    def _local(self) -> str:
        """A local directory with this checkpoint's contents (a remote
        checkpoint is downloaded into a temp dir once per process)."""
        if not self._remote:
            return self.path
        if getattr(self, "_local_cache", None) is None:
            from ray_tpu_torch.train.storage import download_dir
            self._local_cache = download_dir(
                self.path, tempfile.mkdtemp(prefix="rtpu_ckpt_dl_"))
        return self._local_cache

    # ------------------------------------------------------------ builders
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        """For small state dicts (pickled into the directory)."""
        import cloudpickle
        path = tempfile.mkdtemp(prefix="rtpu_ckpt_")
        with open(os.path.join(path, "dict_checkpoint.pkl"), "wb") as f:
            cloudpickle.dump(data, f)
        return cls(path)

    def to_dict(self) -> Dict[str, Any]:
        import cloudpickle
        with open(os.path.join(self._local(), "dict_checkpoint.pkl"),
                  "rb") as f:
            return cloudpickle.load(f)

    # ------------------------------------------------------------ metadata
    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        # tmp + rename: a crash mid-write must not leave a torn file
        target = os.path.join(self.path, _METADATA_FILE)
        tmp = target + ".tmp"
        with open(tmp, "w") as f:
            json.dump(metadata, f)
        os.replace(tmp, target)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self._local(), _METADATA_FILE)
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    # ------------------------------------------------------------ movement
    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        os.makedirs(dest, exist_ok=True)
        local = self._local()
        for name in os.listdir(local):
            src = os.path.join(local, name)
            dst = os.path.join(dest, name)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
        return dest

    @contextmanager
    def as_directory(self):
        yield self._local()

    def persist(self, storage_dir: str, name: Optional[str] = None) -> \
            "Checkpoint":
        """Copy into durable storage (a local path or any fsspec URI);
        returns the persisted checkpoint."""
        from ray_tpu_torch.train.storage import is_remote_uri, upload_dir
        name = name or f"checkpoint_{uuid.uuid4().hex[:8]}"
        if is_remote_uri(storage_dir):
            dest = f"{storage_dir.rstrip('/')}/{name}"
            upload_dir(self._local(), dest)
            return Checkpoint(dest)
        dest = os.path.join(storage_dir, name)
        os.makedirs(storage_dir, exist_ok=True)
        if os.path.abspath(self.path) == os.path.abspath(dest):
            return self
        self.to_directory(dest)
        return Checkpoint(dest)

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


# ---------------------------------------------------------------- pytrees
def map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor (structure kept:
    dicts, lists, tuples, NamedTuples, dataclasses)."""
    import dataclasses

    import torch
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(v, fn)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _to_host(tree):
    """``tree`` with every tensor on the host (structure kept)."""
    return map_tensors(tree, lambda t: t.detach().cpu())


def save_pytree(tree, path: str, *, name: str = "state") -> None:
    """Save a tree of torch tensors as ``<path>/<name>.pt`` (written to
    a temp name, then renamed)."""
    import torch
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"{name}.pt")
    tmp = target + ".tmp"
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, target)


# PyTreeKind of the JAX package's pickled treedefs
_LEAF, _NONE, _TUPLE, _NAMEDTUPLE, _LIST, _DICT = range(6)

# the fields of the NamedTuple node types a JAX-package train state
# holds (its TrainState and optax's states); another type's fields are
# numbered
_FOREIGN_FIELDS = {
    "ray_tpu.models.training.TrainState": ("params", "opt_state", "step"),
    "optax._src.base.EmptyState": (),
    "optax._src.transform.ScaleByAdamState": ("count", "mu", "nu"),
    "optax._src.transform.ScaleByScheduleState": ("count",),
}
_FOREIGN_TYPES: Dict[str, Any] = {}


class _Foreign(str):
    """The qualified name of a node type of the JAX package or its
    libraries, in place of the type: the port imports neither."""


def _foreign_type(key: str, arity: int):
    """A NamedTuple standing in for the node type ``key`` (its fields
    from ``_FOREIGN_FIELDS``); the JAX package's ``TrainState`` is the
    port's."""
    if key == "ray_tpu.models.training.TrainState":
        from ray_tpu_torch.models.training import TrainState
        return TrainState
    cls = _FOREIGN_TYPES.get(key)
    if cls is None:
        import collections
        fields = _FOREIGN_FIELDS.get(key,
                                     tuple(f"f{i}" for i in range(arity)))
        cls = _FOREIGN_TYPES[key] = collections.namedtuple(
            key.rsplit(".", 1)[1], fields)
    return cls


class _TreeDef:
    """A pickled ``jaxlib`` ``PyTreeDef``, read without JAX: its state is
    (registry, nodes), the nodes in post-order, each ``(kind, arity,
    node_data, custom, num_leaves, num_nodes)``."""

    def __setstate__(self, state):
        self.nodes = state[1]

    def unflatten(self, leaves):
        it = iter(leaves)
        stack: list = []
        for kind, arity, data, *_ in self.nodes:
            children = stack[len(stack) - arity:] if arity else []
            del stack[len(stack) - len(children):]
            if kind == _LEAF:
                stack.append(next(it))
            elif kind == _NONE:
                stack.append(None)
            elif kind == _TUPLE:
                stack.append(tuple(children))
            elif kind == _LIST:
                stack.append(list(children))
            elif kind == _DICT:
                stack.append(dict(zip(data, children)))
            elif kind == _NAMEDTUPLE:
                cls = (_foreign_type(data, arity)
                       if isinstance(data, _Foreign) else data)
                stack.append(cls(*children))
            else:
                raise ValueError(f"treedef node kind {kind} (a custom or "
                                 "dataclass pytree node) is not readable "
                                 "without JAX")
        if len(stack) != 1:
            raise ValueError(f"malformed treedef: {len(stack)} roots")
        return stack[0]


def _treedef_unpickler(f):
    import pickle

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            top = module.split(".")[0]
            if top in ("jax", "jaxlib"):
                return _TreeDef if name == "PyTreeDef" else object
            if top in ("ray_tpu", "optax", "flax"):
                return _Foreign(f"{module}.{name}")
            return super().find_class(module, name)

    return Unpickler(f)


# ml_dtypes leaves, written as raw bytes (save_pytree's ``exotic``):
# the ones torch has, under the same names
_EXOTIC_DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _load_jax_npz(path: str, name: str, map_location):
    """The JAX package's npz checkpoint as a tree of torch tensors."""
    import numpy as np
    import torch
    data = np.load(os.path.join(path, f"{name}.npz"))
    with open(os.path.join(path, f"{name}.treedef.pkl"), "rb") as f:
        saved = _treedef_unpickler(f).load()
    if isinstance(saved, dict):
        treedef, exotic = saved["treedef"], saved.get("exotic", {})
    else:                    # the reference's older files: a bare treedef
        treedef, exotic = saved, {}
    leaves = []
    for i in range(len(data.files)):
        arr = data[str(i)]       # (ascontiguousarray makes 0-d 1-d)
        if str(i) in exotic:
            dtype, shape = exotic[str(i)]
            if dtype not in _EXOTIC_DTYPES:
                raise ValueError(f"leaf {i} of dtype {dtype} has no torch "
                                 "counterpart")
            t = torch.from_numpy(arr.copy()).view(
                getattr(torch, dtype)).reshape(shape)
        else:
            t = torch.from_numpy(arr.copy())
        leaves.append(t.to(map_location))
    return treedef.unflatten(leaves)


# orbax's key kinds in ``_METADATA``'s ``key_metadata``
_SEQUENCE_KEY, _DICT_KEY = 1, 2


def _np_to_tensor(arr):
    """A numpy array (tensorstore's read) -> tensor; bf16 and fp8 through
    a same-width integer view, bit for bit."""
    import numpy as np
    import torch
    arr = np.ascontiguousarray(arr) if arr.ndim else np.asarray(arr)
    name = arr.dtype.name
    if name in _EXOTIC_DTYPES:
        bits = np.int16 if arr.dtype.itemsize == 2 else np.uint8
        return torch.from_numpy(arr.view(bits).copy()).view(
            getattr(torch, name))
    if arr.dtype.kind == "V":
        raise ValueError(f"array of dtype {name} has no torch counterpart")
    return torch.from_numpy(arr.copy())


def _orbax_leaves(directory: str):
    """[(key path, tensor or None)] of an orbax ``StandardCheckpointer``
    directory, in ``_METADATA``'s order: sequence keys as ints, dict keys
    as strings; a value orbax skips (``None``, an empty state) is
    None."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise NotImplementedError(
            f"{directory} is a JAX-package orbax checkpoint; reading it "
            "needs the tensorstore library, which does not import in this "
            f"environment ({e})") from e
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{directory}: zarr3 arrays are not read "
                                  "(the reference writes zarr v2)")
    root = os.path.abspath(directory)
    kvstore = ({"driver": "ocdbt", "base": f"file://{root}/"}
               if meta.get("use_ocdbt", True)
               else {"driver": "file", "path": root + "/"})
    out = []
    for node in meta["tree_metadata"].values():
        keys = node["key_metadata"]
        path = tuple(int(k["key"]) if k["key_type"] == _SEQUENCE_KEY
                     else k["key"] for k in keys)
        value = node["value_metadata"]
        if value.get("skip_deserialize") or value["value_type"] == "None":
            out.append((path, None))
            continue
        arr = ts.open({"driver": "zarr", "kvstore": kvstore,
                       "path": ".".join(k["key"] for k in keys)},
                      open=True).result().read().result()
        out.append((path, _np_to_tensor(arr)))
    return out


def _nest(leaves):
    """The nested dicts and lists that ``leaves``' key paths describe
    (what orbax restores with no target)."""
    def build(items):
        if len(items) == 1 and items[0][0] == ():
            return items[0][1]
        groups: Dict[Any, list] = {}
        for path, leaf in items:
            groups.setdefault(path[0], []).append((path[1:], leaf))
        if all(isinstance(k, int) for k in groups):
            return [build(groups[i]) for i in sorted(groups)]
        return {k: build(v) for k, v in groups.items()}

    return build(list(leaves))


def _place(target, leaves, map_location):
    """``target``'s structure (dicts, lists, tuples, NamedTuples and
    dataclasses) with each leaf taken from ``leaves`` by key path, in
    the target's dtype (a Python number as its type).  One mismatch is
    bridged, an optax chain's state tuple against the port's flat
    optimizer state: a NamedTuple or dataclass whose fields the
    checkpoint lacks at its path takes them from the chain's first state
    under it (a path of sequence keys) that has every field (Adam's
    ``count``/``mu``/``nu`` before a schedule's ``count``).  Any other
    path the checkpoint lacks, or a leaf of another shape, raises."""
    import dataclasses

    import torch
    exact = dict(leaves)
    prefixes = {path[:i] for path in exact for i in range(len(path) + 1)}

    def chain_state(path, fields):
        """The first ``path + q`` (q of sequence keys) holding every one
        of ``fields``, or None."""
        for full in exact:
            if full[:len(path)] != path:
                continue
            q = []
            for k in full[len(path):]:
                if not isinstance(k, int):
                    break
                q.append(k)
            base = path + tuple(q)
            if q and all(base + (f,) in prefixes for f in fields):
                return base
        return None

    def leaf_at(path, want):
        if path not in exact:
            raise KeyError(f"checkpoint has no leaf for the target's path "
                           f"{path}")
        got = exact[path]
        if want is None or got is None:
            return got
        if isinstance(want, (bool, int, float)):
            if got.numel() != 1:
                raise ValueError(f"{path}: checkpoint leaf of shape "
                                 f"{tuple(got.shape)} for a scalar")
            return type(want)(got.item())
        if isinstance(want, torch.Tensor) and got.shape != want.shape:
            raise ValueError(f"{path}: checkpoint leaf of shape "
                             f"{tuple(got.shape)}, target "
                             f"{tuple(want.shape)}")
        if isinstance(want, torch.Tensor):
            return got.to(device=map_location, dtype=want.dtype)
        return got.to(map_location)

    def record(node, path, fields, make):
        if not all(path + (f,) in prefixes for f in fields):
            path = chain_state(path, fields) or path
        return make({f: build(getattr(node, f), path + (f,))
                     for f in fields})

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return record(node, path, node._fields,
                          lambda kw: type(node)(**kw))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return record(node, path,
                          [f.name for f in dataclasses.fields(node)],
                          lambda kw: type(node)(**kw))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (i,))
                              for i, v in enumerate(node))
        return leaf_at(path, node)

    return build(target, ())


def load_pytree(path: str, *, name: str = "state", target=None,
                map_location="cpu"):
    """Load a tree saved by :func:`save_pytree`, its tensors on
    ``map_location``.  ``target`` (an example tree) shapes a JAX-package
    orbax checkpoint (below); the port's own file and an npz checkpoint
    carry their own structure.

    A JAX-package npz checkpoint (``<name>.npz`` + ``<name>.treedef.pkl``)
    loads as the same tree of torch tensors: dicts, lists, tuples, its
    ``TrainState`` as the port's, optax's states as NamedTuples of the
    same names and fields; bf16 and fp8 leaves keep their bits.  A
    JAX-package orbax directory (``<name>/``) loads, with no ``target``,
    as the nested dicts and lists that orbax restores (a ``TrainState``
    as a dict, optax's chain as lists, an empty state as None); with
    ``target`` (a port tree, e.g. the port's ``TrainState``), as
    ``target``'s structure with each leaf taken by key path
    (:func:`_place`).  Reading orbax needs ``tensorstore``; where it
    does not import, this raises ``NotImplementedError`` naming it."""
    import torch
    pt = os.path.join(path, f"{name}.pt")
    if not os.path.exists(pt):
        if os.path.exists(os.path.join(path, f"{name}.npz")):
            return _load_jax_npz(path, name, map_location)
        orbax_dir = os.path.join(path, name)
        if os.path.isdir(orbax_dir):
            leaves = _orbax_leaves(orbax_dir)
            if target is not None:
                return _place(target, leaves, map_location)
            return _nest([(p, None if t is None else t.to(map_location))
                          for p, t in leaves])
        raise FileNotFoundError(pt)
    # the file is this package's own (save_pytree): its NamedTuples and
    # dataclasses are unpickled as written
    return torch.load(pt, map_location=map_location, weights_only=False)
