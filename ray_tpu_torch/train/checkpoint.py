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
fallback writer) without importing JAX; reading its orbax directories
is ROADMAP Queue 1 item 10b and raises.
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


def load_pytree(path: str, *, name: str = "state", target=None,
                map_location="cpu"):
    """Load a tree saved by :func:`save_pytree`, its tensors on
    ``map_location``.  ``target`` (an example tree) is accepted for the
    JAX package's signature; the file carries its own structure.

    A JAX-package npz checkpoint (``<name>.npz`` + ``<name>.treedef.pkl``)
    loads as the same tree of torch tensors: dicts, lists, tuples, its
    ``TrainState`` as the port's, optax's states as NamedTuples of the
    same names and fields; bf16 and fp8 leaves keep their bits.  An
    orbax directory raises (item 10b)."""
    import torch
    pt = os.path.join(path, f"{name}.pt")
    if not os.path.exists(pt):
        if os.path.exists(os.path.join(path, f"{name}.npz")):
            return _load_jax_npz(path, name, map_location)
        if os.path.isdir(os.path.join(path, name)):
            raise NotImplementedError(
                f"{path} holds a JAX-package orbax checkpoint ({name}/); "
                "reading orbax directories is not ported yet (ROADMAP "
                "Queue 1 item 10b: the card has no orbax)")
        raise FileNotFoundError(pt)
    # the file is this package's own (save_pytree): its NamedTuples and
    # dataclasses are unpickled as written
    return torch.load(pt, map_location=map_location, weights_only=False)
