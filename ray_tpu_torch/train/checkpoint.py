"""Checkpoint — a directory of files plus metadata.

Counterpart of ``ray_tpu/train/checkpoint.py`` (parity: the reference's
``python/ray/train/_checkpoint.py``: from_directory / to_directory /
as_directory, from_dict / to_dict, metadata, persist).  Storage is a
local path or any fsspec URI (:mod:`.storage`).

:func:`save_pytree` / :func:`load_pytree` keep a tree of torch tensors
(dicts, lists, tuples, NamedTuples and dataclasses such as a
``TrainState``; bf16 leaves included) as one ``torch.save`` file,
``<name>.pt``, with every tensor moved to the host.  Reading the JAX
package's npz and orbax checkpoints is ROADMAP Queue 1 item 10 and
raises.
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
def _to_host(tree):
    """``tree`` with every tensor on the host (structure kept)."""
    import dataclasses

    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to_host(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def save_pytree(tree, path: str, *, name: str = "state") -> None:
    """Save a tree of torch tensors as ``<path>/<name>.pt`` (written to
    a temp name, then renamed)."""
    import torch
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"{name}.pt")
    tmp = target + ".tmp"
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, target)


def load_pytree(path: str, *, name: str = "state", target=None,
                map_location="cpu"):
    """Load a tree saved by :func:`save_pytree`, its tensors on
    ``map_location``.  ``target`` (an example tree) is accepted for the
    JAX package's signature; the file carries its own structure."""
    import torch
    pt = os.path.join(path, f"{name}.pt")
    if not os.path.exists(pt):
        if (os.path.exists(os.path.join(path, f"{name}.npz"))
                or os.path.isdir(os.path.join(path, name))):
            raise NotImplementedError(
                f"{path} holds a JAX-package checkpoint ({name}.npz or an "
                "orbax directory); reading those is not ported yet "
                "(ROADMAP Queue 1 item 10)")
        raise FileNotFoundError(pt)
    # the file is this package's own (save_pytree): its NamedTuples and
    # dataclasses are unpickled as written
    return torch.load(pt, map_location=map_location, weights_only=False)
