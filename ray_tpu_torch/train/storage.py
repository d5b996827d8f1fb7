"""Remote storage for checkpoints and experiment state.

The port's copy of ``ray_tpu/train/storage.py`` (parity: the
reference's ``python/ray/train/_internal/storage.py``): ``storage_path``
may be a URI such as ``gs://bucket/exp`` or ``s3://...``; anything
fsspec can mount works, and ``memory://`` exercises the same path in
tests.  ``fsspec`` is imported only for a remote URI, so local paths
need nothing beyond the standard library.
"""

from __future__ import annotations

import os
from typing import Tuple


def is_remote_uri(path: str) -> bool:
    return "://" in path and not path.startswith("file://")


def _fs_and_path(uri: str) -> Tuple[object, str]:
    import fsspec
    fs, _, paths = fsspec.get_fs_token_paths(uri)
    return fs, paths[0]


def upload_dir(local_dir: str, dest_uri: str) -> None:
    """Recursively upload a local directory to a remote URI."""
    fs, dest = _fs_and_path(dest_uri)
    fs.makedirs(dest, exist_ok=True)
    for root, _, files in os.walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        for name in files:
            remote = (f"{dest}/{name}" if rel == "."
                      else f"{dest}/{rel}/{name}")
            fs.makedirs(remote.rsplit("/", 1)[0], exist_ok=True)
            fs.put_file(os.path.join(root, name), remote)


def download_dir(src_uri: str, local_dir: str) -> str:
    """Recursively download a remote URI into a local directory."""
    fs, src = _fs_and_path(src_uri)
    os.makedirs(local_dir, exist_ok=True)
    src = src.rstrip("/")
    for remote in fs.find(src):
        rel = remote[len(src):].lstrip("/")
        local = os.path.join(local_dir, rel)
        os.makedirs(os.path.dirname(local) or local_dir, exist_ok=True)
        fs.get_file(remote, local)
    return local_dir


def delete_uri(uri: str) -> None:
    fs, path = _fs_and_path(uri)
    try:
        fs.rm(path, recursive=True)
    except FileNotFoundError:
        pass


def list_uri(uri: str):
    fs, path = _fs_and_path(uri)
    try:
        return [p.rsplit("/", 1)[-1] for p in fs.ls(path, detail=False)]
    except FileNotFoundError:
        return []
