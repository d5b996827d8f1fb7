# The port's copy of ray_tpu/workflow/__init__.py
"""Durable workflows (parity: ``python/ray/workflow``): every task's
result is persisted; ``resume`` replays completed steps from storage and
re-executes only the rest.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Callable, Dict, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode, FunctionNode
from ray_tpu_torch.workflow.events import (EventListener, FileEventListener,
                                           TimerListener, wait_for_event)

__all__ = [
    "init", "run", "resume", "get_status", "list_all", "delete",
    "EventListener", "TimerListener", "FileEventListener",
    "wait_for_event",
]

_storage_root: Optional[str] = None
_remote_fs = None   # fsspec filesystem when the root is a cloud URI


def init(storage: Optional[str] = None) -> None:
    """Set the durable store.  ``storage`` may be a local directory or
    any fsspec URI (``gs://bucket/wf``, ``s3://...``, ``memory://...``)
    — parity: the reference's cloud workflow storage
    (``python/ray/workflow/workflow_storage.py``)."""
    global _storage_root, _remote_fs
    from ray_tpu_torch.train.storage import is_remote_uri
    _storage_root = storage or os.path.expanduser("~/ray_tpu_torch_workflows")
    if is_remote_uri(_storage_root):
        import fsspec
        _remote_fs, _, _ = fsspec.get_fs_token_paths(_storage_root)
        _remote_fs.makedirs(_fs_path(_storage_root), exist_ok=True)
    else:
        _remote_fs = None
        os.makedirs(_storage_root, exist_ok=True)


def _fs_path(uri: str) -> str:
    """Strip the scheme for fsspec filesystem calls."""
    return uri.split("://", 1)[1] if "://" in uri else uri


def _join(*parts: str) -> str:
    if _remote_fs is not None:
        return "/".join(p.rstrip("/") for p in parts)
    return os.path.join(*parts)


def _exists(path: str) -> bool:
    if _remote_fs is not None:
        return _remote_fs.exists(_fs_path(path))
    return os.path.exists(path)


def _read_bytes(path: str) -> bytes:
    if _remote_fs is not None:
        with _remote_fs.open(_fs_path(path), "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _write_bytes(path: str, data: bytes) -> None:
    """Durable commit: local writes go tmp + atomic rename; remote
    object stores commit atomically on close."""
    if _remote_fs is not None:
        with _remote_fs.open(_fs_path(path), "wb") as f:
            f.write(data)
        return
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _mkdirs(path: str) -> None:
    if _remote_fs is not None:
        _remote_fs.makedirs(_fs_path(path), exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def _listdir(path: str):
    if _remote_fs is not None:
        return [p.rstrip("/").rsplit("/", 1)[-1]
                for p in _remote_fs.ls(_fs_path(path), detail=False)]
    return os.listdir(path)


def _rmtree(path: str) -> None:
    if _remote_fs is not None:
        try:
            _remote_fs.rm(_fs_path(path), recursive=True)
        except FileNotFoundError:
            pass
    else:
        shutil.rmtree(path, ignore_errors=True)


def _store_dir(workflow_id: str) -> str:
    if _storage_root is None:
        init()
    return _join(_storage_root, workflow_id)


def _step_key(node: FunctionNode, resolved_args) -> str:
    name = getattr(node.remote_fn.func, "__qualname__", "step")
    blob = cloudpickle.dumps((name, resolved_args))
    return f"{name.replace('.', '_')}-{hashlib.sha1(blob).hexdigest()[:12]}"


def _run_node(node: Any, wf_dir: str, cache: Dict[int, Any]):
    if not isinstance(node, DAGNode):
        return node
    if id(node) in cache:
        return cache[id(node)]
    if not isinstance(node, FunctionNode):
        raise TypeError("workflows support function DAGs")
    args = [_run_node(a, wf_dir, cache) for a in node.args]
    kwargs = {k: _run_node(v, wf_dir, cache)
              for k, v in node.kwargs.items()}
    key = _step_key(node, (args, kwargs))
    result_path = _join(wf_dir, f"{key}.pkl")
    if _exists(result_path):
        value = cloudpickle.loads(_read_bytes(result_path))
    else:
        value = ray_tpu_torch.get(node.remote_fn.remote(*args, **kwargs),
                                  timeout=600)
        _write_bytes(result_path, cloudpickle.dumps(value))
    cache[id(node)] = value
    return value


def run(dag: FunctionNode, *, workflow_id: str) -> Any:
    """Execute a DAG durably; completed steps are checkpointed."""
    wf_dir = _store_dir(workflow_id)
    _mkdirs(wf_dir)
    _write_bytes(_join(wf_dir, "status.json"),
                 json.dumps({"status": "RUNNING"}).encode())
    try:
        result = _run_node(dag, wf_dir, {})
    except BaseException:
        _write_bytes(_join(wf_dir, "status.json"),
                     json.dumps({"status": "FAILED"}).encode())
        raise
    _write_bytes(_join(wf_dir, "output.pkl"), cloudpickle.dumps(result))
    _write_bytes(_join(wf_dir, "status.json"),
                 json.dumps({"status": "SUCCESSFUL"}).encode())
    return result


def resume(workflow_id: str, dag: Optional[FunctionNode] = None) -> Any:
    """Resume: replay persisted steps, run the rest (dag required unless
    the workflow finished, in which case the stored output is returned)."""
    wf_dir = _store_dir(workflow_id)
    out_path = _join(wf_dir, "output.pkl")
    if _exists(out_path):
        return cloudpickle.loads(_read_bytes(out_path))
    if dag is None:
        raise ValueError(
            f"workflow {workflow_id!r} is incomplete; pass its dag to "
            "resume execution")
    return run(dag, workflow_id=workflow_id)


def get_status(workflow_id: str) -> str:
    path = _join(_store_dir(workflow_id), "status.json")
    if not _exists(path):
        return "NOT_FOUND"
    return json.loads(_read_bytes(path))["status"]


def list_all() -> Dict[str, str]:
    if _storage_root is None:
        init()
    out = {}
    for wf in _listdir(_storage_root):
        out[wf] = get_status(wf)
    return out


def delete(workflow_id: str) -> None:
    _rmtree(_store_dir(workflow_id))
