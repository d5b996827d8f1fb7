"""``ray_tpu_torch`` — the PyTorch/CUDA port of ``ray_tpu``.

A second package beside the JAX one, written in PyTorch for NVIDIA
Hopper cards: where ``ray_tpu`` drops to a Pallas kernel for the TPU,
this package has a hand-written CUDA kernel (``ops/csrc``), built with
``nvcc`` on first use.  It imports neither ``jax`` nor ``ray_tpu``; its
tests hold it against the JAX package.

Ported so far: the GPT model (:mod:`ray_tpu_torch.models.gpt`), the
paged-KV inference engine with prefix caching, the int8 KV cache,
speculative decoding, disaggregated KV handoff, the tiered KV cache,
deadlines, telemetry and request tracing (:mod:`ray_tpu_torch.inference`,
:mod:`ray_tpu_torch.quant`, :mod:`ray_tpu_torch.telemetry`,
:mod:`ray_tpu_torch.util`, :mod:`ray_tpu_torch.resilience`), the serving
fleet above the engine (replicas, the prefix-affinity router with
failover and hedging, the reconciler and the disaggregated
prefill/decode pools, :mod:`ray_tpu_torch.fleet`), the
single-device training step (:mod:`ray_tpu_torch.models.training`) and
the ten kernel entry points on those paths (attention forward and
backward, decode attention and its int8 variant, the fused out-proj
epilogue forward and backward, flash-CE forward and backward, RMSNorm
forward and backward).  Entry points run on the card unless the caller
passes ``device="cpu"``.

The package itself carries the runtime (``init``, ``remote``, ``get``,
``put``, ``wait``, actors, the object store and the ``"GPU"`` resource,
:mod:`ray_tpu_torch._private`), the counterpart of ``ray_tpu``'s own
``__init__``.  It imports no torch: the model and engine names above are
loaded on first use, so a worker that runs CPU tasks never imports it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.worker import global_worker, is_initialized
from ray_tpu_torch.actor import (ActorClass, ActorHandle, get_actor, method)
from ray_tpu_torch.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"

_init_lock = threading.RLock()


def init(address: Optional[str] = None,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: str = "default",
         ignore_reinit_error: bool = False,
         _system_config: Optional[Dict[str, Any]] = None,
         **kwargs) -> "RuntimeContext":
    """Start a ray_tpu_torch runtime — or, with ``address``, connect to a
    running one as an additional driver ("auto", a session directory,
    or a control-plane address; parity: ``ray.init(address=...)``).
    ``num_gpus`` defaults to the cards the node has
    (:mod:`ray_tpu_torch.accelerators.gpu`)."""
    if "num_tpus" in kwargs:
        raise TypeError("num_tpus has no meaning in ray_tpu_torch: "
                        "give the node's cards with num_gpus")
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                return get_runtime_context()
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; pass "
                "ignore_reinit_error=True to ignore")
        if address is None:
            # job entrypoints etc. inherit the cluster via env
            # (parity: RAY_ADDRESS)
            address = os.environ.get("RAY_TPU_ADDRESS") or None
        if address is not None:
            if any(v is not None for v in (num_cpus, num_gpus,
                                           resources, _system_config)):
                import warnings
                warnings.warn(
                    "init(address=...) attaches to an existing cluster; "
                    "num_cpus/num_gpus/resources/_system_config are "
                    "ignored (reference parity: ray.init warns too)",
                    stacklevel=2)
            from ray_tpu_torch._private.node import AttachedNode
            node = AttachedNode(address, namespace=namespace)
        else:
            from ray_tpu_torch._private.node import HeadNode
            node = HeadNode(num_cpus=num_cpus, num_gpus=num_gpus,
                            resources=resources, namespace=namespace,
                            system_config=_system_config,
                            session_name=kwargs.pop("session_name",
                                                    None))
        _worker_mod.set_global_worker(node.worker, node)
        return get_runtime_context()


def shutdown() -> None:
    with _init_lock:
        node = _worker_mod.global_node()
        _worker_mod.set_global_worker(None, None)
        if node is not None:
            node.shutdown()
        GLOBAL_CONFIG.reset()


def remote(*args, **kwargs):
    """``@remote`` decorator for functions and classes.

    Usage: ``@ray_tpu_torch.remote`` or ``@ray_tpu_torch.remote(num_cpus=2, ...)``.
    """
    def make(target):
        import inspect
        if inspect.isclass(target):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return make(args[0])
    if args:
        raise TypeError("remote() takes keyword arguments only")
    return make


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    return global_worker().get(refs, timeout=timeout)


def put(value: Any) -> ObjectRef:
    return global_worker().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    return global_worker().wait(refs, num_returns=num_returns,
                                timeout=timeout, fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    global_worker().kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = True) -> None:
    global_worker().cancel_task(ref)


def timeline(filename: Optional[str] = None) -> str:
    """Chrome-trace of task events (parity: ``ray.timeline``): returns
    the JSON string; also writes it to ``filename`` when given."""
    from ray_tpu_torch._private.profiling import timeline as _tl
    return _tl(filename)


def nodes() -> List[Dict[str, Any]]:
    out = []
    for info in global_worker().cp.list_nodes():
        out.append({
            "NodeID": info["node_id"].hex(),
            "Alive": info["state"] == "ALIVE",
            "NodeManagerAddress": info.get("ip", "127.0.0.1"),
            "Resources": info.get("resources_total", {}),
            "Labels": info.get("labels", {}),
        })
    return out


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for info in global_worker().cp.list_nodes():
        if info["state"] != "ALIVE":
            continue
        for k, v in info.get("resources_total", {}).items():
            total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for info in global_worker().cp.list_nodes():
        if info["state"] != "ALIVE":
            continue
        for k, v in info.get("resources_available", {}).items():
            total[k] = total.get(k, 0.0) + v
    return total


class RuntimeContext:
    """Parity: ``python/ray/runtime_context.py``."""

    @property
    def worker(self):
        return global_worker()

    def get_node_id(self) -> str:
        return global_worker().node_id.hex()

    def get_job_id(self) -> str:
        return global_worker().job_id.hex()

    def get_worker_id(self) -> str:
        return global_worker().worker_id.hex()

    def get_actor_id(self) -> Optional[str]:
        aid = global_worker().current_actor_id
        return aid.hex() if aid else None

    def get_task_id(self) -> Optional[str]:
        tid = global_worker().current_task_id
        return tid.hex() if tid else None

    @property
    def namespace(self) -> str:
        return global_worker().namespace

    def get_assigned_resources(self) -> Dict[str, float]:
        return {}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()


def _lazy_submodules():
    return {"serve", "util"}


# the model and engine names, imported on first use: they bring torch,
# and a worker that runs CPU tasks starts without it
_LAZY_NAMES = {
    "GPTConfig": "ray_tpu_torch.models.gpt",
    "init_params": "ray_tpu_torch.models.gpt",
    "InferenceEngine": "ray_tpu_torch.inference",
    "SamplingParams": "ray_tpu_torch.inference",
}


def __getattr__(name: str):
    import importlib
    if name in _LAZY_NAMES:
        value = getattr(importlib.import_module(_LAZY_NAMES[name]), name)
        globals()[name] = value
        return value
    if name in _lazy_submodules():
        mod = importlib.import_module(f"ray_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "nodes", "timeline",
    "cluster_resources",
    "available_resources", "get_runtime_context", "ObjectRef",
    "ObjectRefGenerator", "ActorClass", "ActorHandle", "RemoteFunction",
    "exceptions", "__version__",
    "GPTConfig", "init_params", "InferenceEngine", "SamplingParams",
]
