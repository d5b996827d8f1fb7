# The port's copy of ray_tpu/actor.py
"""``@ray_tpu_torch.remote`` classes — actors.

Parity target: ``python/ray/actor.py`` (ActorClass / ActorHandle /
ActorMethod): ``Cls.remote(...)`` creates the actor,
``handle.method.remote(...)`` submits ordered method calls,
``.options(name=..., max_restarts=..., max_concurrency=..., ...)``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private.task_spec import normalize_resources
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.remote_function import (_apply_pg_resources,
                                           normalize_strategy)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, **opts) -> "ActorMethod":
        m = ActorMethod(self._handle, self._name,
                        opts.get("num_returns", self._num_returns))
        return m

    def remote(self, *args, **kwargs):
        worker = global_worker()
        return worker.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            {"num_returns": self._num_returns,
             # class-level retry policy applies to every method call
             # (ray parity: Actor.options(max_task_retries=...))
             "max_task_retries": self._handle._max_task_retries})

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._name}' cannot be called directly; "
            "use .remote().")


class ActorHandle:
    def __init__(self, actor_id: bytes, class_name: str = "Actor",
                 method_num_returns: Optional[Dict[str, int]] = None,
                 max_task_retries: int = 0):
        object.__setattr__(self, "_actor_id", actor_id)
        object.__setattr__(self, "_class_name", class_name)
        object.__setattr__(self, "_method_num_returns",
                           method_num_returns or {})
        object.__setattr__(self, "_max_task_retries", max_task_retries)

    def __getattr__(self, name: str) -> ActorMethod:
        # __ray_call__ runs an arbitrary fn against the actor instance;
        # other dunder/private names are real attribute errors.
        if name.startswith("_") and name != "__ray_call__":
            raise AttributeError(name)
        return ActorMethod(self, name,
                           self._method_num_returns.get(name, 1))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name,
                              self._method_num_returns,
                              self._max_task_retries))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return (isinstance(other, ActorHandle)
                and other._actor_id == self._actor_id)

    def _exit(self):
        """Graceful termination: queued calls run first (ray __ray_terminate__)."""
        return ActorMethod(self, "__ray_terminate__").remote()


class ActorClass:
    def __init__(self, cls, **default_opts):
        self._cls = cls
        self._default_opts = default_opts
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated "
            "directly; use .remote().")

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._default_opts)
        merged.update(opts)
        return ActorClass(self._cls, **merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._default_opts)

    def _remote(self, args, kwargs, opts: Dict[str, Any]) -> ActorHandle:
        worker = global_worker()
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        resources = normalize_resources(
            opts.get("num_cpus"), opts.get("num_gpus"),
            opts.get("resources"), opts.get("memory"),
            default_cpus=0.0 if opts.get("num_cpus") is None else None,
            num_tpus=opts.get("num_tpus"))
        strategy = normalize_strategy(opts.get("scheduling_strategy"))
        resources = _apply_pg_resources(resources, strategy)
        max_restarts = opts.get("max_restarts")
        if max_restarts is None:
            max_restarts = GLOBAL_CONFIG.actor_default_max_restarts
        create_opts = {
            "resources": resources,
            "scheduling_strategy": strategy,
            "name": opts.get("name"),
            "namespace": opts.get("namespace", worker.namespace),
            "lifetime": opts.get("lifetime"),
            "max_restarts": max_restarts,
            "max_task_retries": opts.get("max_task_retries", 0),
            "max_concurrency": opts.get("max_concurrency", 1),
            "runtime_env": opts.get("runtime_env"),
        }
        num_returns = {
            n: getattr(m, "_num_returns")
            for n, m in vars(self._cls).items()
            if hasattr(m, "_num_returns")}
        create_opts["method_num_returns"] = num_returns
        actor_id = worker.create_actor(self._cls, args, kwargs, create_opts)
        return ActorHandle(actor_id, self._cls.__name__, num_returns,
                           opts.get("max_task_retries", 0))

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode
        return ClassNode(self, args, kwargs)


def method(*, num_returns: int = 1):
    """``@ray_tpu_torch.method(num_returns=N)`` decorator for actor methods."""
    def decorator(fn):
        fn._num_returns = num_returns
        return fn
    return decorator


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    worker = global_worker()
    actor_id = worker.cp.resolve_named_actor(name, namespace)
    if actor_id is None:
        raise ValueError(
            f"Failed to look up actor '{name}' in namespace '{namespace}'")
    info = worker.cp.get_actor_info(actor_id) or {}
    return ActorHandle(actor_id, info.get("class_name", "Actor"),
                       info.get("method_num_returns") or {},
                       max_task_retries=info.get("max_task_retries", 0))
