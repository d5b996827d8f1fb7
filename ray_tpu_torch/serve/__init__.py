# The port's copy of ray_tpu/serve/__init__.py
"""``ray_tpu_torch.serve`` — model serving (parity: ``ray.serve``).

``@serve.deployment`` → ``.bind(...)`` → ``serve.run(app)`` → handle or
HTTP.  Controller actor reconciles replica actors; handles route with
power-of-two-choices; an aiohttp proxy serves HTTP.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve._private.controller import (CONTROLLER_NAME,
                                                     ServeController)
from ray_tpu_torch.serve._private.replica import StreamStalledError
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    ray_actor_options: Optional[Dict[str, Any]] = None
    max_ongoing_requests: int = 8
    user_config: Optional[Dict[str, Any]] = None
    # {min_replicas, max_replicas, target_ongoing_requests,
    #  upscale_delay_s, downscale_delay_s} — queue-depth autoscaling
    # (parity: serve/_private/autoscaling_policy.py)
    autoscaling_config: Optional[Dict[str, Any]] = None

    def options(self, **kwargs) -> "Deployment":
        import dataclasses
        return dataclasses.replace(self, **kwargs)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


class Application:
    def __init__(self, deployment: Deployment, args: Tuple,
                 kwargs: Dict[str, Any]):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


def deployment(func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               ray_actor_options: Optional[Dict] = None,
               max_ongoing_requests: int = 8,
               user_config: Optional[Dict] = None,
               autoscaling_config: Optional[Dict] = None, **ignored):
    """``@serve.deployment`` decorator (parity: serve/api.py:244)."""
    def wrap(target):
        return Deployment(
            target, name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            autoscaling_config=autoscaling_config)

    if func_or_class is not None:
        return wrap(func_or_class)
    return wrap


def ingress(asgi_app) -> Callable:
    """``@serve.ingress(app)`` — route HTTP through an ASGI application
    (parity: ``serve/api.py:168`` with FastAPI; here ANY ASGI callable
    works, FastAPI included, so the framework carries no FastAPI pin).

    The decorated deployment's replicas run one ASGI request cycle per
    HTTP request forwarded by the proxy: full path/query/header fidelity,
    the app's own routing, middleware and status codes — instead of the
    proxy's default JSON convention.

    ``asgi_app`` may be the ASGI callable itself or a zero-arg factory
    (use a factory when the app isn't picklable)."""
    def wrap(cls):
        if not isinstance(cls, type):
            raise TypeError("@serve.ingress decorates a deployment class")

        async def __serve_asgi__(self, scope: Dict[str, Any],
                                 body: bytes):
            app = getattr(self, "_serve_asgi_app", None)
            if app is None:
                app = asgi_app
                # zero-arg factory vs ASGI callable (3 params)
                import inspect as _inspect
                try:
                    if len(_inspect.signature(app).parameters) == 0:
                        app = app()
                except (TypeError, ValueError):
                    pass
                self._serve_asgi_app = app
            scope = dict(scope)
            scope["headers"] = [(k.encode() if isinstance(k, str) else k,
                                 v.encode() if isinstance(v, str) else v)
                                for k, v in scope.get("headers", [])]
            sent = {"status": 500, "headers": [], "chunks": []}
            got_body = {"done": False}

            async def receive():
                if got_body["done"]:
                    return {"type": "http.disconnect"}
                got_body["done"] = True
                return {"type": "http.request", "body": body or b"",
                        "more_body": False}

            async def send(message):
                if message["type"] == "http.response.start":
                    sent["status"] = message["status"]
                    sent["headers"] = [
                        (k.decode() if isinstance(k, bytes) else k,
                         v.decode() if isinstance(v, bytes) else v)
                        for k, v in message.get("headers", [])]
                elif message["type"] == "http.response.body":
                    sent["chunks"].append(message.get("body", b""))

            await app(scope, receive, send)
            return {"status": sent["status"], "headers": sent["headers"],
                    "body": b"".join(sent["chunks"])}

        cls.__serve_asgi__ = __serve_asgi__
        cls.__serve_is_asgi__ = True
        return cls

    return wrap


# ------------------------------------------------------------------ run
def _get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        try:
            return ServeController.options(
                name=CONTROLLER_NAME, lifetime="detached",
                max_concurrency=16).remote()
        except ValueError:
            return ray_tpu_torch.get_actor(CONTROLLER_NAME)


def _collect_deployments(app: Application, app_name: str,
                         out: List[Dict[str, Any]]) -> str:
    """DFS the bind graph; nested Applications become handles."""
    dep = app.deployment

    def resolve(value):
        if isinstance(value, Application):
            child_name = _collect_deployments(value, app_name, out)
            return DeploymentHandle(app_name, child_name)
        return value

    args = tuple(resolve(a) for a in app.args)
    kwargs = {k: resolve(v) for k, v in app.kwargs.items()}
    if not any(d["name"] == dep.name for d in out):
        out.append({
            "name": dep.name,
            "cls_blob": cloudpickle.dumps(dep.func_or_class),
            "init_args": args,
            "init_kwargs": kwargs,
            "num_replicas": dep.num_replicas,
            "actor_options": dep.ray_actor_options,
            "max_ongoing": dep.max_ongoing_requests,
            "user_config": dep.user_config,
            "autoscaling_config": dep.autoscaling_config,
            "asgi": bool(getattr(dep.func_or_class,
                                 "__serve_is_asgi__", False)),
        })
    return dep.name


def run(app: Application, *, name: str = "default",
        route_prefix: str = "/", blocking: bool = False,
        http_port: Optional[int] = None,
        http_host: str = "127.0.0.1",
        grpc_port: Optional[int] = None) -> DeploymentHandle:
    """Deploy ``app``; proxies bind loopback unless ``http_host`` opts
    into a routable interface (e.g. ``"0.0.0.0"``)."""
    controller = _get_or_create_controller()
    deployments: List[Dict[str, Any]] = []
    ingress = _collect_deployments(app, name, deployments)
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, deployments, ingress), timeout=300)
    if http_port is not None:
        start_http_proxy(http_port, http_host)
    if grpc_port is not None:
        start_grpc_proxy(grpc_port, http_host)
    return DeploymentHandle(name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(name)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(app_name, deployment_name)


def status() -> Dict[str, Any]:
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.list_applications.remote(), timeout=30)


def delete(name: str) -> None:
    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name), timeout=60)


def shutdown() -> None:
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    apps = ray_tpu_torch.get(controller.list_applications.remote(), timeout=30)
    for app in list(apps):
        ray_tpu_torch.get(controller.delete_application.remote(app),
                          timeout=60)
    proxy = ray_tpu_torch.get(controller.get_proxy.remote(), timeout=10)
    if proxy is not None:
        ray_tpu_torch.kill(proxy)
    grpc_proxy = ray_tpu_torch.get(controller.get_grpc_proxy.remote(),
                                   timeout=10)
    if grpc_proxy is not None:
        ray_tpu_torch.kill(grpc_proxy)
    ray_tpu_torch.kill(ray_tpu_torch.get_actor(CONTROLLER_NAME))


# ------------------------------------------------------------- ingress
def start_http_proxy(port: int = 8000, host: str = "127.0.0.1"):
    from ray_tpu_torch.serve._private.proxy import HTTPProxy
    controller = _get_or_create_controller()
    existing = ray_tpu_torch.get(controller.get_proxy.remote(), timeout=10)
    if existing is not None:
        return existing
    proxy = HTTPProxy.options(max_concurrency=64).remote(port, host)
    ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    ray_tpu_torch.get(controller.set_proxy.remote(proxy), timeout=10)
    return proxy


def start_grpc_proxy(port: int = 9000, host: str = "127.0.0.1"):
    """gRPC ingress on ``/ray_tpu_torch.serve.GenericService/Predict`` (unary)
    and ``PredictStreaming`` (server-streaming); app picked by the
    ``application`` metadata key."""
    from ray_tpu_torch.serve._private.proxy import GRPCProxy
    controller = _get_or_create_controller()
    existing = ray_tpu_torch.get(controller.get_grpc_proxy.remote(),
                                 timeout=10)
    if existing is not None:
        return existing
    proxy = GRPCProxy.options(max_concurrency=64).remote(port, host)
    bound = ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    ray_tpu_torch.get(controller.set_grpc_proxy.remote(proxy, bound),
                      timeout=10)
    return proxy


# --------------------------------------------------------- multiplexing
def multiplexed(_func=None, *, max_num_models_per_replica: int = 3):
    """``@serve.multiplexed`` — per-replica LRU of loaded model
    versions (parity: ``serve/api.py`` multiplexed + model
    multiplexing): decorate an async ``load_model(self, model_id)``;
    calls hit the cache, misses load and evict least-recently-used.
    Route requests with ``handle.options(multiplexed_model_id=...)``
    and read the id inside with ``get_multiplexed_model_id()``.
    """
    import collections
    import functools

    def wrap(fn):
        @functools.wraps(fn)
        async def wrapper(self, model_id: str):
            import asyncio
            import inspect as _inspect
            cache = getattr(self, "_mux_models", None)
            if cache is None:
                cache = collections.OrderedDict()
                self._mux_models = cache
                self._mux_pending = {}
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            # dedup concurrent misses: one loader per model id, the
            # rest await its future (double-loading a model can OOM a
            # TPU replica)
            pending = self._mux_pending
            fut = pending.get(model_id)
            if fut is not None:
                return await fut
            fut = asyncio.get_running_loop().create_future()
            pending[model_id] = fut
            try:
                model = fn(self, model_id)
                if _inspect.iscoroutine(model):
                    model = await model
                cache[model_id] = model
                cache.move_to_end(model_id)
                # eviction drops the cache reference only; the object
                # finalizes when the last in-flight user releases it
                # (no explicit __del__: double-finalize hazard)
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
                fut.set_result(model)
                return model
            except BaseException as e:
                fut.set_exception(e)
                raise
            finally:
                pending.pop(model_id, None)

        wrapper._is_multiplexed = True
        return wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


def get_multiplexed_model_id() -> str:
    """The model id the current request was routed with."""
    from ray_tpu_torch.serve._private.replica import get_multiplexed_model_id
    return get_multiplexed_model_id()


# ------------------------------------------------------------- batching
def batch(_func=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """``@serve.batch`` — coalesce concurrent calls into one batch call.

    Parity: ``python/ray/serve/batching.py``.  The wrapped method receives
    a list of inputs and must return a list of outputs.
    """
    import asyncio
    import functools

    def wrap(fn):
        # single-event-loop state: no awaits between mutations, so no lock
        state: Dict[str, Any] = {"queue": [], "timer": None}

        async def flush(owner):
            if state["timer"] is not None:
                state["timer"].cancel()
                state["timer"] = None
            items = state["queue"][:max_batch_size]
            del state["queue"][:max_batch_size]
            if not items:
                return
            inputs = [p for p, _ in items]
            try:
                outs = await (fn(owner, inputs) if owner is not None
                              else fn(inputs))
                for (_, fut), out in zip(items, outs):
                    if not fut.done():
                        fut.set_result(out)
            except Exception as e:  # noqa: BLE001
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
            if state["queue"]:
                asyncio.ensure_future(flush(owner))

        @functools.wraps(fn)
        async def wrapper(self_or_arg, *args):
            # support bound methods (self) and free functions
            if args:
                owner, payload = self_or_arg, args[0]
            else:
                owner, payload = None, self_or_arg
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            state["queue"].append((payload, fut))
            if len(state["queue"]) >= max_batch_size:
                asyncio.ensure_future(flush(owner))
            elif state["timer"] is None:
                state["timer"] = loop.call_later(
                    batch_wait_timeout_s,
                    lambda: asyncio.ensure_future(flush(owner)))
            return await fut

        return wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


__all__ = [
    "deployment", "Deployment", "Application", "run", "get_app_handle",
    "get_deployment_handle", "status", "delete", "shutdown",
    "DeploymentHandle", "DeploymentResponse", "StreamStalledError",
    "batch",
    "multiplexed", "get_multiplexed_model_id",
    "start_http_proxy",
]
