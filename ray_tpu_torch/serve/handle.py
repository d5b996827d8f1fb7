# The port's copy of ray_tpu/serve/handle.py
"""DeploymentHandle — the client API for calling deployments.

Parity: reference ``serve/handle.py`` + the power-of-two-choices replica
scheduler (``replica_scheduler/pow_2_scheduler.py``): pick two random
replicas, probe queue lengths, send to the shorter queue.  The routing
table is pulled from the controller and cached (refreshed on version
bump or failure).

Streams carry a credit flow the reference's do not (see
``_private/replica.py``, which holds its constants): the consumer
acknowledges every ``_STREAM_ACK_EVERY`` items it takes.
"""

from __future__ import annotations

import random
import threading
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._private.replica import _STREAM_ACK_EVERY


class DeploymentResponse:
    """Future-like response (parity: serve.handle.DeploymentResponse)."""

    def __init__(self, ref):
        self._ref = ref

    def result(self, timeout_s: Optional[float] = 60.0):
        return ray_tpu_torch.get(self._ref, timeout=timeout_s)

    def __await__(self):
        return self._ref.__await__()

    @property
    def ref(self):
        return self._ref


class _AckedRefs:
    """A stream's object refs, acknowledging to the replica: asking for
    item ``n + 1`` tells it that ``n`` items were taken (every
    ``_STREAM_ACK_EVERY``th).  Sync and async iteration, as the
    ``ObjectRefGenerator`` it wraps."""

    def __init__(self, ref_gen, replica, stream_id: str):
        self._ref_gen = ref_gen
        self._replica = replica
        self._stream_id = stream_id
        self._taken = 0

    def _ack(self) -> None:
        if self._taken and self._taken % _STREAM_ACK_EVERY == 0:
            self._replica.stream_ack.remote(self._stream_id, self._taken)

    def __iter__(self):
        return self

    def __next__(self):
        self._ack()
        ref = next(self._ref_gen)
        self._taken += 1
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self):
        self._ack()
        ref = await self._ref_gen.__anext__()
        self._taken += 1
        return ref


class DeploymentResponseGenerator:
    """Streaming response: iterate resolved items as the replica yields
    them (parity: serve.handle.DeploymentResponseGenerator over
    ObjectRefGenerator)."""

    def __init__(self, ref_gen, replica=None, stream_id: str = ""):
        self._ref_gen = (ref_gen if replica is None
                         else _AckedRefs(ref_gen, replica, stream_id))

    def __iter__(self):
        for ref in self._ref_gen:
            yield ray_tpu_torch.get(ref)

    @property
    def ref_generator(self):
        return self._ref_gen


class DeploymentHandle:
    def __init__(self, app_name: str, deployment_name: Optional[str] = None,
                 method_name: str = "__call__",
                 multiplexed_model_id: Optional[str] = None,
                 stream: bool = False):
        self._app = app_name
        self._deployment = deployment_name
        self._method = method_name
        self._stream = stream
        self._routing: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        self._poller: Optional[threading.Thread] = None
        self._poller_stop = threading.Event()
        # model multiplexing: requests for one model id stick to the
        # replica that already loaded it (reference: model-affinity
        # routing in the pow-2 scheduler)
        self._mux_id: Optional[str] = multiplexed_model_id
        self._mux_affinity: Dict[str, Any] = {}
        # liveness probes of pinned replicas are TTL-cached: probing on
        # every dispatch added an RPC round trip per request
        self._mux_probe_ok: Dict[Any, float] = {}

    def _start_poller(self, deployment: str) -> None:
        """Long-poll the control-plane pubsub for routing pushes
        (autoscale/redeploy version bumps) — parity with the reference's
        LongPollClient (``serve/_private/long_poll.py:173``)."""
        with self._lock:
            if self._poller is not None:
                return
            self._poller = True  # placeholder: claim before starting

        import weakref
        handle_ref = weakref.ref(self)  # don't keep the handle alive
        stop = self._poller_stop
        app = self._app

        def loop():
            from ray_tpu_torch._private.worker import global_worker
            from ray_tpu_torch.serve._private.controller import routing_channel
            channel = routing_channel(app, deployment)
            cursor = 0
            while not stop.is_set():
                try:
                    cursor, msgs = global_worker().cp.poll(
                        channel, cursor, 10.0)
                    handle = handle_ref()
                    if handle is None:
                        return  # handle was GC'd: stop polling
                    if msgs:
                        with handle._lock:
                            handle._routing = None  # refetch on next use
                    del handle
                except Exception:  # noqa: BLE001 — retry next round
                    if stop.wait(1.0):
                        return

        self._poller = threading.Thread(target=loop, daemon=True,
                                        name="serve-handle-poll")
        self._poller.start()

    def __del__(self):
        self._poller_stop.set()

    # handle.method.remote(...) sugar (cached: each sub-handle owns a
    # routing cache + long-poll thread, so recreating per access would
    # churn threads)
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        sub = DeploymentHandle(self._app, self._deployment, name,
                               self._mux_id, stream=self._stream)
        sub._mux_affinity = self._mux_affinity
        sub._mux_probe_ok = self._mux_probe_ok
        sub._get_routing = self._get_routing
        sub._get_routing_async = self._get_routing_async
        self.__dict__[name] = sub
        return sub

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        sub = DeploymentHandle(
            self._app, self._deployment, method_name or self._method,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._mux_id,
            stream=self._stream if stream is None else stream)
        # per-request sub-handles delegate routing state to the parent:
        # they must not each pay a controller RPC + long-poll thread
        # (or lose the probe TTL cache that skips per-dispatch probes)
        sub._mux_affinity = self._mux_affinity
        sub._mux_probe_ok = self._mux_probe_ok
        sub._get_routing = self._get_routing
        sub._get_routing_async = self._get_routing_async
        return sub

    def _controller(self):
        ctrl = self.__dict__.get("_controller_handle")
        if ctrl is None:
            from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME
            ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            self.__dict__["_controller_handle"] = ctrl
        return ctrl

    def _get_routing(self, refresh: bool = False) -> Dict[str, Any]:
        with self._lock:
            if self._routing is None or refresh:
                routing = ray_tpu_torch.get(
                    self._controller().get_routing.remote(
                        self._app, self._deployment), timeout=30)
                if routing is None:
                    raise RuntimeError(
                        f"no deployment "
                        f"{self._deployment or '(ingress)'} in app "
                        f"{self._app!r}")
                self._routing = routing
            routing = self._routing
        self._start_poller(routing["deployment"])
        return routing

    def _wait_for_replicas(self, timeout_s: float = 30.0):
        """Scale-from-zero: ask the controller for capacity, then wait
        for the routing push to carry a live replica (reference:
        handle-side autoscaling metrics let min_replicas=0 deployments
        wake on first request)."""
        import time as _time
        routing = self._get_routing()
        deadline = _time.monotonic() + timeout_s
        kicked = False
        while not routing["replicas"]:
            if not kicked:
                try:
                    ray_tpu_torch.get(
                        self._controller().request_upscale.remote(
                            self._app, routing["deployment"]), timeout=30)
                except Exception:  # noqa: BLE001 — retried below
                    pass
                kicked = True
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"deployment {routing['deployment']!r} has no "
                    f"replicas after {timeout_s}s")
            _time.sleep(0.1)
            routing = self._get_routing(refresh=True)
        return routing

    def _pick_replica(self):
        routing = self._get_routing()
        if not routing["replicas"]:
            routing = self._wait_for_replicas()
        replicas = routing["replicas"]
        if len(replicas) == 1:
            return replicas[0]
        # power of two choices on queue length
        a, b = random.sample(replicas, 2)
        try:
            qa, qb = ray_tpu_torch.get([a.num_ongoing.remote(),
                                        b.num_ongoing.remote()], timeout=5)
        except Exception:  # noqa: BLE001 - refresh and fall back
            routing = self._get_routing(refresh=True)
            if not routing["replicas"]:
                # scaled to zero while we probed: wake it back up
                routing = self._wait_for_replicas()
            return random.choice(routing["replicas"])
        return a if qa <= qb else b

    _MUX_PROBE_TTL_S = 5.0

    def _dispatch(self, replica, args, kwargs, mux: str = ""):
        if self._stream:
            method = replica.handle_request_streaming.options(
                num_returns="streaming")
            stream_id = uuid.uuid4().hex
            return DeploymentResponseGenerator(
                method.remote(self._method, args, kwargs, mux, stream_id),
                replica, stream_id)
        ref = replica.handle_request.remote(self._method, args, kwargs,
                                            mux)
        return DeploymentResponse(ref)

    # ------------------------------------------------------------------
    # Async dispatch (proxy hot path).  Same routing logic as the sync
    # path, but every wait point — controller fetch, replica probes,
    # scale-from-zero backoff — is awaited on the caller's event loop
    # instead of burning an executor thread per request (reference:
    # the proxy is async end-to-end, ``serve/_private/proxy.py:423``).
    # ------------------------------------------------------------------
    async def _get_routing_async(self, refresh: bool = False):
        with self._lock:
            routing = None if refresh else self._routing
        if routing is None:
            ref = self._controller().get_routing.remote(
                self._app, self._deployment)
            import asyncio
            routing = await asyncio.wait_for(ref, timeout=30)
            if routing is None:
                raise RuntimeError(
                    f"no deployment {self._deployment or '(ingress)'} "
                    f"in app {self._app!r}")
            with self._lock:
                self._routing = routing
        self._start_poller(routing["deployment"])
        return routing

    async def _wait_for_replicas_async(self, timeout_s: float = 30.0):
        import asyncio
        import time as _time
        routing = await self._get_routing_async()
        deadline = _time.monotonic() + timeout_s
        kicked = False
        while not routing["replicas"]:
            if not kicked:
                try:
                    await asyncio.wait_for(
                        self._controller().request_upscale.remote(
                            self._app, routing["deployment"]), timeout=30)
                except Exception:  # noqa: BLE001 — retried below
                    pass
                kicked = True
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"deployment {routing['deployment']!r} has no "
                    f"replicas after {timeout_s}s")
            await asyncio.sleep(0.1)
            routing = await self._get_routing_async(refresh=True)
        return routing

    async def _pick_replica_async(self):
        import asyncio
        routing = await self._get_routing_async()
        if not routing["replicas"]:
            routing = await self._wait_for_replicas_async()
        replicas = routing["replicas"]
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)

        async def _aw(ref):
            return await ref

        try:
            qa, qb = await asyncio.wait_for(
                asyncio.gather(_aw(a.num_ongoing.remote()),
                               _aw(b.num_ongoing.remote())),
                timeout=5)
        except Exception:  # noqa: BLE001 - refresh and fall back
            routing = await self._get_routing_async(refresh=True)
            if not routing["replicas"]:
                routing = await self._wait_for_replicas_async()
            return random.choice(routing["replicas"])
        return a if qa <= qb else b

    async def remote_async(self, *args, **kwargs):
        """Route + dispatch without blocking the event loop; returns the
        same DeploymentResponse/Generator as ``remote()``."""
        mux = self._mux_id
        if mux:
            import time as _time
            routing = await self._get_routing_async()
            replica = self._mux_affinity.get(mux)
            if replica is not None and replica in routing["replicas"]:
                last_ok = self._mux_probe_ok.get(replica, 0.0)
                if _time.monotonic() - last_ok > self._MUX_PROBE_TTL_S:
                    import asyncio
                    try:
                        await asyncio.wait_for(
                            replica.num_ongoing.remote(), timeout=5)
                        self._mux_probe_ok[replica] = _time.monotonic()
                    except Exception:  # noqa: BLE001 — crashed: re-pin
                        await self._get_routing_async(refresh=True)
                        self._mux_probe_ok.pop(replica, None)
                        replica = None
            else:
                replica = None
            if replica is None:
                replica = await self._pick_replica_async()
                self._mux_affinity[mux] = replica
                self._mux_probe_ok[replica] = _time.monotonic()
            return self._dispatch(replica, args, kwargs, mux)
        replica = await self._pick_replica_async()
        return self._dispatch(replica, args, kwargs)

    def remote(self, *args, **kwargs):
        mux = self._mux_id
        if mux:
            import time as _time
            routing = self._get_routing()
            replica = self._mux_affinity.get(mux)
            if replica is not None and replica in routing["replicas"]:
                # optimistic dispatch: probe only when the cached
                # liveness result is stale (ADVICE: a probe per dispatch
                # added a full RPC round trip to every request)
                last_ok = self._mux_probe_ok.get(replica, 0.0)
                if _time.monotonic() - last_ok > self._MUX_PROBE_TTL_S:
                    try:
                        ray_tpu_torch.get(replica.num_ongoing.remote(),
                                          timeout=5)
                        self._mux_probe_ok[replica] = _time.monotonic()
                    except Exception:  # noqa: BLE001 — crashed: re-pin
                        self._get_routing(refresh=True)
                        self._mux_probe_ok.pop(replica, None)
                        replica = None
            else:
                replica = None
            if replica is None:
                replica = self._pick_replica()
                self._mux_affinity[mux] = replica
                self._mux_probe_ok[replica] = _time.monotonic()
            return self._dispatch(replica, args, kwargs, mux)
        replica = self._pick_replica()
        return self._dispatch(replica, args, kwargs)

    def __reduce__(self):
        return (DeploymentHandle, (self._app, self._deployment,
                                   self._method, self._mux_id,
                                   self._stream))

    # identity is the target, not the instance: the controller compares
    # init_args across redeploys to decide in-place reconfigure vs
    # restart, and composed apps carry handles in init_args
    def __eq__(self, other):
        return (isinstance(other, DeploymentHandle)
                and (self._app, self._deployment, self._method)
                == (other._app, other._deployment, other._method))

    def __hash__(self):
        return hash((self._app, self._deployment, self._method))
