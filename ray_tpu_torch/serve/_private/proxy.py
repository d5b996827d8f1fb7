# The port's copy of ray_tpu/serve/_private/proxy.py
"""Ingress proxies (parity: reference ``serve/_private/proxy.py``).

Dual protocol, like the reference's GenericProxy split into HTTPProxy
(``proxy.py:747``) and gRPCProxy (``proxy.py:533``):

- :class:`HTTPProxy` — aiohttp server in an async actor.  Requests ride
  the deployment handle asynchronously (``await ref``), one coroutine
  per request — no thread-per-request.  A request with
  ``?stream=1`` (or header ``X-Serve-Streaming: 1``) hits the
  deployment's streaming path and the response body is chunked: one
  JSON line per yielded item (SSE-flavored ``data:`` framing when the
  client asks for ``text/event-stream``).
- :class:`GRPCProxy` — grpc.aio server exposing a generic byte service
  (``/ray_tpu_torch.serve.GenericService/Predict`` unary and
  ``/.../PredictStreaming`` server-streaming).  The application is
  selected by the ``application`` metadata key (reference uses the same
  key); payloads are JSON if they parse, raw bytes otherwise.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any

import ray_tpu_torch

GRPC_SERVICE = "ray_tpu_torch.serve.GenericService"


def _decode_body(raw: bytes) -> Any:
    if not raw:
        return None
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError):
        try:
            return raw.decode()
        except UnicodeDecodeError:
            return raw


def _encode_item(item: Any) -> bytes:
    if isinstance(item, bytes):
        return item
    try:
        return json.dumps(item).encode()
    except (TypeError, ValueError):
        return str(item).encode()


@ray_tpu_torch.remote
class HTTPProxy:
    def __init__(self, port: int = 8000, host: str = "127.0.0.1"):
        # NOTE: __init__ runs before the actor's event loop starts; the
        # server is brought up lazily from the first ready() call.
        self.port = port
        self.host = host
        self._runner = None
        self._ready = False
        self._starting = False
        self._handles = {}

    async def _start(self):
        from aiohttp import web

        async def handle(request: "web.Request"):
            path = request.path.strip("/")
            app_name = path.split("/")[0] if path else "default"
            if await self._is_asgi(app_name):
                return await self._asgi_dispatch(app_name, request)
            stream = (request.query.get("stream") == "1"
                      or request.headers.get("X-Serve-Streaming") == "1")
            try:
                body: Any = None
                if request.can_read_body:
                    body = _decode_body(await request.read())
                handle = self._handle(app_name)
                if stream:
                    return await self._stream_response(
                        request, handle, body)
                # async end-to-end: routing fetch + pow-2 probes await
                # on this event loop (handle.remote_async), then the
                # result ref is awaited — no thread per request
                resp_obj = await handle.remote_async(body)
                response = await resp_obj.ref
                if isinstance(response, (dict, list, int, float, bool)) \
                        or response is None:
                    return web.json_response(response)
                return web.Response(text=str(response))
            except Exception as e:  # noqa: BLE001
                return web.json_response(
                    {"error": str(e)}, status=500)

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", handle)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        self._ready = True

    def _handle(self, app_name: str):
        """Cached per-app ingress handles: each handle owns a routing
        cache + long-poll thread, so per-request construction would
        refetch routing from the controller every call."""
        from ray_tpu_torch.serve.handle import DeploymentHandle
        h = self._handles.get(app_name)
        if h is None:
            # bounded LRU: the key is a client-supplied path segment, so
            # unique bogus paths must not grow this without limit
            if len(self._handles) >= 256:
                evict = next(iter(self._handles))
                self._handles.pop(evict, None)
            h = self._handles[app_name] = DeploymentHandle(app_name)
        else:
            # move-to-end for LRU recency
            self._handles[app_name] = self._handles.pop(app_name)
        return h

    async def _is_asgi(self, app_name: str) -> bool:
        """Whether this app's ingress is an ASGI deployment — read per
        request from the handle's routing table, which the long-poll
        invalidates on redeploy (a positive cache here would survive an
        ASGI→plain redeploy and dispatch a method the new replicas
        don't have)."""
        try:
            routing = await self._handle(app_name)._get_routing_async()
        except Exception:  # noqa: BLE001 — unknown app: default path
            return False
        return bool(routing.get("asgi"))

    async def _asgi_dispatch(self, app_name: str, request):
        """Forward the request as one ASGI cycle on an ingress replica
        (reference: ``serve.ingress(fastapi_app)``, serve/api.py:168)."""
        from aiohttp import web
        prefix = f"/{app_name}"
        path = request.path
        if path.startswith(prefix):
            path = path[len(prefix):] or "/"
        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request.method,
            "scheme": request.scheme,
            "path": path,
            "raw_path": path.encode(),
            "root_path": "",
            "query_string": request.query_string.encode(),
            "headers": [(k.lower(), v)
                        for k, v in request.headers.items()],
            "client": (request.remote, 0),
            "server": (self.host, self.port),
        }
        body = await request.read() if request.can_read_body else b""
        handle = self._handle(app_name).options(
            method_name="__serve_asgi__")
        try:
            resp_obj = await handle.remote_async(scope, body)
            result = await resp_obj.ref
        except Exception as e:  # noqa: BLE001
            return web.json_response({"error": str(e)}, status=500)
        from multidict import CIMultiDict
        headers = CIMultiDict()
        for k, v in result.get("headers", []):
            # multidict: repeated headers (Set-Cookie!) must survive
            if k.lower() not in ("content-length", "transfer-encoding"):
                headers.add(k, v)
        return web.Response(status=result.get("status", 200),
                            headers=headers,
                            body=result.get("body", b""))

    async def _stream_response(self, request, handle, body):
        from aiohttp import web
        sse = "text/event-stream" in request.headers.get("Accept", "")
        resp = web.StreamResponse(
            headers={"Content-Type": ("text/event-stream" if sse
                                      else "application/x-ndjson")})
        await resp.prepare(request)
        gen = await handle.options(stream=True).remote_async(body)
        async for ref in gen.ref_generator:
            item = await ref
            payload = _encode_item(item)
            if sse:
                await resp.write(b"data: " + payload + b"\n\n")
            else:
                await resp.write(payload + b"\n")
        await resp.write_eof()
        return resp

    async def ready(self):
        if not self._starting:
            self._starting = True
            asyncio.ensure_future(self._start())
        for _ in range(200):
            if self._ready:
                return self.port
            await asyncio.sleep(0.05)
        raise RuntimeError("proxy failed to start")


@ray_tpu_torch.remote
class GRPCProxy:
    """gRPC ingress (parity: reference gRPCProxy, ``proxy.py:533``)."""

    def __init__(self, port: int = 9000, host: str = "127.0.0.1"):
        self.port = port
        self.host = host
        self._server = None
        self._ready = False
        self._starting = False

    async def _start(self):
        import grpc

        def app_from(context) -> str:
            for key, value in (context.invocation_metadata() or ()):
                if key == "application":
                    return value
            return "default"

        async def predict(request: bytes, context):
            from ray_tpu_torch.serve.handle import DeploymentHandle
            handle = DeploymentHandle(app_from(context))
            try:
                loop = asyncio.get_running_loop()
                resp_obj = await loop.run_in_executor(
                    None, lambda: handle.remote(_decode_body(request)))
                result = await resp_obj.ref
            except Exception as e:  # noqa: BLE001
                await context.abort(grpc.StatusCode.INTERNAL, str(e))
                return
            return _encode_item(result)

        async def predict_streaming(request: bytes, context):
            from ray_tpu_torch.serve.handle import DeploymentHandle
            handle = DeploymentHandle(app_from(context))
            try:
                loop = asyncio.get_running_loop()
                gen = await loop.run_in_executor(
                    None, lambda: handle.options(stream=True).remote(
                        _decode_body(request)))
                async for ref in gen.ref_generator:
                    yield _encode_item(await ref)
            except Exception as e:  # noqa: BLE001
                await context.abort(grpc.StatusCode.INTERNAL, str(e))

        ident = lambda b: b  # noqa: E731 — raw-bytes (de)serializer
        handlers = grpc.method_handlers_generic_handler(GRPC_SERVICE, {
            "Predict": grpc.unary_unary_rpc_method_handler(
                predict, request_deserializer=ident,
                response_serializer=ident),
            "PredictStreaming": grpc.unary_stream_rpc_method_handler(
                predict_streaming, request_deserializer=ident,
                response_serializer=ident),
        })
        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((handlers,))
        self.port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        await self._server.start()
        self._ready = True

    async def ready(self):
        if not self._starting:
            self._starting = True
            asyncio.ensure_future(self._start())
        for _ in range(200):
            if self._ready:
                return self.port
            await asyncio.sleep(0.05)
        raise RuntimeError("grpc proxy failed to start")
