# The port's copy of ray_tpu/dashboard/app.py
"""Dashboard — HTTP observability API.

Parity (compressed): reference ``dashboard/head.py`` + modules: REST
endpoints over control-plane state (nodes/actors/tasks/objects/cluster),
Prometheus ``/metrics``, Chrome-trace ``/api/timeline``, and a minimal
HTML index.  Runs as an aiohttp server thread in the head process.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
from typing import Optional

_STATIC_INDEX = os.path.join(os.path.dirname(__file__), "static",
                             "index.html")

# fallback when the bundled SPA is missing (e.g. a trimmed install)
_INDEX_HTML = """<!doctype html>
<title>ray_tpu_torch dashboard</title>
<h1>ray_tpu_torch dashboard</h1>
<ul>
<li><a href="/api/cluster">cluster</a></li>
<li><a href="/api/nodes">nodes</a></li>
<li><a href="/api/actors">actors</a></li>
<li><a href="/api/tasks">tasks</a></li>
<li><a href="/api/objects">objects</a></li>
<li><a href="/api/placement_groups">placement groups</a></li>
<li><a href="/api/timeline">timeline (chrome trace)</a></li>
<li><a href="/api/jobs">jobs</a></li>
<li><a href="/api/serve">serve apps</a></li>
<li><a href="/metrics">prometheus metrics</a></li>
</ul>"""


class Dashboard:
    def __init__(self, port: int = 8265):
        self.port = port
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    def start(self) -> int:
        started = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            loop.run_until_complete(self._serve(started))
            loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="dashboard")
        self._thread.start()
        if not started.wait(10):
            raise RuntimeError("dashboard failed to start")
        return self.port

    async def _serve(self, started: threading.Event):
        from aiohttp import web

        import ray_tpu_torch
        from ray_tpu_torch.util import state as state_api

        def json_response(data):
            return web.json_response(data)

        async def index(request):
            # the SPA frontend (dashboard/static/index.html, parity:
            # reference dashboard/client React app)
            try:
                with open(_STATIC_INDEX) as f:
                    return web.Response(text=f.read(),
                                        content_type="text/html")
            except OSError:
                return web.Response(text=_INDEX_HTML,
                                    content_type="text/html")

        async def nodes(request):
            return json_response(state_api.list_nodes())

        async def actors(request):
            return json_response(state_api.list_actors())

        async def tasks(request):
            return json_response(state_api.list_tasks())

        async def objects(request):
            return json_response(state_api.summarize_objects())

        async def pgs(request):
            return json_response(state_api.list_placement_groups())

        async def cluster(request):
            return json_response({
                "resources_total": ray_tpu_torch.cluster_resources(),
                "resources_available": ray_tpu_torch.available_resources(),
                "task_summary": state_api.summarize_tasks(),
                "actor_summary": state_api.summarize_actors(),
            })

        async def timeline(request):
            from ray_tpu_torch._private.profiling import timeline as tl
            return web.Response(text=tl(), content_type="application/json")

        async def metrics(request):
            from ray_tpu_torch.util.metrics import prometheus_text
            return web.Response(text=prometheus_text(),
                                content_type="text/plain")

        def _list_jobs_blocking():
            from ray_tpu_torch.job import JobSubmissionClient
            try:
                return [j.__dict__
                        for j in JobSubmissionClient().list_jobs()]
            except Exception:  # noqa: BLE001 — no jobs submitted yet
                return []

        def _serve_apps_blocking():
            import ray_tpu_torch as rt
            try:
                controller = rt.get_actor("__serve_controller__")
                return rt.get(controller.list_applications.remote(),
                              timeout=10)
            except Exception:  # noqa: BLE001 — serve not running
                return {}

        async def jobs(request):
            # cross-process RPC: keep it off the dashboard event loop
            loop = asyncio.get_running_loop()
            return json_response(
                await loop.run_in_executor(None, _list_jobs_blocking))

        async def serve_apps(request):
            loop = asyncio.get_running_loop()
            return json_response(
                await loop.run_in_executor(None, _serve_apps_blocking))

        # ---- per-entity drill-down + logs (reference:
        # dashboard/modules/{actor,node,log}) ----
        def _nm_client(node_hex: str):
            from ray_tpu_torch._private.protocol import RpcClient
            from ray_tpu_torch._private.worker import global_worker
            info = global_worker().cp.get_node(bytes.fromhex(node_hex))
            if info is None:
                return None
            return RpcClient(info["sock_path"])

        def _actor_detail_blocking(actor_hex: str):
            from ray_tpu_torch._private.worker import global_worker
            info = global_worker().cp.get_actor_info(
                bytes.fromhex(actor_hex))
            if info is None:
                return None
            out = {k: (v.hex() if isinstance(v, bytes) else v)
                   for k, v in info.items()
                   if isinstance(v, (str, int, float, bool, bytes,
                                     type(None)))}
            out["actor_id"] = actor_hex
            return out

        def _node_detail_blocking(node_hex: str):
            from ray_tpu_torch._private.worker import global_worker
            info = global_worker().cp.get_node(bytes.fromhex(node_hex))
            if info is None:
                return None
            out = dict(info)
            out["node_id"] = node_hex
            client = _nm_client(node_hex)
            if client is not None:
                try:
                    out["debug_state"] = client.call("debug_state")
                except Exception:  # noqa: BLE001
                    pass
            return {k: v for k, v in out.items()
                    if not isinstance(v, bytes)}

        async def actor_detail(request):
            loop = asyncio.get_running_loop()
            data = await loop.run_in_executor(
                None, _actor_detail_blocking,
                request.match_info["actor_id"])
            if data is None:
                return web.json_response({"error": "not found"},
                                         status=404)
            return json_response(data)

        async def node_detail(request):
            loop = asyncio.get_running_loop()
            data = await loop.run_in_executor(
                None, _node_detail_blocking,
                request.match_info["node_id"])
            if data is None:
                return web.json_response({"error": "not found"},
                                         status=404)
            return json_response(data)

        async def logs_list(request):
            node = request.query.get("node_id")
            if not node:
                return web.json_response({"error": "node_id required"},
                                         status=400)
            loop = asyncio.get_running_loop()

            def blocking():
                client = _nm_client(node)
                return client.call("list_logs") if client else None

            data = await loop.run_in_executor(None, blocking)
            if data is None:
                return web.json_response({"error": "node not found"},
                                         status=404)
            return json_response(data)

        async def logs_tail(request):
            node = request.query.get("node_id")
            name = request.query.get("name")
            n = int(request.query.get("nbytes", 65536))
            if not node or not name:
                return web.json_response(
                    {"error": "node_id and name required"}, status=400)
            loop = asyncio.get_running_loop()

            def blocking():
                client = _nm_client(node)
                return client.call("tail_log", name, n) if client \
                    else None

            data = await loop.run_in_executor(None, blocking)
            if data is None:
                return web.json_response(
                    {"error": "node or log file not found"}, status=404)
            return web.Response(text=data.decode("utf-8", "replace"),
                                content_type="text/plain")

        app = web.Application()
        app.router.add_get("/", index)
        app.router.add_get("/api/nodes", nodes)
        app.router.add_get("/api/actors", actors)
        app.router.add_get("/api/tasks", tasks)
        app.router.add_get("/api/objects", objects)
        app.router.add_get("/api/placement_groups", pgs)
        app.router.add_get("/api/cluster", cluster)
        app.router.add_get("/api/timeline", timeline)
        app.router.add_get("/api/jobs", jobs)
        app.router.add_get("/api/serve", serve_apps)
        app.router.add_get("/api/actors/{actor_id}", actor_detail)
        app.router.add_get("/api/nodes/{node_id}", node_detail)
        app.router.add_get("/api/logs", logs_list)
        app.router.add_get("/api/logs/tail", logs_tail)
        app.router.add_get("/metrics", metrics)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", self.port)
        await site.start()
        started.set()
