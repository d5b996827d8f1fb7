# The port's copy of ray_tpu/serve/_private/controller.py
"""ServeController — declarative app reconciliation + autoscaling.

Parity: reference ``serve/_private/controller.py`` + ``deployment_state.py``
+ ``autoscaling_policy.py`` (compressed): a detached actor holds the
desired state of every application and reconciles replica actors to it.
An async autoscale loop sizes each deployment from measured queue depth
(``ceil(total_ongoing / target_ongoing_requests)`` clamped to
[min, max], with upscale/downscale sustain delays).  Routing-table
changes are *pushed* to handles through the control-plane pubsub
(reference ``_private/long_poll.py:64,173``) instead of polled.

Redeploys are minimally disruptive: if only ``user_config`` changed, the
live replicas are reconfigured in place (no restart); replica-count
changes add/remove the delta.
"""

from __future__ import annotations

import asyncio
import math
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch

CONTROLLER_NAME = "__serve_controller__"

AUTOSCALE_DEFAULTS = {
    "min_replicas": 1,
    # max_replicas defaults to num_replicas at deploy time
    "target_ongoing_requests": 2.0,
    "upscale_delay_s": 0.5,
    "downscale_delay_s": 2.0,
    "metrics_interval_s": 0.25,
}


def routing_channel(app_name: str, deployment: str) -> str:
    return f"serve_routing:{app_name}:{deployment}"


def _cp():
    from ray_tpu_torch._private.worker import global_worker
    return global_worker().cp


@ray_tpu_torch.remote
class ServeController:
    def __init__(self):
        # app -> deployment -> {"config":..., "replicas": [handles],
        #   "version": int, "blob": bytes, "autoscale": dict|None,
        #   "desired_since": (direction, t0)}
        self.apps: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self.ingress: Dict[str, str] = {}  # app -> ingress deployment
        self.proxy = None
        # started from the first async call: __init__ runs before the
        # actor's event loop exists, so a task created here would never
        # be scheduled
        self._autoscaler: Optional[asyncio.Task] = None
        # strong refs: the loop holds tasks weakly, and a GC'd drain
        # task would leak its unrouted victims forever
        self._drain_tasks: set = set()

    def _ensure_autoscaler(self) -> None:
        if self._autoscaler is None or self._autoscaler.done():
            self._autoscaler = asyncio.ensure_future(
                self._autoscale_loop())

    # ------------------------------------------------------- deploy ----
    def _spawn_replica(self, app_name: str, d: Dict[str, Any]):
        from ray_tpu_torch.serve._private.replica import ServeReplica
        opts = dict(d.get("actor_options") or {})
        opts.setdefault("num_cpus", 0)
        opts["max_concurrency"] = max(d.get("max_ongoing", 8), 1)
        return ServeReplica.options(**opts).remote(
            app_name, d["name"], d["cls_blob"],
            d.get("init_args") or (), d.get("init_kwargs") or {},
            d.get("user_config"))

    def _publish(self, app_name: str, name: str, version: int) -> None:
        try:
            _cp().publish(routing_channel(app_name, name),
                          {"version": version})
        except Exception:  # noqa: BLE001 — pubsub is best-effort
            pass

    @staticmethod
    def _same_code(entry: Dict[str, Any], d: Dict[str, Any]) -> bool:
        return (entry["blob"] == d["cls_blob"]
                and entry["config"].get("init_args") == (
                    d.get("init_args") or ())
                and entry["config"].get("init_kwargs") == (
                    d.get("init_kwargs") or {})
                and entry["config"].get("actor_options") ==
                d.get("actor_options"))

    async def deploy_application(self, app_name: str,
                                 deployments: List[Dict[str, Any]],
                                 ingress_name: str):
        """deployments: [{name, cls_blob, init_args, init_kwargs,
        num_replicas, actor_options, max_ongoing, user_config,
        autoscaling_config}]"""
        self._ensure_autoscaler()
        app = self.apps.setdefault(app_name, {})
        desired = {d["name"] for d in deployments}
        for name in list(app):  # tear down removed deployments
            if name not in desired:
                for replica in app[name]["replicas"]:
                    ray_tpu_torch.kill(replica)
                del app[name]
        pings = []
        for d in deployments:
            autoscale = None
            if d.get("autoscaling_config") is not None:
                autoscale = dict(AUTOSCALE_DEFAULTS)
                autoscale.update(d["autoscaling_config"])
                # min_replicas=0 is supported: a handle that finds the
                # routing table empty calls request_upscale and waits
                # for the push carrying the first replica
                autoscale.setdefault(
                    "max_replicas",
                    max(d["num_replicas"], autoscale["min_replicas"], 1))
            target_n = (autoscale["min_replicas"] if autoscale
                        else d["num_replicas"])
            entry = app.get(d["name"])
            if entry and self._same_code(entry, d):
                # lightweight redeploy: reconfigure in place, adjust count
                version = entry["version"] + 1
                if autoscale:
                    # keep the autoscaler-earned count, clamped to the
                    # (possibly new) bounds — don't snap back to min
                    target_n = max(autoscale["min_replicas"],
                                   min(autoscale["max_replicas"],
                                       len(entry["replicas"])))
                if len(entry["replicas"]) > target_n:
                    victims = entry["replicas"][target_n:]
                    del entry["replicas"][target_n:]
                    self._schedule_drain(victims)
                while len(entry["replicas"]) < target_n:
                    entry["replicas"].append(
                        self._spawn_replica(app_name, d))
                # reconfigure only the survivors (after any shrink)
                if entry["config"].get("user_config") != \
                        d.get("user_config"):
                    for replica in entry["replicas"]:
                        pings.append(replica.reconfigure.remote(
                            d.get("user_config")))
                entry["config"] = {k: v for k, v in d.items()
                                   if k != "cls_blob"}
                entry["version"] = version
                entry["autoscale"] = autoscale
                entry["desired_since"] = None
            else:
                if entry:  # code changed: replace replicas
                    for replica in entry["replicas"]:
                        ray_tpu_torch.kill(replica)
                replicas = [self._spawn_replica(app_name, d)
                            for _ in range(target_n)]
                app[d["name"]] = {
                    "config": {k: v for k, v in d.items()
                               if k != "cls_blob"},
                    "blob": d["cls_blob"],
                    "replicas": replicas,
                    "version": (entry["version"] + 1) if entry else 1,
                    "autoscale": autoscale,
                    "desired_since": None,
                }
            self._publish(app_name, d["name"],
                          app[d["name"]]["version"])
        self.ingress[app_name] = ingress_name
        for name in desired:  # wait for live replicas + reconfigures
            for replica in app[name]["replicas"]:
                pings.append(replica.ping.remote())
        for ref in pings:
            await ref
        return True

    # --------------------------------------------------- autoscaling ----
    async def _autoscale_loop(self):
        """Queue-depth-driven scaling (reference autoscaling_policy.py:1:
        desired = ceil(total_ongoing / target), sustained over the
        up/downscale delay before acting)."""
        while True:
            try:
                await asyncio.sleep(0.25)
                now = time.monotonic()
                for app_name, deps in list(self.apps.items()):
                    for name, entry in list(deps.items()):
                        cfg = entry.get("autoscale")
                        if not cfg:
                            continue
                        last = entry.get("last_probe", 0.0)
                        if now - last < cfg["metrics_interval_s"]:
                            continue
                        entry["last_probe"] = now
                        await self._autoscale_one(app_name, name,
                                                  entry, cfg)
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — keep the loop alive
                pass

    async def request_upscale(self, app_name: str, name: str) -> bool:
        """Scale-from-zero wakeup: a handle found no replicas to route
        to.  Spawn one immediately (the autoscaler grows it further if
        load sustains) and push the new routing table."""
        entry = self.apps.get(app_name, {}).get(name)
        if entry is None:
            return False
        if entry["replicas"]:
            return True
        d = dict(entry["config"])
        d["cls_blob"] = entry["blob"]
        replica = self._spawn_replica(app_name, d)
        entry["replicas"].append(replica)
        entry["version"] += 1
        entry["desired_since"] = None
        self._publish(app_name, name, entry["version"])
        try:
            await replica.ping.remote()
        except Exception:  # noqa: BLE001 — handle retries routing anyway
            pass
        return True

    async def _autoscale_one(self, app_name: str, name: str,
                             entry: Dict[str, Any], cfg: Dict[str, Any]):
        replicas = entry["replicas"]
        if not replicas:
            return
        # snapshot: a same-code redeploy can mutate the list in place
        # while we await probes (counts must pair with these replicas)
        replicas = list(replicas)

        async def probe(r):
            try:
                return await r.num_ongoing.remote()
            except Exception:  # noqa: BLE001 — dead replica counts 0
                return 0

        counts = list(await asyncio.gather(*[probe(r) for r in replicas]))
        # a concurrent redeploy may have replaced this entry while we
        # were suspended on the probes — mutating the old dict would
        # spawn replicas into an orphaned list
        if self.apps.get(app_name, {}).get(name) is not entry:
            return
        total = sum(counts)
        desired = math.ceil(total / max(cfg["target_ongoing_requests"],
                                        1e-9))
        desired = max(cfg["min_replicas"],
                      min(cfg["max_replicas"], desired))
        current = len(replicas)
        if desired == current:
            entry["desired_since"] = None
            return
        direction = "up" if desired > current else "down"
        mark = entry.get("desired_since")
        now = time.monotonic()
        if mark is None or mark[0] != direction:
            entry["desired_since"] = (direction, now)
            return
        delay = (cfg["upscale_delay_s"] if direction == "up"
                 else cfg["downscale_delay_s"])
        if now - mark[1] < delay:
            return
        entry["desired_since"] = None
        d = dict(entry["config"])
        d["cls_blob"] = entry["blob"]
        if direction == "up":
            for _ in range(desired - current):
                entry["replicas"].append(self._spawn_replica(app_name, d))
            entry["version"] += 1
            self._publish(app_name, name, entry["version"])
        else:
            # drain-then-kill: remove the least-loaded replicas from the
            # routing table first (version bump pushes the new table to
            # handles), wait for their in-flight requests to finish,
            # then kill (reference: replica graceful shutdown /
            # drain_replicas)
            order = sorted(range(current), key=lambda i: counts[i])
            victims = [replicas[i] for i in order[:current - desired]]
            for v in victims:
                if v in entry["replicas"]:
                    entry["replicas"].remove(v)
            entry["version"] += 1
            self._publish(app_name, name, entry["version"])
            self._schedule_drain(victims)

    def _schedule_drain(self, victims) -> None:
        task = asyncio.ensure_future(self._drain_and_kill(victims))
        self._drain_tasks.add(task)
        task.add_done_callback(self._drain_tasks.discard)

    async def _drain_and_kill(self, victims, timeout_s: float = 30.0,
                              grace_s: float = 1.0):
        # grace: handles learn about the routing change via the pubsub
        # push; requests dispatched from a stale table in that window
        # are invisible to num_ongoing until they start executing
        await asyncio.sleep(grace_s)
        deadline = time.monotonic() + timeout_s
        pending = list(victims)
        while pending and time.monotonic() < deadline:
            still = []
            for r in pending:
                busy = False
                try:
                    busy = await r.num_ongoing.remote() > 0
                except Exception:  # noqa: BLE001 — probe failed: kill
                    pass           # anyway (kill tolerates dead actors)
                if busy:
                    still.append(r)
                    continue
                try:
                    ray_tpu_torch.kill(r)
                except Exception:  # noqa: BLE001
                    pass
            pending = still
            if pending:
                await asyncio.sleep(0.2)
        for r in pending:  # drain timeout: cut them loose
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------- routing ----
    def get_routing(self, app_name: str,
                    deployment: Optional[str] = None):
        app = self.apps.get(app_name)
        if app is None:
            return None
        name = deployment or self.ingress.get(app_name)
        entry = app.get(name)
        if entry is None:
            return None
        return {"deployment": name, "replicas": list(entry["replicas"]),
                "version": entry["version"],
                "max_ongoing": entry["config"].get("max_ongoing", 8),
                "asgi": entry["config"].get("asgi", False)}

    def list_applications(self):
        return {app: {"deployments": {
            name: {"num_replicas": len(e["replicas"]),
                   "version": e["version"]}
            for name, e in deps.items()},
            "ingress": self.ingress.get(app)}
            for app, deps in self.apps.items()}

    def delete_application(self, app_name: str):
        app = self.apps.pop(app_name, None)
        self.ingress.pop(app_name, None)
        if app:
            for entry in app.values():
                for replica in entry["replicas"]:
                    ray_tpu_torch.kill(replica)
        return True

    def set_proxy(self, proxy):
        self.proxy = proxy

    def get_proxy(self):
        return self.proxy

    def set_grpc_proxy(self, proxy, port: Optional[int] = None):
        self.grpc_proxy = proxy
        self.grpc_port = port

    def get_grpc_proxy(self):
        return getattr(self, "grpc_proxy", None)

    def get_grpc_port(self):
        return getattr(self, "grpc_port", None)

    def ping(self):
        return "pong"
