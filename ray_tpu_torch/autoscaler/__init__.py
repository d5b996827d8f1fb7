# The port's copy of ray_tpu/autoscaler/__init__.py
"""Autoscaler — demand-driven node provisioning.

Parity: reference autoscaler v1/v2
(``python/ray/autoscaler/_private/autoscaler.py:1``,
``autoscaler/v2``): a monitor loop reads cluster load from the control
plane (per-node queue depth piggybacked on heartbeats), launches worker
nodes through a ``NodeProvider`` while demand is sustained, and reaps
nodes that stay idle past ``idle_timeout_s``.

Providers: ``LocalNodeProvider`` spawns real extra node-manager
processes on this host (the multi-node-on-one-host simulation the test
suite uses everywhere); a cloud provider for GPU machines implements
the same three methods against its VM API.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch


class NodeProvider:
    """Minimal provider surface (reference: node_provider.py +
    ``available_node_types`` from the cluster config)."""

    def node_types(self) -> Dict[str, Dict[str, float]]:
        """Launchable node shapes: type name -> resource dict."""
        return {"default": {"CPU": 1.0}}

    def create_node(self, node_type: str = "default") -> bytes:
        raise NotImplementedError

    def terminate_node(self, node_id: bytes) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[bytes]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Real extra node processes on this host (cluster_utils parity)."""

    def __init__(self, worker_resources: Optional[Dict[str, float]] = None,
                 node_types: Optional[Dict[str, Dict[str, float]]] = None):
        from ray_tpu_torch._private.worker import global_node
        self._node = global_node()
        self.worker_resources = worker_resources or {"CPU": 2.0}
        self._types = node_types or {"default": dict(self.worker_resources)}
        self._nodes: List[bytes] = []

    def node_types(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self._types.items()}

    def create_node(self, node_type: str = "default") -> bytes:
        res = dict(self._types.get(node_type, self.worker_resources))
        cpus = res.pop("CPU", 1.0)
        gpus = res.pop("GPU", 0.0)
        node_id = self._node.add_node(num_cpus=cpus, num_gpus=gpus,
                                      resources=res or None)
        self._nodes.append(node_id)
        return node_id

    def terminate_node(self, node_id: bytes) -> None:
        self._node.remove_node(node_id)
        if node_id in self._nodes:
            self._nodes.remove(node_id)

    def non_terminated_nodes(self) -> List[bytes]:
        return list(self._nodes)


@dataclass
class AutoscalerConfig:
    min_workers: int = 0
    max_workers: int = 2
    # pending work must persist this long before a node launches
    upscale_delay_s: float = 1.0
    # a provider node with zero load/zero busy resources this long is
    # terminated
    idle_timeout_s: float = 10.0
    tick_s: float = 0.5


class StandardAutoscaler:
    """Monitor thread: scale the provider between min and max workers."""

    def __init__(self, provider: NodeProvider,
                 config: Optional[AutoscalerConfig] = None,
                 engine: str = "v1"):
        self.provider = provider
        self.config = config or AutoscalerConfig()
        self._stop = threading.Event()
        self._pending_since: Optional[float] = None
        self._idle_since: Dict[bytes, float] = {}
        self._thread: Optional[threading.Thread] = None
        self.events: List[str] = []  # human-readable scaling decisions
        # engine="v2": demand decisions stay here, but launches and
        # terminations flow through the instance reconciler, whose
        # state machine heals stuck/failed launches across ticks
        # (reference: autoscaler/v2/instance_manager/reconciler.py)
        self.reconciler = None
        if engine == "v2":
            from ray_tpu_torch.autoscaler.v2 import InstanceReconciler
            self.reconciler = InstanceReconciler(provider)

    # -- cluster state -------------------------------------------------
    @staticmethod
    def _nodes() -> List[Dict[str, Any]]:
        from ray_tpu_torch._private.worker import global_worker
        return global_worker().cp.list_nodes()

    def start(self) -> None:
        # advertise launchable shapes so node managers keep queueing
        # tasks this autoscaler could satisfy (instead of failing them
        # as infeasible) and their demand reaches the heartbeats
        import json

        from ray_tpu_torch._private.worker import global_worker
        try:
            global_worker().cp.kv_put(
                b"node_types",
                json.dumps(self.provider.node_types()).encode(),
                namespace="_autoscaler", overwrite=True)
        except Exception:  # noqa: BLE001 - registry is best-effort
            pass
        if self.reconciler is not None:
            self.reconciler.set_target("default", self.config.min_workers)
            self.reconciler.start()
        else:
            for _ in range(self.config.min_workers):
                self.provider.create_node()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.tick_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — keep the monitor alive
                pass

    def _tick(self) -> None:
        now = time.monotonic()
        nodes = {n["node_id"]: n for n in self._nodes()
                 if n.get("state") == "ALIVE"}
        pending = sum((n.get("load") or {}).get("num_pending", 0)
                      for n in nodes.values())
        # the max_workers bound counts every provider node, including
        # ones still booting (not ALIVE yet) — otherwise slow startup
        # lets sustained demand overshoot the cap.  In v2 mode the
        # launch is async, so instances the reconciler is still
        # materializing count too (they aren't provider-visible yet).
        provisioned = self.provider.non_terminated_nodes()
        managed = [nid for nid in provisioned if nid in nodes]
        in_flight = (self.reconciler.live_count()
                     if self.reconciler is not None
                     else len(provisioned))

        # ---- scale up: sustained unservable demand, matched by SHAPE
        # (reference: resource_demand_scheduler.py — bin-pack pending
        # bundles against launchable node types, not raw queue depth)
        if pending > 0:
            if self._pending_since is None:
                self._pending_since = now
            elif (now - self._pending_since >=
                  self.config.upscale_delay_s
                  and max(len(provisioned), in_flight)
                  < self.config.max_workers):
                node_type = self._pick_node_type(nodes.values())
                if node_type is not None:
                    # record the decision before the (blocking) launch —
                    # node startup can take seconds and observability
                    # should reflect when scaling was *chosen*
                    self.events.append(
                        f"up: +{node_type} (pending={pending})")
                    self._pending_since = None
                    if self.reconciler is not None:
                        # async: the reconciler launches, retries a
                        # stuck/failed create, and reports RAY_RUNNING
                        # once the node joins
                        self.reconciler.bump_target(node_type, +1)
                    else:
                        node_id = self.provider.create_node(node_type)
                        self.events.append(
                            f"up: node {node_id.hex()[:8]} ready")
        else:
            self._pending_since = None

        # ---- scale down: provider nodes idle past the timeout
        self._scale_down(nodes, managed, now)

    def _pick_node_type(self, node_infos) -> Optional[str]:
        """Bin-pack the heartbeat demand vector against existing
        capacity; pick the node type satisfying the most unfulfilled
        bundles (ties: fewest resources).  Returns None when nothing
        pending fits any launchable type (those bundles are logged as
        infeasible)."""
        demand: List[Dict[str, float]] = []
        for info in node_infos:
            for s in (info.get("load") or {}).get("pending_shapes", []):
                demand.extend([s["resources"]] * min(int(s["count"]), 64))
        types = self.provider.node_types()
        if not demand:
            # num_pending counted dep-waiting or just-drained work but
            # the shape vector is empty: launching an arbitrary type
            # would be a blind guess — wait for real shape demand
            return None
        # virtually pack demand onto existing nodes' available resources
        virtual = [dict(info.get("resources_available") or {})
                   for info in node_infos]
        unfulfilled: List[Dict[str, float]] = []
        for bundle in demand:
            for avail in virtual:
                if all(avail.get(k, 0.0) >= v for k, v in bundle.items()):
                    for k, v in bundle.items():
                        avail[k] = avail.get(k, 0.0) - v
                    break
            else:
                unfulfilled.append(bundle)
        if not unfulfilled:
            return None
        best, best_score = None, (0, 0.0)
        for name, shape in types.items():
            cap = dict(shape)
            served = 0
            for bundle in unfulfilled:
                if all(cap.get(k, 0.0) >= v for k, v in bundle.items()):
                    for k, v in bundle.items():
                        cap[k] -= v
                    served += 1
            score = (served, -sum(shape.values()))
            if served > 0 and score > best_score:
                best, best_score = name, score
        if best is None:
            infeasible = [b for b in unfulfilled
                          if not any(
                              all(shape.get(k, 0) >= v
                                  for k, v in b.items())
                              for shape in types.values())]
            if infeasible:
                msg = f"infeasible: {infeasible[0]} fits no node type"
                if not self.events or self.events[-1] != msg:
                    self.events.append(msg)
        return best

    def _scale_down(self, nodes, managed, now) -> None:
        alive_count = len(managed)
        for nid in list(managed):
            info = nodes[nid]
            load = (info.get("load") or {}).get("num_pending", 0)
            avail = info.get("resources_available") or {}
            total = info.get("resources_total") or {}
            busy = any(avail.get(k, 0) < total.get(k, 0) for k in total)
            if load == 0 and not busy:
                self._idle_since.setdefault(nid, now)
                if (now - self._idle_since[nid] >=
                        self.config.idle_timeout_s
                        and alive_count > self.config.min_workers):
                    if self.reconciler is not None:
                        if not self.reconciler.release_node(nid):
                            # instance not releasable yet (reconciler
                            # hasn't observed the node): retry next tick
                            continue
                    else:
                        self.provider.terminate_node(nid)
                    self.events.append(f"down: -node {nid.hex()[:8]}")
                    self._idle_since.pop(nid, None)
                    alive_count -= 1
            else:
                self._idle_since.pop(nid, None)

    def stop(self) -> None:
        self._stop.set()
        if self.reconciler is not None:
            self.reconciler.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # withdraw the shape registry: with no autoscaler to provision
        # them, unservable shapes must fail fast again
        from ray_tpu_torch._private.worker import global_worker
        try:
            global_worker().cp.kv_del(b"node_types",
                                      namespace="_autoscaler")
        except Exception:  # noqa: BLE001 - session may be gone
            pass


def request_resources(num_cpus: float = 0,
                      bundles: Optional[List[Dict]] = None) -> None:
    """API parity stub for ``ray.autoscaler.sdk.request_resources``:
    demand is inferred from queue depth; explicit requests are recorded
    as a KV hint for operators."""
    import json

    from ray_tpu_torch._private.worker import global_worker
    global_worker().cp.kv_put(
        b"autoscaler_request",
        json.dumps({"num_cpus": num_cpus,
                    "bundles": bundles or []}).encode(),
        namespace="_autoscaler")
