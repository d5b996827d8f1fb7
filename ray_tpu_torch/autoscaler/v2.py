# The port's copy of ray_tpu/autoscaler/v2.py
"""Autoscaler v2 — reconciler-style instance manager.

Parity: ``python/ray/autoscaler/v2/instance_manager/reconciler.py``:
instead of v1's imperative scale-up/down decisions, v2 keeps a table of
*instances*, each walking an explicit state machine

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                                   \\-> TERMINATING -> TERMINATED
           (REQUESTED | ALLOCATED stuck past timeout -> retried/FAILED)

and every tick *reconciles* the table against (a) the provider's view
and (b) the cluster's live node set.  Crashes between decision and
effect are healed by the next tick instead of leaking instances — the
property v1 loops lack.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"
FAILED = "FAILED"


@dataclass
class Instance:
    instance_id: str
    node_type: str
    state: str = QUEUED
    node_id: Optional[bytes] = None
    updated_at: float = field(default_factory=time.monotonic)
    retries: int = 0

    def to(self, state: str) -> None:
        self.state = state
        self.updated_at = time.monotonic()


@dataclass
class ReconcilerConfig:
    request_timeout_s: float = 30.0    # stuck REQUESTED -> retry
    allocate_timeout_s: float = 60.0   # ALLOCATED but node never ALIVE
    max_retries: int = 2
    tick_s: float = 0.5


class InstanceReconciler:
    """Drive instance states toward per-type targets.

    ``provider`` needs ``create_node(node_type) -> node_id`` and
    ``terminate_node(node_id)`` (the v1 ``NodeProvider`` surface).
    ``list_cluster_nodes`` returns the control plane's node table; it
    is injected so the reconciler unit-tests without a runtime.
    """

    def __init__(self, provider, config: Optional[ReconcilerConfig] = None,
                 list_cluster_nodes: Optional[Callable] = None):
        self.provider = provider
        self.config = config or ReconcilerConfig()
        self.instances: Dict[str, Instance] = {}
        self.targets: Dict[str, int] = {}
        self.events: List[str] = []
        self._list_nodes = list_cluster_nodes or self._default_nodes
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_nodes() -> List[Dict[str, Any]]:
        from ray_tpu_torch._private.worker import global_worker
        return global_worker().cp.list_nodes()

    # ------------------------------------------------------------- API
    def set_target(self, node_type: str, count: int) -> None:
        with self._lock:
            self.targets[node_type] = count

    def bump_target(self, node_type: str, delta: int) -> None:
        with self._lock:
            self.targets[node_type] = max(
                0, self.targets.get(node_type, 0) + delta)

    def live_count(self) -> int:
        """Instances being launched or running — callers enforcing a
        max-nodes cap must count these, not just provider-visible
        nodes, or demand overshoots the cap during a slow launch."""
        live = (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING)
        with self._lock:
            return sum(1 for i in self.instances.values()
                       if i.state in live)

    def release_node(self, node_id: bytes) -> bool:
        """Terminate the SPECIFIC instance running ``node_id`` (idle
        scale-down chooses its victim; a bare target decrement would
        let the reconciler pick an arbitrary one).  False when no
        releasable instance matches (caller must not record a
        termination that did not happen)."""
        with self._lock:
            for inst in self.instances.values():
                if inst.node_id == node_id \
                        and inst.state in (RAY_RUNNING, ALLOCATED):
                    inst.to(TERMINATING)
                    self.targets[inst.node_type] = max(
                        0, self.targets.get(inst.node_type, 1) - 1)
                    self._log(f"{inst.instance_id[:8]} released "
                              f"({node_id.hex()[:8]} idle)")
                    return True
        return False

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler-v2")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.config.tick_s):
            try:
                self.reconcile()
            except Exception:  # noqa: BLE001 — heal next tick
                pass

    # ------------------------------------------------------ reconcile
    def _log(self, msg: str) -> None:
        self.events.append(msg)

    def reconcile(self) -> None:
        """One pass: sync with cluster state, heal stuck instances,
        then converge instance counts toward the targets."""
        now = time.monotonic()
        alive = {n["node_id"] for n in self._list_nodes()
                 if n.get("state") == "ALIVE"}
        cfg = self.config
        with self._lock:
            live_states = (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING)
            # 1. observe: allocated instances whose node joined/left
            for inst in self.instances.values():
                if inst.state == ALLOCATED and inst.node_id in alive:
                    inst.to(RAY_RUNNING)
                    self._log(f"{inst.instance_id[:8]} RAY_RUNNING")
                elif inst.state == RAY_RUNNING and \
                        inst.node_id not in alive:
                    # node died underneath us: release the instance
                    inst.to(TERMINATING)
                    self._log(f"{inst.instance_id[:8]} node died")
            # 2. heal: stuck transitions retry (bounded) or fail
            for inst in self.instances.values():
                age = now - inst.updated_at
                if inst.state == REQUESTED and \
                        age > cfg.request_timeout_s:
                    self._retry_or_fail(inst, "request timed out")
                elif inst.state == ALLOCATED and \
                        age > cfg.allocate_timeout_s:
                    # provider gave us a node that never joined: drop
                    # it and retry
                    self._terminate_quiet(inst)
                    self._retry_or_fail(inst, "node never joined")
            # 3. converge per type
            for node_type, want in self.targets.items():
                have = [i for i in self.instances.values()
                        if i.node_type == node_type
                        and i.state in live_states]
                for _ in range(want - len(have)):
                    iid = uuid.uuid4().hex
                    self.instances[iid] = Instance(iid, node_type)
                    self._log(f"{iid[:8]} QUEUED ({node_type})")
                for inst in have[want:] if len(have) > want else []:
                    inst.to(TERMINATING)
                    self._log(f"{inst.instance_id[:8]} excess")
            # snapshot work outside the lock
            to_request = [i for i in self.instances.values()
                          if i.state == QUEUED]
            to_terminate = [i for i in self.instances.values()
                            if i.state == TERMINATING]
            for inst in to_request:
                inst.to(REQUESTED)
        # 4. effect (provider calls block: outside the lock)
        for inst in to_request:
            try:
                node_id = self.provider.create_node(inst.node_type)
                with self._lock:
                    inst.node_id = node_id
                    inst.to(ALLOCATED)
                self._log(f"{inst.instance_id[:8]} ALLOCATED "
                          f"{node_id.hex()[:8]}")
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self._retry_or_fail(inst, f"create failed: {e}")
        for inst in to_terminate:
            self._terminate_quiet(inst)
            with self._lock:
                inst.to(TERMINATED)
            self._log(f"{inst.instance_id[:8]} TERMINATED")

    def _retry_or_fail(self, inst: Instance, why: str) -> None:
        inst.retries += 1
        if inst.retries > self.config.max_retries:
            inst.to(FAILED)
            # surrender the demand slot: leaving the target in place
            # would queue a fresh instance every tick against a
            # provider that keeps failing (quota, bad type)
            self.targets[inst.node_type] = max(
                0, self.targets.get(inst.node_type, 1) - 1)
            self._log(f"{inst.instance_id[:8]} FAILED: {why}")
        else:
            inst.node_id = None
            inst.to(QUEUED)
            self._log(f"{inst.instance_id[:8]} retry "
                      f"{inst.retries}: {why}")

    def _terminate_quiet(self, inst: Instance) -> None:
        if inst.node_id is None:
            return
        try:
            self.provider.terminate_node(inst.node_id)
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        with self._lock:
            by_state: Dict[str, int] = {}
            for inst in self.instances.values():
                by_state[inst.state] = by_state.get(inst.state, 0) + 1
            return {"instances": by_state, "targets": dict(self.targets),
                    "events": list(self.events[-50:])}
