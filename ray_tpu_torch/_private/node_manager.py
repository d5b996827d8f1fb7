# The port's copy of ray_tpu/_private/node_manager.py
"""Node manager — per-node scheduler daemon (raylet-equivalent).

Analogue of the reference raylet (``src/ray/raylet/``):
worker pool (forks language workers), task queueing + dispatch, dependency
management, actor hosting, resource accounting, and spillback to other
nodes.  One NodeManager runs in the head process (serving the driver
in-process) and one per extra node process; they all talk to the same
control plane.

Scheduling follows the reference's hybrid policy shape
(``raylet/scheduling/policy/hybrid_scheduling_policy.cc``): prefer the
local node while utilization is below ``scheduler_spread_threshold``, then
spread by lowest utilization; explicit strategies (spread / node-affinity /
placement-group) override.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import protocol, serialization
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.task_spec import (TaskSpec, acquire, fits, release)
from ray_tpu_torch.exceptions import (ActorDiedError, WorkerCrashedError,
                                      format_remote_traceback)

logger = logging.getLogger(__name__)

_EXIT_SENTINEL = {"type": "exit"}

_CONN_ERRORS = (protocol.ConnectionClosed, ConnectionResetError,
                ConnectionRefusedError, BrokenPipeError, OSError,
                EOFError)


class _ResilientCP:
    """Control-plane client that rides out a head restart.

    Wraps the remote RpcClient: a connection failure blocks and retries
    (bounded) instead of raising, so in-flight bookkeeping — task result
    commits, actor state updates — lands once the restarted head rebinds
    its socket (reference flow: raylet reconnect on NotifyGCSRestart,
    ``node_manager.proto:352``).  Only used for the out-of-process client;
    the head's in-process ControlPlane needs none of this.
    """

    def __init__(self, client, retry_window_s: float = 30.0):
        self._client = client
        self._window = retry_window_s

    def __getattr__(self, name: str):
        target = getattr(self._client, name)

        def call(*args, **kwargs):
            deadline = time.time() + self._window
            while True:
                try:
                    return target(*args, **kwargs)
                except _CONN_ERRORS:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.5)

        call.__name__ = name
        return call


class _ForkedProc:
    """Popen-shaped handle for a worker forked by the forkserver.

    The child is the *template's* child, not ours (and the template
    auto-reaps), so liveness can't use waitpid — and a bare pid check
    is unsafe once the kernel recycles the pid.  Identity is the
    (pid, /proc start_time) pair recorded at fork: poll() reports dead
    and kill()/terminate() become no-ops the moment the pid belongs to
    a different process."""

    def __init__(self, pid: int, start_time: Optional[int] = None):
        self.pid = pid
        self._start_time = start_time

    def _alive(self) -> bool:
        from ray_tpu_torch._private.worker_forkserver import proc_start_time
        if self._start_time is None:
            # the fork reply carried no start_time: the child died and
            # was reaped before it could be stat'ed.  Treat as dead —
            # a bare pid match here could be a recycled pid, and
            # signalling it would hit an unrelated process.
            return False
        now = proc_start_time(self.pid)
        return now is not None and now == self._start_time

    def poll(self) -> Optional[int]:
        return None if self._alive() else 0

    def terminate(self) -> None:
        if not self._alive():
            return
        try:
            os.kill(self.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        if not self._alive():
            return
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.time() + timeout
        while self.poll() is None:
            if deadline is not None and time.time() > deadline:
                raise subprocess.TimeoutExpired(f"pid:{self.pid}",
                                                timeout or 0)
            time.sleep(0.01)
        return 0


def _gpu_request(spec: TaskSpec) -> float:
    """The cards a task requests: its ``"GPU"`` resource, or inside a
    placement group its bundle's (``pg_<id>[_<index>]_GPU``, which
    ``remote_function._apply_pg_resources`` renames it to): the bundle
    reserved the accounting, the task still takes a card of its own."""
    n = spec.resources.get("GPU", 0)
    for name, qty in spec.resources.items():
        if name.startswith("pg_") and name.endswith("_GPU"):
            n += qty
    return n


def _whole_gpus(spec: TaskSpec) -> int:
    """Whole cards a task requests: 0 for none and for a fraction."""
    return int(_gpu_request(spec))


class _Worker:
    """NM-side view of one worker process."""

    def __init__(self, worker_id: bytes, proc: Optional[subprocess.Popen],
                 gpu: bool = False):
        self.worker_id = worker_id
        self.proc = proc
        self.gpu = gpu
        # the card list this GPU worker's process was bound to at its
        # first task, fixed for its life: CUDA reads
        # CUDA_VISIBLE_DEVICES once, when the process initialises it.
        # None = not bound yet; () = bound to no assignment (a
        # fractional request, which takes no card and sees the node's)
        self.devices: Optional[Tuple[int, ...]] = None
        self.sock: Optional[socket.socket] = None
        self.send_lock = threading.Lock()
        self.state = "starting"  # starting | idle | busy | actor | dead
        self.current_task: Optional[TaskSpec] = None
        self.actor_id: Optional[bytes] = None
        self.blocked = False
        self.inflight_actor_tasks: Dict[bytes, TaskSpec] = {}
        self.task_started_at = 0.0
        self.oom_killed: Optional[float] = None  # usage at OOM kill

    def send(self, msg: Any) -> bool:
        if self.sock is None:
            return False
        try:
            with self.send_lock:
                protocol.send_msg(self.sock, msg)
            return True
        except (BrokenPipeError, ConnectionResetError, OSError):
            return False


class _ActorState:
    def __init__(self, creation_spec: TaskSpec):
        self.creation_spec = creation_spec
        self.worker: Optional[_Worker] = None
        self.state = "PENDING"
        self.queued: deque = deque()  # actor TaskSpecs awaiting a live worker
        self.restarts_used = 0
        self.resources = dict(creation_spec.resources)


class _PendingQueues:
    """Ready-to-schedule tasks bucketed by scheduling shape.

    The dispatch loop previously drained and re-queued one flat deque
    each wake: with N queued tasks and bounded worker capacity that is
    O(N) scanned per dispatched task — O(N^2) to drain a 100k backlog.
    A task that cannot dispatch blocks only tasks of its own *shape*
    (same resources + strategy target), so dispatch walks each shape's
    head and stops that shape at the first failure: one wake is
    O(shapes + dispatched).  Reference analogue: per-SchedulingClass
    deques in ``raylet/local_task_manager.h``.
    """

    def __init__(self):
        self._queues: Dict[Any, deque] = {}
        self._count = 0

    @staticmethod
    def shape_key(spec: TaskSpec) -> Any:
        strat = spec.scheduling_strategy
        return (tuple(sorted(spec.resources.items())), strat.kind,
                getattr(strat, "node_id", None),
                getattr(strat, "pg_id", None))

    def append(self, spec: TaskSpec) -> None:
        key = self.shape_key(spec)
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
        q.append(spec)
        self._count += 1

    def push_front(self, key: Any, spec: TaskSpec) -> None:
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
        q.appendleft(spec)
        self._count += 1

    def pop_front(self, key: Any) -> Optional[TaskSpec]:
        q = self._queues.get(key)
        if not q:
            if q is not None:
                del self._queues[key]   # prune drained shapes
            return None
        self._count -= 1
        spec = q.popleft()
        if not q:
            del self._queues[key]
        return spec

    def shapes(self) -> List[Any]:
        return [k for k, q in self._queues.items() if q]

    def shape_counts(self) -> Dict[Any, int]:
        """Pending count per resource shape — O(#shapes), for the
        heartbeat demand vector (key[0] is the sorted resources tuple)."""
        out: Dict[Any, int] = {}
        for key, q in self._queues.items():
            if q:
                out[key[0]] = out.get(key[0], 0) + len(q)
        return out

    def remove(self, task_id: bytes) -> Optional[TaskSpec]:
        for q in self._queues.values():
            for i, spec in enumerate(q):
                if spec.task_id == task_id:
                    del q[i]
                    self._count -= 1
                    return spec
        return None

    def __len__(self) -> int:
        return self._count

    def __iter__(self):
        for q in self._queues.values():
            yield from q


class NodeManager:
    def __init__(self, node_id: bytes, session_dir: str, control_plane,
                 cp_sock_path: str, shm_store, resources: Dict[str, float],
                 node_ip: str = "127.0.0.1", labels: Optional[Dict] = None):
        self.node_id = node_id
        self.session_dir = session_dir
        if isinstance(control_plane, protocol.RpcClient):
            control_plane = _ResilientCP(control_plane)
        self.cp = control_plane  # ControlPlane, or _ResilientCP(RpcClient)
        self.cp_sock_path = cp_sock_path
        self.store = shm_store
        if getattr(shm_store, "on_evict", None) is None:
            # dropped secondary copies must leave the broadcast chain,
            # or later joiners chain off a node that has nothing
            shm_store.on_evict = self._on_store_evict
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.node_ip = node_ip
        self.labels = labels or {}
        self._res_lock = threading.RLock()

        if GLOBAL_CONFIG.use_tcp:
            self.sock_path = f"tcp://{node_ip}:0"
        else:
            self.sock_path = os.path.join(
                session_dir, "sockets", f"nm_{node_id.hex()[:12]}.sock")
        self._server = protocol.RpcServer(self.sock_path, self,
                                          name=f"nm-{node_id.hex()[:6]}")
        self.sock_path = self._server.address  # resolve ephemeral TCP port

        self._workers: Dict[bytes, _Worker] = {}
        self._idle: deque = deque()
        # pre-warmed worker forkserver (lazy; CPU workers only)
        self._forksrv_proc: Optional[subprocess.Popen] = None
        self._forksrv_sock: Optional[socket.socket] = None
        self._forksrv_failed = False
        self._forksrv_lock = threading.RLock()
        self._starting = 0
        self._actors: Dict[bytes, _ActorState] = {}
        self._pending = _PendingQueues()         # ready-to-schedule specs
        self._waiting: Dict[bytes, TaskSpec] = {}  # task_id -> waiting on deps
        # dependency resolution (one resolver thread, not one per task):
        # dep object id -> task ids blocked on it, task id -> unready deps
        self._dep_map: Dict[bytes, set] = {}
        self._task_unready: Dict[bytes, set] = {}
        self._dep_kick = threading.Event()
        self._dep_blocked = False
        self._retries_left: Dict[bytes, int] = {}
        # CP-side effects that outlasted _ResilientCP's retry window
        # (head outage): retried from the heartbeat loop so a caller's
        # get() can't hang forever on a result that was never committed
        self._deferred_cp: List[Any] = []
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stopped = threading.Event()
        # GPU assignment bookkeeping: free card indices, and the cards
        # each busy GPU worker holds
        self._free_devices: List[int] = list(
            range(int(resources.get("GPU", 0))))
        self._worker_devices: Dict[bytes, List[int]] = {}
        # remote node manager clients (for spillback / actor routing)
        self._peers: Dict[bytes, protocol.RpcClient] = {}
        # ---- owned-object reference counts (decentralized ownership,
        # reference: core_worker/reference_count.cc).  This NM owns the
        # lifetime of every object created by its workers/driver; ref
        # holders anywhere in the cluster flush +1/-1 deltas HERE (the
        # CP is out of the per-ref hot path) and _owner_sweep frees
        # owned objects unreferenced past the grace period.
        self._owner_lock = threading.Lock()
        self._owner_by_holder: Dict[bytes, Dict[bytes, int]] = (
            defaultdict(lambda: defaultdict(int)))
        self._owner_totals: Dict[bytes, int] = {}
        self._owner_zero_since: Dict[bytes, float] = {}
        # holder -> {node -> {oid: count}}: per-NODE contributions, so a
        # whole-node death subtracts exactly what that node's processes
        # flushed (its own NM can't send the purge) without touching the
        # same holder's pins from surviving nodes — e.g. the caller-side
        # pre-pin and the hosting NM's pin share the task:<id> holder
        # but live on different nodes.
        self._owner_holder_contrib: Dict[
            bytes, Dict[bytes, Dict[bytes, int]]] = {}
        self._owner_peers: Dict[str, protocol.RpcClient] = {}
        self._last_owner_sweep = time.time()

        self.cp.register_node(node_id, {
            "ip": node_ip,
            "sock_path": self.sock_path,
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "labels": self.labels,
            "session_dir": session_dir,
        })

        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="nm-dispatch", daemon=True)
        self._dispatch_thread.start()
        self._dep_thread = threading.Thread(
            target=self._dep_resolver_loop, name="nm-depresolve",
            daemon=True)
        self._dep_thread.start()
        if GLOBAL_CONFIG.memory_monitor_refresh_ms > 0:
            threading.Thread(target=self._memory_monitor_loop,
                             name="nm-memmon", daemon=True).start()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="nm-heartbeat", daemon=True)
        self._hb_thread.start()
        # Warm the fork template shortly after boot (without waiting):
        # its import cost overlaps cluster setup instead of the first
        # spawn burst.  Deferred a beat — N nodes added together each
        # booting a template AT registration starves the very
        # heartbeats that prove the nodes alive on small hosts.
        def _warm():
            try:
                if self._stopped.is_set():
                    return  # NM shut down before the warm fired
                with self._forksrv_lock:
                    if self._forksrv_sock is None \
                            and not self._forksrv_failed:
                        self._launch_forkserver_proc()
            except Exception:  # noqa: BLE001 — cold spawn still works
                pass
        self._forksrv_warm_timer = threading.Timer(
            GLOBAL_CONFIG.forksrv_warm_delay_s, _warm)
        self._forksrv_warm_timer.daemon = True
        self._forksrv_warm_timer.start()
        for _ in range(GLOBAL_CONFIG.worker_pool_min_workers):
            self._spawn_worker()

    # ------------------------------------------------------------------
    # Public RPC surface (called by drivers/workers via RpcClient, or
    # in-process by the driver).
    # ------------------------------------------------------------------
    def _pin_dependencies(self, spec: TaskSpec) -> None:
        """Keep arg objects alive while the task is queued/running.

        The pin is a refcount held under a per-task holder id, purged when
        the task reaches a terminal state (reference: the submitting
        worker's reference_count.cc holds deps until the task completes).
        Pins route to each dependency's OWNER node manager
        (``spec.ref_owners``); ownerless deps pin at the control plane.
        """
        deps = spec.dependencies()
        if not deps:
            return
        from ray_tpu_torch._private import owner_routing
        owner_routing.route_updates(
            self.cp, self._owner_peer, b"task:" + spec.task_id,
            owner_routing.bucket_by_owner({d: 1 for d in deps},
                                          spec.ref_owners.get),
            holder_node=self.node_id,
            local_addr=self.sock_path, local=self.update_owned_refs)

    def _unpin_dependencies(self, spec: TaskSpec) -> None:
        deps = spec.dependencies()
        if not deps:
            return
        from ray_tpu_torch._private import owner_routing
        owner_routing.route_purge(
            self.cp, self._owner_peer, b"task:" + spec.task_id,
            {spec.ref_owners.get(d) for d in deps},
            local_addr=self.sock_path, local=self.purge_owned_holder)

    # ------------------------------------------------------------------
    # Owned-object refcounting (this NM = owner).  RPC surface used by
    # ref trackers, pinning NMs, and caller-side pre-pins cluster-wide.
    # ------------------------------------------------------------------
    def _owner_peer(self, addr: str) -> protocol.RpcClient:
        client = self._owner_peers.get(addr)
        if client is None:
            client = protocol.RpcClient(addr)
            self._owner_peers[addr] = client
        return client

    def update_owned_refs(self, holder_id: bytes,
                          deltas: Dict[bytes, int],
                          holder_node: bytes = b"") -> None:
        now = time.time()
        with self._owner_lock:
            if holder_node:
                contrib = self._owner_holder_contrib.setdefault(
                    holder_id, {}).setdefault(holder_node, {})
            held = self._owner_by_holder[holder_id]
            for oid, d in deltas.items():
                oid = bytes(oid)
                if holder_node:
                    c = contrib.get(oid, 0) + d
                    if c:
                        contrib[oid] = c
                    else:
                        contrib.pop(oid, None)
                held[oid] += d
                if held[oid] == 0:
                    held.pop(oid)
                total = self._owner_totals.get(oid, 0) + d
                if total > 0:
                    self._owner_totals[oid] = total
                    self._owner_zero_since.pop(oid, None)
                else:
                    # net<=0: born-and-dropped within one flush window,
                    # or a drop against untracked state — either way the
                    # object is now unreferenced
                    self._owner_totals.pop(oid, None)
                    self._owner_zero_since.setdefault(oid, now)
            if not held:
                self._owner_by_holder.pop(holder_id, None)

    def purge_owned_holder(self, holder_id: bytes) -> None:
        """Drop every count a (finished task / dead process) holder
        contributed to objects owned here."""
        with self._owner_lock:
            held = self._owner_by_holder.pop(holder_id, None)
            self._owner_holder_contrib.pop(holder_id, None)
        if held:
            self.update_owned_refs(b"_purge",
                                   {o: -d for o, d in held.items()})
            with self._owner_lock:
                self._owner_by_holder.pop(b"_purge", None)

    def purge_owned_node_holders(self, node_id: bytes) -> None:
        """A whole node died: subtract exactly the contributions flushed
        here by processes on that node (their NM died with them; the
        head broadcasts this from its node-death handler).  Holders with
        pins from surviving nodes keep those pins."""
        with self._owner_lock:
            victims = []
            for h, nodes in list(self._owner_holder_contrib.items()):
                contrib = nodes.pop(node_id, None)
                if contrib:
                    # clamp to what the holder still actually holds: a
                    # stale/negative contribution must not resurrect an
                    # emptied holder (the defaultdict would recreate it
                    # with residual counts nothing will ever purge)
                    held = (self._owner_by_holder.get(h) or {})
                    deltas = {}
                    for oid, d in contrib.items():
                        take = min(d, held.get(oid, 0))
                        if take > 0:
                            deltas[oid] = -take
                    if deltas:
                        victims.append((h, deltas))
                if not nodes:
                    self._owner_holder_contrib.pop(h, None)
        for h, deltas in victims:
            self.update_owned_refs(h, deltas)

    def debug_state(self) -> Dict[str, Any]:
        """Introspection snapshot for ``ray-tpu stack``-style debugging:
        queue depths, worker states, per-actor queue lengths."""
        with self._lock:
            return {
                "pending": len(self._pending),
                "waiting": len(self._waiting),
                "workers": {w.worker_id.hex()[:12]:
                            {"state": w.state,
                             "task": (w.current_task.name
                                      if w.current_task else None),
                             "inflight_actor_tasks":
                             len(w.inflight_actor_tasks)}
                            for w in self._workers.values()},
                "actors": {aid.hex()[:12]:
                           {"state": st.state,
                            "queued": len(st.queued),
                            "worker": (st.worker.worker_id.hex()[:12]
                                       if st.worker else None)}
                           for aid, st in self._actors.items()},
            }

    def signal_stack_dump(self) -> List[int]:
        """``ray stack`` equivalent (reference: py-spy-based
        ``python/ray/scripts/scripts.py stack``): SIGUSR1 every live
        worker — their registered faulthandler writes all-thread python
        tracebacks to their log files — and dump this NM process's own
        threads to stderr.  Returns the signalled pids."""
        import faulthandler
        import signal as _signal
        pids: List[int] = []
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if w.proc is not None and w.state != "dead":
                try:
                    os.kill(w.proc.pid, _signal.SIGUSR1)
                    pids.append(w.proc.pid)
                except (ProcessLookupError, PermissionError):
                    pass
        faulthandler.dump_traceback(all_threads=True)
        return pids

    def owned_refs_summary(self) -> Dict[str, int]:
        with self._owner_lock:
            return {"tracked_objects": len(self._owner_totals),
                    "holders": len(self._owner_by_holder),
                    "zero_pending": len(self._owner_zero_since)}

    def _owner_sweep(self) -> None:
        """Free owned objects unreferenced past the grace period: drop
        their directory entries at the CP in one batch, then fan the shm
        deletion out to every node (the owner drives GC; the CP is
        touched once per object lifetime, not per ref event)."""
        grace = GLOBAL_CONFIG.object_gc_grace_s
        now = time.time()
        cutoff = now - grace
        with self._owner_lock:
            victims = [o for o, t0 in self._owner_zero_since.items()
                       if t0 < cutoff]
        if not victims:
            return
        res = self.cp.free_owned(victims)
        freed = res["freed"]
        with self._owner_lock:
            for o in freed:
                self._owner_zero_since.pop(o, None)
                self._owner_totals.pop(o, None)
            # ids never committed: keep briefly (commit may be in
            # flight), forget zero-marks that stayed uncommitted long
            # past the grace
            for o in res["pending"]:
                if self._owner_zero_since.get(o, now) < cutoff - 60.0:
                    self._owner_zero_since.pop(o, None)
        if not freed:
            return
        self.delete_objects(freed)
        for info in self.cp.list_nodes():
            if (info.get("state") != "ALIVE"
                    or info["node_id"] == self.node_id):
                continue
            try:
                self._owner_peer(info["sock_path"]).call(
                    "delete_objects", freed)
            except (OSError, ConnectionError):
                pass

    def submit_task(self, spec: TaskSpec) -> None:
        self._pin_dependencies(spec)
        self.cp.add_lineage(spec.task_id, spec)
        with self._lock:
            self._retries_left.setdefault(spec.task_id, spec.max_retries)
            self._pending.append(spec)
        self.cp.add_task_event({"task_id": spec.task_id.hex(),
                                "name": spec.name, "state": "PENDING",
                                "node": self.node_id.hex()})
        self._wake.set()

    def submit_actor_creation(self, spec: TaskSpec) -> None:
        assert spec.actor_creation and spec.actor_id
        self._pin_dependencies(spec)
        with self._lock:
            self._actors[spec.actor_id] = _ActorState(spec)
            self._pending.append(spec)
        self._wake.set()

    def _satrace(self, *parts) -> None:
        from ray_tpu_torch._private.debug_trace import trace
        trace("submit_actor_task", *parts, var="RAY_TPU_DEBUG_FREE")

    def submit_actor_task(self, spec: TaskSpec) -> None:
        """Queue a method call on an actor hosted by this node."""
        self._pin_dependencies(spec)
        with self._lock:
            astate = self._actors.get(spec.actor_id)
            if astate is None or astate.state == "DEAD":
                self._satrace("DROP dead", spec.name, spec.task_id.hex()[:20])
                self._fail_task(spec, ActorDiedError(
                    spec.actor_id.hex() if spec.actor_id else "",
                    "actor not found or dead"))
                return
            # dedup (best-effort, matching the reference's at-least-once
            # retry semantics): drop a resend whose twin is queued,
            # in flight, or already committed a result
            if any(t.task_id == spec.task_id for t in astate.queued) or (
                    astate.worker is not None and spec.task_id in
                    astate.worker.inflight_actor_tasks):
                self._satrace("DROP dup-queued", spec.name,
                              spec.task_id.hex()[:20])
                return
            ret_ids = spec.return_object_ids()
            if ret_ids:
                try:
                    if self.cp.get_location(ret_ids[0]) is not None:
                        self._satrace("DROP committed", spec.name,
                                      spec.task_id.hex()[:20])
                        return  # the retried copy already finished
                except Exception:  # noqa: BLE001
                    pass
            self._satrace("QUEUE", spec.name, spec.task_id.hex()[:20],
                          "astate", astate.state,
                          "worker", bool(astate.worker))
            astate.queued.append(spec)
            self._flush_actor_queue_locked(astate)
        self._wake.set()

    def kill_actor(self, actor_id: bytes, no_restart: bool = True) -> bool:
        with self._lock:
            astate = self._actors.get(actor_id)
            if astate is None:
                return False
            if no_restart:
                astate.restarts_used = astate.creation_spec.max_restarts + 1
            worker = astate.worker
        if worker is not None and worker.proc is not None:
            worker.proc.terminate()
        elif worker is not None:
            # in-process actor (driver-hosted) — not supported; mark dead
            self._on_actor_worker_death(astate, "killed")
        return True

    def cancel_task(self, task_id: bytes) -> bool:
        from ray_tpu_torch.exceptions import TaskCancelledError
        with self._lock:
            spec = self._pending.remove(task_id)
            if spec is None:
                spec = self._waiting.pop(task_id, None)
                if spec is not None:
                    # drop its dependency bookkeeping
                    for d in self._task_unready.pop(task_id, ()):
                        tids = self._dep_map.get(d)
                        if tids is not None:
                            tids.discard(task_id)
                            if not tids:
                                del self._dep_map[d]
        if spec is not None:
            self._fail_task(spec, TaskCancelledError(task_id.hex()))
            return True
        return False

    def node_stats(self) -> Dict[str, Any]:
        with self._lock, self._res_lock:
            return {
                "node_id": self.node_id.hex(),
                "resources_total": dict(self.resources_total),
                "resources_available": dict(self.resources_available),
                "num_workers": len(self._workers),
                "num_idle": len(self._idle),
                "num_pending": len(self._pending),
                "num_waiting": len(self._waiting),
                "num_actors": len(self._actors),
                "store": self.store.stats(),
            }

    def reserve_bundle(self, pg_id: bytes, bundle_index: int,
                       resources: Dict[str, float]) -> bool:
        """Placement-group 2PC 'prepare+commit' collapsed to one step.

        Mirrors the effect of the reference's
        ``PrepareBundleResources``/``CommitBundleResources``
        (``protobuf/node_manager.proto``): on success the node exposes
        bundle-indexed custom resources that PG-scheduled tasks consume.
        """
        wildcard = f"pg_{pg_id.hex()}"
        indexed = f"pg_{pg_id.hex()}_{bundle_index}"
        with self._res_lock:
            if not fits(self.resources_available, resources):
                return False
            acquire(self.resources_available, resources)
            for name, qty in resources.items():
                self.resources_total[f"{indexed}_{name}"] = qty
                self.resources_available[f"{indexed}_{name}"] = qty
                self.resources_total[f"{wildcard}_{name}"] = (
                    self.resources_total.get(f"{wildcard}_{name}", 0) + qty)
                self.resources_available[f"{wildcard}_{name}"] = (
                    self.resources_available.get(f"{wildcard}_{name}", 0)
                    + qty)
        self._wake.set()
        return True

    def return_bundle(self, pg_id: bytes, bundle_index: int,
                      resources: Dict[str, float]) -> None:
        wildcard = f"pg_{pg_id.hex()}"
        indexed = f"pg_{pg_id.hex()}_{bundle_index}"
        with self._res_lock:
            for name, qty in resources.items():
                self.resources_total.pop(f"{indexed}_{name}", None)
                self.resources_available.pop(f"{indexed}_{name}", None)
                wkey = f"{wildcard}_{name}"
                if wkey in self.resources_total:
                    self.resources_total[wkey] -= qty
                    self.resources_available[wkey] = (
                        self.resources_available.get(wkey, 0) - qty)
                    if self.resources_total[wkey] <= 0:
                        self.resources_total.pop(wkey, None)
                        self.resources_available.pop(wkey, None)
            release(self.resources_available, resources)
        self._wake.set()

    def shutdown_node(self) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # Object pull protocol (node-to-node transfer; reference:
    # object_manager.cc Push/Pull + chunk_object_reader.cc)
    # ------------------------------------------------------------------
    def fetch_object_meta(self, object_id: bytes) -> Optional[Dict[str, Any]]:
        view = self.store.get_view(object_id)
        if view is None:
            return None
        meta = {"size": len(view), "ip": self.node_ip}
        # same-host fastpath: a co-hosted puller kernel-copies the
        # sealed file instead of pulling RPC chunks
        path = self.store.sealed_path(object_id)
        if path:
            meta["path"] = path
        return meta

    def push_object_chunk(self, object_id: bytes, total: int,
                          offset: int, data: bytes) -> bool:
        """Receive one chunk of an object pushed by a cross-host client
        driver (its local store isn't reachable from the cluster, so the
        primary copy lands here; reference: object_manager Push RPCs)."""
        return self.store.write_push_chunk(object_id, total, offset,
                                           data)

    def fetch_object_chunk(self, object_id: bytes, offset: int,
                           length: int) -> Optional[bytes]:
        return self.store.read_chunk(object_id, offset, length)

    def fetch_partial_chunk(self, object_id: bytes, offset: int,
                            length: int):
        """Broadcast-chain read: serve from a sealed copy OR the prefix
        an in-progress pull on this node has already written (None =
        not there yet; the downstream puller polls).  ``{"gone": True}``
        = no copy and no pull in flight here — the puller should stop
        polling and re-chain instead of waiting out its stall budget."""
        data = self.store.read_partial_chunk(object_id, offset, length)
        if data is None and not self.store.has_any_copy(object_id):
            return {"gone": True}
        return data

    # ------------------------------------------------------------------
    # Log access (``ray logs`` parity + dashboard log pane; reference:
    # dashboard/modules/log/log_agent.py serves per-node worker logs)
    # ------------------------------------------------------------------
    def list_logs(self) -> List[Dict[str, Any]]:
        log_dir = os.path.join(self.session_dir, "logs")
        out: List[Dict[str, Any]] = []
        try:
            for name in sorted(os.listdir(log_dir)):
                path = os.path.join(log_dir, name)
                if os.path.isfile(path):
                    out.append({"name": name,
                                "size": os.path.getsize(path),
                                "mtime": os.path.getmtime(path)})
        except OSError:
            pass
        return out

    def tail_log(self, name: str,
                 nbytes: int = 65536) -> Optional[bytes]:
        """Last ``nbytes`` of a session log, or None when this node
        doesn't have that file (callers probe several nodes)."""
        if os.sep in name or name.startswith("."):
            raise ValueError(f"bad log name {name!r}")
        path = os.path.join(self.session_dir, "logs", name)
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(max(0, size - nbytes))
                return f.read(nbytes)
        except OSError:
            return None

    def delete_objects(self, object_ids: List[bytes]) -> int:
        """GC fan-out target: drop local shm copies of freed objects."""
        n = 0
        for oid in object_ids:
            if self.store.delete(oid):
                self._on_store_evict(oid)
                n += 1
        return n

    def _on_store_evict(self, object_id: bytes) -> None:
        """A local copy was dropped: leave the object's broadcast chain
        so downstream pullers aren't pointed at an empty parent."""
        try:
            self.cp.leave_broadcast(object_id, self.node_id)
        except Exception:  # noqa: BLE001 — bookkeeping best-effort
            pass

    # ------------------------------------------------------------------
    # Worker channel (hijacked connection)
    # ------------------------------------------------------------------
    def stream_worker(self, conn: socket.socket, worker_id: bytes) -> None:
        """A worker process registered its task channel."""
        with self._lock:
            worker = self._workers.get(worker_id)
            if worker is None:
                worker = _Worker(worker_id, None)
                self._workers[worker_id] = worker
            worker.sock = conn
            worker.state = "idle"
            self._starting = max(0, self._starting - 1)
            self._idle.append(worker)
        self._wake.set()
        self._worker_reader(worker)

    _CONN_ERRORS = _CONN_ERRORS

    def _worker_reader(self, worker: _Worker) -> None:
        """Two distinct failure domains: the worker socket (worker died —
        run death handling) and control-plane calls made while handling a
        message (head outage — _ResilientCP block-retries through the
        restart; this branch is the backstop for an outage longer than
        its window)."""
        while True:
            try:
                msg = protocol.recv_msg(worker.sock)
            except self._CONN_ERRORS:
                break
            try:
                self._handle_worker_msg(worker, msg)
            except self._CONN_ERRORS:
                logger.error(
                    "control plane unreachable handling %s from worker "
                    "%s; message dropped", msg.get("type"),
                    worker.worker_id.hex()[:12])
        try:
            self._on_worker_death(worker)
        except self._CONN_ERRORS:
            logger.error("control plane unreachable reporting death of "
                         "worker %s", worker.worker_id.hex()[:12])

    def _handle_worker_msg(self, worker: _Worker, msg: Dict[str, Any]):
        kind = msg.get("type")
        if kind == "done":
            task_id = msg["task_id"]
            with self._lock:
                if worker.actor_id is not None:
                    done_actor_spec = worker.inflight_actor_tasks.pop(
                        task_id, None)
                    spec = None
                else:
                    done_actor_spec = None
                    spec = worker.current_task
                    worker.current_task = None
            if done_actor_spec is not None:
                self._unpin_dependencies(done_actor_spec)
            if spec is not None:
                self._release_task_resources(spec, worker)
                retrying = False
                if msg.get("error") and msg.get("error_payload") is not None:
                    # Application exception with retry_exceptions=True: the
                    # worker deferred the error commit so we can resubmit.
                    with self._lock:
                        left = self._retries_left.get(spec.task_id, 0)
                        if left > 0:
                            self._retries_left[spec.task_id] = left - 1
                            self._pending.append(spec)
                            retrying = True
                    if not retrying:
                        def commit_error(spec=spec,
                                         payload=msg["error_payload"]):
                            for oid in spec.return_object_ids():
                                self.cp.put_inline(
                                    oid, payload, is_error=True,
                                    owner_addr=spec.owner_addr)
                            self._fail_generator_stream(spec, payload)
                        self._cp_effect_or_defer(commit_error)
                with self._lock:
                    if not retrying:
                        self._retries_left.pop(spec.task_id, None)
                    if worker.state == "busy":
                        worker.state = "idle"
                        self._idle.append(worker)
                if not retrying:
                    self._unpin_dependencies(spec)
            self.cp.add_task_event({
                "task_id": task_id.hex(), "state": "FINISHED"
                if not msg.get("error") else "FAILED",
                "node": self.node_id.hex()})
            self._wake.set()
        elif kind == "actor_ready":
            with self._lock:
                astate = self._actors.get(msg["actor_id"])
                if astate is not None:
                    astate.state = "ALIVE"
                    astate.worker = worker
                    worker.actor_id = msg["actor_id"]
                    worker.state = "actor"
                    self._flush_actor_queue_locked(astate)
            def publish_alive(actor_id=msg["actor_id"], pid=msg.get("pid")):
                self.cp.update_actor(actor_id, state="ALIVE",
                                     node_id=self.node_id,
                                     nm_sock=self.sock_path, pid=pid)
            self._cp_effect_or_defer(publish_alive)
            self._wake.set()
        elif kind == "actor_init_failed":
            with self._lock:
                astate = self._actors.get(msg["actor_id"])
                spec = worker.current_task
                worker.current_task = None
                worker.actor_id = None
            if spec is not None:
                self._release_task_resources(spec, worker)
            with self._lock:
                # recycle the worker: the failed __init__ left no state
                worker.state = "idle"
                self._idle.append(worker)
            if astate is not None:
                # Creation raised: do not restart, error is in the object.
                astate.restarts_used = astate.creation_spec.max_restarts + 1
                self._on_actor_worker_death(astate, "init failed",
                                            from_msg=True, worker=worker)
            self._wake.set()
        elif kind == "blocked":
            # Worker blocked in get(): release its CPU so the node can run
            # other tasks (reference: CPU borrowing while blocked).
            with self._lock:
                if not worker.blocked and worker.current_task:
                    worker.blocked = True
                    cpus = worker.current_task.resources.get("CPU", 0)
                    if cpus:
                        with self._res_lock:
                            release(self.resources_available, {"CPU": cpus})
            self._wake.set()
        elif kind == "unblocked":
            with self._lock:
                if worker.blocked and worker.current_task:
                    worker.blocked = False
                    cpus = worker.current_task.resources.get("CPU", 0)
                    if cpus:
                        with self._res_lock:
                            acquire(self.resources_available, {"CPU": cpus})
        elif kind == "exit":
            with self._lock:
                worker.state = "dead"

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------
    def _dispatch_loop(self):
        while not self._stopped.is_set():
            self._wake.wait(timeout=0.2)
            self._wake.clear()
            try:
                self._dispatch_once()
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    def _dispatch_once(self):
        with self._lock:
            shape_keys = self._pending.shapes()
        for key in shape_keys:
            while not self._stopped.is_set():
                with self._lock:
                    spec = self._pending.pop_front(key)
                if spec is None:
                    break
                deps = spec.dependencies()
                if deps:
                    locs = self.cp.get_locations(deps)
                    unready = [d for d in deps if locs.get(d) is None]
                    if unready:
                        self._register_dep_wait(spec, unready)
                        continue
                if not self._try_dispatch(spec):
                    with self._lock:
                        # head-of-shape blocks only its own shape
                        self._pending.push_front(key, spec)
                    break

    def _register_dep_wait(self, spec: TaskSpec, deps: List[bytes]):
        with self._lock:
            self._waiting[spec.task_id] = spec
            pend = self._task_unready.setdefault(spec.task_id, set())
            for d in deps:
                pend.add(d)
                self._dep_map.setdefault(d, set()).add(spec.task_id)
            blocked = self._dep_blocked
        self._dep_kick.set()
        if blocked:
            # interrupt the resolver's standing server-side wait so the
            # new ids join the waited set
            try:
                self.cp.kick_waiters(self.node_id)
            except Exception:  # noqa: BLE001
                pass

    def _dep_resolver_loop(self):
        """One thread resolves all tasks' dependencies.

        Replaces the thread-per-waiting-task design (10k queued tasks
        meant 10k ``nm-depwait`` threads): a single standing
        ``cp.wait_any`` over the union of unready deps, interrupted via
        ``kick_waiters`` when registration adds new ids.  Reference
        analogue: ``raylet/dependency_manager.cc``.
        """
        while not self._stopped.is_set():
            # snapshot + blocked flag under ONE lock acquisition: a task
            # registering after the snapshot then sees blocked=True and
            # sends a kick; the CP keeps kicks sticky so one that lands
            # before wait_any registers its waiter is consumed on entry
            # instead of lost (30s stall otherwise).
            with self._lock:
                deps = list(self._dep_map)
                if deps:
                    self._dep_blocked = True
            if not deps:
                self._dep_kick.wait(timeout=1.0)
                self._dep_kick.clear()
                continue
            try:
                ready = self.cp.wait_any(deps, 1, 30.0, kick=self.node_id)
            except Exception:  # noqa: BLE001
                if self._stopped.is_set():
                    return
                time.sleep(0.5)
                continue
            finally:
                with self._lock:
                    self._dep_blocked = False
            self._dep_kick.clear()
            if ready:
                self._resolve_deps(ready)

    def _resolve_deps(self, ready: List[bytes]):
        moved = False
        with self._lock:
            for d in ready:
                for tid in self._dep_map.pop(d, ()):
                    pend = self._task_unready.get(tid)
                    if pend is None:
                        continue
                    pend.discard(d)
                    if not pend:
                        del self._task_unready[tid]
                        spec = self._waiting.pop(tid, None)
                        if spec is not None:
                            self._pending.append(spec)
                            moved = True
        if moved:
            self._wake.set()

    def _pick_node(self, spec: TaskSpec) -> Optional[Dict[str, Any]]:
        """Choose a target node; None => run locally.

        Raises :class:`InfeasibleTaskError` for tasks no node can ever
        satisfy (the reference surfaces infeasible-task warnings instead
        of silently requeueing forever) and for hard affinity to a dead
        node.
        """
        from ray_tpu_torch.exceptions import InfeasibleTaskError
        strategy = spec.scheduling_strategy
        nodes = [n for n in self.cp.list_nodes() if n["state"] == "ALIVE"]
        if strategy.kind == "node_affinity":
            if strategy.node_id == self.node_id:
                return None
            for n in nodes:
                if n["node_id"] == strategy.node_id:
                    return n
            if strategy.soft:
                return None
            raise InfeasibleTaskError(
                f"task {spec.name!r} has hard affinity to node "
                f"{strategy.node_id.hex()[:12]}, which is not alive")
        if strategy.kind == "spread":
            # Least-loaded first (queue depth from heartbeats, locally from
            # live state), round-robin only to break ties between bursts
            # (reference: spread_scheduling_policy.cc sorts by load).
            candidates = sorted(
                (n for n in nodes
                 if fits(n.get("resources_total", {}), spec.resources)
                 or n["node_id"] == self.node_id),
                key=lambda n: n["node_id"])
            if not candidates:
                return None

            def _queue_depth(n):
                if n["node_id"] == self.node_id:
                    with self._lock:
                        return len(self._pending) + len(self._waiting)
                return n.get("load", {}).get("num_pending", 0)

            depths = [_queue_depth(n) for n in candidates]
            least = min(depths)
            tied = [n for n, d in zip(candidates, depths) if d == least]
            self._spread_rr = getattr(self, "_spread_rr", -1) + 1
            best = tied[self._spread_rr % len(tied)]
            return None if best["node_id"] == self.node_id else best
        # default hybrid: local first if it can ever fit and is under
        # the spread threshold; else best remote fit.
        with self._res_lock:
            local_fits_now = fits(self.resources_available, spec.resources)
            local_fits_ever = fits(self.resources_total, spec.resources)
            total_cpu = self.resources_total.get("CPU", 0) or 1
            local_util = 1.0 - (self.resources_available.get("CPU", 0)
                                / total_cpu)
        if local_fits_now:
            return None
        if (local_fits_ever
                and local_util < GLOBAL_CONFIG.scheduler_spread_threshold):
            return None
        for n in nodes:
            if n["node_id"] == self.node_id:
                continue
            if fits(n.get("resources_available", {}), spec.resources):
                return n
        if local_fits_ever:
            return None
        if not any(fits(n.get("resources_total", {}), spec.resources)
                   for n in nodes):
            # an active autoscaler may be able to PROVISION a fitting
            # node type: keep the task queued (its shape rides the
            # heartbeat demand vector) instead of failing it — the
            # reference keeps infeasible tasks pending with warnings
            if self._provisionable(spec.resources):
                return None
            raise InfeasibleTaskError(
                f"task {spec.name!r} requests {spec.resources}, which no "
                f"node in the cluster can ever satisfy")
        return None  # a node could fit it later; keep requeueing

    def _provisionable(self, resources: Dict[str, float]) -> bool:
        """True if an autoscaler has registered a node type whose shape
        could satisfy these resources.  The registry blob is TTL-cached:
        this runs on every dispatch retry of an infeasible-shaped task,
        and an identical CP read ~5x/s per shape adds up."""
        now = time.time()
        cached = getattr(self, "_node_types_cache", None)
        if cached is None or now - cached[0] > 5.0:
            types = None
            try:
                blob = self.cp.kv_get(b"node_types",
                                      namespace="_autoscaler")
                if blob:
                    import json
                    types = json.loads(blob)
            except Exception:  # noqa: BLE001
                types = None
            cached = (now, types)
            self._node_types_cache = cached
        types = cached[1]
        if not types:
            return False
        return any(fits(shape, resources) for shape in types.values())

    def _try_dispatch(self, spec: TaskSpec) -> bool:
        from ray_tpu_torch.exceptions import InfeasibleTaskError
        try:
            target = self._pick_node(spec)
        except InfeasibleTaskError as e:
            if spec.actor_creation and spec.actor_id:
                self.cp.update_actor(spec.actor_id, state="DEAD",
                                     death_reason=str(e))
            self._fail_task(spec, e)
            return True  # terminally handled; do not requeue
        if target is not None:
            try:
                peer = self._peer_client(target)
                if spec.actor_creation:
                    peer.call("submit_actor_creation", spec)
                else:
                    peer.call("submit_task", spec)
                return True
            except (OSError, ConnectionError):
                pass  # fall through to local
        with self._res_lock:
            if not fits(self.resources_available, spec.resources):
                return False
            acquire(self.resources_available, spec.resources)
        need_gpu = _gpu_request(spec) > 0
        worker = self._take_idle_worker(need_gpu, _whole_gpus(spec))
        if worker is None:
            with self._res_lock:
                release(self.resources_available, spec.resources)
            # spawn toward the whole same-shape backlog, not one worker
            # per dispatch wake (this spec + everything queued behind it)
            with self._lock:
                backlog = 1 + len(self._pending._queues.get(
                    _PendingQueues.shape_key(spec), ()))
            self._maybe_spawn_worker(need_gpu, count=backlog)
            return False
        try:
            devices = self._assign_devices(spec, worker)
        except RuntimeError as e:
            print(f"[node_manager] {e}; requeueing task", file=sys.stderr)
            with self._lock:
                worker.state = "idle"
                self._idle.append(worker)
            with self._res_lock:
                release(self.resources_available, spec.resources)
            return False
        with self._lock:
            worker.current_task = spec
            worker.task_started_at = time.time()
            worker.state = "busy" if not spec.actor_creation else "actor"
        ok = worker.send({"type": "task", "spec": spec,
                          "devices": devices})
        if not ok:
            self._on_worker_death(worker)
            return False
        self.cp.add_task_event({"task_id": spec.task_id.hex(),
                                "name": spec.name, "state": "RUNNING",
                                "node": self.node_id.hex(),
                                "worker": worker.worker_id.hex()})
        return True

    def _flush_actor_queue_locked(self, astate: _ActorState):
        if astate.state != "ALIVE" or astate.worker is None:
            return
        while astate.queued:
            spec = astate.queued.popleft()
            astate.worker.inflight_actor_tasks[spec.task_id] = spec
            if not astate.worker.send({"type": "task", "spec": spec,
                                       "devices": None}):
                astate.queued.appendleft(spec)
                astate.worker.inflight_actor_tasks.pop(spec.task_id, None)
                break

    # ------------------------------------------------------------------
    # Worker pool
    # ------------------------------------------------------------------
    def _take_idle_worker(self, need_gpu: bool = False,
                          n_gpus: int = 0) -> Optional[_Worker]:
        """An idle worker of the right kind.  A GPU worker is reused only
        for a task it can serve without changing its card list: first a
        worker bound to ``n_gpus`` cards that are all free (to no card,
        for a fraction), else one not bound yet."""
        free = None
        if need_gpu:
            with self._res_lock:
                free = set(self._free_devices)

        def fits_bound(w: _Worker) -> bool:
            if n_gpus == 0:
                return w.devices == ()
            return (w.devices is not None and len(w.devices) == n_gpus
                    and free.issuperset(w.devices))

        with self._lock:
            passes = ([fits_bound, lambda w: w.devices is None]
                      if need_gpu else [lambda w: True])
            for ok in passes:
                for i, w in enumerate(self._idle):
                    if (w.state == "idle" and w.sock is not None
                            and w.gpu == need_gpu and ok(w)):
                        del self._idle[i]
                        return w
            # clean out dead entries
            self._idle = deque(w for w in self._idle
                               if w.state == "idle" and w.sock is not None)
            return None

    def _maybe_spawn_worker(self, gpu: bool = False, count: int = 1):
        """Spawn up to ``count`` workers toward the pending backlog.

        Worker startup cost is dominated by the child's imports, which
        parallelize across processes — so an actor-creation burst (128
        actors = 128 workers) spawns in batches instead of one per
        dispatch wake (the round-4 probe measured 2 actors/s precisely
        because of that serialization).  ``_starting`` still bounds the
        in-flight forks so a tight dispatch loop cannot fork-bomb.
        """
        spawn = 0
        with self._lock:
            max_concurrent_starts = GLOBAL_CONFIG.worker_max_concurrent_starts
            max_workers = int(self.resources_total.get("CPU", 1)) + 64
            while (spawn < count
                   and self._starting + spawn < max_concurrent_starts
                   and (len(self._workers) + self._starting + spawn
                        < max_workers)):
                spawn += 1
            self._starting += spawn
        for _ in range(spawn):
            self._spawn_worker(gpu)

    def _worker_env(self, worker_id: bytes, gpu: bool) -> Dict[str, str]:
        env = dict(os.environ)
        parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p]
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        if repo_root not in parts:
            parts.append(repo_root)
        env["PYTHONPATH"] = os.pathsep.join(parts)
        if not gpu:
            # CPU workers (and the forkserver template they fork from)
            # see no card: a task that imports torch there finds CUDA
            # unavailable instead of taking a card from the workers
            # that requested the GPU resource.  GPU workers set the
            # variable from their card list at their first task
            # (worker_proc._set_visible_devices).
            env["CUDA_VISIBLE_DEVICES"] = ""
        env.update({
            "RAY_TPU_SESSION_DIR": self.session_dir,
            "RAY_TPU_CP_SOCK": self.cp_sock_path,
            "RAY_TPU_NM_SOCK": self.sock_path,
            "RAY_TPU_WORKER_ID": worker_id.hex(),
            "RAY_TPU_NODE_ID": self.node_id.hex(),
            "RAY_TPU_SHM_ROOT": self.store.root,
            "RAY_TPU_SPILL_DIR": self.store.spill_dir or "",
            "RAY_TPU_LOG_TO_DRIVER":
                "1" if GLOBAL_CONFIG.log_to_driver else "0",
        })
        return env

    def _forksrv_sock_path(self) -> str:
        return os.path.join(
            self.session_dir, "sockets",
            f"forksrv_{self.node_id.hex()[:12]}.sock")

    def _launch_forkserver_proc(self) -> None:
        """Start the template process WITHOUT waiting for it.

        Called at NM boot so the template's import cost overlaps with
        cluster setup instead of landing inside the first actor/task
        spawn burst (on a 1-core host, N nodes lazily booting N
        templates serializes ~N x seconds into the creation window)."""
        sock_path = self._forksrv_sock_path()
        if self._forksrv_proc is not None and \
                self._forksrv_proc.poll() is None:
            return
        env = self._worker_env(b"\0" * 16, gpu=False)
        env["RAY_TPU_FORKSRV_SOCK"] = sock_path
        os.makedirs(os.path.dirname(sock_path), exist_ok=True)
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(log_dir, "forkserver.log"), "ab")
        self._forksrv_proc = subprocess.Popen(
            [sys.executable, "-m",
             "ray_tpu_torch._private.worker_forkserver"],
            env=env, stdout=out, stderr=subprocess.STDOUT)
        out.close()

    def _ensure_forkserver(self) -> Optional[protocol.RpcClient]:
        """Start (once) and connect to the pre-warmed worker forkserver.

        Returns the connected socket wrapper, or None if the template
        is unavailable (caller falls back to cold spawn)."""
        with self._forksrv_lock:
            if self._forksrv_sock is not None:
                return self._forksrv_sock
            if self._forksrv_failed:
                return None
            sock_path = self._forksrv_sock_path()
            if self._forksrv_proc is None or \
                    self._forksrv_proc.poll() is not None:
                self._launch_forkserver_proc()
            deadline = time.time() + 30.0
            while time.time() < deadline:
                try:
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.connect(sock_path)
                    self._forksrv_sock = s
                    return s
                except (FileNotFoundError, ConnectionRefusedError, OSError):
                    if self._forksrv_proc.poll() is not None:
                        break
                    time.sleep(0.05)
            self._forksrv_failed = True
            return None

    def _fork_worker(self, worker_id: bytes, env: Dict[str, str],
                     log_path: str) -> "Optional[tuple]":
        """Ask the forkserver for a worker; returns (pid, start_time)
        or None (caller falls back to cold spawn)."""
        from ray_tpu_torch._private import worker_forkserver as fsrv
        sock = self._ensure_forkserver()
        if sock is None:
            return None
        # only ship the vars the child must override; the template
        # already inherited the rest of the NM environment
        child_env = {k: v for k, v in env.items()
                     if k.startswith("RAY_TPU_")
                     or k == "CUDA_VISIBLE_DEVICES"}
        with self._forksrv_lock:
            try:
                fsrv._send_obj(sock, {"env": child_env,
                                      "log_path": log_path})
                reply = fsrv._recv_obj(sock)
                return reply["pid"], reply.get("start_time")
            except (EOFError, OSError, ConnectionResetError):
                try:
                    sock.close()
                except OSError:
                    pass
                self._forksrv_sock = None
                self._forksrv_failed = True
                return None

    def _spawn_worker(self, gpu: bool = False):
        worker_id = WorkerID.from_random().binary()
        env = self._worker_env(worker_id, gpu)
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(
            log_dir, f"worker-{worker_id.hex()[:12]}.log")
        proc = None
        # GPU workers cold-spawn: CUDA is not fork-safe once initialised
        if not gpu:
            forked = self._fork_worker(worker_id, env, log_path)
            if forked is not None:
                proc = _ForkedProc(*forked)
        if proc is None:
            out = open(log_path, "ab")
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.worker_proc"],
                env=env, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=False)
            out.close()
        with self._lock:
            # a forked worker can register its stream before we get here;
            # attach the proc handle to the existing entry in that case
            worker = self._workers.get(worker_id)
            if worker is None:
                worker = _Worker(worker_id, proc, gpu=gpu)
                self._workers[worker_id] = worker
            else:
                worker.proc = proc
                worker.gpu = gpu

    def _assign_devices(self, spec: TaskSpec,
                        worker: _Worker) -> Optional[List[int]]:
        """The cards a task runs on, bound to its GPU worker for life.
        A whole-number request takes that many cards from the free list
        (a bound worker takes exactly its own list back); a fractional
        one (``int(n) == 0``) takes none, as in the reference."""
        if _gpu_request(spec) <= 0:
            return None
        n = _whole_gpus(spec)
        if n <= 0:
            if worker.devices is None:
                worker.devices = ()
            if worker.devices != ():
                raise RuntimeError(
                    f"worker bound to cards {list(worker.devices)} "
                    f"offered fractional task {spec.name!r}")
            return None
        with self._res_lock:
            if worker.devices is not None:
                want = list(worker.devices)
                if len(want) != n or not set(want).issubset(
                        self._free_devices):
                    raise RuntimeError(
                        f"worker bound to cards {want} cannot run task "
                        f"{spec.name!r} ({n} cards, free "
                        f"{self._free_devices})")
            elif len(self._free_devices) < n:
                # GPU resource accounting said the task fits, so the card
                # list must agree; a skew here would silently hand the task
                # fewer cards than it asked for.
                raise RuntimeError(
                    f"card accounting skew: task {spec.name!r} needs {n} "
                    f"cards but only {len(self._free_devices)} are free")
            else:
                want = self._free_devices[:n]
            for d in want:
                self._free_devices.remove(d)
        worker.devices = tuple(want)
        self._worker_devices[worker.worker_id] = want
        return want

    def _release_task_resources(self, spec: TaskSpec, worker: _Worker):
        with self._res_lock:
            res = dict(spec.resources)
            if worker.blocked:
                res.pop("CPU", None)
                worker.blocked = False
            release(self.resources_available, res)
            devices = self._worker_devices.pop(worker.worker_id, None)
            if devices:
                self._free_devices.extend(devices)

    # ------------------------------------------------------------------
    # Failure handling
    # ------------------------------------------------------------------
    def _on_worker_death(self, worker: _Worker):
        with self._lock:
            if worker.state == "dead":
                return
            prev_state = worker.state
            worker.state = "dead"
            self._workers.pop(worker.worker_id, None)
            spec = worker.current_task
            worker.current_task = None
            actor_id = worker.actor_id
        try:
            # drop the dead process's refcount contributions wholesale —
            # at the CP (ownerless refs) and at every owner NM the dead
            # worker may have flushed deltas to
            self.cp.purge_holder(worker.worker_id)
            self.purge_owned_holder(worker.worker_id)
            for info in self.cp.list_nodes():
                if (info.get("state") != "ALIVE"
                        or info["node_id"] == self.node_id):
                    continue
                try:
                    self._owner_peer(info["sock_path"]).call(
                        "purge_owned_holder", worker.worker_id)
                except (OSError, ConnectionError):
                    pass
        except Exception:  # noqa: BLE001
            pass
        if prev_state == "starting":
            with self._lock:
                self._starting = max(0, self._starting - 1)
        if spec is not None:
            self._release_task_resources(spec, worker)
            if actor_id is None and not spec.actor_creation:
                reason = ""
                if worker.oom_killed is not None:
                    reason = ("killed by the memory monitor: node "
                              f"memory usage {worker.oom_killed:.0%} "
                              "exceeded "
                              f"{GLOBAL_CONFIG.memory_usage_threshold:.0%}")
                self._maybe_retry(spec, reason)
        if actor_id is not None or (spec is not None and spec.actor_creation):
            aid = actor_id or spec.actor_id
            with self._lock:
                astate = self._actors.get(aid)
            if astate is not None:
                self._on_actor_worker_death(astate, "worker died",
                                            worker=worker)
        self._wake.set()

    def _maybe_retry(self, spec: TaskSpec, reason: str = ""):
        with self._lock:
            left = self._retries_left.get(spec.task_id, 0)
            if left > 0:
                self._retries_left[spec.task_id] = left - 1
                self._pending.append(spec)
                retried = True
            else:
                retried = False
        if retried:
            self.cp.add_task_event({"task_id": spec.task_id.hex(),
                                    "state": "RETRY",
                                    "node": self.node_id.hex()})
            self._wake.set()
        else:
            self._fail_task(spec, WorkerCrashedError(
                f"worker died while running task {spec.name}"
                + (f" ({reason})" if reason else "")))

    def _on_actor_worker_death(self, astate: _ActorState, reason: str,
                               from_msg: bool = False,
                               worker: Optional[_Worker] = None):
        spec = astate.creation_spec
        # Fail in-flight calls on the dead worker; they are not retried
        # (at-most-once actor semantics unless max_task_retries).
        dead_worker = worker or astate.worker
        inflight = []
        if dead_worker is not None:
            with self._lock:
                inflight = list(dead_worker.inflight_actor_tasks.values())
                dead_worker.inflight_actor_tasks.clear()
        can_restart = (spec.max_restarts == -1
                       or astate.restarts_used < spec.max_restarts)
        # reversed + appendleft keeps the original submission order at
        # the front of the queue (forward appendleft would reverse it)
        for t in reversed(inflight):
            if t.max_task_retries != 0 and can_restart:
                with self._lock:
                    astate.queued.appendleft(t)
            else:
                self._fail_task(t, ActorDiedError(
                    spec.actor_id.hex(), reason))
        with self._lock:
            astate.worker = None
            if can_restart:
                astate.state = "RESTARTING"
                astate.restarts_used += 1
                if spec.actor_creation:
                    self._pending.append(spec)
            else:
                astate.state = "DEAD"
                queued = list(astate.queued)
                astate.queued.clear()
        if can_restart:
            self.cp.update_actor(spec.actor_id, state="RESTARTING",
                                 num_restarts=astate.restarts_used)
            self._wake.set()
        else:
            if not from_msg:
                # creation object may still be pending a consumer: mark error
                self._fail_task(spec, ActorDiedError(spec.actor_id.hex(),
                                                     reason))
            for t in queued:
                self._fail_task(t, ActorDiedError(spec.actor_id.hex(),
                                                  reason))
            self.cp.update_actor(spec.actor_id, state="DEAD",
                                 death_reason=reason)

    def _fail_task(self, spec: TaskSpec, error: BaseException):
        """Commit error objects for every return so getters unblock."""
        from ray_tpu_torch.exceptions import TaskError
        self._unpin_dependencies(spec)
        err = TaskError(error, format_remote_traceback(error),
                        spec.task_id.hex())
        data = serialization.dumps(err)
        for oid in spec.return_object_ids():
            if self.cp.get_location(oid) is None:
                self.cp.put_inline(oid, data, is_error=True,
                                   owner_addr=spec.owner_addr)
        self._fail_generator_stream(spec, data)
        self.cp.add_task_event({"task_id": spec.task_id.hex(),
                                "state": "FAILED",
                                "node": self.node_id.hex()})

    def _fail_generator_stream(self, spec: TaskSpec, error_data: bytes):
        """Terminate a dead generator stream so consumers unblock.

        Commits the error as the next stream item and seals the stream with
        a length marker (items live at return indices 1.., marker at
        GEN_LEN_INDEX — see CoreWorker generator protocol).
        """
        if not spec.is_generator:
            return
        from ray_tpu_torch._private.ids import ObjectID, TaskID
        from ray_tpu_torch._private.worker import GEN_LEN_INDEX
        tid = TaskID(spec.task_id)
        len_oid = ObjectID(
            spec.task_id + GEN_LEN_INDEX.to_bytes(4, "big")).binary()
        if self.cp.get_location(len_oid) is not None:
            return  # stream completed normally
        index = 0
        while self.cp.get_location(
                ObjectID.for_task_return(tid, index + 1).binary()) is not None:
            index += 1
        self.cp.put_inline(
            ObjectID.for_task_return(tid, index + 1).binary(),
            error_data, is_error=True)
        self.cp.put_inline(len_oid, serialization.dumps(index + 1))

    # ------------------------------------------------------------------
    def _peer_client(self, node_info: Dict[str, Any]) -> protocol.RpcClient:
        nid = node_info["node_id"]
        if isinstance(nid, str):
            nid = bytes.fromhex(nid)
        client = self._peers.get(nid)
        if client is None:
            client = protocol.RpcClient(node_info["sock_path"])
            self._peers[nid] = client
        return client

    # ------------------------------------------------------------------
    # Memory monitor + OOM worker-killing policy (reference:
    # common/memory_monitor.h node sampling thread +
    # raylet/worker_killing_policy.cc "newest retriable task first")
    # ------------------------------------------------------------------
    @staticmethod
    def _worker_rss(pid: int) -> int:
        try:
            with open(f"/proc/{pid}/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            return 0

    def _memory_usage(self) -> float:
        limit = GLOBAL_CONFIG.memory_monitor_limit_bytes
        if limit > 0:
            with self._lock:
                pids = [w.proc.pid for w in self._workers.values()
                        if w.proc is not None and w.state != "dead"]
            return sum(self._worker_rss(p) for p in pids) / limit
        try:
            total = avail = None
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = int(line.split()[1])
                    elif line.startswith("MemAvailable:"):
                        avail = int(line.split()[1])
            if total and avail is not None:
                return 1.0 - avail / total
        except OSError:
            pass
        return 0.0

    def _pick_oom_victim(self) -> Optional[_Worker]:
        """Newest retriable task first; actors are never chosen (their
        in-flight calls are not idempotent by default)."""
        with self._lock:
            cands = [w for w in self._workers.values()
                     if w.state == "busy" and w.current_task is not None
                     and w.proc is not None
                     and not w.current_task.actor_creation]
            if not cands:
                return None

            def key(w):
                retriable = self._retries_left.get(
                    w.current_task.task_id, 0) > 0
                return (retriable, getattr(w, "task_started_at", 0.0))

            return max(cands, key=key)

    def _memory_monitor_loop(self):
        period = GLOBAL_CONFIG.memory_monitor_refresh_ms / 1000.0
        threshold = GLOBAL_CONFIG.memory_usage_threshold
        while not self._stopped.wait(period):
            try:
                usage = self._memory_usage()
                if usage < threshold:
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                spec = victim.current_task
                logger.warning(
                    "memory usage %.0f%% over threshold %.0f%%: OOM "
                    "policy killing worker %s (task %s)", usage * 100,
                    threshold * 100, victim.worker_id.hex()[:12],
                    spec.name if spec else "?")
                victim.oom_killed = usage
                if spec is not None:
                    self._cp_effect_or_defer(
                        lambda s=spec: self.cp.add_task_event(
                            {"task_id": s.task_id.hex(),
                             "state": "OOM_KILL",
                             "node": self.node_id.hex()}))
                victim.proc.kill()
                # let the worker-reader thread run the death handling
                # before re-sampling (the RSS drop takes a beat)
                time.sleep(period)
            except Exception:  # noqa: BLE001 — keep the monitor alive
                traceback.print_exc()

    def _cp_effect_or_defer(self, fn) -> None:
        """Run a control-plane side effect now; on an outage longer than
        _ResilientCP's window, queue it for heartbeat-loop retry instead
        of dropping it (a dropped result commit hangs the caller's get)."""
        try:
            fn()
        except self._CONN_ERRORS:
            logger.warning("control plane unreachable; deferring %s",
                           getattr(fn, "__name__", "cp effect"))
            with self._lock:
                self._deferred_cp.append(fn)

    def _drain_deferred_cp(self) -> None:
        with self._lock:
            if not self._deferred_cp:
                return
            pending, self._deferred_cp = self._deferred_cp, []
        survivors = []
        for fn in pending:
            try:
                fn()
            except self._CONN_ERRORS:
                survivors.append(fn)
            except Exception:  # noqa: BLE001 — effect itself is broken
                logger.exception("deferred control-plane effect failed")
        if survivors:
            with self._lock:
                self._deferred_cp = survivors + self._deferred_cp

    def _heartbeat_loop(self):
        period = GLOBAL_CONFIG.health_check_period_s
        while not self._stopped.wait(period):
            try:
                with self._res_lock:
                    avail = dict(self.resources_available)
                with self._lock:
                    # per-shape demand so the autoscaler can launch
                    # nodes that actually FIT the queue (reference:
                    # resource_demand_scheduler.py demand vector).
                    # _PendingQueues already buckets by shape, so this
                    # is O(#shapes), not O(backlog); dep-waiting tasks
                    # are folded in too (their resources are demand the
                    # moment the deps land)
                    shapes = dict(self._pending.shape_counts())
                    for spec in self._waiting.values():
                        key = tuple(sorted(spec.resources.items()))
                        shapes[key] = shapes.get(key, 0) + 1
                    load = {
                        "num_pending": len(self._pending)
                        + len(self._waiting),
                        "pending_shapes": [
                            {"resources": dict(k), "count": c}
                            for k, c in sorted(
                                shapes.items(), key=lambda kv: -kv[1]
                            )[:8]],
                    }
                self.cp.heartbeat_node(self.node_id, avail, load)
            except Exception:  # noqa: BLE001
                pass
            self._drain_deferred_cp()
            if (time.time() - self._last_owner_sweep
                    >= GLOBAL_CONFIG.object_gc_period_s):
                self._last_owner_sweep = time.time()
                try:
                    self._owner_sweep()
                except Exception:  # noqa: BLE001
                    pass

    def stop(self):
        if self._stopped.is_set():
            return
        self._stopped.set()
        timer = getattr(self, "_forksrv_warm_timer", None)
        if timer is not None:
            timer.cancel()
        self._wake.set()
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            w.send(_EXIT_SENTINEL)
        deadline = time.time() + 2.0
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=max(0.05, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    w.proc.terminate()
                    try:
                        w.proc.wait(timeout=1.0)
                    except subprocess.TimeoutExpired:
                        w.proc.kill()
        with self._forksrv_lock:
            if self._forksrv_sock is not None:
                try:
                    self._forksrv_sock.close()
                except OSError:
                    pass
                self._forksrv_sock = None
            if self._forksrv_proc is not None:
                self._forksrv_proc.terminate()
                try:
                    self._forksrv_proc.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    self._forksrv_proc.kill()
                self._forksrv_proc = None
        self._server.shutdown()
        # the caller destroys the shm store right after stop() returns
        # (node.py / node_proc.py): join the loops that touch it so an
        # in-flight owner sweep can't call into a detached native arena
        cur = threading.current_thread()
        for t in (self._hb_thread, self._dispatch_thread,
                  self._dep_thread):
            if t is not cur and t.is_alive():
                t.join(timeout=5.0)
