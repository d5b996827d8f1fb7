# The port's copy of ray_tpu/_private/worker.py
"""CoreWorker — the in-process runtime of every driver and worker.

Analogue of the reference core worker
(``src/ray/core_worker/core_worker.cc`` + ``python/ray/_private/worker.py``):
object put/get/wait, task + actor-task submission, the function table, and
generator streaming.  The driver holds in-process handles to the control
plane and local node manager; worker processes hold socket clients — the
logic is identical either way.
"""

from __future__ import annotations

import contextvars
import hashlib
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import cloudpickle

from ray_tpu_torch._private import protocol, serialization
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import (ActorID, JobID, ObjectID, TaskID,
                                        WorkerID)
from ray_tpu_torch._private.task_spec import Arg, SchedulingStrategy, TaskSpec
from ray_tpu_torch.exceptions import (ActorDiedError, GetTimeoutError,
                                      TaskError)
from ray_tpu_torch.object_ref import ObjectRef, ObjectRefGenerator

# index of the generator end-of-stream marker object
GEN_LEN_INDEX = 2**32 - 2


class CoreWorker:
    def __init__(self, mode: str, job_id: JobID, worker_id: WorkerID,
                 node_id: bytes, control_plane, node_manager, shm_store,
                 session_dir: str, namespace: str = "default",
                 nm_notify=None, nm_addr: str = ""):
        assert mode in ("driver", "worker")
        self.mode = mode
        self.job_id = job_id
        self.worker_id = worker_id
        self.node_id = node_id
        # RPC address of this worker's node manager: the OWNER of every
        # object this worker creates (node-granularity ownership;
        # reference: reference_count.cc owner = creating worker)
        self.nm_addr = nm_addr
        # Node advertised as the location of this worker's shm commits.
        # Differs from node_id only for cross-host attached drivers,
        # whose puts are mirrored to the head node's store.
        self.commit_node_id = node_id
        self.cp = control_plane
        self.nm = node_manager
        self.store = shm_store
        if shm_store is not None \
                and getattr(shm_store, "on_evict", None) is None:
            # a dropped secondary copy must leave the broadcast chain
            # (same wiring as the NM's store instance; whichever process
            # evicts tells the CP)
            def _left(oid, _self=self):
                try:
                    _self.cp.leave_broadcast(oid, _self.node_id)
                except Exception:  # noqa: BLE001 — best-effort
                    pass
            shm_store.on_evict = _left
        self.session_dir = session_dir
        self.namespace = namespace
        self._nm_notify = nm_notify  # callable(msg) to notify NM blocked state
        self._fn_cache: Dict[bytes, Any] = {}
        self._fn_keys: Dict[int, bytes] = {}  # id(fn) -> registered key
        self._actor_nm_cache: Dict[bytes, Any] = {}
        self._actor_direct_cache: Dict[bytes, Any] = {}
        # the incarnation (num_restarts) each cached direct client dials
        self._actor_direct_incarnation: Dict[bytes, int] = {}
        # task_id -> the direct address whose connection closed between
        # the call's request and its reply (protocol.MaybeDelivered)
        self._maybe_delivered: Dict[bytes, str] = {}
        # direct_addr whose dial failed: calls stay on the NM relay
        # (which preserves per-caller order) until the actor publishes
        # a *different* addr — mixing paths could reorder calls
        self._actor_direct_failed: Dict[bytes, str] = {}
        # direct-channel result push-back: return oid -> pending entry
        # {event, payload, error, actor}.  Filled by per-actor reader
        # threads; get() consumes entries instead of 3 CP round trips.
        # Pure latency cache: results also commit at the CP, so a lost
        # push (conn death wakes the entry with payload=None) just
        # means the normal location/wait/fetch flow.
        self._direct_pending: Dict[bytes, Dict[str, Any]] = {}
        self._direct_pending_lock = threading.Lock()
        # actors whose result-stream reader thread is alive: pending
        # entries are only registered while the reader is — an entry
        # nobody will ever fill must not exist, or a get() with no
        # timeout would park on it forever
        self._direct_readers_ok: set = set()
        # actor liveness cache: (state, num_restarts) per actor.  The
        # submit hot path was paying TWO get_actor_info round trips per
        # call (route + inflight bookkeeping); stale entries are safe —
        # a failed direct dial or the inflight watcher invalidates, and
        # the at-least-once + dedup machinery absorbs a spurious resend.
        self._actor_state_cache: Dict[bytes, Tuple[str, int]] = {}
        self._seq_lock = threading.Lock()
        self._actor_seq: Dict[bytes, int] = {}
        # Client-side buffering for calls to not-yet-ALIVE actors
        # (reference: caller-side buffer in direct_actor_task_submitter).
        self._actor_buffers: Dict[bytes, List] = {}
        self._actor_buffer_lock = threading.Lock()
        self._gen_len_cache: Dict[bytes, int] = {}
        self._nm_peers: Dict[str, Any] = {}
        self.num_remote_pulls = 0
        # Caller-side in-flight actor calls (reference:
        # direct_actor_task_submitter pending queue): watched so calls
        # in flight when an actor's host dies are failed or resent
        # instead of hanging forever.
        self._inflight_actor: Dict[bytes, Dict[bytes, Tuple]] = {}
        self._inflight_lock = threading.Lock()
        self._watcher_started = False
        self.current_actor = None
        self.current_actor_id: Optional[bytes] = None
        # Per-execution-context task id (contextvar: safe under threaded
        # actor pools and async actor event loops alike).
        self._task_id_var: "contextvars.ContextVar[Optional[bytes]]" = (
            contextvars.ContextVar(f"task_id_{worker_id.hex()[:8]}",
                                   default=None))

    @property
    def current_task_id(self) -> Optional[bytes]:
        return self._task_id_var.get()

    @current_task_id.setter
    def current_task_id(self, value: Optional[bytes]) -> None:
        self._task_id_var.set(value)

    # ------------------------------------------------------------------
    # Function / class table
    # ------------------------------------------------------------------
    def register_function(self, fn, prefix: bytes = b"fn:") -> bytes:
        cached = self._fn_keys.get(id(fn))
        if cached is not None:
            return cached
        blob = cloudpickle.dumps(fn)
        key = prefix + hashlib.sha1(blob).digest()
        self.cp.kv_put(key, blob, overwrite=False, namespace="_functions")
        self._fn_keys[id(fn)] = key
        self._fn_cache[key] = fn
        return key

    def load_function(self, key: bytes):
        fn = self._fn_cache.get(key)
        if fn is None:
            blob = self.cp.kv_get(key, namespace="_functions")
            if blob is None:
                raise RuntimeError(f"function {key!r} not found in table")
            fn = cloudpickle.loads(blob)
            self._fn_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # Objects
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_random().binary()
        self.put_object(oid, value, owner_addr=self.nm_addr)
        return ObjectRef(oid, self.nm_addr or None)

    def put_object(self, oid: bytes, value: Any,
                   is_error: bool = False,
                   owner_addr: Optional[str] = None) -> Optional[bytes]:
        """Commit a value under ``oid``.  ``owner_addr`` is the node
        manager owning the object's lifetime (the caller's NM for task
        returns, ours for puts); empty/None commits a CP-governed object
        (centralized refcounting fallback).  Returns the serialized
        payload when it committed inline (the direct-channel result
        push reuses it), else None."""
        sobj = serialization.serialize(value)
        owner = self.worker_id.binary()
        if sobj.total_bytes <= GLOBAL_CONFIG.inline_object_max_bytes:
            data = sobj.to_bytes()
            self.cp.put_inline(oid, data, is_error=is_error,
                               owner=owner, owner_addr=owner_addr or "")
            return data
        self.store.put_serialized(oid, sobj)
        self.cp.commit_shm(oid, sobj.total_bytes,
                           node_id=self.commit_node_id,
                           is_error=is_error, owner=owner,
                           owner_addr=owner_addr or "")
        return None

    def _fetch_committed(self, oid: bytes, loc: Dict[str, Any],
                         preloaded: Optional[bytes] = None) -> Any:
        if loc["where"] == "inline":
            data = preloaded if preloaded is not None \
                else self.cp.get_inline(oid)
            if data is None:
                raise KeyError(f"inline object {oid.hex()} vanished")
            value = serialization.deserialize_frame(memoryview(data))
        else:
            value = self.store.get_object(oid)
            if value is None and self._pull_remote(oid, loc):
                value = self.store.get_object(oid)
            if value is None:
                raise KeyError(f"shm object {oid.hex()} missing from store")
        return value

    # ------------------------------------------------------------------
    # Node-to-node object transfer (pull side).  Reference:
    # object_manager/pull_manager.cc — here the *consumer* worker pulls
    # chunks from the node manager of the node holding the primary copy
    # and seals a local secondary copy.
    # ------------------------------------------------------------------
    def _pull_remote(self, oid: bytes, loc: Dict[str, Any]) -> bool:
        src_node = loc.get("node")
        if not src_node or src_node == self.node_id:
            return False
        info = self.cp.get_node(src_node)
        if info is None or info.get("state") != "ALIVE":
            return False
        peer = self._nm_peer(info["sock_path"])
        try:
            meta = peer.call("fetch_object_meta", oid)
            if meta is None:
                return False
            size = meta["size"]
            # Same-host fastpath: co-hosted nodes share tmpfs, so a
            # sealed source file copies kernel-side — one memcpy, no
            # RPC chunking (multi-node-per-host deployments; the sim
            # fixtures are exactly this shape).
            path = meta.get("path")
            if path and GLOBAL_CONFIG.object_samehost_fastpath \
                    and self._same_host(meta.get("ip")) \
                    and os.path.exists(path) \
                    and self.store.put_file_copy(oid, path, size):
                self.num_remote_pulls += 1
                return True
            if self._pull_chained(oid, size, peer):
                self.num_remote_pulls += 1
                return True
            return False
        except (OSError, IOError, ConnectionError):
            return False

    def _pull_chained(self, oid: bytes, size: int, primary_peer) -> bool:
        """Chain-push broadcast pull (reference: push_manager.cc role).

        Join the object's broadcast chain at the CP; pull chunks from
        the assigned parent — which may still be mid-pull itself, in
        which case its node re-serves the prefix it already has
        (``fetch_partial_chunk``) and we poll forward.  On a dead or
        stalled parent, leave the chain and restart against the
        primary, so a mid-broadcast node death costs one retry, not the
        broadcast."""
        chunk_bytes = GLOBAL_CONFIG.object_transfer_chunk_bytes
        parent_peer, parent_node = primary_peer, None
        try:
            parent = self.cp.join_broadcast(oid, self.node_id)
            if parent is not None:
                parent_node = parent["node_id"]
                parent_peer = self._nm_peer(parent["sock_path"])
        except Exception:  # noqa: BLE001 — no chain: primary direct
            pass

        def chunks_from(peer, partial: bool):
            off = 0
            stall_deadline = time.monotonic() + 20.0
            # a parent that reports "gone" has no copy and no pull in
            # flight — give it a short grace (it may be between its
            # join and its first written chunk), then re-chain
            gone_deadline = time.monotonic() + 3.0
            while off < size:
                n = min(chunk_bytes, size - off)
                method = ("fetch_partial_chunk" if partial
                          else "fetch_object_chunk")
                data = peer.call(method, oid, off, n)
                if isinstance(data, dict):         # {"gone": True}
                    if off > 0 or time.monotonic() > gone_deadline:
                        raise IOError(
                            f"parent lost {oid.hex()} at {off}")
                    time.sleep(0.05)
                    continue
                if data is None:
                    if not partial:
                        raise IOError(f"object {oid.hex()} gone at src")
                    if time.monotonic() > stall_deadline:
                        raise IOError(f"parent stalled at {off}")
                    time.sleep(0.02)
                    continue
                if len(data) != n:
                    raise IOError(
                        f"short chunk pulling {oid.hex()} "
                        f"({len(data)}/{n})")
                stall_deadline = time.monotonic() + 20.0
                yield data
                off += n

        if parent_node is not None:
            try:
                self.store.put_stream(
                    oid, size, chunks_from(parent_peer, partial=True))
                return True
            except (OSError, IOError, ConnectionError):
                # parent died/stalled mid-chain: drop it and fall back
                try:
                    self.cp.leave_broadcast(oid, parent_node)
                except Exception:  # noqa: BLE001
                    pass
        try:
            self.store.put_stream(
                oid, size, chunks_from(primary_peer, partial=False))
            return True
        except (OSError, IOError, ConnectionError):
            try:
                self.cp.leave_broadcast(oid, self.node_id)
            except Exception:  # noqa: BLE001
                pass
            return False

    def _same_host(self, src_ip: Optional[str]) -> bool:
        """Whether the source node's sealed file is on THIS host's
        tmpfs.  UDS sessions are single-host by construction; TCP
        sessions compare the source ip against our own NM's — a path
        that merely *exists* locally could be a different host's
        bind-mounted store."""
        from ray_tpu_torch._private.protocol import is_tcp_address, \
            parse_tcp_address
        if not self.nm_addr or not is_tcp_address(self.nm_addr):
            return True
        if not src_ip:
            return False
        try:
            local_ip, _ = parse_tcp_address(self.nm_addr)
        except Exception:  # noqa: BLE001
            return False
        return src_ip == local_ip

    def _nm_peer(self, sock_path: str):
        from ray_tpu_torch._private.protocol import RpcClient
        client = self._nm_peers.get(sock_path)
        if client is None:
            client = RpcClient(sock_path)
            self._nm_peers[sock_path] = client
        return client

    # ------------------------------------------------------------------
    # Lineage reconstruction.  Reference:
    # core_worker/object_recovery_manager.cc + TaskManager::ResubmitTask —
    # a lost object (evicted shm copy, dead holder node) is recomputed by
    # re-executing the deterministic task that created it; return ids are
    # derived from the task id, so the re-execution commits the same ids.
    # ------------------------------------------------------------------
    def _recover_object(self, oid: bytes, attempts: int = 3,
                        adopt: bool = False) -> Dict[str, Any]:
        from ray_tpu_torch.exceptions import ObjectLostError
        task_id = oid[: TaskID.SIZE]
        for _ in range(attempts):
            spec = self.cp.get_lineage(task_id)
            if spec is None:
                raise ObjectLostError(
                    oid.hex(), "no lineage to reconstruct (ray.put "
                    "objects and actor-task returns are not "
                    "reconstructible)")
            if adopt:
                # owner-death recovery: recommitting under the dead
                # owner address would leak the recomputed copy, so this
                # worker's NM adopts ownership and we register OUR ref
                # there (rebinding the local tracker so the eventual -1
                # routes the same way).  Other borrowers still pointing
                # at the dead owner can re-trigger recovery — at-least-
                # once, never a leak.
                spec.owner_addr = self.nm_addr
            # invalidate the stale location so waiters block on the
            # re-execution's commit instead of re-reading the dead copy
            self.cp.free_objects([oid])
            if hasattr(self.nm, "call"):
                self.nm.call("submit_task", spec)
            else:
                self.nm.submit_task(spec)
            loc = self.cp.wait_object(oid, 300.0)
            if loc is not None:
                if adopt and self.nm_addr:
                    try:
                        self._nm_peer(self.nm_addr).call(
                            "update_owned_refs", self.worker_id.binary(),
                            {oid: 1}, self.node_id)
                        from ray_tpu_torch._private.ref_tracker import \
                            rebind_ref
                        rebind_ref(oid, self.nm_addr)
                    except Exception:  # noqa: BLE001 - best effort
                        pass
                return loc
        raise ObjectLostError(oid.hex(), "reconstruction failed")

    def _handle_owner_died(self, oid: bytes) -> Dict[str, Any]:
        """The node owning ``oid``'s refcount died.  Task returns are
        recomputed through lineage (and adopted by this worker's owner);
        ``put`` objects fate-share with their owner (reference:
        OwnerDiedError semantics in ``python/ray/exceptions.py``)."""
        from ray_tpu_torch.exceptions import ObjectLostError, OwnerDiedError
        try:
            return self._recover_object(oid, adopt=True)
        except OwnerDiedError:
            raise
        except ObjectLostError:
            raise OwnerDiedError(
                oid.hex(), "the node owning this object died and it "
                "has no lineage to reconstruct") from None

    def get(self, refs: Union[ObjectRef, Sequence[ObjectRef]],
            timeout: Optional[float] = None) -> Any:
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(
                    f"get() expects ObjectRef(s), got {type(r).__name__}")
        ids = [r.binary() for r in ref_list]
        # ONE deadline across the direct-push wait and the CP flow: a
        # fallback after a consumed wait must not restart the budget
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        # direct-channel fast path: results pushed by the actor worker
        # resolve with zero control-plane round trips
        direct_vals: Dict[bytes, Any] = {}
        direct_errs: Dict[bytes, bool] = {}
        pending = []
        with self._direct_pending_lock:
            for o in ids:
                e = self._direct_pending.get(o)
                if e is not None:
                    pending.append((o, e))
        if pending:
            self._notify_blocked(True)
            try:
                for o, e in pending:
                    t = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
                    if e["event"].wait(t):
                        with self._direct_pending_lock:
                            self._direct_pending.pop(o, None)
                        if e["payload"] is not None:
                            direct_vals[o] = serialization.loads(
                                e["payload"])
                            direct_errs[o] = e["error"]
                    # payload None (big result / conn died) or timeout:
                    # the CP flow below handles it
            finally:
                self._notify_blocked(False)
        rest = [o for o in ids if o not in direct_vals]
        # one bulk location RPC; blocked waits use the combined
        # wait+fetch so a small result costs one round trip total
        locs = self.cp.get_locations(rest) if rest else {}
        preloaded: Dict[bytes, bytes] = {}
        unready = [o for o in rest if locs.get(o) is None]
        if unready:
            self._notify_blocked(True)
            try:
                for o in unready:
                    t = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
                    out = self.cp.wait_fetch(o, t)
                    if out is None:
                        raise GetTimeoutError(
                            f"get() timed out waiting for {o.hex()}")
                    locs[o] = out["loc"]
                    if out.get("data") is not None:
                        preloaded[o] = out["data"]
            finally:
                self._notify_blocked(False)
        values = []
        for o in ids:
            if o in direct_vals:
                value = direct_vals[o]
                if direct_errs.get(o):
                    if isinstance(value, TaskError):
                        raise value.as_instanceof_cause()
                    if isinstance(value, BaseException):
                        raise value
                values.append(value)
                continue
            loc = locs.get(o)
            if loc is None:
                raise GetTimeoutError(f"object {o.hex()} not available")
            if loc.get("owner_died"):
                loc = self._handle_owner_died(o)
            try:
                value = self._fetch_committed(o, loc,
                                              preloaded=preloaded.get(o))
            except KeyError:
                loc = self._recover_object(o)
                value = self._fetch_committed(o, loc)
            if loc.get("error"):
                if isinstance(value, TaskError):
                    raise value.as_instanceof_cause()
                if isinstance(value, BaseException):
                    raise value
            values.append(value)
        return values[0] if single else values

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True) -> Tuple[List[ObjectRef],
                                                List[ObjectRef]]:
        if isinstance(refs, ObjectRef):
            raise TypeError("wait() expects a list of ObjectRefs")
        ids = [r.binary() for r in refs]
        if num_returns > len(ids):
            raise ValueError("num_returns exceeds number of refs")
        self._notify_blocked(True)
        try:
            ready_ids = set(self.cp.wait_any(ids, num_returns, timeout))
        finally:
            self._notify_blocked(False)
        ready, not_ready = [], []
        for r in refs:
            # Ray contract: len(ready) <= num_returns; surplus completed
            # refs stay in not_ready and are returned by the next wait().
            if r.binary() in ready_ids and len(ready) < num_returns:
                ready.append(r)
            else:
                not_ready.append(r)
        return ready, not_ready

    def free(self, refs: Sequence[ObjectRef]) -> int:
        ids = [r.binary() for r in refs]
        for o in ids:
            self.store.delete(o)
        return self.cp.free_objects(ids)

    def _notify_blocked(self, blocked: bool):
        if self.mode == "worker" and self._nm_notify is not None:
            try:
                self._nm_notify({"type": "blocked" if blocked
                                 else "unblocked"})
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------------
    # Generator streaming
    # ------------------------------------------------------------------
    def _gen_len_oid(self, task_id: bytes) -> bytes:
        return ObjectID(task_id + GEN_LEN_INDEX.to_bytes(4, "big")).binary()

    def commit_generator_item(self, task_id: bytes, index: int, value: Any,
                              is_error: bool = False) -> bytes:
        # Streamed items live at return indices 1.. (index 0 is the task's
        # nominal return, which carries the item count).
        oid = ObjectID.for_task_return(TaskID(task_id), index + 1).binary()
        self.put_object(oid, value, is_error=is_error)
        return oid

    def commit_generator_done(self, task_id: bytes, length: int) -> None:
        self.put_object(self._gen_len_oid(task_id), length)

    def peek_generator_length(self, task_id: bytes) -> Optional[int]:
        cached = self._gen_len_cache.get(task_id)
        if cached is not None:
            return cached
        oid = self._gen_len_oid(task_id)
        loc = self.cp.get_location(oid)
        if loc is None:
            return None
        length = self._fetch_committed(oid, loc)
        self._gen_len_cache[task_id] = length
        return length

    def wait_generator_length(self, task_id: bytes) -> Optional[int]:
        return self.peek_generator_length(task_id)

    def wait_ready_or_len(self, oid: bytes, task_id: bytes):
        len_oid = self._gen_len_oid(task_id)
        while True:
            ready = self.cp.wait_any([oid, len_oid], 1, 30.0)
            if ready:
                return

    # ------------------------------------------------------------------
    # Task submission
    # ------------------------------------------------------------------
    def _serialize_args(self, args: Sequence[Any],
                        kwargs: Dict[str, Any]) -> Tuple[List[Arg],
                                                         Dict[str, Arg],
                                                         Dict[bytes, str]]:
        ref_owners: Dict[bytes, str] = {}

        def one(value: Any) -> Arg:
            if isinstance(value, ObjectRef):
                if value.owner_addr():
                    ref_owners[value.binary()] = value.owner_addr()
                return Arg(object_id=value.binary())
            if isinstance(value, ObjectRefGenerator):
                raise TypeError(
                    "Pass generator refs individually, not the generator")
            sobj = serialization.serialize(value)
            if sobj.total_bytes <= GLOBAL_CONFIG.inline_object_max_bytes:
                return Arg(inline=sobj.to_bytes())
            oid = ObjectID.from_random().binary()
            self.store.put_serialized(oid, sobj)
            self.cp.commit_shm(oid, sobj.total_bytes,
                               node_id=self.commit_node_id,
                               owner=self.worker_id.binary(),
                               owner_addr=self.nm_addr)
            if self.nm_addr:
                ref_owners[oid] = self.nm_addr
            return Arg(object_id=oid)

        ser_args = [one(a) for a in args]
        ser_kwargs = {k: one(v) for k, v in kwargs.items()}
        return ser_args, ser_kwargs, ref_owners

    def submit_task(self, fn, args: Sequence[Any], kwargs: Dict[str, Any],
                    opts: Dict[str, Any]) -> Union[ObjectRef,
                                                   List[ObjectRef],
                                                   ObjectRefGenerator]:
        fn_key = self.register_function(fn)
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns in ("streaming", "dynamic")
        task_id = TaskID.for_normal_task(self.job_id)
        ser_args, ser_kwargs, ref_owners = self._serialize_args(
            args, kwargs)
        spec = TaskSpec(
            task_id=task_id.binary(), job_id=self.job_id.binary(),
            name=opts.get("name") or getattr(fn, "__qualname__", "task"),
            function_key=fn_key, args=ser_args, kwargs=ser_kwargs,
            num_returns=1 if streaming else num_returns,
            resources=dict(opts["resources"]),
            max_retries=opts.get(
                "max_retries", GLOBAL_CONFIG.task_default_max_retries),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            scheduling_strategy=opts.get(
                "scheduling_strategy") or SchedulingStrategy(),
            is_generator=streaming,
            owner_id=self.worker_id.binary(),
            owner_addr=self.nm_addr, ref_owners=ref_owners,
            runtime_env=opts.get("runtime_env") or {},
            parent_task_id=self.current_task_id,
        )
        from ray_tpu_torch.util.tracing import submit_span
        with submit_span(spec.name):
            self.nm.submit_task(spec)
        if streaming:
            return ObjectRefGenerator(task_id.binary())
        refs = [ObjectRef(o, self.nm_addr or None)
                for o in spec.return_object_ids()]
        return refs[0] if num_returns == 1 else refs

    # ------------------------------------------------------------------
    # Actors
    # ------------------------------------------------------------------
    def create_actor(self, cls, args: Sequence[Any], kwargs: Dict[str, Any],
                     opts: Dict[str, Any]) -> bytes:
        cls_key = self.register_function(cls, prefix=b"cls:")
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.for_actor_creation(actor_id)
        ser_args, ser_kwargs, ref_owners = self._serialize_args(
            args, kwargs)
        name = opts.get("name")
        spec = TaskSpec(
            task_id=task_id.binary(), job_id=self.job_id.binary(),
            name=f"{getattr(cls, '__name__', 'Actor')}.__init__",
            function_key=cls_key, args=ser_args, kwargs=ser_kwargs,
            num_returns=1, resources=opts["resources"],
            scheduling_strategy=opts.get(
                "scheduling_strategy") or SchedulingStrategy(),
            actor_id=actor_id.binary(), actor_creation=True,
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            owner_id=self.worker_id.binary(),
            owner_addr=self.nm_addr, ref_owners=ref_owners,
            runtime_env=opts.get("runtime_env") or {},
        )
        self.cp.register_actor(actor_id.binary(), {
            "name": name, "namespace": opts.get("namespace", self.namespace),
            "class_name": getattr(cls, "__name__", "Actor"),
            "state": "PENDING",
            "max_restarts": opts.get("max_restarts", 0),
            "max_task_retries": opts.get("max_task_retries", 0),
            "method_num_returns": opts.get("method_num_returns") or {},
            "lifetime": opts.get("lifetime"),
            "resources": opts["resources"],
            # kept so the head can reschedule the actor on another node
            # when its host dies (gcs_actor_manager restart path)
            "creation_spec": spec,
        })
        self.nm.submit_actor_creation(spec)
        return actor_id.binary()

    def _actor_nm(self, actor_id: bytes, wait: bool = True):
        """Client to the node manager hosting the actor."""
        info = self.cp.get_actor_info(actor_id)
        if info is None:
            raise ActorDiedError(actor_id.hex(), "unknown actor")
        state = info.get("state")
        if state in ("PENDING", "RESTARTING") and wait:
            self._notify_blocked(True)
            try:
                info = self.cp.wait_actor_state(
                    actor_id, ("ALIVE", "DEAD"), timeout=300.0)
            finally:
                self._notify_blocked(False)
            if info is None:
                raise ActorDiedError(actor_id.hex(),
                                     "timed out waiting for actor start")
        if info.get("state") == "DEAD":
            raise ActorDiedError(actor_id.hex(),
                                 info.get("death_reason", "actor is dead"))
        nm_sock = info.get("nm_sock")
        if nm_sock is None:
            raise ActorDiedError(actor_id.hex(), "actor has no address")
        if self.nm is not None and getattr(self.nm, "sock_path", None) == \
                nm_sock:
            return self.nm
        client = self._actor_nm_cache.get(actor_id)
        if client is None or getattr(client, "sock_path", None) != nm_sock:
            from ray_tpu_torch._private.protocol import RpcClient
            client = RpcClient(nm_sock)
            client.sock_path = nm_sock
            self._actor_nm_cache[actor_id] = client
        return client

    def submit_actor_task(self, actor_id: bytes, method_name: str,
                          args: Sequence[Any], kwargs: Dict[str, Any],
                          opts: Dict[str, Any]) -> Union[ObjectRef,
                                                         List[ObjectRef],
                                                         ObjectRefGenerator]:
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns in ("streaming", "dynamic")
        task_id = TaskID.for_actor_task(ActorID(actor_id))
        ser_args, ser_kwargs, ref_owners = self._serialize_args(
            args, kwargs)
        with self._seq_lock:
            seq = self._actor_seq.get(actor_id, 0)
            self._actor_seq[actor_id] = seq + 1
        spec = TaskSpec(
            task_id=task_id.binary(), job_id=self.job_id.binary(),
            name=f"actor.{method_name}",
            function_key=b"", args=ser_args, kwargs=ser_kwargs,
            num_returns=1 if streaming else num_returns,
            resources={}, actor_id=actor_id, actor_method=method_name,
            seq_no=seq, is_generator=streaming,
            max_task_retries=opts.get("max_task_retries", 0),
            owner_id=self.worker_id.binary(),
            owner_addr=self.nm_addr, ref_owners=ref_owners,
        )
        # Pin arg objects from the moment of submission.  A call made
        # while the actor is still PENDING sits in the caller-side
        # buffer where the node manager's pin (submit_actor_task)
        # doesn't exist yet — if the caller drops its ObjectRefs in that
        # window, GC frees the args and the task hangs resolving them.
        # purge clears the whole "task:" holder at completion, so the
        # node manager re-pinning the same holder is harmless.  Pins
        # route to each dep's owner, like the ref tracker's deltas.
        deps = spec.dependencies()
        if deps:
            self._update_pins(b"task:" + spec.task_id,
                              {d: 1 for d in deps}, spec.ref_owners)
        self._route_or_buffer(spec, streaming)
        if streaming:
            return ObjectRefGenerator(task_id.binary())
        refs = [ObjectRef(o, self.nm_addr or None)
                for o in spec.return_object_ids()]
        return refs[0] if num_returns == 1 else refs

    def _update_pins(self, holder: bytes, deltas: Dict[bytes, int],
                     ref_owners: Dict[bytes, str]) -> None:
        """Apply pin refcount deltas at each object's owner (CP for
        ownerless objects)."""
        from ray_tpu_torch._private import owner_routing
        owner_routing.route_updates(
            self.cp, self._nm_peer, holder,
            owner_routing.bucket_by_owner(deltas, ref_owners.get),
            holder_node=self.node_id)

    def _route_now(self, spec: TaskSpec, streaming: bool = False,
                   restarts_seen: Optional[int] = None) -> None:
        # Direct caller->callee transport (reference:
        # transport/direct_actor_task_submitter.cc): dial the actor
        # worker's own socket, skipping the hosting NM's relay +
        # queue + task-event machinery on the per-call hot path.
        # Streaming calls and misses fall back to the NM relay (which
        # also owns restart-time requeueing).
        if not streaming:
            direct = self._actor_direct(spec.actor_id)
            if direct is not None:
                rets = spec.return_object_ids()
                oid = rets[0] if spec.num_returns == 1 and rets else None
                if oid is not None:
                    with self._direct_pending_lock:
                        if spec.actor_id not in self._direct_readers_ok:
                            oid = None  # no reader: CP flow only
                        elif oid in self._direct_pending:
                            pass  # resend: keep the (maybe-filled) entry
                        else:
                            # bounded: refs the caller never get()s must
                            # not pin payloads forever.  Wake evictees —
                            # a get() already parked on one falls back
                            # to the CP flow instead of stranding.
                            while len(self._direct_pending) >= 4096:
                                old = self._direct_pending.pop(
                                    next(iter(self._direct_pending)))
                                old["event"].set()
                            self._direct_pending[oid] = {
                                "event": threading.Event(),
                                "payload": None, "error": False,
                                "actor": spec.actor_id}
                try:
                    direct.call_once("call_actor", spec)
                    self._record_inflight(spec, streaming,
                                          restarts_seen)
                    return
                except protocol.MaybeDelivered:
                    # the actor may have taken the call and then died
                    # (a method that exits its process): resending it
                    # through the relay would run it again on the next
                    # incarnation.  An actor call runs at most once
                    # unless max_task_retries, so it is watched as in
                    # flight on the incarnation it was sent to: the
                    # watcher fails it (or resends it, with retries)
                    # when that incarnation is gone, and asks it
                    # whether it took the call while it lives
                    # (_settle_maybe_delivered)
                    incarnation = self._actor_direct_incarnation.get(
                        spec.actor_id)
                    if oid is not None:
                        with self._direct_pending_lock:
                            self._direct_pending.pop(oid, None)
                    self._actor_direct_cache.pop(spec.actor_id, None)
                    self._actor_state_cache.pop(spec.actor_id, None)
                    self._actor_direct_failed[spec.actor_id] = (
                        direct.sock_path)
                    self._maybe_delivered[spec.task_id] = direct.sock_path
                    self._record_inflight(spec, streaming, incarnation)
                    return
                except Exception:  # noqa: BLE001 — stale addr, or the
                    # call was never taken (refused, reset unread, or
                    # protocol.Fenced by an orphan): relay it
                    if oid is not None:
                        with self._direct_pending_lock:
                            self._direct_pending.pop(oid, None)
                    self._actor_direct_cache.pop(spec.actor_id, None)
                    self._actor_state_cache.pop(spec.actor_id, None)
                    self._actor_direct_failed[spec.actor_id] = (
                        direct.sock_path)
        nm = self._actor_nm(spec.actor_id, wait=False)
        if nm is self.nm and self.mode == "driver":
            nm.submit_actor_task(spec)
        elif hasattr(nm, "call"):
            nm.call("submit_actor_task", spec)
        else:
            nm.submit_actor_task(spec)
        self._record_inflight(spec, streaming, restarts_seen)

    def _actor_direct(self, actor_id: bytes):
        """Cached client to the actor's direct-call socket (None when
        the actor hasn't published one / is mid-restart).  "No direct
        addr" is cached with a TTL: without it every call to such an
        actor pays a control-plane round trip on the hot path."""
        client = self._actor_direct_cache.get(actor_id)
        if client is not None:
            if isinstance(client, float):       # negative entry
                if time.monotonic() < client:
                    return None
                self._actor_direct_cache.pop(actor_id, None)
            else:
                return client
        info = self.cp.get_actor_info(actor_id)
        if not info or info.get("state") != "ALIVE":
            return None
        addr = info.get("direct_addr")
        if not addr:
            self._actor_direct_cache[actor_id] = time.monotonic() + 10.0
            return None
        if self._actor_direct_failed.get(actor_id) == addr:
            return None  # relay-pinned until the actor re-publishes
        self._actor_direct_failed.pop(actor_id, None)
        from ray_tpu_torch._private.protocol import RpcClient
        client = RpcClient(addr, connect_timeout=2.0)
        self._start_direct_result_reader(actor_id, client)
        self._actor_direct_cache[actor_id] = client
        self._actor_direct_incarnation[actor_id] = info.get("num_restarts", 0)
        return client

    def _start_direct_result_reader(self, actor_id: bytes,
                                    client) -> None:
        """Open the per-caller result stream on the actor's direct
        server and drain pushed results into ``_direct_pending``."""
        from ray_tpu_torch._private import protocol as _proto
        try:
            sock = client.hijack("stream_results",
                                 self.worker_id.binary())
        except Exception:  # noqa: BLE001 — push-back is optional
            return
        with self._direct_pending_lock:
            self._direct_readers_ok.add(actor_id)

        def reader():
            try:
                while True:
                    msg = _proto.recv_msg(sock)
                    entry = None
                    with self._direct_pending_lock:
                        entry = self._direct_pending.get(msg.get("oid"))
                    if entry is not None:
                        entry["payload"] = msg.get("payload")
                        entry["error"] = bool(msg.get("error"))
                        entry["event"].set()
            except Exception:  # noqa: BLE001 — conn died
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
                # drop the liveness mark FIRST (no new registrations),
                # then wake every waiter still parked on this actor:
                # they fall back to the CP flow
                with self._direct_pending_lock:
                    self._direct_readers_ok.discard(actor_id)
                    stale = [e for e in self._direct_pending.values()
                             if e["actor"] == actor_id]
                for e in stale:
                    e["event"].set()

        threading.Thread(target=reader, daemon=True,
                         name=f"direct-res-{actor_id.hex()[:6]}").start()

    # ------------------------------------------------------------------
    # In-flight actor call tracking.  If the hosting node dies, the node
    # manager that knew about the call dies with it — the caller is the
    # only party able to fail or resend.  A 1s watcher prunes committed
    # calls and reacts to actor DEAD / restart transitions.
    # ------------------------------------------------------------------
    def _record_inflight(self, spec: TaskSpec, streaming: bool,
                         restarts_seen: Optional[int] = None) -> None:
        if not streaming and not spec.return_object_ids():
            return  # num_returns=0: nothing to watch for
        if restarts_seen is None:
            cached = self._actor_state_cache.get(spec.actor_id)
            if cached is not None:
                restarts_seen = cached[1]
            else:
                info = self.cp.get_actor_info(spec.actor_id) or {}
                restarts_seen = info.get("num_restarts", 0)
                if info:
                    self._actor_state_cache[spec.actor_id] = (
                        info.get("state", "?"), restarts_seen)
        with self._inflight_lock:
            self._inflight_actor.setdefault(spec.actor_id, {})[
                spec.task_id] = (spec, streaming, restarts_seen)
            if not self._watcher_started:
                self._watcher_started = True
                threading.Thread(target=self._inflight_watch_loop,
                                 daemon=True,
                                 name="actor-inflight-watch").start()

    def _call_committed(self, spec: TaskSpec, streaming: bool) -> bool:
        if streaming:
            oid = self._gen_len_oid(spec.task_id)
        else:
            ids = spec.return_object_ids()
            if not ids:
                return True
            oid = ids[0]
        return self.cp.get_location(oid) is not None

    def _inflight_watch_loop(self) -> None:
        while True:
            time.sleep(1.0)
            try:
                self._inflight_watch_once()
            except Exception:  # noqa: BLE001 - transient cp error; keep
                continue       # watching (a dead watcher would strand
                               # every future in-flight call)

    def _inflight_watch_once(self) -> None:
        with self._inflight_lock:
            snapshot = {aid: dict(tasks) for aid, tasks
                        in self._inflight_actor.items()}
        for actor_id, tasks in snapshot.items():
            done = [tid for tid, (spec, streaming, _) in tasks.items()
                    if self._call_committed(spec, streaming)]
            for tid in done:
                tasks.pop(tid)
                self._maybe_delivered.pop(tid, None)
            with self._inflight_lock:
                for tid in done:
                    self._inflight_actor.get(actor_id, {}).pop(tid, None)
                if not self._inflight_actor.get(actor_id):
                    self._inflight_actor.pop(actor_id, None)
            if not tasks:
                continue
            info = self.cp.get_actor_info(actor_id)
            state = (info or {}).get("state")
            # keep the submit-path cache honest while calls are watched
            if info is None:
                self._actor_state_cache.pop(actor_id, None)
            else:
                self._actor_state_cache[actor_id] = (
                    state, info.get("num_restarts", 0))
            if info is None or state == "DEAD":
                for tid, (spec, streaming, _) in tasks.items():
                    if not self._call_committed(spec, streaming):
                        self._fail_actor_call(
                            spec, streaming, ActorDiedError(
                                actor_id.hex(),
                                (info or {}).get("death_reason",
                                                 "actor is dead")))
                with self._inflight_lock:
                    # pop only what we actually failed: a call recorded
                    # after the snapshot must stay tracked
                    actor_tasks = self._inflight_actor.get(actor_id, {})
                    for tid in tasks:
                        actor_tasks.pop(tid, None)
                        self._maybe_delivered.pop(tid, None)
                    if not actor_tasks:
                        self._inflight_actor.pop(actor_id, None)
            elif state == "ALIVE":
                restarts = info.get("num_restarts", 0)
                for tid, (spec, streaming, seen) in tasks.items():
                    if restarts <= seen:
                        addr = self._maybe_delivered.get(tid)
                        if addr is not None:
                            self._settle_maybe_delivered(spec, addr)
                        continue  # same incarnation; still running
                    self._maybe_delivered.pop(tid, None)
                    if self._call_committed(spec, streaming):
                        continue
                    if spec.max_task_retries != 0:
                        try:
                            self._route_now(spec, streaming)
                        except ActorDiedError as e:
                            self._fail_actor_call(spec, streaming, e)
                        except (OSError, ConnectionError):
                            continue  # retry next tick
                    else:
                        self._fail_actor_call(
                            spec, streaming, ActorDiedError(
                                actor_id.hex(),
                                "actor restarted; in-flight call "
                                "lost (set max_task_retries to "
                                "resend)"))
                        with self._inflight_lock:
                            self._inflight_actor.get(
                                actor_id, {}).pop(tid, None)

    def _settle_maybe_delivered(self, spec: TaskSpec, addr: str) -> None:
        """A direct call whose connection closed between its request and
        its reply, on an incarnation that is still alive (its server
        dropped the connection): ask that incarnation's server whether
        it took the call, and send the call again if it did not.  The
        actor drops a task id it has seen, so a resend there cannot run
        it twice.  A server that cannot be reached is asked again on the
        next tick; once the incarnation is gone the watcher fails or
        resends the call as for any call in flight."""
        from ray_tpu_torch._private.protocol import RpcClient
        client = RpcClient(addr, connect_timeout=2.0)
        try:
            if not client.call("task_seen", spec.task_id):
                client.call_once("call_actor", spec)
        except (OSError, ConnectionError):
            return
        finally:
            client.close()
        self._maybe_delivered.pop(spec.task_id, None)

    def _fail_actor_call(self, spec: TaskSpec, streaming: bool,
                         error: BaseException) -> None:
        err = TaskError(error, "", spec.task_id.hex())
        data = serialization.dumps(err)
        for oid in spec.return_object_ids():
            self.cp.put_inline(oid, data, is_error=True)
        if streaming:
            self.commit_generator_done(spec.task_id, 1)
            self.commit_generator_item(spec.task_id, 0, err, is_error=True)
        deps = spec.dependencies()
        if deps:
            # release the submit-time dependency pin at each dep's owner
            from ray_tpu_torch._private import owner_routing
            owner_routing.route_purge(
                self.cp, self._nm_peer, b"task:" + spec.task_id,
                {spec.ref_owners.get(d) for d in deps})

    def _abtrace(self, *parts) -> None:
        from ray_tpu_torch._private.debug_trace import trace
        trace("actor_buffer", *parts, var="RAY_TPU_DEBUG_ACTOR_BUFFER")

    def _route_or_buffer(self, spec: TaskSpec, streaming: bool) -> None:
        """Route to the actor's node manager, or buffer until it's ALIVE.

        Buffered calls preserve per-caller order: a single flusher thread
        per actor drains the buffer FIFO once the actor starts.
        """
        actor_id = spec.actor_id
        cached = self._actor_state_cache.get(actor_id)
        if cached is not None and cached[0] == "ALIVE":
            # hot path: no control-plane round trip.  {} (not None) so
            # the dead-branch below can't mistake the cache hit for
            # "actor unknown"
            info: Optional[Dict[str, Any]] = {}
            state = "ALIVE"
        else:
            info = self.cp.get_actor_info(actor_id)
            state = info.get("state") if info else None
            if info:
                self._actor_state_cache[actor_id] = (
                    state, info.get("num_restarts", 0))
        self._abtrace("route_or_buffer", spec.name,
                      actor_id.hex()[:8], "state", state)
        with self._actor_buffer_lock:
            buffer = self._actor_buffers.get(actor_id)
            if state == "ALIVE" and buffer is None:
                pass  # fall through to direct route below
            elif state == "DEAD" or info is None:
                self._fail_actor_call(spec, streaming, ActorDiedError(
                    actor_id.hex() if actor_id else "",
                    (info or {}).get("death_reason", "actor is dead")))
                return
            else:
                if buffer is None:
                    buffer = []
                    self._actor_buffers[actor_id] = buffer
                    threading.Thread(
                        target=self._flush_actor_buffer,
                        args=(actor_id,), daemon=True,
                        name="actor-buffer-flush").start()
                buffer.append((spec, streaming))
                return
        try:
            self._route_now(spec, streaming)
            self._abtrace("routed_direct", spec.name)
        except ActorDiedError as e:
            self._abtrace("fail_direct", spec.name, str(e)[:60])
            self._fail_actor_call(spec, streaming, e)
        except (OSError, ConnectionError):
            self._actor_state_cache.pop(actor_id, None)
            # The actor's node manager is unreachable (its node just
            # died); buffer the call — the health loop will transition
            # the actor to RESTARTING (new address) or DEAD shortly.
            with self._actor_buffer_lock:
                buffer = self._actor_buffers.get(actor_id)
                if buffer is None:
                    buffer = []
                    self._actor_buffers[actor_id] = buffer
                    threading.Thread(
                        target=self._flush_actor_buffer,
                        args=(actor_id,), daemon=True,
                        name="actor-buffer-flush").start()
                buffer.append((spec, streaming))

    def _flush_actor_buffer(self, actor_id: bytes) -> None:
        deadline = time.monotonic() + 600.0
        info = self.cp.wait_actor_state(actor_id, ("ALIVE", "DEAD"),
                                        timeout=600.0)
        self._abtrace("flusher_woke", actor_id.hex()[:8],
                      (info or {}).get("state"))
        while True:
            with self._actor_buffer_lock:
                buffered = self._actor_buffers.get(actor_id, [])
                if not buffered:
                    self._actor_buffers.pop(actor_id, None)
                    return
                batch = list(buffered)
                buffered.clear()
            retry = []
            for spec, streaming in batch:
                if info is None or info.get("state") != "ALIVE":
                    self._fail_actor_call(
                        spec, streaming, ActorDiedError(
                            actor_id.hex(),
                            "actor failed to start" if info is None
                            else info.get("death_reason",
                                          "actor is dead")))
                else:
                    try:
                        self._route_now(spec, streaming)
                        self._abtrace("flushed", spec.name)
                    except ActorDiedError as e:
                        self._abtrace("fail_flush", spec.name,
                                      str(e)[:60])
                        self._fail_actor_call(spec, streaming, e)
                    except (OSError, ConnectionError):
                        retry.append((spec, streaming))
            if retry:
                if time.monotonic() > deadline:
                    for spec, streaming in retry:
                        self._fail_actor_call(
                            spec, streaming, ActorDiedError(
                                actor_id.hex(),
                                "actor unreachable past deadline"))
                    continue
                # stale ALIVE info pointing at a dead node: wait for the
                # health loop to move the actor, then try again
                with self._actor_buffer_lock:
                    self._actor_buffers.setdefault(actor_id,
                                                   []).extend(retry)
                time.sleep(0.5)
                info = self.cp.wait_actor_state(
                    actor_id, ("ALIVE", "DEAD"),
                    timeout=max(0.0, deadline - time.monotonic()))

    def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        self._actor_state_cache.pop(actor_id, None)
        self._actor_direct_cache.pop(actor_id, None)
        try:
            nm = self._actor_nm(actor_id, wait=True)
        except ActorDiedError:
            return
        if hasattr(nm, "call"):
            nm.call("kill_actor", actor_id, no_restart)
        else:
            nm.kill_actor(actor_id, no_restart)

    def cancel_task(self, ref: ObjectRef):
        if hasattr(self.nm, "call"):
            return self.nm.call("cancel_task", ref.task_id())
        return self.nm.cancel_task(ref.task_id())


# ----------------------------------------------------------------------
# Global worker management
# ----------------------------------------------------------------------
_global_worker: Optional[CoreWorker] = None
_global_node = None
_init_lock = threading.RLock()


def global_worker() -> CoreWorker:
    if _global_worker is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call "
            "ray_tpu_torch.init() first")
    return _global_worker


def set_global_worker(worker: Optional[CoreWorker], node=None):
    global _global_worker, _global_node
    _global_worker = worker
    _global_node = node


def global_node():
    return _global_node


def is_initialized() -> bool:
    return _global_worker is not None
