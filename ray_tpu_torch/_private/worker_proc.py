# The port's copy of ray_tpu/_private/worker_proc.py
"""Worker process entrypoint
(``python -m ray_tpu_torch._private.worker_proc``).

Analogue of the reference's ``python/ray/_private/workers/
default_worker.py`` + the execution half of the core worker: connects to
the node manager's task channel, executes pushed tasks/actor methods, and
commits results to the object store.
"""

from __future__ import annotations

import asyncio
import inspect
import socket
import os
import sys
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import protocol, serialization
from ray_tpu_torch._private.ids import JobID, WorkerID
from ray_tpu_torch._private.object_store import ShmStore
from ray_tpu_torch._private.task_spec import Arg, TaskSpec
from ray_tpu_torch._private.worker import CoreWorker, set_global_worker
from ray_tpu_torch.exceptions import TaskError, format_remote_traceback
from ray_tpu_torch.object_ref import ObjectRef


class WorkerProcess:
    def __init__(self):
        self.session_dir = os.environ["RAY_TPU_SESSION_DIR"]
        self.cp_sock = os.environ["RAY_TPU_CP_SOCK"]
        self.nm_sock = os.environ["RAY_TPU_NM_SOCK"]
        self.worker_id = WorkerID.from_hex(os.environ["RAY_TPU_WORKER_ID"])
        self.node_id = bytes.fromhex(os.environ["RAY_TPU_NODE_ID"])
        self.cp = protocol.RpcClient(self.cp_sock)
        self.nm_client = protocol.RpcClient(self.nm_sock)
        self.nm_client.sock_path = self.nm_sock
        self.store = ShmStore(
            os.environ["RAY_TPU_SHM_ROOT"],
            spill_dir=os.environ.get("RAY_TPU_SPILL_DIR") or None)
        self.stream = self.nm_client.hijack(
            "stream_worker", self.worker_id.binary())
        self._send_lock = threading.Lock()
        # direct-channel result push-back: caller worker_id -> stream
        self._direct_res_lock = threading.Lock()
        self._direct_result_conns: Dict[bytes, socket.socket] = {}
        self._direct_res_send_locks: Dict[bytes, threading.Lock] = {}
        # generator tasks whose stream already ends in its error item:
        # the task's own error commit must not rewrite that stream
        self._streams_ended: set = set()
        from ray_tpu_torch.util.tracing import maybe_enable_from_cluster
        maybe_enable_from_cluster(self.cp)
        # the node's card list as this process inherited it: the node
        # manager numbers cards 0..n-1 within it
        inherited = os.environ.get("CUDA_VISIBLE_DEVICES")
        self._node_devices = (inherited.split(",") if inherited
                              else None)
        self._bound_devices: Optional[str] = None
        self.core = CoreWorker(
            mode="worker", job_id=JobID.nil(), worker_id=self.worker_id,
            node_id=self.node_id, control_plane=self.cp,
            node_manager=self.nm_client, shm_store=self.store,
            session_dir=self.session_dir, nm_notify=self._send,
            nm_addr=self.nm_sock)
        set_global_worker(self.core)
        from ray_tpu_torch._private.ref_tracker import install_tracker
        install_tracker(self.worker_id.binary(), self.cp,
                        node_id=self.node_id)
        self._log_drain = None
        if os.environ.get("RAY_TPU_LOG_TO_DRIVER", "1") == "1":
            from ray_tpu_torch._private.log_streaming import install_worker_tee
            self._log_drain = install_worker_tee(
                self.cp, self.worker_id.binary())
        # actor execution machinery (populated on creation)
        self.actor_pool: Optional[ThreadPoolExecutor] = None
        self.actor_loop: Optional[asyncio.AbstractEventLoop] = None
        self.is_async_actor = False
        # direct caller->callee channel (populated on actor creation)
        self._direct_server = None
        # task_id -> "running" | ("done", error): duplicate deliveries
        # across the direct and relay channels are suppressed, but the
        # NM-notification obligation of a relayed dup is preserved
        import collections
        self._seen_tasks: "dict[bytes, object]" = {}
        self._seen_order: "collections.deque[bytes]" = \
            collections.deque()
        self._late_notify: "set[bytes]" = set()
        self._seen_lock = threading.Lock()
        # the fence: once the node manager is gone the direct server
        # reads no new request, and the requests it read are answered
        # and the calls it took run to their end before the process
        # exits (_fence)
        self._fence_cond = threading.Condition()
        self._fenced = False
        self._direct_busy = 0          # direct requests read, unanswered
        self._direct_taken: "set[bytes]" = set()

    def _send(self, msg: Dict[str, Any]):
        with self._send_lock:
            protocol.send_msg(self.stream, msg)

    # ------------------------------------------------------------------
    def run(self):
        while True:
            try:
                msg = protocol.recv_msg(self.stream)
            except (protocol.ConnectionClosed, ConnectionResetError,
                    OSError, EOFError):
                # NM channel dropped without an "exit" handshake: the
                # node manager died.  Exit now — a lingering actor
                # worker keeps answering cached direct-channel calls,
                # split-braining with the incarnation the health loop
                # restarts elsewhere — but only once the direct calls
                # it took have run (_fence).
                self._fence()
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(1)
            kind = msg.get("type")
            if kind == "exit":
                self._send({"type": "exit"})
                # fast exit: flush the log tee, then skip interpreter
                # finalization (library teardown + atexit walks
                # cost ~1.5 s per worker — every session shutdown on
                # the tier-1 box paid it x workers).  The NM-died
                # path above already exits this way.
                if self._log_drain is not None:
                    self._log_drain()
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(0)
            if kind != "task":
                continue
            spec: TaskSpec = msg["spec"]
            devices = msg.get("devices")
            if spec.actor_creation:
                self._execute_creation(spec, devices)
            elif spec.actor_id is not None:
                self._dispatch_actor_task(spec)
            else:
                self._execute_task(spec, devices)

    # ------------------------------------------------------------------
    def _resolve_args(self, spec: TaskSpec):
        def one(arg: Arg):
            if arg.inline is not None:
                return serialization.loads(arg.inline)
            return self.core.get(
                ObjectRef(arg.object_id,
                          spec.ref_owners.get(arg.object_id)))
        args = [one(a) for a in spec.args]
        kwargs = {k: one(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    def _set_visible_devices(self, devices: Optional[List[int]]):
        """Restrict this process to its cards (``CUDA_VISIBLE_DEVICES``),
        before the task's code or arguments are loaded.  CUDA reads the
        variable once, when the process initialises it, so a GPU worker
        keeps its first list for life; the node manager reuses it only
        for that list, and a different one is refused here."""
        if devices is None:
            return
        value = ",".join(
            self._node_devices[d] if self._node_devices else str(d)
            for d in devices)
        if self._bound_devices is not None and value != self._bound_devices:
            raise RuntimeError(
                f"GPU worker bound to CUDA_VISIBLE_DEVICES="
                f"{self._bound_devices!r} was sent cards {value!r}")
        os.environ["CUDA_VISIBLE_DEVICES"] = value
        self._bound_devices = value

    def _commit_results(self, spec: TaskSpec, result: Any):
        if spec.is_generator:
            count = 0
            try:
                if inspect.isgenerator(result) or hasattr(
                        result, "__iter__") and not isinstance(
                            result, (list, tuple, dict, str, bytes)):
                    for item in result:
                        self.core.commit_generator_item(
                            spec.task_id, count, item)
                        count += 1
                else:
                    for item in list(result):
                        self.core.commit_generator_item(
                            spec.task_id, count, item)
                        count += 1
            except BaseException as e:  # noqa: BLE001
                err = TaskError(e, format_remote_traceback(e),
                                spec.task_id.hex())
                self.core.commit_generator_item(spec.task_id, count, err,
                                                is_error=True)
                count += 1
                self.core.commit_generator_done(spec.task_id, count)
                self._streams_ended.add(spec.task_id)
                raise
            self.core.commit_generator_done(spec.task_id, count)
            # also commit the nominal return so plain get() works
            self.core.put_object(spec.return_object_ids()[0], count)
            return
        oids = spec.return_object_ids()
        if spec.num_returns == 1:
            return self.core.put_object(oids[0], result,
                                        owner_addr=spec.owner_addr)
        values = list(result)
        if len(values) != spec.num_returns:
            raise ValueError(
                f"task {spec.name} declared num_returns="
                f"{spec.num_returns} but returned {len(values)} values")
        for oid, v in zip(oids, values):
            self.core.put_object(oid, v, owner_addr=spec.owner_addr)
        return None

    def _commit_error(self, spec: TaskSpec, exc: BaseException):
        err = TaskError(exc, format_remote_traceback(exc),
                        spec.task_id.hex())
        inline = None
        try:
            for oid in spec.return_object_ids():
                inline = self.core.put_object(oid, err, is_error=True,
                                              owner_addr=spec.owner_addr)
            ended = spec.task_id in self._streams_ended
            self._streams_ended.discard(spec.task_id)
            if spec.is_generator and not ended:
                self.core.commit_generator_item(spec.task_id, 0, err,
                                                is_error=True)
                self.core.commit_generator_done(spec.task_id, 1)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
        return inline

    # ------------------------------------------------------------------
    def _execute_task(self, spec: TaskSpec, devices):
        from ray_tpu_torch.util.tracing import task_span
        self.core.current_task_id = spec.task_id
        error = False
        error_payload = None
        try:
            from ray_tpu_torch._private import runtime_env as _renv
            self._set_visible_devices(devices)
            fn = self.core.load_function(spec.function_key)
            args, kwargs = self._resolve_args(spec)
            with _renv.applied(spec.runtime_env), task_span(spec):
                if inspect.iscoroutinefunction(fn):
                    result = asyncio.run(fn(*args, **kwargs))
                else:
                    result = fn(*args, **kwargs)
            self._commit_results(spec, result)
        except BaseException as e:  # noqa: BLE001
            error = True
            if spec.retry_exceptions:
                # Defer the error commit: the node manager decides whether
                # to resubmit (reference: task retries on app exceptions).
                err = TaskError(e, format_remote_traceback(e),
                                spec.task_id.hex())
                error_payload = serialization.dumps(err)
            else:
                self._commit_error(spec, e)
        finally:
            self.core.current_task_id = None
        self._send({"type": "done", "task_id": spec.task_id, "error": error,
                    "error_payload": error_payload})

    def _execute_creation(self, spec: TaskSpec, devices):
        try:
            from ray_tpu_torch._private import runtime_env as _renv
            self._set_visible_devices(devices)
            if spec.runtime_env:
                # actors own their process: applied for life
                _renv.apply(spec.runtime_env)
            cls = self.core.load_function(spec.function_key)
            args, kwargs = self._resolve_args(spec)
            instance = cls(*args, **kwargs)
            self.core.current_actor = instance
            self.core.current_actor_id = spec.actor_id
            self.is_async_actor = any(
                inspect.iscoroutinefunction(getattr(cls, n, None))
                for n in dir(cls) if not n.startswith("__"))
            if self.is_async_actor:
                self.actor_loop = asyncio.new_event_loop()
                t = threading.Thread(target=self.actor_loop.run_forever,
                                     daemon=True, name="actor-loop")
                t.start()
                asyncio.run_coroutine_threadsafe(
                    self._event_loop_lag_monitor(spec.actor_id),
                    self.actor_loop)
            else:
                # always a pool (size 1 = strict serialization): direct
                # caller connections submit from their own threads, so
                # execution must funnel through one ordered executor
                self.actor_pool = ThreadPoolExecutor(
                    max_workers=max(1, spec.max_concurrency),
                    thread_name_prefix="actor")
            self.core.put_object(spec.return_object_ids()[0], None)
            # publish the direct-call address BEFORE flipping ALIVE:
            # every caller that observes the actor as ALIVE then uses
            # ONE channel from its first call — no relay/direct
            # interleaving window to break per-caller ordering
            self._start_direct_server(spec.actor_id)
            self._send({"type": "actor_ready", "actor_id": spec.actor_id,
                        "pid": os.getpid()})
        except BaseException as e:  # noqa: BLE001
            self._commit_error(spec, e)
            self._send({"type": "actor_init_failed",
                        "actor_id": spec.actor_id})
            self._send({"type": "done", "task_id": spec.task_id,
                        "error": True})

    async def _event_loop_lag_monitor(self, actor_id: bytes,
                                      period: float = 0.5,
                                      warn_ms: float = 200.0):
        """Async-actor responsiveness watchdog (SURVEY §5.2 — the
        asyncio analogue of a blocked-event-loop sanitizer: the
        reference leans on py-spy; here the loop measures its own
        scheduling lag).  A coroutine that blocks the loop shows up as
        lag: exported as the ``async_actor_event_loop_lag_ms`` gauge
        and warned to the worker log (streamed to the driver) when it
        exceeds ``warn_ms``."""
        import time as _time

        from ray_tpu_torch.util.metrics import Gauge
        gauge = None
        warned_at = 0.0
        last_published = -1.0
        ticks = 0
        while True:
            t0 = _time.monotonic()
            await asyncio.sleep(period)
            lag_ms = max(0.0, (_time.monotonic() - t0 - period) * 1e3)
            ticks += 1
            # gauge.set is a synchronous CP RPC: keep it OFF the loop
            # (the watchdog must never become the blocker it detects)
            # and publish only on material change or every ~30 ticks
            if (last_published < 0 or abs(lag_ms - last_published) > 10.0
                    or ticks % 30 == 0):
                last_published = lag_ms
                try:
                    if gauge is None:
                        gauge = Gauge(
                            "async_actor_event_loop_lag_ms",
                            "Scheduling delay of the async actor "
                            "event loop",
                            tag_keys=("actor_id",))
                    g, tag = gauge, {"actor_id": actor_id.hex()[:12]}
                    await asyncio.get_running_loop().run_in_executor(
                        None, lambda: g.set(lag_ms, tags=tag))
                except Exception:  # noqa: BLE001 - best-effort metric
                    pass
            if lag_ms > warn_ms and _time.monotonic() - warned_at > 10.0:
                warned_at = _time.monotonic()
                print(f"WARNING: async actor {actor_id.hex()[:12]} "
                      f"event loop lagged {lag_ms:.0f} ms — a handler "
                      "is blocking the loop (use asyncio.to_thread for "
                      "CPU/blocking work)", flush=True)

    def _dedup(self, spec: TaskSpec, notify_nm: bool = True) -> bool:
        """True if this task was already seen (at-least-once resend
        across the direct and relay channels).

        A relayed duplicate of a task first delivered on the direct
        channel carries an obligation the direct run didn't have: the
        NM that relayed it now tracks the task inflight and holds its
        dependency pins until a 'done' arrives.  Swallowing the dup
        silently would leak both — so a dup with ``notify_nm`` either
        emits 'done' now (run already finished) or flags the running
        task to notify at completion."""
        with self._seen_lock:
            state = self._seen_tasks.get(spec.task_id)
            if state is not None:
                if notify_nm:
                    if state == "running":
                        self._late_notify.add(spec.task_id)
                        return True
                    done, error = state
                else:
                    return True
                # fall through to send outside the lock
            else:
                self._seen_tasks[spec.task_id] = "running"
                self._seen_order.append(spec.task_id)
                if len(self._seen_order) > 4096:
                    # evict the oldest COMPLETED entry — a still-running
                    # task must keep its dedup record or a cross-channel
                    # duplicate would re-execute it.  Bounded rotation:
                    # if everything is running (pathological), grow.
                    for _ in range(len(self._seen_order)):
                        old = self._seen_order.popleft()
                        if self._seen_tasks.get(old) == "running":
                            self._seen_order.append(old)
                            continue
                        self._seen_tasks.pop(old, None)
                        self._late_notify.discard(old)
                        break
                return False
        self._send({"type": "done", "task_id": spec.task_id,
                    "error": error})
        return True

    def _finish_actor_task(self, spec: TaskSpec, notify_nm: bool,
                           error: bool,
                           inline: "Optional[bytes]" = None) -> None:
        """Completion bookkeeping shared by the sync and async runners:
        record the outcome for duplicate deliveries, notify the NM when
        either the original delivery or a relayed duplicate needs it,
        and push inline results back to direct-channel callers."""
        with self._seen_lock:
            if spec.task_id in self._seen_tasks:
                self._seen_tasks[spec.task_id] = ("done", error)
            late = spec.task_id in self._late_notify
            self._late_notify.discard(spec.task_id)
        if notify_nm or late:
            self._send({"type": "done", "task_id": spec.task_id,
                        "error": error})
        if not notify_nm:
            try:
                self._push_direct_result(spec, error, inline)
                self._purge_direct_pins(spec)
            finally:
                self._direct_done(spec.task_id)

    def _push_direct_result(self, spec: TaskSpec, error: bool,
                            inline: "Optional[bytes]") -> None:
        """Send the result straight back over the caller's result
        stream (reference: the direct transport replies in-band).  The
        result is ALSO committed to the CP as usual — this push is a
        latency cache, dropping 3 control-plane round trips from the
        sync call+get hot path; a lost push just means the caller falls
        back to the normal location/wait/fetch flow."""
        caller = spec.owner_id
        with self._direct_res_lock:
            conn = self._direct_result_conns.get(caller)
            lock = self._direct_res_send_locks.get(caller)
        if conn is None or lock is None:
            return
        oids = spec.return_object_ids()
        msg = {"oid": oids[0] if oids else b"",
               "payload": inline, "error": error}
        try:
            with lock:
                protocol.send_msg(conn, msg)
        except (OSError, BrokenPipeError):  # caller gone: CP path holds
            pass

    def _nm_alive(self) -> bool:
        """Whether the node manager's channel is still open: a peek that
        neither blocks nor consumes (the main thread owns the reads)."""
        try:
            return self.stream.recv(
                1, socket.MSG_PEEK | socket.MSG_DONTWAIT) != b""
        except BlockingIOError:
            return True
        except OSError:
            return False

    def _fence(self, timeout: float = 1.0) -> None:
        """The node manager is gone: the direct server reads no new
        request (it closes the connection with the request unread, which
        its caller sees as a reset), and this waits, at most ``timeout``
        seconds, until every request already read is answered and every
        call taken has committed its result.  A call this process took is
        answered by it; one it did not goes to the next incarnation."""
        with self._fence_cond:
            self._fenced = True
            self._fence_cond.wait_for(
                lambda: not self._direct_taken and not self._direct_busy,
                timeout)

    def _direct_done(self, task_id: bytes) -> None:
        with self._fence_cond:
            self._direct_taken.discard(task_id)
            self._fence_cond.notify_all()

    class _DirectGate:
        """The direct server's gate (``protocol.RpcServer``): a request
        is read only while the process is not fenced."""

        def __init__(self, proc: "WorkerProcess"):
            self._proc = proc

        def admit(self) -> bool:
            proc = self._proc
            with proc._fence_cond:
                if proc._fenced:
                    return False
                proc._direct_busy += 1
                return True

        def done(self) -> None:
            proc = self._proc
            with proc._fence_cond:
                proc._direct_busy -= 1
                proc._fence_cond.notify_all()

    def _dispatch_actor_task(self, spec: TaskSpec,
                             notify_nm: bool = True) -> bool:
        """Run or queue an actor call; False when it was a duplicate
        delivery and nothing was dispatched."""
        if self._dedup(spec, notify_nm):
            return False
        if self.is_async_actor and self.actor_loop is not None:
            asyncio.run_coroutine_threadsafe(
                self._run_actor_task_async(spec, notify_nm),
                self.actor_loop)
        elif self.actor_pool is not None:
            self.actor_pool.submit(self._run_actor_task, spec, notify_nm)
        else:
            self._run_actor_task(spec, notify_nm)
        return True

    # ------------------------------------------------------------------
    # Direct caller->callee channel.  Reference:
    # core_worker/transport/direct_actor_task_submitter.cc — callers
    # dial the actor process's own socket; the hosting node manager
    # stays out of the per-call hot path (placement/restart only).
    # ------------------------------------------------------------------
    class _DirectHandler:
        def __init__(self, proc: "WorkerProcess"):
            self._proc = proc

        def call_actor(self, spec: TaskSpec) -> bool:
            """Enqueue one actor call; returns once queued (results
            travel through the object store as usual).  Per-caller
            ordering: RpcClient conns are FIFO and the actor executor
            drains submissions in order.  Once this process's node
            manager is gone the call is refused with
            :class:`protocol.Fenced`, untaken: the caller sends it on to
            the next incarnation."""
            proc = self._proc
            with proc._fence_cond:
                if proc._fenced or not proc._nm_alive():
                    raise protocol.Fenced(
                        "actor worker's node manager is gone: call "
                        "refused, not taken")
                proc._direct_taken.add(spec.task_id)
            if not proc._dispatch_actor_task(spec, notify_nm=False):
                proc._direct_done(spec.task_id)
            return True

        def task_seen(self, task_id: bytes) -> bool:
            """Whether this incarnation took the call ``task_id`` (it
            runs, or ran): a caller whose connection closed before the
            reply asks before it sends the call again."""
            proc = self._proc
            with proc._seen_lock:
                return task_id in proc._seen_tasks

        def stream_results(self, conn: socket.socket,
                           caller_id: bytes) -> None:
            """Hijacked per-caller channel for inline result push-back.

            The caller never sends after the handshake; this thread
            parks on recv to notice the peer closing, then drops the
            registration so pushes stop."""
            proc = self._proc
            with proc._direct_res_lock:
                proc._direct_result_conns[caller_id] = conn
                proc._direct_res_send_locks[caller_id] = threading.Lock()
            try:
                while True:
                    if not conn.recv(4096):
                        break
            except OSError:
                pass
            finally:
                with proc._direct_res_lock:
                    if proc._direct_result_conns.get(caller_id) is conn:
                        proc._direct_result_conns.pop(caller_id, None)
                        proc._direct_res_send_locks.pop(caller_id, None)

    def _start_direct_server(self, actor_id: bytes) -> None:
        from ray_tpu_torch._private.protocol import is_tcp_address, \
            parse_tcp_address
        if is_tcp_address(self.nm_sock):
            # TCP session: a UDS path would be unreachable from other
            # hosts — bind an ephemeral TCP port on the NM's interface
            host, _ = parse_tcp_address(self.nm_sock)
            path = f"tcp://{host}:0"
        else:
            path = os.path.join(self.session_dir, "sockets",
                                f"actor_{actor_id.hex()[:12]}_"
                                f"{os.getpid()}.sock")
        try:
            self._direct_server = protocol.RpcServer(
                path, self._DirectHandler(self),
                gate=self._DirectGate(self),
                name=f"actor-{actor_id.hex()[:6]}")
            self.cp.call("update_actor", actor_id,
                         direct_addr=self._direct_server.address)
        except Exception:  # noqa: BLE001 — relay path still works
            traceback.print_exc()
            self._direct_server = None

    def _run_actor_task(self, spec: TaskSpec, notify_nm: bool = True):
        from ray_tpu_torch.util.tracing import task_span
        self.core.current_task_id = spec.task_id
        inline = None
        try:
            method = self._lookup_method(spec)
            args, kwargs = self._resolve_args(spec)
            with task_span(spec):
                result = method(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = asyncio.run(result)
            inline = self._commit_results(spec, result)
            error = False
        except BaseException as e:  # noqa: BLE001
            inline = self._commit_error(spec, e)
            error = True
        finally:
            self.core.current_task_id = None
        self._finish_actor_task(spec, notify_nm, error, inline)
        if spec.actor_method == "__ray_terminate__":
            os._exit(0)

    def _purge_direct_pins(self, spec: TaskSpec) -> None:
        """Direct calls bypass the hosting NM, so the callee releases
        the caller's dependency pre-pins at completion (the relay path
        does this in the NM's _unpin_dependencies)."""
        deps = spec.dependencies()
        if not deps:
            return
        from ray_tpu_torch._private import owner_routing
        owner_routing.route_purge(
            self.cp, self.core._nm_peer, b"task:" + spec.task_id,
            {spec.ref_owners.get(d) for d in deps})

    async def _run_actor_task_async(self, spec: TaskSpec,
                                    notify_nm: bool = True):
        self.core.current_task_id = spec.task_id
        inline = None
        try:
            method = self._lookup_method(spec)
            args, kwargs = self._resolve_args(spec)
            result = method(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            if spec.is_generator and inspect.isasyncgen(result):
                await self._commit_async_generator(spec, result)
            else:
                inline = self._commit_results(spec, result)
            error = False
        except BaseException as e:  # noqa: BLE001
            inline = self._commit_error(spec, e)
            error = True
        self._finish_actor_task(spec, notify_nm, error, inline)
        if spec.actor_method == "__ray_terminate__":
            os._exit(0)

    async def _commit_async_generator(self, spec: TaskSpec, result):
        """Streaming commit of an async generator (async-actor methods
        yielding items, e.g. Serve streaming responses): each yielded
        item becomes a generator slot as it is produced."""
        count = 0
        try:
            async for item in result:
                self.core.commit_generator_item(spec.task_id, count, item)
                count += 1
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, format_remote_traceback(e),
                            spec.task_id.hex())
            self.core.commit_generator_item(spec.task_id, count, err,
                                            is_error=True)
            count += 1
            self.core.commit_generator_done(spec.task_id, count)
            self._streams_ended.add(spec.task_id)
            raise
        self.core.commit_generator_done(spec.task_id, count)
        self.core.put_object(spec.return_object_ids()[0], count)

    def _lookup_method(self, spec: TaskSpec):
        instance = self.core.current_actor
        if spec.actor_method == "__ray_terminate__":
            return lambda: None
        if spec.actor_method == "__ray_call__":
            # run an arbitrary function against the actor instance
            def _call(fn, *a, **kw):
                return fn(instance, *a, **kw)
            return _call
        method = getattr(instance, spec.actor_method, None)
        if method is None:
            raise AttributeError(
                f"actor {type(instance).__name__} has no method "
                f"{spec.actor_method!r}")
        return method


def main():
    import faulthandler
    import signal
    faulthandler.register(signal.SIGUSR1)
    proc = WorkerProcess()
    try:
        proc.run()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()


if __name__ == "__main__":
    main()
