"""``ray_tpu_torch.util.collective`` — collectives between actors.

Counterpart of ``ray_tpu/util/collective.py`` (API parity: the
reference's ``python/ray/util/collective/collective.py``:
init_collective_group, allreduce, allgather, reducescatter, broadcast,
reduce, barrier, send, recv).  The backend strings keep the JAX
package's meanings:

- ``"host"`` / ``"cpu"`` / ``"gloo"`` → :class:`HostGroup`: ring
  collectives over the runtime's object store, with a
  :class:`CollectiveStore` rendezvous actor that shuttles only
  ObjectRefs.  Numpy in, numpy out.  (``"gloo"`` names the reference's
  gloo-equivalent here, not ``torch.distributed``'s gloo.)
- ``"xla"`` / ``"tpu"`` / ``"nccl"`` → :class:`LocalDeviceGroup`, the
  counterpart of ``XlaGroup``: single-process verbs over this process's
  visible devices (the leading axis holds one row per device).
- ``"ici"`` → :class:`ProcessGroup`, the counterpart of ``IciGroup``:
  one ``torch.distributed`` world across processes.  Rank 0 starts the
  rendezvous store and publishes its ``ip:port`` in the control-plane KV
  (the reference's key scheme and 120 s freshness window); every rank
  calls ``init_process_group`` on it, NCCL in a worker that holds a card
  (``torch.cuda.set_device(0)`` first) and gloo in one that does not.
  The verbs are ``torch.distributed`` collectives; ``global_mesh(**axes)``
  is a mesh over the world (``parallel.mesh.make_mesh``), data-parallel
  by default.
  A failed NCCL init raises: nothing falls back to gloo.

Group state is per process, keyed by group name (reference
``GroupManager``).
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.actor import get_actor

_groups: Dict[str, "BaseGroup"] = {}
_lock = threading.Lock()

_BINOPS = {"sum": np.add, "product": np.multiply, "min": np.minimum,
           "max": np.maximum}

REDUCE_OPS = {name: (lambda arrs, f=f: _tree_reduce(arrs, f))
              for name, f in _BINOPS.items()}


def _tree_reduce(arrs, op):
    out = arrs[0]
    for a in arrs[1:]:
        out = op(out, a)
    return out


@ray_tpu_torch.remote
class CollectiveStore:
    """Async rendezvous + reduction actor (one per group)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._bufs: Dict[str, Dict[int, Any]] = {}
        self._events: Dict[str, asyncio.Event] = {}
        self._results: Dict[str, Any] = {}
        self._consumed: Dict[str, int] = {}
        self._p2p: Dict[Any, Any] = {}
        self._p2p_events: Dict[str, asyncio.Event] = {}

    def _event(self, key: str) -> asyncio.Event:
        if key not in self._events:
            self._events[key] = asyncio.Event()
        return self._events[key]

    async def gather(self, op_id: str, rank: int, value: Any):
        """Collect one contribution; resolves once all ranks arrived."""
        bufs = self._bufs.setdefault(op_id, {})
        bufs[rank] = value
        ev = self._event(op_id)
        if len(bufs) == self.world_size:
            self._results[op_id] = [bufs[r]
                                    for r in range(self.world_size)]
            ev.set()
        else:
            await ev.wait()
        result = self._results[op_id]
        # garbage-collect once every rank has read
        self._consumed[op_id] = self._consumed.get(op_id, 0) + 1
        if self._consumed[op_id] == self.world_size:
            self._bufs.pop(op_id, None)
            self._events.pop(op_id, None)
            self._results.pop(op_id, None)
            self._consumed.pop(op_id, None)
        return result

    async def set_config(self, key: str, value: Any):
        """Group-wide config agreed at init (the ring threshold): rank 0
        sets, everyone else waits, so every rank picks one algorithm."""
        self._p2p[("cfg", key)] = value
        self._event(f"cfg:{key}").set()

    async def get_config(self, key: str):
        await self._event(f"cfg:{key}").wait()
        return self._p2p[("cfg", key)]

    async def put_p2p(self, key: str, value: Any):
        self._p2p[key] = value
        if key not in self._p2p_events:
            self._p2p_events[key] = asyncio.Event()
        self._p2p_events[key].set()

    async def get_p2p(self, key: str):
        """The mailbox entry, not popped: the mailbox keeps the contained
        ObjectRef alive until the receiver has fetched it (``ack_p2p``)."""
        if key not in self._p2p_events:
            self._p2p_events[key] = asyncio.Event()
        await self._p2p_events[key].wait()
        return self._p2p[key]

    async def ack_p2p(self, key: str):
        self._p2p.pop(key, None)
        self._p2p_events.pop(key, None)


class BaseGroup:
    def __init__(self, world_size: int, rank: int, group_name: str):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self._seq = 0

    def _next_op(self, verb: str) -> str:
        self._seq += 1
        return f"{self.group_name}:{verb}:{self._seq}"

    def destroy(self):
        pass


class HostGroup(BaseGroup):
    """Ring collectives; payloads via the object store, refs via mailbox.

    Every rank calls each verb in the same order (the collective
    contract), so the per-group op sequence numbers agree across ranks
    and key the per-step mailboxes."""

    # Below this payload size the ring's 2(W-1) sequential hops cost
    # more than one rendezvous round trip; RAY_TPU_COLLECTIVE_RING_MIN
    # overrides it (rank 0's value is published to the group)
    RING_MIN_BYTES = 4 * 1024 * 1024

    def __init__(self, world_size: int, rank: int, group_name: str):
        super().__init__(world_size, rank, group_name)
        self._p2p_seq: Dict[Any, int] = {}
        self._ring_min: Optional[int] = None
        store_name = f"__collective_{group_name}"
        if rank == 0:
            try:
                self.store = CollectiveStore.options(
                    name=store_name, lifetime="detached").remote(world_size)
            except ValueError:
                self.store = get_actor(store_name)
            try:
                ring_min = int(os.environ.get(
                    "RAY_TPU_COLLECTIVE_RING_MIN", self.RING_MIN_BYTES))
            except ValueError:
                ring_min = self.RING_MIN_BYTES
            ray_tpu_torch.get(self.store.set_config.remote("ring_min",
                                                           ring_min))
        else:
            t0 = time.time()
            while True:
                try:
                    self.store = get_actor(store_name)
                    break
                except ValueError:
                    if time.time() - t0 > 30.0:
                        raise
                    time.sleep(0.05)

    def _exchange(self, verb: str, value: Any) -> List[Any]:
        """Full gather through the actor, for tiny payloads (barrier
        tokens, refs)."""
        op = self._next_op(verb)
        return ray_tpu_torch.get(self.store.gather.remote(op, self.rank,
                                                          value))

    def _exchange_arrays(self, verb: str, arr) -> List[np.ndarray]:
        """All ranks see all arrays; payloads ride the object store and
        the actor shuttles refs.  The trailing exchange keeps every
        rank's ref alive until all have fetched."""
        ref = ray_tpu_torch.put(np.ascontiguousarray(arr))
        refs = self._exchange(verb, [ref])
        values = ray_tpu_torch.get([r[0] for r in refs])
        self._exchange(verb + "_ack", None)
        return [np.asarray(v) for v in values]

    def _ring_threshold(self) -> int:
        if self._ring_min is None:
            self._ring_min = ray_tpu_torch.get(
                self.store.get_config.remote("ring_min"))
        return self._ring_min

    # -- ring plumbing ------------------------------------------------
    def _ring_send(self, op: str, step: int, dst: int, arr) -> None:
        key = f"{op}:s{step}:{self.rank}->{dst}"
        ref = ray_tpu_torch.put(np.ascontiguousarray(arr))
        # the ack: the mailbox holds (and refcounts) the ref before our
        # local handle can be dropped
        ray_tpu_torch.get(self.store.put_p2p.remote(key, [ref]))

    def _ring_recv(self, op: str, step: int, src: int):
        key = f"{op}:s{step}:{src}->{self.rank}"
        (ref,) = ray_tpu_torch.get(self.store.get_p2p.remote(key))
        value = ray_tpu_torch.get(ref)
        self.store.ack_p2p.remote(key)
        return value

    def _ring_reduce_scatter(self, op_id: str, chunks, binop):
        """In-place ring reduce-scatter; afterwards chunk[(rank+1) % W]
        holds the full reduction on this rank."""
        W, r = self.world_size, self.rank
        nxt, prv = (r + 1) % W, (r - 1) % W
        for step in range(W - 1):
            send_idx = (r - step) % W
            recv_idx = (r - step - 1) % W
            self._ring_send(op_id, step, nxt, chunks[send_idx])
            chunks[recv_idx] = binop(chunks[recv_idx],
                                     self._ring_recv(op_id, step, prv))
        return chunks

    def _ring_allgather(self, op_id: str, chunks, owned_idx: int):
        """Circulate chunks so every rank ends with all of them."""
        W, r = self.world_size, self.rank
        nxt, prv = (r + 1) % W, (r - 1) % W
        for step in range(W - 1):
            send_idx = (owned_idx - step) % W
            recv_idx = (owned_idx - step - 1) % W
            self._ring_send(op_id, step, nxt, chunks[send_idx])
            chunks[recv_idx] = self._ring_recv(op_id, step, prv)
        return chunks

    # -- verbs --------------------------------------------------------
    def allreduce(self, tensor, op: str = "sum"):
        arr = np.asarray(tensor)
        W = self.world_size
        if W == 1:
            return arr
        binop = _BINOPS[op]
        if arr.nbytes < self._ring_threshold():
            return REDUCE_OPS[op](self._exchange_arrays("allreduce", arr))
        flat = arr.reshape(-1)
        chunks = [c.copy() for c in np.array_split(flat, W)]
        op_rs = self._next_op("ar_rs")
        op_ag = self._next_op("ar_ag")
        chunks = self._ring_reduce_scatter(op_rs, chunks, binop)
        chunks = self._ring_allgather(op_ag, chunks, (self.rank + 1) % W)
        return np.concatenate(chunks).reshape(arr.shape)

    def allgather(self, tensor) -> List[np.ndarray]:
        arr = np.asarray(tensor)
        W = self.world_size
        if W == 1:
            return [arr]
        if arr.nbytes < self._ring_threshold():
            return self._exchange_arrays("allgather", arr)
        chunks: List[Any] = [None] * W
        chunks[self.rank] = arr
        chunks = self._ring_allgather(self._next_op("ag"), chunks,
                                      self.rank)
        return [np.asarray(c) for c in chunks]

    def reducescatter(self, tensor, op: str = "sum"):
        arr = np.asarray(tensor)
        W = self.world_size
        if W == 1:
            return arr
        binop = _BINOPS[op]
        if arr.nbytes < self._ring_threshold():
            red = REDUCE_OPS[op](self._exchange_arrays("rs_direct", arr))
            return np.array_split(red, W)[self.rank]
        chunks = [c.copy() for c in np.array_split(arr, W)]
        chunks = self._ring_reduce_scatter(self._next_op("rs"), chunks,
                                           binop)
        # rank holds chunk (rank+1)%W reduced; route it to its owner
        op_mv = self._next_op("rs_mv")
        owner = (self.rank + 1) % W
        if owner != self.rank:
            self._ring_send(op_mv, 0, owner, chunks[owner])
            mine = self._ring_recv(op_mv, 0, (self.rank - 1) % W)
        else:
            mine = chunks[owner]
        return np.asarray(mine)

    def broadcast(self, tensor, src_rank: int = 0):
        # one put by src; the trailing exchange keeps src's ref alive
        # until every rank has fetched
        if self.rank == src_rank:
            ref = ray_tpu_torch.put(np.asarray(tensor))
            arrs = self._exchange("broadcast", [ref])
        else:
            arrs = self._exchange("broadcast", None)
        (ref,) = arrs[src_rank]
        value = np.asarray(ray_tpu_torch.get(ref))
        self._exchange("broadcast_ack", None)
        return value

    def reduce(self, tensor, dst_rank: int = 0, op: str = "sum"):
        arr = np.asarray(tensor)
        W = self.world_size
        if W == 1:
            return arr
        binop = _BINOPS[op]
        if arr.nbytes < self._ring_threshold():
            arrs = self._exchange_arrays("red_direct", arr)
            return (REDUCE_OPS[op](arrs) if self.rank == dst_rank
                    else arr)
        chunks = [c.copy() for c in np.array_split(arr.reshape(-1), W)]
        chunks = self._ring_reduce_scatter(self._next_op("red_rs"), chunks,
                                           binop)
        # every rank sends its reduced chunk to dst
        op_gv = self._next_op("red_gather")
        mine_idx = (self.rank + 1) % W
        if self.rank != dst_rank:
            self._ring_send(op_gv, mine_idx, dst_rank, chunks[mine_idx])
            return arr
        for i in range(W):
            src = (i - 1) % W
            if src == dst_rank:
                continue
            chunks[i] = self._ring_recv(op_gv, i, src)
        return np.concatenate(chunks).reshape(arr.shape)

    def barrier(self):
        self._exchange("barrier", None)

    def send(self, tensor, dst_rank: int, tag: int = 0):
        # a per-(peer, tag) sequence keeps every key unique, so a late
        # fire-and-forget ack never deletes a later message
        n = self._p2p_seq.setdefault(("s", dst_rank, tag), 0)
        self._p2p_seq[("s", dst_rank, tag)] = n + 1
        key = f"{self.group_name}:p2p:{self.rank}->{dst_rank}:{tag}:{n}"
        ref = ray_tpu_torch.put(np.asarray(tensor))
        ray_tpu_torch.get(self.store.put_p2p.remote(key, [ref]))

    def recv(self, src_rank: int, tag: int = 0):
        n = self._p2p_seq.setdefault(("r", src_rank, tag), 0)
        self._p2p_seq[("r", src_rank, tag)] = n + 1
        key = f"{self.group_name}:p2p:{src_rank}->{self.rank}:{tag}:{n}"
        (ref,) = ray_tpu_torch.get(self.store.get_p2p.remote(key))
        value = np.asarray(ray_tpu_torch.get(ref))
        self.store.ack_p2p.remote(key)
        return value


def _to_tensor(x, device):
    """(tensor on ``device``, whether the caller passed numpy)."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device), False
    return torch.as_tensor(np.asarray(x)).to(device), True


def _like_input(t, was_numpy: bool):
    return t.cpu().numpy() if was_numpy else t


class LocalDeviceGroup(BaseGroup):
    """Single-process verbs over this process's visible devices: the
    counterpart of ``XlaGroup``.  ``world_size`` is the device count; a
    verb's input holds one leading row (or block of rows) per device,
    placed on its device, and the reduction runs across the devices.
    ``devices``: the devices to use (default: every visible card; on a
    process without one, raise)."""

    def __init__(self, world_size: int, rank: int, group_name: str,
                 devices=None):
        super().__init__(world_size, rank, group_name)
        import torch
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend 'nccl' (single-process device verbs) needs a "
                    "visible card; pass devices=[...] to use others")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices][:world_size]

    def _shards(self, tensor):
        t, was_numpy = _to_tensor(tensor, self.devices[0])
        if t.shape[0] % len(self.devices):
            raise ValueError(
                f"a leading axis of {t.shape[0]} does not split over "
                f"{len(self.devices)} devices")
        return ([c.to(d) for c, d in zip(t.chunk(len(self.devices)),
                                         self.devices)], was_numpy)

    def allreduce(self, tensor, op: str = "sum"):
        """The elementwise reduction of the devices' rows."""
        import torch
        shards, was_numpy = self._shards(tensor)
        first = self.devices[0]
        red = {"sum": torch.add, "product": torch.mul, "min": torch.minimum,
               "max": torch.maximum}.get(op)
        if red is None:
            raise ValueError(f"unknown reduce op {op!r}")
        out = shards[0]
        for s in shards[1:]:
            out = red(out, s.to(first))
        return _like_input(out, was_numpy)

    def allgather(self, tensor) -> List[Any]:
        shards, was_numpy = self._shards(tensor)
        return [_like_input(s, was_numpy) for s in shards]

    def reducescatter(self, tensor, op: str = "sum"):
        """Rows summed across devices, then scattered: each device's
        chunk of the sum, stacked on dim 0 (one process owns them all)."""
        import torch
        if op != "sum":
            raise ValueError("reducescatter supports sum")
        shards, was_numpy = self._shards(tensor)
        if shards[0].shape[0] != 1:
            raise ValueError(f"reducescatter needs one leading row per "
                             f"device ({len(self.devices)})")
        total = shards[0][0].clone()
        for s in shards[1:]:
            total += s[0].to(total.device)
        parts = total.chunk(len(self.devices))
        return _like_input(torch.stack([p.clone() for p in parts]),
                           was_numpy)

    def broadcast(self, tensor, src_rank: int = 0):
        return tensor     # one process: already everywhere

    def barrier(self):
        import torch
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


class ProcessGroup(BaseGroup):
    """One ``torch.distributed`` world across processes: the counterpart
    of ``IciGroup``, with NCCL in place of ``jax.distributed``.

    Rank 0 starts the rendezvous store on an ephemeral port (bound by
    the store itself, so no other process can take the port between a
    probe and its use) and publishes ``ip:port`` under a control-plane
    KV key; every rank joins and calls ``init_process_group`` with
    ``timeout`` seconds for every collective, so a rank whose peers died
    raises instead of hanging a restart.  ``dist_backend``: ``"nccl"``
    or ``"gloo"`` (default: NCCL where this worker holds a card, else
    gloo).  ``rendezvous``: the KV key's id (default: the group name);
    the train backend gives each attempt its own, so a restart never
    reads the address of the world it replaces.  With a live world in
    the process, the group adopts it.  ``init_s``: the seconds from the
    rendezvous to a ready world (NCCL's communicator included: it is
    created at init, bound to card 0)."""

    def __init__(self, world_size: int, rank: int, group_name: str,
                 coordinator: Optional[str] = None, timeout: float = 180.0,
                 dist_backend: Optional[str] = None,
                 rendezvous: Optional[str] = None):
        super().__init__(world_size, rank, group_name)
        self._rendezvous_id = rendezvous or group_name
        import datetime

        import torch
        import torch.distributed as dist
        self._owns_world = False
        if dist.is_initialized():
            if dist.get_world_size() != world_size or \
                    dist.get_rank() != rank:
                raise ValueError(
                    f"the live process group is rank {dist.get_rank()} of "
                    f"{dist.get_world_size()}, not {rank} of {world_size}")
            self.backend = dist.get_backend()
            self.coordinator = coordinator
            self.init_s = 0.0
            return
        backend = dist_backend or ("nccl" if _holds_a_card() else "gloo")
        device_id = None
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("backend 'nccl' needs a card in this "
                                   "worker (num_gpus >= 1)")
            # the worker's one visible card, before NCCL sees the world
            torch.cuda.set_device(0)
            device_id = torch.device("cuda", 0)
        t0 = time.monotonic()
        td = datetime.timedelta(seconds=timeout)
        if rank == 0:
            store = dist.TCPStore(_node_ip(), 0, world_size, is_master=True,
                                  timeout=td, wait_for_workers=False)
            coordinator = f"{_node_ip()}:{store.port}"
            self._publish(coordinator)
        else:
            if coordinator is None:
                coordinator = self._rendezvous(timeout)
            host, port = coordinator.rsplit(":", 1)
            store = dist.TCPStore(host, int(port), world_size,
                                  is_master=False, timeout=td)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, timeout=td,
                                device_id=device_id)
        self.init_s = time.monotonic() - t0
        self._owns_world = True
        self.backend = backend
        self.coordinator = coordinator

    @property
    def _kv_key(self) -> bytes:
        return f"__ici_coordinator_{self._rendezvous_id}".encode()

    # joiners ignore coordinator records older than this: a crashed
    # run's stale key must not capture a fresh group's rendezvous
    _COORD_FRESH_S = 120.0

    def _publish(self, coordinator: str) -> None:
        from ray_tpu_torch._private.worker import global_worker
        payload = json.dumps({"addr": coordinator, "ts": time.time()})
        global_worker().cp.kv_put(self._kv_key, payload.encode(),
                                  namespace="_collective")

    def _rendezvous(self, timeout: float) -> str:
        from ray_tpu_torch._private.worker import global_worker
        worker = global_worker()
        t0 = time.time()
        while True:
            raw = worker.cp.kv_get(self._kv_key, namespace="_collective")
            if raw:
                try:
                    rec = json.loads(raw.decode())
                    if rec["ts"] >= t0 - self._COORD_FRESH_S:
                        return rec["addr"]
                except (ValueError, KeyError, TypeError):
                    pass  # stale or foreign record: keep polling
            if time.time() - t0 > timeout:
                raise TimeoutError(
                    f"no coordinator published for group "
                    f"{self.group_name!r} within {timeout}s")
            time.sleep(0.05)

    def global_mesh(self, **axes):
        """A mesh over the world: ``axes`` as ``parallel.mesh.make_mesh``
        takes them (``fsdp=2, tp=2``), data-parallel by default."""
        from ray_tpu_torch.parallel.mesh import make_mesh
        return make_mesh(**(axes or {"dp": -1}))

    def _device(self):
        import torch
        return (torch.device("cuda", torch.cuda.current_device())
                if self.backend == "nccl" else torch.device("cpu"))

    @staticmethod
    def _op(op: str):
        import torch.distributed as dist
        ops = {"sum": dist.ReduceOp.SUM, "product": dist.ReduceOp.PRODUCT,
               "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
        if op not in ops:
            raise ValueError(f"unknown reduce op {op!r}")
        return ops[op]

    def allreduce(self, tensor, op: str = "sum"):
        import torch.distributed as dist
        t, was_numpy = _to_tensor(tensor, self._device())
        t = t.clone()
        dist.all_reduce(t, op=self._op(op))
        return _like_input(t, was_numpy)

    def allgather(self, tensor) -> List[Any]:
        import torch
        import torch.distributed as dist
        t, was_numpy = _to_tensor(tensor, self._device())
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(outs, t)
        return [_like_input(o, was_numpy) for o in outs]

    def reducescatter(self, tensor, op: str = "sum"):
        import torch
        red = self.allreduce(tensor, op=op)
        if isinstance(red, np.ndarray):
            return np.array_split(red, self.world_size)[self.rank]
        return torch.tensor_split(red, self.world_size)[self.rank].clone()

    def broadcast(self, tensor, src_rank: int = 0):
        import torch.distributed as dist
        t, was_numpy = _to_tensor(tensor, self._device())
        t = t.clone().contiguous()
        dist.broadcast(t, src=src_rank)
        return _like_input(t, was_numpy)

    def reduce(self, tensor, dst_rank: int = 0, op: str = "sum"):
        import torch.distributed as dist
        t, was_numpy = _to_tensor(tensor, self._device())
        out = t.clone().contiguous()
        dist.reduce(out, dst=dst_rank, op=self._op(op))
        return _like_input(out if self.rank == dst_rank else t, was_numpy)

    def barrier(self):
        import torch.distributed as dist
        dist.barrier()

    def destroy(self):
        import torch.distributed as dist
        if self._owns_world and dist.is_initialized():
            dist.destroy_process_group()
        if self.rank == 0:
            try:
                from ray_tpu_torch._private.worker import global_worker
                global_worker().cp.kv_del(self._kv_key,
                                          namespace="_collective")
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass


def _holds_a_card() -> bool:
    """Whether this worker was given a card (``CUDA_VISIBLE_DEVICES``
    names one), read without initialising CUDA."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return bool(visible and visible.strip() not in ("", "-1"))


def _node_ip() -> str:
    """This worker's node address from the control plane (loopback on
    a one-host cluster)."""
    try:
        from ray_tpu_torch._private.worker import global_worker
        worker = global_worker()
        node = worker.cp.get_node(worker.node_id) or {}
        return node.get("ip") or "127.0.0.1"
    except Exception:  # noqa: BLE001 — no runtime: this host
        return "127.0.0.1"


def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default", **kwargs) -> None:
    """Register this process/actor as ``rank`` of a collective group."""
    with _lock:
        if group_name in _groups:
            raise ValueError(f"group {group_name!r} already initialized")
        if backend in ("host", "cpu", "gloo"):
            group = HostGroup(world_size, rank, group_name)
        elif backend in ("xla", "tpu", "nccl"):
            group = LocalDeviceGroup(world_size, rank, group_name, **kwargs)
        elif backend == "ici":
            group = ProcessGroup(world_size, rank, group_name, **kwargs)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        _groups[group_name] = group


def create_collective_group(actors, world_size: int, ranks: List[int],
                            backend: str = "host",
                            group_name: str = "default"):
    """Driver-side setup: ``init_collective_group`` on each actor."""
    refs = []
    for actor, rank in zip(actors, ranks):
        refs.append(actor.__ray_call__.remote(
            _remote_init, world_size, rank, backend, group_name))
    ray_tpu_torch.get(refs)


def _remote_init(self_instance, world_size, rank, backend, group_name):
    init_collective_group(world_size, rank, backend, group_name)
    return rank


def _group(group_name: str) -> BaseGroup:
    group = _groups.get(group_name)
    if group is None:
        raise ValueError(
            f"collective group {group_name!r} is not initialized in this "
            "process; call init_collective_group() first")
    return group


def get_group(group_name: str = "default") -> BaseGroup:
    return _group(group_name)


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


def destroy_collective_group(group_name: str = "default") -> None:
    with _lock:
        group = _groups.pop(group_name, None)
    if group is not None:
        group.destroy()


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return _group(group_name).allreduce(tensor, op=op)


def allgather(tensor, group_name: str = "default"):
    return _group(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    return _group(group_name).reducescatter(tensor, op=op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group(group_name).broadcast(tensor, src_rank=src_rank)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = "sum"):
    return _group(group_name).reduce(tensor, dst_rank=dst_rank, op=op)


def barrier(group_name: str = "default"):
    _group(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0):
    _group(group_name).send(tensor, dst_rank, tag)


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    return _group(group_name).recv(src_rank, tag)
