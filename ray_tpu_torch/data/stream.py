"""The streaming training data plane: a deterministic, preemption-proof
input pipeline.

The port's counterpart of ``ray_tpu/data/stream.py``: the cursor, the
document schedule, the readers, the chaos sites and the producer are
the reference's, so every batch and every cursor image is bit-equal to
its; the host-to-device double buffer (the reference's async
``jax.device_put``) is :class:`_DeviceStager`, pinned host buffers
copied on a side stream.

Shaped after the reference's streaming executor + backpressure policies
(``data/_internal/execution/streaming_executor.py``,
``backpressure_policy/``) but specialized to the one workload that
matters here: feeding ``[B, S]`` token batches to a train host at step
rate, overlapping all host work (shard reads, tokenized-document
packing, host->device transfer) with the device step — the prefetch
idiom applied on the host side, per arXiv:2011.03641's
concurrency-limits argument.

The load-bearing constraint is **determinism under preemption**: every
batch is a pure function of ``(seed, cursor)`` — the seed is part of
the stream's identity (carried in the cursor and validated on resume;
today the document schedule is deterministic round-robin, so the seed
is the hook where a future shuffle stage derives its permutations, not
a source of randomness yet).

- :class:`~ray_tpu_torch.data.source.DocumentSource` reads are pure, so a
  shard-reader death is recovered by restarting the reader and
  re-issuing the fetch verbatim — exactly-once sample accounting with
  no acknowledgement protocol.
- The :class:`StreamCursor` captures per-shard offsets, the packer
  residue (closed-but-unemitted rows + the partial row) and, by
  construction, the in-flight queue state: the cursor paired with a
  delivered batch describes the stream *after* that batch, so batches
  still sitting in the prefetch queue at a kill are simply regenerated
  — bit-for-bit — on resume.  Serialized as a fixed-capacity uint8
  array it rides :class:`~ray_tpu_torch.resilience.checkpoint.
  TrainCheckpointer` ``extras``.

Deterministic fault sites (``RAY_TPU_FAULTS``, ``util/chaos.py``):
``data.read`` (a shard fetch dies — the plane restarts the reader and
re-issues; a ``data.read@N..M:delay=S`` entry instead *slows* the
fetch, the gray failure the hedged read mitigates), ``data.pack`` (a
batch assembly dies before mutating packer state — retried),
``data.stall`` (a shard read sleeps — prefer ``:delay=S``; the bare
form sleeps the deprecated ``RAY_TPU_DATA_STALL_S`` alias).

**Hedged reads**: with ``RAY_TPU_DATA_HEDGE`` > 0, a shard read
that outlives the hedge budget is re-issued to a standby reader and
the first response wins.  Exactly-once needs no protocol: sources are
pure (both responses are byte-identical) and only cursor advancement
consumes a document — the loser's response is simply discarded.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

from ray_tpu_torch.data.config import data_config
from ray_tpu_torch.data.packer import PackedBatch, SamplePacker
from ray_tpu_torch.data.source import DocumentSource
from ray_tpu_torch.util import chaos

# fetch granularity: documents per reader round-trip (amortizes actor
# call overhead; determinism is unaffected — consumption order is the
# cursor's round-robin schedule, not fetch-completion order)
READ_CHUNK = 16

# default serialized-cursor capacity (bytes).  Fixed so checkpoint
# restore validation (shape/dtype leaf checks) accepts any snapshot of
# the same stream; the JSON payload length rides in a 4-byte prefix.
CURSOR_CAPACITY = 32768


class DataPlaneError(RuntimeError):
    """A shard read kept failing past ``RAY_TPU_DATA_RETRIES`` (or the
    pack stage did) — the input pipeline is down, loudly, instead of
    spinning or silently skipping samples."""


# ------------------------------------------------------------- cursor
@dataclasses.dataclass
class StreamCursor:
    """The exact stream position: everything needed to regenerate the
    next batch (and all batches after it) bit-identically.

    ``shard_offsets[s]`` is the next unread document index of shard
    ``s``; ``rotation`` the next shard the round-robin schedule draws
    from; ``packer`` the residue (see
    :meth:`~ray_tpu_torch.data.packer.SamplePacker.state_dict`).  The
    geometry fields (``num_shards``/``batch_size``/``seq_len``/
    ``pack``) are validated on resume — restoring a cursor into a
    different stream shape must fail loudly, not replay garbage.
    """
    seed: int
    num_shards: int
    batch_size: int
    seq_len: int
    pack: bool
    shard_offsets: List[int]
    rotation: int = 0
    epoch: int = 0
    batches: int = 0
    docs: int = 0
    packer: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def copy(self) -> "StreamCursor":
        return StreamCursor(
            seed=self.seed, num_shards=self.num_shards,
            batch_size=self.batch_size, seq_len=self.seq_len,
            pack=self.pack, shard_offsets=list(self.shard_offsets),
            rotation=self.rotation, epoch=self.epoch,
            batches=self.batches, docs=self.docs,
            packer=json.loads(json.dumps(self.packer)))

    # ------------------------------------------------- serialization
    def to_array(self, capacity: int = CURSOR_CAPACITY) -> np.ndarray:
        """Fixed-capacity uint8 image: 4-byte LE length + JSON payload,
        zero-padded — constant shape/dtype so checkpoint restore
        validation accepts every snapshot of one stream."""
        payload = json.dumps(dataclasses.asdict(self),
                             separators=(",", ":")).encode()
        if len(payload) + 4 > capacity:
            raise ValueError(
                f"serialized stream cursor is {len(payload)} bytes, "
                f"over the {capacity}-byte capacity — raise "
                "cursor_capacity (packer residue grows with B*S)")
        arr = np.zeros(capacity, np.uint8)
        arr[:4] = np.frombuffer(
            len(payload).to_bytes(4, "little"), np.uint8)
        arr[4:4 + len(payload)] = np.frombuffer(payload, np.uint8)
        return arr

    @staticmethod
    def from_array(arr: np.ndarray) -> "StreamCursor":
        raw = np.asarray(arr, np.uint8).tobytes()
        n = int.from_bytes(raw[:4], "little")
        if not 0 < n <= len(raw) - 4:
            raise ValueError(f"corrupt stream-cursor array (payload "
                             f"length {n} of {len(raw)} bytes)")
        state = json.loads(raw[4:4 + n].decode())
        return StreamCursor(**state)


# ------------------------------------------------------------- readers
def _read_docs(source: DocumentSource, shard: int, start: int,
               count: int):
    """The one read path both reader modes share — chaos sites fire
    here so in-process and actor readers exercise identical faults."""
    chaos.maybe_fail("data.read")
    if chaos.should_fire("data.stall"):
        time.sleep(data_config().stall_s)
    return source.read(shard, start, count)


class _InProcessReader:
    """readers=0: shard reads on the producer thread (host-sim)."""

    def __init__(self, source: DocumentSource):
        self._source = source

    def read(self, shard: int, start: int, count: int):
        return _read_docs(self._source, shard, start, count)

    def restart(self) -> None:
        pass


def _reader_actor_cls():
    # num_cpus=0: reader concurrency is bounded by the schedule, and
    # taking CPU slots would let queued work starve actor creation
    # (as the reference's streaming executor's pool workers)
    global _READER_ACTOR
    if _READER_ACTOR is None:
        import ray_tpu_torch

        @ray_tpu_torch.remote(num_cpus=0)
        class _ReaderActor:
            """One stateless shard reader: fetches are pure functions
            of the source, so a restarted actor re-serves any fetch
            verbatim."""

            def __init__(self, source):
                self.source = source

            def read(self, shard, start, count):
                from ray_tpu_torch.data.stream import _read_docs
                return _read_docs(self.source, shard, start, count)

        _READER_ACTOR = _ReaderActor
    return _READER_ACTOR


_READER_ACTOR = None


class _ActorReader:
    """One restartable shard-reader actor.  The actor holds no stream
    state (the source is pure), so restart = recreate: the re-issued
    fetch returns the identical documents."""

    def __init__(self, source: DocumentSource):
        self._source = source
        self._actor = None

    def _ensure(self):
        if self._actor is None:
            self._actor = _reader_actor_cls().remote(self._source)
        return self._actor

    def read(self, shard: int, start: int, count: int):
        import ray_tpu_torch
        return ray_tpu_torch.get(
            self._ensure().read.remote(shard, start, count),
            timeout=data_config().read_timeout_s)

    def restart(self) -> None:
        import ray_tpu_torch
        if self._actor is not None:
            try:
                ray_tpu_torch.kill(self._actor)
            except Exception:  # noqa: BLE001 — it may already be dead
                pass
        self._actor = None


class _DocSchedule:
    """The deterministic document iterator the cursor describes:
    round-robin across shards by ``cursor.rotation``/``shard_offsets``,
    epoch wrap when every shard drains, chunked fetches through
    restartable readers with a bounded retry budget.

    The RL prompt dataset draws its prompts through it
    (``rl/rollout.py:PromptDataset``), as the reference's does."""

    def __init__(self, source: DocumentSource, cursor: StreamCursor, *,
                 readers: int = 0, retries: int = 3,
                 hedge_s: Optional[float] = None, telemetry=None):
        self.source = source
        self.cursor = cursor
        self.retries = int(retries)
        self.hedge_s = data_config().hedge_s if hedge_s is None \
            else float(hedge_s)
        self.telemetry = telemetry
        self.reader_restarts = 0
        # read_hedges counts hedges issued; telemetry's
        # record_read_hedge fires per hedge resolved by a returning
        # leg — an attempt where both legs fail is counted here but
        # not there (it surfaces through the retry/restart counters)
        self.read_hedges = 0
        self.read_hedges_won = 0
        if readers > 0:
            self._readers = [_ActorReader(source) for _ in range(readers)]
        else:
            self._readers = [_InProcessReader(source)]
        self._standby: Optional[_InProcessReader] = None
        self._buf: Dict[int, List] = {}      # shard -> [(start, docs)]
        self._buf_start: Dict[int, int] = {}

    def _standby_reader(self, shard: int):
        """The reader a hedge re-issues to: the next reader replica
        when there is one, else a dedicated in-process reader over the
        same pure source (identical bytes either way)."""
        if len(self._readers) > 1:
            return self._readers[(shard + 1) % len(self._readers)]
        if self._standby is None:
            self._standby = _InProcessReader(self.source)
        return self._standby

    @staticmethod
    def _spawn_read(reader, shard: int, start: int, count: int,
                    wake: threading.Event) -> dict:
        """Run one read leg on a *daemon* thread (a leg parked in a
        genuinely hung read must neither block interpreter exit nor
        need a pool teardown the loader would have to own).  The box
        gains ``docs`` or ``err``, written before ``wake`` fires."""
        box: dict = {}

        def run():
            try:
                box["docs"] = reader.read(shard, start, count)
            except BaseException as e:  # noqa: BLE001 — leg lost
                box["err"] = e
            finally:
                wake.set()

        threading.Thread(target=run, name="data-read",
                         daemon=True).start()
        return box

    def _hedged_read(self, reader, shard: int, start: int, count: int):
        """One read attempt with a tail hedge: the primary runs on a
        daemon thread; past ``hedge_s`` with no response, a standby
        read races it and the first *successful* response wins.  The
        loser's (identical, by purity) response is discarded; a leg
        that errors just cedes the race, and only both legs failing
        fails the attempt."""
        wake = threading.Event()
        pbox = self._spawn_read(reader, shard, start, count, wake)
        wake.wait(self.hedge_s)
        if "docs" in pbox:
            return pbox["docs"]
        if "err" in pbox:
            raise pbox["err"]         # fast failure: the retry loop's
        self.read_hedges += 1
        sbox = self._spawn_read(self._standby_reader(shard), shard,
                                start, count, wake)
        while True:
            wake.clear()
            # primary checked first on a same-wake tie: "won" must
            # mean the standby genuinely beat it (box writes happen
            # before the wake, so a set flag means a decided leg)
            for box, is_standby in ((pbox, False), (sbox, True)):
                if "docs" in box:
                    if is_standby:
                        self.read_hedges_won += 1
                    if self.telemetry is not None:
                        self.telemetry.record_read_hedge(won=is_standby)
                    return box["docs"]
            if "err" in pbox and "err" in sbox:
                raise sbox["err"]
            wake.wait()

    def _fetch(self, shard: int, start: int, count: int):
        reader = self._readers[shard % len(self._readers)]
        for attempt in range(self.retries + 1):
            try:
                if self.hedge_s > 0:
                    return self._hedged_read(reader, shard, start,
                                             count)
                return reader.read(shard, start, count)
            except Exception as e:  # noqa: BLE001 — restart + re-issue
                if attempt >= self.retries:
                    raise DataPlaneError(
                        f"shard {shard} read at offset {start} failed "
                        f"{attempt + 1}x (retry budget "
                        f"{self.retries}): {e!r}") from e
                reader.restart()
                self.reader_restarts += 1
                if self.telemetry is not None:
                    self.telemetry.record_reader_restart()

    def _doc_at(self, shard: int, offset: int):
        docs = self._buf.get(shard)
        start = self._buf_start.get(shard, -1)
        if docs is None or not (start <= offset < start + len(docs)):
            docs = self._fetch(shard, offset, READ_CHUNK)
            self._buf[shard] = docs
            self._buf_start[shard] = offset
            start = offset
        return docs[offset - start]

    def next_doc(self, *, epochs: Optional[int] = None):
        """The next ``(doc_id, tokens)`` of the schedule, or None when
        a finite stream (``epochs``) is drained."""
        c = self.cursor
        for _wrap in range(2):
            n = c.num_shards
            for _ in range(n):
                s = c.rotation
                c.rotation = (c.rotation + 1) % n
                if c.shard_offsets[s] >= self.source.docs_in_shard(s):
                    continue
                doc = self._doc_at(s, c.shard_offsets[s])
                c.shard_offsets[s] += 1
                c.docs += 1
                return doc
            # every shard drained: epoch boundary
            c.epoch += 1
            if epochs is not None and c.epoch >= epochs:
                return None
            c.shard_offsets = [0] * n
            c.rotation = 0
            self._buf.clear()
            self._buf_start.clear()
        raise DataPlaneError("document source is empty (no shard has "
                             "any documents)")


# -------------------------------------------------------------- loader
@dataclasses.dataclass
class StreamBatch:
    """One delivered batch + the cursor that regenerates its
    successors (what the train loop puts in checkpoint extras)."""
    batch: Dict[str, Any]          # tokens/targets/segment_ids/positions
    cursor: StreamCursor           # stream state AFTER this batch
    spans: List                    # (row, col, doc_id, n) audit trail
    packed_tokens: int
    cursor_capacity: int = CURSOR_CAPACITY
    # the numpy batch a device batch was copied from (set_sharding
    # re-places a staged batch from it)
    host_batch: Optional[Dict[str, np.ndarray]] = dataclasses.field(
        default=None, repr=False)
    _cursor_array: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)

    @property
    def cursor_array(self) -> np.ndarray:
        """Fixed-capacity ckpt serialization — built lazily so
        batches that never reach a checkpointer (``RAY_TPU_CKPT_EVERY``
        off or off-cadence) pay no JSON encode or 32 KB buffer."""
        if self._cursor_array is None:
            self._cursor_array = self.cursor.to_array(
                self.cursor_capacity)
        return self._cursor_array


_DONE = object()


class _DeviceStager:
    """Host batch -> device batch, the reference's async
    ``jax.device_put`` on a card: each batch is written into one of two
    pinned host buffers and copied to the card on a side stream, so the
    copy runs under the step.  :meth:`deliver`, called as the batch is
    handed to the trainer, makes the trainer's stream wait for that copy
    and records the tensors on it (the allocator must not reuse them
    while the step reads them).  A pinned buffer is written again only
    after its previous copy's event has completed.  On the CPU a batch
    is a plain copy."""

    def __init__(self, device=None):
        from ray_tpu_torch.ops.substrate import resolve_device
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = None
        self._slots: List[Optional[Dict[str, Any]]] = [None, None]
        self._next = 0

    def put(self, batch: Dict[str, np.ndarray], sharding=None
            ) -> Dict[str, Any]:
        import warnings

        import torch
        with warnings.catch_warnings():
            # a batch read from the object store is a read-only view; it
            # is only read here (cloned, or copied into a pinned buffer)
            warnings.filterwarnings("ignore", message=".*not writable")
            host = {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items()}
        if sharding is not None:
            host = sharding(host)
        if not self._cuda:
            return {k: v.clone() for k, v in host.items()}
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        slot = self._slots[self._next]
        self._next ^= 1
        if slot is None or any(
                k not in slot["pinned"]
                or slot["pinned"][k].shape != v.shape
                or slot["pinned"][k].dtype != v.dtype
                for k, v in host.items()):
            if slot is not None:
                slot["event"].synchronize()
            slot = {"pinned": {k: torch.empty(v.shape, dtype=v.dtype,
                                              pin_memory=True)
                               for k, v in host.items()},
                    "event": torch.cuda.Event()}
            self._slots[self._next ^ 1] = slot
        else:
            slot["event"].synchronize()   # its last copy has landed
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in host.items():
                pinned = slot["pinned"][k]
                pinned.copy_(v)
                out[k] = pinned.to(self.device, non_blocking=True)
            slot["event"].record(self._stream)
        return out

    def deliver(self, batch: Dict[str, Any]) -> None:
        if not self._cuda or self._stream is None:
            return
        import torch
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(self._stream)
        for v in batch.values():
            v.record_stream(cur)


class StreamingLoader:
    """Bounded-prefetch, double-buffered, cursor-exact batch stream.

    A producer thread runs the deterministic assembler (schedule ->
    packer -> ``[B, S]`` arrays) and fills a ``prefetch``-bounded queue
    — backpressure against a slow trainer by construction.  The
    consumer (:meth:`next`) keeps one batch staged on device and
    issues the next host-to-device copy before returning, so the
    transfer hides under the step (:class:`_DeviceStager`: pinned
    buffers, a side stream; on the CPU a plain copy).

    ``device``: where delivered batches live (the card unless
    ``device="cpu"``; ``device_put=False`` keeps them as numpy arrays).
    ``sharding``: a function from the global host batch to this rank's
    part of it (``fns["shard_batch"]``), applied before the copy — the
    port's counterpart of the reference's ``NamedSharding``.

    Every delivered :class:`StreamBatch` carries the cursor of the
    stream *after* it; resuming with ``cursor=`` replays the identical
    continuation — batches that were sitting in the prefetch queue at
    a kill are regenerated, not lost (and never duplicated, because
    the checkpointed cursor only ever advances at delivery).
    """

    def __init__(self, source: DocumentSource, *, batch_size: int,
                 seq_len: int, seed: int = 0,
                 cursor: Union[None, StreamCursor, np.ndarray] = None,
                 epochs: Optional[int] = None,
                 pack: Optional[bool] = None,
                 prefetch: Optional[int] = None,
                 readers: Optional[int] = None,
                 retries: Optional[int] = None,
                 hedge_s: Optional[float] = None,
                 device_put: bool = True,
                 sharding=None,
                 device=None,
                 cursor_capacity: int = CURSOR_CAPACITY,
                 telemetry=None):
        dcfg = data_config()
        self.source = source
        self.epochs = epochs
        self.pack = dcfg.pack if pack is None else bool(pack)
        self.prefetch = dcfg.prefetch if prefetch is None else \
            max(1, int(prefetch))
        self.retries = dcfg.retries if retries is None else int(retries)
        readers = dcfg.readers if readers is None else int(readers)
        self.device_put = device_put
        self.sharding = sharding
        self._stager = _DeviceStager(device) if device_put else None
        self.cursor_capacity = int(cursor_capacity)
        from ray_tpu_torch.telemetry.data import DataTelemetry
        self.telemetry = telemetry if telemetry is not None \
            else DataTelemetry()
        if cursor is None:
            cursor = StreamCursor(
                seed=int(seed), num_shards=source.num_shards,
                batch_size=int(batch_size), seq_len=int(seq_len),
                pack=self.pack,
                shard_offsets=[0] * source.num_shards)
        elif not isinstance(cursor, StreamCursor):
            cursor = StreamCursor.from_array(cursor)
        want = (source.num_shards, int(batch_size), int(seq_len),
                self.pack, int(seed))
        got = (cursor.num_shards, cursor.batch_size, cursor.seq_len,
               cursor.pack, cursor.seed)
        if want != got:
            raise ValueError(
                f"stream cursor geometry mismatch: cursor has "
                f"(shards, B, S, pack, seed)={got}, loader wants "
                f"{want} — a cursor only resumes the stream it was "
                "taken from")
        self._cursor = cursor.copy()
        self._packer = SamplePacker(batch_size, seq_len, pack=self.pack)
        if cursor.packer:
            self._packer.load_state(cursor.packer)
        self._schedule = _DocSchedule(
            source, self._cursor, readers=readers, retries=self.retries,
            hedge_s=hedge_s, telemetry=self.telemetry)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._staged: Optional[StreamBatch] = None
        self._pending_error: Optional[BaseException] = None
        self._primed = False
        self._drained = False
        self._thread = threading.Thread(target=self._produce,
                                        daemon=True,
                                        name="data-producer")
        self._thread.start()

    # ----------------------------------------------------- producer
    def _assemble(self) -> Optional[PackedBatch]:
        """One deterministic batch (or None at end of a finite
        stream).  The ``data.pack`` site fires before any packer
        mutation, so a retry replays the identical assembly."""
        exhausted = False
        for attempt in range(self.retries + 1):
            try:
                chaos.maybe_fail("data.pack")
                break
            except chaos.InjectedFault:
                self.telemetry.record_pack_retry()
                if attempt >= self.retries:
                    raise DataPlaneError(
                        "batch assembly failed past the retry budget "
                        f"({self.retries})")
        while not self._packer.ready:
            doc = self._schedule.next_doc(epochs=self.epochs)
            if doc is None:
                exhausted = True
                self._packer.flush()
                break
            self._packer.add(*doc)
        return self._packer.pop_batch(allow_partial=exhausted)

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                # wall covers assembly + snapshot ONLY — including the
                # block inside _put (a full queue) would collapse the
                # input-tok/s gauge to the consumer's rate under
                # backpressure, hiding which side has headroom
                t0 = time.monotonic()
                pb = self._assemble()
                if pb is None:
                    self._put(_DONE)
                    return
                c = self._cursor
                c.batches += 1
                c.packer = self._packer.state_dict()
                snap = c.copy()
                sb = StreamBatch(
                    batch=pb.as_train_batch(with_segments=self.pack),
                    cursor=snap,
                    spans=pb.spans, packed_tokens=pb.packed_tokens,
                    cursor_capacity=self.cursor_capacity)
                wall = time.monotonic() - t0
                self._put(sb)
                self.telemetry.record_batch(
                    pb.packed_tokens, wall,
                    queue_depth=self._q.qsize())
        except BaseException as e:  # noqa: BLE001 — surface on next()
            self._put(e)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # ----------------------------------------------------- consumer
    def _pop(self) -> Optional[StreamBatch]:
        if self._drained:
            return None
        t0 = time.monotonic()
        item = self._q.get()
        self.telemetry.record_stall(time.monotonic() - t0)
        if item is _DONE:
            self._drained = True
            return None
        if isinstance(item, BaseException):
            self._drained = True
            if isinstance(item, DataPlaneError):
                raise item
            raise DataPlaneError(
                f"data producer died: {item!r}") from item
        if self._stager is not None and item is not None:
            item.host_batch = item.batch
            item.batch = self._stager.put(item.batch, self.sharding)
        return item

    def next(self) -> StreamBatch:
        """The next batch, device-resident, with its cursor.  The
        successor's transfer is dispatched before returning (double
        buffering) so it copies while the caller steps.

        A producer error encountered while staging the successor is
        held back until the already-produced staged batch has been
        delivered — errors never cost a good batch or reorder
        delivery."""
        if not self._primed:
            self._staged = self._pop()
            self._primed = True
        if self._pending_error is not None:
            err, self._pending_error = self._pending_error, None
            raise err
        out = self._staged
        if out is None:
            raise StopIteration
        if self._stager is not None:
            self._stager.deliver(out.batch)
        try:
            self._staged = self._pop()
        except DataPlaneError as e:
            self._staged = None
            self._pending_error = e
        return out

    def set_sharding(self, sharding) -> None:
        """Re-point delivery at a new mesh (the elastic shrink/expand
        path): subsequent batches are cut by ``sharding`` before their
        copy, and the already-staged double-buffered batch is re-placed so
        the very next :meth:`next` also lands on the new topology —
        the cursor, packer residue and prefetch queue are untouched,
        which is what keeps the consumed document sequence identical
        across topology changes."""
        self.sharding = sharding
        if self._stager is not None and self._primed and \
                self._staged is not None:
            self._staged.batch = self._stager.put(
                self._staged.host_batch, sharding)

    def __iter__(self) -> Iterator[StreamBatch]:
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)

    def __enter__(self) -> "StreamingLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
