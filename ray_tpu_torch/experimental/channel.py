# The port's copy of ray_tpu/experimental/channel.py
"""Mutable shared-memory channels (parity: ``python/ray/experimental/
channel.py:51`` + ``core_worker/experimental_mutable_object_manager.cc``).

A Channel is one *reusable* shm slot between a writer and N readers on
the same host — the transport under compiled DAGs.  Unlike the immutable
object store, a channel is written ten-thousand times with zero
control-plane traffic: the slot carries a seqlock-style header and the
payload in place.

Protocol (x86 total-store-order; all header fields are aligned u64):
- writer: wait until every reader's ack equals the current seq (slot
  consumed), memcpy payload + length, then publish seq+1;
- reader: wait until seq > own ack, read payload, publish ack = seq.
Payload bytes are fully written before the seq bump and read only after
observing it, so torn reads are impossible under TSO.

Capacity is fixed at creation (default 1 MiB); oversized payloads raise.
A ``stop`` flag poisons the channel: readers raise ChannelClosed.
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
import time
from typing import Any, List, Optional

_MAX_READERS = 8
# header: seq, stop, length, n_readers, acks[8]
_HEADER = struct.Struct("<QQQQ" + "Q" * _MAX_READERS)
HEADER_SIZE = _HEADER.size


class ChannelClosed(Exception):
    pass


class ChannelFull(TimeoutError):
    pass


def _spin_wait(predicate, timeout: Optional[float], what: str):
    deadline = None if timeout is None else time.monotonic() + timeout
    spins = 0
    while not predicate():
        spins += 1
        if spins < 50:
            continue            # burst-poll the mmap header
        # yield quickly at first (a peer on this core may be about to
        # publish), back off to real sleeps if the slot stays idle
        time.sleep(0.00005 if spins < 500 else
                   (0.0005 if spins < 5000 else 0.002))
        if deadline is not None and time.monotonic() > deadline:
            raise ChannelFull(f"channel {what} timed out")


class Channel:
    """One slot, one writer, ``num_readers`` readers (same host).

    Pickleable: the receiving process maps the same shm file.  Each
    reader must claim a distinct ``reader_index``.
    """

    def __init__(self, path: str, capacity: int = 1 << 20,
                 num_readers: int = 1, _create: bool = True):
        if num_readers > _MAX_READERS:
            raise ValueError(f"at most {_MAX_READERS} readers")
        self.path = path
        self.capacity = capacity
        self.num_readers = num_readers
        if _create:
            with open(path, "wb") as f:
                f.truncate(HEADER_SIZE + capacity)
            self._map()
            _HEADER.pack_into(self._mm, 0, 0, 0, 0, num_readers,
                              *([0] * _MAX_READERS))
        else:
            self._map()

    def _map(self):
        self._f = open(self.path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(), HEADER_SIZE + self.capacity)

    # ------------------------------------------------------------------
    def _seq(self) -> int:
        return struct.unpack_from("<Q", self._mm, 0)[0]

    def _stop_flag(self) -> int:
        return struct.unpack_from("<Q", self._mm, 8)[0]

    def _acks(self) -> List[int]:
        return list(struct.unpack_from(
            "<" + "Q" * self.num_readers, self._mm, 32))

    # ------------------------------------------------------------------
    def write(self, value: Any, timeout: Optional[float] = 60.0) -> None:
        payload = pickle.dumps(value, protocol=5)
        if len(payload) > self.capacity:
            raise ValueError(
                f"payload of {len(payload)}B exceeds channel capacity "
                f"{self.capacity}B")
        seq = self._seq()
        _spin_wait(lambda: (all(a >= seq for a in self._acks())
                            or self._stop_flag()),
                   timeout, f"write {self.path}")
        if self._stop_flag():
            raise ChannelClosed(self.path)
        self._mm[HEADER_SIZE:HEADER_SIZE + len(payload)] = payload
        struct.pack_into("<Q", self._mm, 16, len(payload))
        struct.pack_into("<Q", self._mm, 0, seq + 1)   # publish

    def read(self, reader_index: int = 0,
             timeout: Optional[float] = 60.0) -> Any:
        ack_off = 32 + 8 * reader_index
        my_ack = struct.unpack_from("<Q", self._mm, ack_off)[0]
        _spin_wait(lambda: (self._seq() > my_ack or self._stop_flag()),
                   timeout, f"read {self.path}")
        if self._seq() <= my_ack and self._stop_flag():
            raise ChannelClosed(self.path)
        seq = self._seq()
        length = struct.unpack_from("<Q", self._mm, 16)[0]
        payload = bytes(self._mm[HEADER_SIZE:HEADER_SIZE + length])
        struct.pack_into("<Q", self._mm, ack_off, seq)  # release slot
        return pickle.loads(payload)

    def close(self) -> None:
        """Poison the channel: blocked/future readers and writers see
        ChannelClosed."""
        try:
            struct.pack_into("<Q", self._mm, 8, 1)
        except ValueError:
            pass                # already unmapped

    def unlink(self) -> None:
        self.close()
        try:
            self._mm.close()
            self._f.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __reduce__(self):
        return (Channel, (self.path, self.capacity, self.num_readers,
                          False))
