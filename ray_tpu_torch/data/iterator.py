"""Per-consumer stream iterators (``Dataset.streaming_split``).

Counterpart of ``ray_tpu/data/iterator.py`` over the port's runtime;
``iter_torch_batches`` takes the place of ``iter_jax_batches``.
Parity: Ray's ``Dataset.streaming_split`` +
``data/_internal/execution/operators/output_splitter.py`` — one
execution of the dataset feeds N consumers *disjoint* block streams, so
N Train workers ingest one epoch cooperatively without materializing or
duplicating it.  A coordinator actor owns the single streaming
execution; iterators (cheap, serializable — they travel to the train
workers) pull blocks from it.

Dispatch: by default first-come-first-served (a fast consumer takes
more blocks — the reference's default load-balancing behavior);
``equal=True`` hands blocks out in complete rounds and row-splits the
final partial round so every consumer sees the same number of blocks
(±1 row), which gang-stepping SPMD workers need to stay in lock step.

Epochs: each fresh iteration of a ``DataIterator`` is one epoch.  The
coordinator starts the next epoch's execution once every consumer has
either drained or *abandoned* the previous one (requesting epoch k+1
counts as abandoning k — a ``islice``-style partial epoch does not wedge
the stream).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterator, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote(num_cpus=0)
class _SplitCoordinator:
    def __init__(self, ds_blob: bytes, n: int, equal: bool):
        import cloudpickle
        self._ds = cloudpickle.loads(ds_blob)
        self._n = n
        self._equal = equal
        self._epoch = 0
        self._reset()

    def _reset(self):
        self._gen = None
        self._queues: List[deque] = [deque() for _ in range(self._n)]
        self._done = False
        self._round: List[Any] = []     # equal mode: blocks of one round
        # consumers that finished or abandoned the current epoch
        self._moved_on: set = set()

    def _advance_round(self, final: bool) -> None:
        """equal mode: release buffered blocks once a full round of n is
        collected; at stream end, row-split the partial round n ways so
        consumers stay block-count equal."""
        if len(self._round) == self._n:
            for i, ref in enumerate(self._round):
                self._queues[i].append(ref)
            self._round = []
        elif final and self._round:
            from ray_tpu_torch.data.dataset import _fan_out, _split_block
            for ref in self._round:
                parts = _fan_out([_split_block.options(
                    num_returns=self._n).remote(ref, self._n, None)])[0]
                for i, p in enumerate(parts):
                    self._queues[i].append(p)
            self._round = []

    def next_block_ref(self, split: int, epoch: int = 0):
        """Pull the next block for consumer ``split`` within ``epoch``.

        Returns ``("ref", ref)``, ``("end",)`` when the epoch's stream
        is exhausted for this consumer, or ``("wait",)`` while other
        consumers are still on the previous epoch.
        """
        if epoch < self._epoch:
            return ("end",)     # a stream the caller already left behind
        if epoch > self._epoch:
            self._moved_on.add(split)
            if len(self._moved_on) == self._n:
                # everyone is past the old epoch: restart the stream
                if self._gen is not None:
                    self._gen.close()
                self._epoch = epoch
                self._reset()
            else:
                return ("wait",)
        if self._gen is None:
            self._gen = self._ds._execute()
        q = self._queues[split]
        if q:
            return ("ref", q.popleft())
        while True:
            if self._done:
                self._moved_on.add(split)
                return ("end",)
            try:
                ref = next(self._gen)
            except StopIteration:
                self._done = True
                if self._equal:
                    self._advance_round(final=True)
                    if q:
                        return ("ref", q.popleft())
                self._moved_on.add(split)
                return ("end",)
            if not self._equal:
                return ("ref", ref)  # greedy: the asker takes the block
            self._round.append(ref)
            self._advance_round(final=False)
            if q:
                return ("ref", q.popleft())

    def stats(self):
        return {"done": self._done, "epoch": self._epoch,
                "queued": [len(q) for q in self._queues]}


class _CoordinatorOwner:
    """Caller-side owner: kills the coordinator actor when the last
    caller-held iterator is GC'd (worker-side copies never own it).

    Also pins the source dataset: its block ObjectRefs travel to the
    coordinator inside an opaque pickle blob that dependency pinning
    cannot see, so this strong reference is what keeps them alive until
    the coordinator has unpickled (and thereby re-registered) them."""

    def __init__(self, coordinator, dataset=None):
        self.coordinator = coordinator
        self.dataset = dataset

    def __del__(self):
        try:
            ray_tpu_torch.kill(self.coordinator)
        except Exception:  # noqa: BLE001 — shutdown/interp teardown
            pass


class DataIterator:
    """One consumer's view of a streaming split (serializable).

    Each fresh iteration (``iter_block_refs``/``iter_batches``/...)
    consumes one epoch; the coordinator restarts the stream once every
    consumer has drained or abandoned the previous epoch."""

    def __init__(self, coordinator: Any, split: int, epoch: int = 0):
        self._coord = coordinator
        self._split = split
        self._epoch = epoch
        self._owner: Optional[_CoordinatorOwner] = None

    def iter_block_refs(self) -> Iterator[Any]:
        import time
        epoch = self._epoch
        self._epoch += 1
        while True:
            out = ray_tpu_torch.get(
                self._coord.next_block_ref.remote(self._split, epoch),
                timeout=600)
            if out[0] == "wait":
                time.sleep(0.05)
                continue
            if out[0] == "end":
                return
            yield out[1]

    def iter_blocks(self) -> Iterator[Any]:
        for ref in self.iter_block_refs():
            yield ray_tpu_torch.get(ref, timeout=600)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_blocks: int = 0) -> Iterator[Any]:
        from ray_tpu_torch.data.dataset import iter_fixed_batches
        yield from iter_fixed_batches(
            self.iter_blocks(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           device=None, dtypes=None,
                           drop_last: bool = False, prefetch: int = 2,
                           batch_format: str = "numpy",
                           sharding=None) -> Iterator[Any]:
        """Device-fed batches of this consumer's stream (see
        ``Dataset.iter_torch_batches``): a train worker passes its own
        card, ``device=None`` is the card and never the CPU."""
        from ray_tpu_torch.data.dataset import iter_device_batches
        if batch_format != "numpy":
            raise ValueError(
                "iter_torch_batches requires batch_format='numpy'")
        it = self.iter_batches(batch_size=batch_size,
                               batch_format=batch_format,
                               drop_last=drop_last)
        yield from iter_device_batches(it, device=device, dtypes=dtypes,
                                       prefetch=prefetch, sharding=sharding)

    def iter_rows(self) -> Iterator[Any]:
        from ray_tpu_torch.data.block import BlockAccessor
        for block in self.iter_blocks():
            yield from BlockAccessor.for_block(block).to_pylist()

    def count(self) -> int:
        """Row count of one epoch of this consumer's stream (drains it)."""
        from ray_tpu_torch.data.block import num_rows
        return sum(num_rows(b) for b in self.iter_blocks())

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def shutdown(self) -> None:
        """Tear down the shared coordinator actor."""
        try:
            ray_tpu_torch.kill(self._coord)
        except Exception:  # noqa: BLE001
            pass

    def __reduce__(self):
        # worker-side copies share the coordinator but never own it
        return (DataIterator, (self._coord, self._split, self._epoch))
