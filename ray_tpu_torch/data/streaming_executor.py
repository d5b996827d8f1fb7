"""Streaming operator-DAG executor for Datasets.

Counterpart of ``ray_tpu/data/streaming_executor.py``, over the port's
runtime (``ray_tpu_torch.remote``/``wait``/``kill`` and actor pools).
Parity: ``python/ray/data/_internal/execution/streaming_executor.py:55``
and ``operators/actor_pool_map_operator.py`` — a chain of physical
operators, each with a bounded number of in-flight tasks (backpressure),
draining completions in one scheduling loop so downstream stages overlap
upstream ones.  Differences from the reference, on purpose: budgets are
task-count based (the shm store's LRU + spill already bounds memory), and
the loop runs in the calling thread that consumes the iterator (pull
model) instead of a dedicated scheduler thread.  Two differences from
``ray_tpu/data/streaming_executor.py``, which leave the outputs and
their order as they are: an operator's completed outputs that wait for
an earlier one to be released count against its task budget, so a slow
head-of-line block bounds how far the operator runs ahead (a ``limit``
stops launching once its prefix is out); and outputs handed downstream
are launched there at once, not after the next completion.

Operators:
- ``MapOperator`` — one task per block over a fused chain of map stages.
- ``ActorPoolMapOperator`` — stateful UDFs (``map_batches(cls)``): a
  fixed pool of actors, least-loaded dispatch, constructed once per
  actor (reference ``ActorPoolStrategy``).
- ``AllToAllOperator`` — barrier (shuffle/repartition/sort): needs every
  upstream block before emitting.

Ordering: every operator releases outputs downstream in input order, so
the final iterator is deterministic regardless of completion order.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.object_ref import ObjectRef

DEFAULT_OP_BUDGET = 8


def _ref_size(ref: ObjectRef) -> int:
    """Committed size of a block ref (0 for inline/unknown)."""
    try:
        from ray_tpu_torch._private.worker import global_worker
        loc = global_worker().cp.get_locations(
            [ref.binary()]).get(ref.binary())
        return int(loc.get("size", 0)) if loc else 0
    except Exception:  # noqa: BLE001 — sizing is best-effort
        return 0


class PhysicalOperator:
    """Base: bounded in-flight tasks + in-order output release.

    Two backpressure axes (reference:
    ``data/_internal/execution/backpressure_policy/`` +
    ``resource_manager.py`` per-op budgets):
    - task count: at most ``budget`` tasks in flight or completed and
      waiting for an earlier output to be released;
    - memory: with ``DataContext.op_bytes_budget`` set, launches pause
      while the operator's OUTSTANDING bytes (completed-but-unreleased
      buffer + estimated in-flight outputs) exceed the cap — a fat map
      stage can't balloon the object store however fast upstream feeds
      it.  One launch is always allowed when nothing is outstanding, so
      a block bigger than the budget still makes progress.
    """

    def __init__(self, name: str, budget: int = DEFAULT_OP_BUDGET):
        from ray_tpu_torch.data.context import DataContext
        self.name = name
        self.budget = budget
        self.bytes_budget = DataContext.get_current().op_bytes_budget
        self.inqueue: deque = deque()           # (seq, ref) from upstream
        self.inflight: Dict[bytes, Tuple[int, ObjectRef]] = {}
        self._completed: Dict[int, ObjectRef] = {}
        self._next_in = 0                        # seq assigned to inputs
        self._next_out = 0                       # next seq to release
        self.input_done = False
        self.max_observed_inflight = 0
        self._out_sizes: Dict[int, int] = {}
        self._buffered_bytes = 0
        self._avg_out_bytes = 0.0
        self._n_sized = 0
        self.max_outstanding_bytes = 0

    # -- upstream side -------------------------------------------------
    def add_input(self, ref: ObjectRef) -> None:
        self.inqueue.append((self._next_in, ref))
        self._next_in += 1

    def mark_input_done(self) -> None:
        self.input_done = True

    # -- scheduling ----------------------------------------------------
    def outstanding_bytes(self) -> int:
        return int(self._buffered_bytes
                   + len(self.inflight) * self._avg_out_bytes)

    def can_launch(self) -> bool:
        if not self.inqueue or \
                len(self.inflight) + len(self._completed) >= self.budget:
            return False
        if self.bytes_budget is not None and \
                (self.inflight or self._completed):
            if self._n_sized == 0:
                # no output-size estimate yet: probe with ONE task
                # instead of blind-launching the whole task budget
                return False
            if self.outstanding_bytes() >= self.bytes_budget:
                return False
        return True

    def launch_one(self) -> Optional[ObjectRef]:
        """Submit the next queued block; returns the task ref to track."""
        seq, ref = self.inqueue.popleft()
        out = self._submit(ref)
        self.inflight[out.binary()] = (seq, out)
        self.max_observed_inflight = max(self.max_observed_inflight,
                                         len(self.inflight))
        return out

    def _submit(self, ref: ObjectRef) -> ObjectRef:
        raise NotImplementedError

    def on_done(self, ref: ObjectRef) -> None:
        seq, out = self.inflight.pop(ref.binary())
        self._completed[seq] = out
        if self.bytes_budget is not None:
            size = _ref_size(out)
            self._out_sizes[seq] = size
            self._buffered_bytes += size
            self._n_sized += 1
            self._avg_out_bytes += (size - self._avg_out_bytes) \
                / self._n_sized
            self.max_outstanding_bytes = max(self.max_outstanding_bytes,
                                             self.outstanding_bytes())

    def release_ready(self) -> List[ObjectRef]:
        """Outputs whose predecessors have all been released (in order)."""
        out = []
        while self._next_out in self._completed:
            out.append(self._completed.pop(self._next_out))
            self._buffered_bytes -= self._out_sizes.pop(self._next_out, 0)
            self._next_out += 1
        return out

    def finished(self) -> bool:
        return (self.input_done and not self.inqueue
                and not self.inflight and not self._completed)

    def maybe_fire(self) -> None:
        """Hook for operators with non-per-input launches (barriers,
        merge phases); called every scheduling round."""

    def expected_outputs(self, n_inputs: int) -> int:
        """Output-count propagation through the chain (pre-pass)."""
        return n_inputs

    def shutdown(self) -> None:
        pass


class MapOperator(PhysicalOperator):
    def __init__(self, fused: List[Tuple[str, Callable, Dict]],
                 budget: int = DEFAULT_OP_BUDGET):
        names = "->".join(k for k, _, _ in fused)
        super().__init__(f"Map[{names}]", budget)
        self._fused = fused

    def _submit(self, ref: ObjectRef) -> ObjectRef:
        from ray_tpu_torch.data.dataset import _map_block
        return _map_block.remote(ref, self._fused)


# num_cpus=0: the pool size already bounds concurrency, and taking CPU
# slots would let queued upstream tasks starve the pool's actor creation
# (priority inversion the reference solves with operator resource
# reservation, streaming_executor ReservationOpResourceAllocator).
@ray_tpu_torch.remote(num_cpus=0)
class _PoolWorker:
    """One actor of an ActorPoolMapOperator: constructs the UDF once."""

    def __init__(self, cls, args, kwargs):
        self.udf = cls(*(args or ()), **(kwargs or {}))

    def apply(self, block, batch_size, batch_format):
        from ray_tpu_torch.data.block import (BlockAccessor,
                                              batch_to_block, concat_blocks)
        acc = BlockAccessor.for_block(block)
        out = []
        for batch in acc.iter_batches(batch_size, batch_format):
            out.append(batch_to_block(self.udf(batch)))
        return concat_blocks(out) if out else acc.slice(0, 0)


class ActorPoolMapOperator(PhysicalOperator):
    """Stateful map_batches: fixed actor pool, least-loaded dispatch.

    Parity: reference ``actor_pool_map_operator.py:1`` +
    ``ActorPoolStrategy``.
    """

    def __init__(self, cls, *, pool_size: int = 2,
                 fn_constructor_args=None, fn_constructor_kwargs=None,
                 batch_size: Optional[int] = None,
                 batch_format: str = "numpy",
                 budget: Optional[int] = None):
        super().__init__(f"ActorPoolMap[{getattr(cls, '__name__', cls)}]",
                         budget or 2 * pool_size)
        self._batch_size = batch_size
        self._batch_format = batch_format
        # pool is spawned lazily on the first block: metadata peeks
        # (schema/count/take) build operators too, and shouldn't pay
        # pool_size process spawns when little or no work reaches here
        self._cls = cls
        self._ctor = (fn_constructor_args, fn_constructor_kwargs)
        self._pool_size = pool_size
        self._actors: List[Any] = []
        self._load: List[int] = []
        self._ref_actor: Dict[bytes, int] = {}

    def _ensure_pool(self) -> None:
        if not self._actors:
            args, kwargs = self._ctor
            self._actors = [_PoolWorker.remote(self._cls, args, kwargs)
                            for _ in range(self._pool_size)]
            self._load = [0] * self._pool_size

    def _submit(self, ref: ObjectRef) -> ObjectRef:
        self._ensure_pool()
        i = self._load.index(min(self._load))
        self._load[i] += 1
        out = self._actors[i].apply.remote(ref, self._batch_size,
                                           self._batch_format)
        self._ref_actor[out.binary()] = i
        return out

    def on_done(self, ref: ObjectRef) -> None:
        i = self._ref_actor.pop(ref.binary(), None)
        if i is not None:
            self._load[i] -= 1
        super().on_done(ref)

    def shutdown(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self._actors = []


class ShuffleOperator(PhysicalOperator):
    """Full random shuffle with a *streaming* split stage.

    The old path materialized every upstream block at a barrier, then
    fanned out split+merge (``dataset._all_to_all_refs``) — upstream map
    work and shuffle work never overlapped.  Here each arriving block is
    split into ``num_outputs`` random parts immediately (so splits run
    concurrently with upstream maps under the normal per-op budget);
    only the per-output merges wait for the whole input, which is the
    data dependency a full shuffle cannot avoid.  Reference analogue:
    push-based shuffle's pipelined map/reduce stages
    (``data/_internal/execution/operators`` + backpressure).
    """

    def __init__(self, seed: Optional[int] = None,
                 num_outputs: Optional[int] = None,
                 budget: int = DEFAULT_OP_BUDGET):
        super().__init__("Shuffle", budget)
        # seed=None must still SHUFFLE (a fresh random seed per run) —
        # _split_block treats seed=None as a contiguous, deterministic
        # split, which is no shuffle at all
        if seed is None:
            import os as _os
            seed = int.from_bytes(_os.urandom(4), "little")
        self.seed = seed
        self.num_outputs = num_outputs   # filled by the executor pre-pass
        self._parts: Dict[int, List[ObjectRef]] = {}  # input idx -> parts
        self._n_inputs = 0
        self._merge_mode = False
        self._pending_merges: List[int] = []
        # observability: splits that completed while upstream was still
        # producing (the overlap this operator exists to create)
        self.overlapped_splits = 0

    def expected_outputs(self, n_inputs: int) -> int:
        if self.num_outputs is None:
            self.num_outputs = max(1, n_inputs)
        return self.num_outputs

    def _submit(self, ref: ObjectRef) -> ObjectRef:
        from ray_tpu_torch.data.dataset import _fan_out, _split_block
        k = self.num_outputs or 1
        idx = self._n_inputs
        self._n_inputs += 1
        parts = _fan_out([_split_block.options(num_returns=k).remote(
            ref, k, self.seed + idx)])[0]
        self._parts[idx] = parts
        return parts[0]     # any part: all commit when the task ends

    def on_done(self, ref: ObjectRef) -> None:
        if self._merge_mode:
            super().on_done(ref)
            return
        self.inflight.pop(ref.binary())
        if not self.input_done:
            self.overlapped_splits += 1

    def release_ready(self) -> List[ObjectRef]:
        if not self._merge_mode:
            return []       # split parts are internal, not outputs
        return super().release_ready()

    def maybe_fire(self) -> None:
        if not self._merge_mode:
            if (not self.input_done or self.inqueue or self.inflight):
                return
            self._merge_mode = True
            if self._n_inputs == 0:
                return
            self._pending_merges = list(range(self.num_outputs or 1))
        # merges launch under the same budget as everything else (one
        # burst of num_outputs tasks x num_inputs args would flood the
        # scheduler the backpressure design exists to protect)
        from ray_tpu_torch.data.dataset import _merge_blocks
        while (self._pending_merges
               and len(self.inflight) < max(self.budget, 1)):
            j = self._pending_merges.pop(0)
            out = _merge_blocks.remote(
                *[self._parts[i][j] for i in range(self._n_inputs)])
            self.inflight[out.binary()] = (j, out)
        if not self._pending_merges:
            self._parts = {}

    def finished(self) -> bool:
        return (self.input_done and not self.inqueue and self._merge_mode
                and not getattr(self, "_pending_merges", None)
                and not self.inflight and not self._completed)


class AllToAllOperator(PhysicalOperator):
    """Barrier operator: buffers every upstream block, then fans out the
    shuffle/repartition/sort tasks in one go."""

    def __init__(self, kind: str, kwargs: Dict[str, Any]):
        super().__init__(f"AllToAll[{kind}]", budget=0)
        self.kind = kind
        self.kwargs = kwargs
        self._buffer: List[ObjectRef] = []
        self._fired = False

    def can_launch(self) -> bool:
        return False  # launches happen in maybe_fire, all at once

    def expected_outputs(self, n_inputs: int) -> int:
        if self.kind == "repartition":
            return self.kwargs["num_blocks"]
        return n_inputs

    def maybe_fire(self) -> None:
        """Once upstream is exhausted, run the all-to-all (output refs
        tracked as this op's in-flight work)."""
        while self.inqueue:
            _, ref = self.inqueue.popleft()
            self._buffer.append(ref)
        if not self.input_done or self._fired:
            return
        self._fired = True
        from ray_tpu_torch.data.dataset import _all_to_all_refs
        outs = _all_to_all_refs(self._buffer, self.kind, self.kwargs)
        self._buffer = []
        # output seqs restart at 0: release_ready tracks *outputs*, and
        # an all-to-all's output count differs from its input count
        for k, out in enumerate(outs):
            self.inflight[out.binary()] = (k, out)

    def finished(self) -> bool:
        return (self.input_done and self._fired
                and not self.inflight and not self._completed)


class StreamingExecutor:
    """Drive an operator chain, overlapping stages with bounded budgets."""

    def __init__(self, operators: List[PhysicalOperator]):
        self.operators = operators

    def execute(self, input_refs: List[ObjectRef]) -> Iterator[ObjectRef]:
        ops = self.operators
        if not ops:
            yield from input_refs
            return
        # pre-pass: propagate expected block counts (shuffle sizes its
        # output partition count from its input count)
        n = len(input_refs)
        for op in ops:
            n = op.expected_outputs(n)
        for ref in input_refs:
            ops[0].add_input(ref)
        ops[0].mark_input_done()
        try:
            yield from self._loop()
        finally:
            for op in ops:
                op.shutdown()

    def _route(self, op_idx: int, refs: List[ObjectRef]
               ) -> List[ObjectRef]:
        """Push released outputs downstream; returns final-op outputs."""
        if op_idx + 1 < len(self.operators):
            nxt = self.operators[op_idx + 1]
            for r in refs:
                nxt.add_input(r)
            return []
        return refs

    def _loop(self) -> Iterator[ObjectRef]:
        ops = self.operators
        while True:
            # propagate input-done marks downstream
            for i, op in enumerate(ops[:-1]):
                if op.finished() and not ops[i + 1].input_done:
                    ops[i + 1].mark_input_done()
            # launch whatever the budgets allow (downstream first so a
            # full pipeline drains before it refills)
            inflight: Dict[bytes, int] = {}
            for i in reversed(range(len(ops))):
                op = ops[i]
                op.maybe_fire()
                while op.can_launch():
                    op.launch_one()
                for key in op.inflight:
                    inflight[key] = i
            # release anything already complete
            moved = False
            for i, op in enumerate(ops):
                ready = op.release_ready()
                if ready:
                    moved = True
                    for out in self._route(i, ready):
                        yield out
            if moved:
                continue  # launch what was handed downstream at once
            if all(op.finished() for op in ops):
                return
            if not inflight:
                continue  # barrier transition: loop to propagate marks
            refs = [pair[1] for op in ops for pair in op.inflight.values()]
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=60,
                                    fetch_local=False)
            for r in ready:
                ops[inflight[r.binary()]].on_done(r)
