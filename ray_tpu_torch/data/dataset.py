"""Dataset — lazy, distributed data pipelines.

Counterpart of ``ray_tpu/data/dataset.py`` (parity: Ray's
``python/ray/data/dataset.py``): a logical plan of operators over
blocks; execution fans out tasks of the port's runtime per block with a
bounded in-flight window (streaming backpressure, the shape of Ray's
``StreamingExecutor``).  Blocks are numpy columns in the shm object
store (``block.py``); ``iter_batches`` yields host batches and
``iter_torch_batches`` lands them on the card ahead of the consumer.

The shuffles, splits and the sample sort draw from numpy RNGs in the
reference's order, so a seeded pipeline yields the reference's rows in
the reference's order; the aggregates sum as pyarrow does
(``block.arrow_sum``).
"""

from __future__ import annotations

import itertools
from typing import (Any, Callable, Dict, Iterator, List, Optional, Tuple,
                    Union)

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (Block, BlockAccessor, arrow_sum,
                                      batch_to_block, concat_blocks,
                                      format_batch, is_null, num_rows)
from ray_tpu_torch.object_ref import ObjectRef

# bounded number of concurrently materializing blocks (backpressure)
DEFAULT_WINDOW = 8


# ---------------------------------------------------------------- remote ops
@ray_tpu_torch.remote(max_retries=3)
def _map_block(block: Block, fns) -> Block:
    for kind, fn, kwargs in fns:
        acc = BlockAccessor.for_block(block)
        if kind == "map_batches":
            batch_size = kwargs.get("batch_size")
            fmt = kwargs.get("batch_format", "numpy")
            out = []
            for batch in acc.iter_batches(batch_size, fmt):
                res = fn(batch)
                out.append(batch_to_block(res))
            block = concat_blocks(out) if out else acc.slice(0, 0)
        elif kind == "map":
            rows = [fn(r) for r in acc.to_pylist()]
            block = batch_to_block(rows)
        elif kind == "flat_map":
            rows = list(itertools.chain.from_iterable(
                fn(r) for r in acc.to_pylist()))
            block = batch_to_block(rows) if rows else acc.slice(0, 0)
        elif kind == "filter":
            rows = [r for r in acc.to_pylist() if fn(r)]
            block = batch_to_block(rows) if rows else acc.slice(0, 0)
        else:
            raise ValueError(kind)
    return block


@ray_tpu_torch.remote(max_retries=3)
def _split_block(block: Block, n: int, seed: Optional[int]) -> List[Block]:
    """Split one block into n shards (for shuffle/repartition)."""
    acc = BlockAccessor.for_block(block)
    rows = acc.num_rows()
    idx = np.arange(rows)
    if seed is not None:
        rng = np.random.default_rng(seed)
        rng.shuffle(idx)
    parts = np.array_split(idx, n)
    return [acc.take_rows(p) if len(p) else acc.slice(0, 0)
            for p in parts]


@ray_tpu_torch.remote(max_retries=3)
def _merge_blocks(*blocks: Block) -> Block:
    # with num_returns=1 an upstream _split_block resolves to the whole
    # 1-element list rather than its only item — flatten
    flat: List[Block] = []
    for b in blocks:
        flat.extend(b) if isinstance(b, list) else flat.append(b)
    return concat_blocks(flat)


# ------------------------------------------------------------------- plan
class _Op:
    pass


class _MapOp(_Op):
    def __init__(self, kind: str, fn: Callable, **kwargs):
        self.kind = kind
        self.fn = fn
        self.kwargs = kwargs


class _ActorMapOp(_Op):
    def __init__(self, cls, *, pool_size: int, batch_size, batch_format,
                 fn_constructor_args=None, fn_constructor_kwargs=None):
        self.cls = cls
        self.pool_size = pool_size
        self.batch_size = batch_size
        self.batch_format = batch_format
        self.fn_constructor_args = fn_constructor_args
        self.fn_constructor_kwargs = fn_constructor_kwargs


class _AllToAllOp(_Op):
    def __init__(self, kind: str, **kwargs):
        self.kind = kind
        self.kwargs = kwargs


def _all_to_all_refs(refs_in: List[ObjectRef], kind: str,
                     arg: Dict[str, Any]) -> List[ObjectRef]:
    """Fan out one all-to-all stage over materialized upstream refs."""
    if kind == "shuffle":
        seed = arg.get("seed")
        n = max(1, len(refs_in))
        parts = _fan_out([_split_block.options(num_returns=n).remote(
            r, n, (seed + i) if seed is not None else None)
            for i, r in enumerate(refs_in)])
        return [_merge_blocks.remote(
            *[parts[j][i] for j in range(len(refs_in))])
            for i in range(n)]
    if kind == "repartition":
        n = arg["num_blocks"]
        parts = _fan_out([_split_block.options(num_returns=n).remote(
            r, n, None) for r in refs_in])
        return [_merge_blocks.remote(
            *[parts[j][i] for j in range(len(refs_in))])
            for i in range(n)]
    if kind == "sort":
        return _distributed_sort(refs_in, arg["key"], arg["descending"])
    raise ValueError(kind)


def _fan_out(parts: List) -> List[List]:
    """num_returns>1 task handles resolve to either a list of refs or a
    single ref (n==1); normalize to list-of-lists."""
    return [p if isinstance(p, list) else [p] for p in parts]


@ray_tpu_torch.remote(max_retries=3)
def _sample_keys(block: Block, key: str, n: int):
    """Uniform key sample from one block (boundary estimation; nulls
    are excluded — they route to the last partition)."""
    col = block[key]
    col = col[~is_null(col)]
    if len(col) == 0:
        return col
    idx = np.random.default_rng(0).integers(0, len(col),
                                            size=min(n, len(col)))
    return col[idx]


@ray_tpu_torch.remote(max_retries=3)
def _range_partition(block: Block, key: str, boundaries,
                     descending: bool) -> List[Block]:
    """Split one block into len(boundaries)+1 key ranges."""
    acc = BlockAccessor(block)
    col = block[key]
    null_mask = is_null(col)
    # searchsorted can't order None: substitute the first boundary, then
    # force nulls into the last partition (the sort puts nulls at the end)
    if null_mask.any():
        col = col.copy()
        col[null_mask] = boundaries[0]
    part = np.searchsorted(boundaries, col, side="right")
    if descending:
        part = len(boundaries) - part
    part = np.where(null_mask, len(boundaries), part)
    out = []
    for p in range(len(boundaries) + 1):
        mask = part == p
        out.append(acc.filter_mask(mask) if mask.any()
                   else acc.slice(0, 0))
    return out


def sort_indices(col: np.ndarray, descending: bool) -> np.ndarray:
    """A stable sort of ``col`` with nulls last in either direction
    (``pyarrow.compute.sort_indices``'s order): equal keys keep their
    row order."""
    null_mask = is_null(col)
    live = np.flatnonzero(~null_mask)
    keys = col[live]
    if descending:
        # stable descending: the stable ascending order of the reversed
        # keys, read backwards
        rev = np.argsort(keys[::-1], kind="stable")
        order = (len(keys) - 1 - rev)[::-1]
    else:
        order = np.argsort(keys, kind="stable")
    return np.concatenate([live[order], np.flatnonzero(null_mask)])


@ray_tpu_torch.remote(max_retries=3)
def _merge_sorted(key: str, descending: bool, *parts: Block) -> Block:
    flat: List[Block] = []
    for p in parts:
        flat.extend(p) if isinstance(p, list) else flat.append(p)
    table = concat_blocks(flat)
    return BlockAccessor(table).take_rows(
        sort_indices(table[key], descending))


def _distributed_sort(refs_in: List[ObjectRef], key: str,
                      descending: bool) -> List[ObjectRef]:
    """Sample sort (parity: ray.data push-based shuffle sort): sample
    keys -> pick partition boundaries -> range-partition every block in
    parallel -> sort each partition in parallel.  Output block i holds
    keys <= block i+1 (or >= when descending); nothing funnels through
    the calling process except the O(blocks * sample) key sample."""
    if not refs_in:
        return []
    n = len(refs_in)
    if n == 1:
        return [_merge_sorted.remote(key, descending, refs_in[0])]
    samples = np.concatenate(
        ray_tpu_torch.get([_sample_keys.remote(r, key, 64) for r in refs_in],
                    timeout=600))
    if len(samples) == 0:
        return list(refs_in)
    # boundaries by rank in the sorted sample (not np.quantile: no
    # interpolation, so string/datetime keys sort too)
    srt = np.sort(samples)
    boundaries = srt[(np.arange(1, n) * len(srt)) // n]
    parts = _fan_out([_range_partition.options(num_returns=n).remote(
        r, key, boundaries, descending) for r in refs_in])
    return [_merge_sorted.remote(key, descending,
                                 *[parts[j][i] for j in range(n)])
            for i in range(n)]


def iter_fixed_batches(block_iter: Iterator[Block], *,
                       batch_size: Optional[int], batch_format: str,
                       drop_last: bool) -> Iterator[Any]:
    """Fixed-size batches over a block stream: remainder rows carry
    into the next block, so batch shapes stay constant across block
    boundaries (jit-compiled train steps need static shapes).  Shared
    by ``Dataset.iter_batches`` and ``DataIterator.iter_batches``."""
    carry: Optional[Block] = None
    for block in block_iter:
        if carry is not None and num_rows(carry) > 0:
            block = concat_blocks([carry, block])
            carry = None
        acc = BlockAccessor.for_block(block)
        n = acc.num_rows()
        if batch_size is None:
            if n:
                yield format_batch(block, batch_format)
            continue
        start = 0
        while n - start >= batch_size:
            yield format_batch(acc.slice(start, start + batch_size),
                               batch_format)
            start += batch_size
        if start < n:
            carry = acc.slice(start, n)
    if carry is not None and num_rows(carry) > 0 and not drop_last:
        yield format_batch(carry, batch_format)


def iter_device_batches(batch_iter: Iterator[Any], *, device=None,
                        dtypes=None, prefetch: int = 2,
                        sharding=None) -> Iterator[Any]:
    """Host batches -> tensor batches on ``device``, ``prefetch`` of
    them in flight, so the host-to-device copy overlaps the consumer's
    step (the reference's async ``device_put`` pipeline).  On the card
    each batch is written into pinned host memory and copied on a side
    stream (``stream._DeviceStager``); a batch is handed over only after
    the consumer's stream waits for its copy.

    ``device``: None means the card, and without one this raises (it
    never falls back to the CPU); the tests pass ``"cpu"``.  ``dtypes``:
    a torch dtype for every column, or a dict of them per column.  The
    reference's ``sharding`` has no meaning in one process and is
    refused."""
    if sharding is not None:
        raise ValueError(
            "sharding= places a jax batch over a device mesh; the port's "
            "batches go to one device (device=), and a trainer's rank "
            "reads its own shard (get_dataset_shard / streaming_split)")
    import torch

    from ray_tpu_torch.data.stream import _DeviceStager
    stager = _DeviceStager(device)

    def put(batch):
        if not isinstance(batch, dict):
            raise TypeError("device batches need batch_format='numpy' "
                            f"(got {type(batch).__name__})")
        for k, v in batch.items():
            if v.dtype == object:
                raise TypeError(f"column {k!r} holds Python objects "
                                f"({type(v[0]).__name__ if len(v) else '?'})"
                                " and has no tensor form")
        return stager.put(batch)

    def hand_over(batch):
        stager.deliver(batch)
        if dtypes is None:
            return batch
        if isinstance(dtypes, torch.dtype):
            return {k: v.to(dtypes) for k, v in batch.items()}
        return {k: v.to(dtypes[k]) if k in dtypes else v
                for k, v in batch.items()}

    from collections import deque
    window: deque = deque()
    for batch in batch_iter:
        window.append(put(batch))
        if len(window) > prefetch:
            yield hand_over(window.popleft())
    while window:
        yield hand_over(window.popleft())


class Dataset:
    def __init__(self, block_refs: List[ObjectRef],
                 ops: Optional[List[_Op]] = None):
        self._block_refs = block_refs
        self._ops: List[_Op] = ops or []

    # -------------------------------------------------------- transforms
    def _with_op(self, op: _Op) -> "Dataset":
        return Dataset(self._block_refs, self._ops + [op])

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    concurrency: Optional[int] = None,
                    compute=None, fn_constructor_args=None,
                    fn_constructor_kwargs=None, **ignored) -> "Dataset":
        """Map a function — or a *callable class* — over batches.

        A class UDF runs on a fixed actor pool (constructed once per
        actor; ``concurrency`` = pool size), the reference's
        ``ActorPoolStrategy`` (``actor_pool_map_operator.py:1``).
        """
        if isinstance(fn, type):
            pool = concurrency or getattr(compute, "size", None) or 2
            if isinstance(pool, (tuple, list)):  # Ray's (min, max) form
                pool = pool[-1]
            return self._with_op(_ActorMapOp(
                fn, pool_size=int(pool), batch_size=batch_size,
                batch_format=batch_format,
                fn_constructor_args=fn_constructor_args,
                fn_constructor_kwargs=fn_constructor_kwargs))
        return self._with_op(_MapOp("map_batches", fn,
                                    batch_size=batch_size,
                                    batch_format=batch_format))

    def map(self, fn: Callable) -> "Dataset":
        return self._with_op(_MapOp("map", fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with_op(_MapOp("flat_map", fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_op(_MapOp("filter", fn))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(batch):
            batch[name] = fn(batch)
            return batch
        return self.map_batches(add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch):
            return {k: v for k, v in batch.items() if k not in cols}
        return self.map_batches(drop)

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(batch):
            return {k: batch[k] for k in cols}
        return self.map_batches(select)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with_op(_AllToAllOp("shuffle", seed=seed))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_op(_AllToAllOp("repartition",
                                         num_blocks=num_blocks))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with_op(_AllToAllOp("sort", key=key,
                                         descending=descending))

    def union(self, other: "Dataset") -> "Dataset":
        """Lazy concatenation: both branches keep their own logical
        plans and stream at consumption time — nothing materializes
        (parity: the reference keeps Union in the logical plan,
        ``data/_internal/logical/operators/n_ary_operator.py``)."""
        return _UnionDataset([self, other])

    def limit(self, n: int) -> "Dataset":
        """Lazy prefix: consumption stops pulling upstream blocks once
        ``n`` rows are out — a limit over an expensive pipeline never
        runs the whole thing (parity: lazy Limit in the logical plan,
        ``one_to_one_operator.py``)."""
        return _LimitDataset(self, n)

    def zip(self, other: "Dataset") -> "Dataset":
        a = self.materialize()._to_table()
        b = other.materialize()._to_table()
        if num_rows(a) != num_rows(b):
            raise ValueError("zip requires equal row counts")
        cols = dict(a)
        for name, col in b.items():
            key = name if name not in cols else f"{name}_1"
            cols[key] = col
        return Dataset([ray_tpu_torch.put(cols)])

    # --------------------------------------------------------- execution
    def _build_operators(self, window: int):
        """Fuse consecutive function-map ops; class UDFs and all-to-alls
        become their own physical operators."""
        from ray_tpu_torch.data.streaming_executor import (ActorPoolMapOperator,
                                                     AllToAllOperator,
                                                     MapOperator)
        physical = []
        fused: List[Tuple[str, Callable, Dict]] = []

        def flush():
            nonlocal fused
            if fused:
                physical.append(MapOperator(fused, budget=window))
                fused = []

        from ray_tpu_torch.data.streaming_executor import ShuffleOperator
        for op in self._ops:
            if isinstance(op, _MapOp):
                fused.append((op.kind, op.fn, op.kwargs))
            elif isinstance(op, _ActorMapOp):
                flush()
                physical.append(ActorPoolMapOperator(
                    op.cls, pool_size=op.pool_size,
                    fn_constructor_args=op.fn_constructor_args,
                    fn_constructor_kwargs=op.fn_constructor_kwargs,
                    batch_size=op.batch_size,
                    batch_format=op.batch_format))
            elif isinstance(op, _AllToAllOp) and op.kind == "shuffle":
                flush()
                # streaming split stage: overlaps with upstream maps
                physical.append(ShuffleOperator(
                    seed=op.kwargs.get("seed"), budget=window))
            else:
                flush()
                physical.append(AllToAllOperator(op.kind, op.kwargs))
        flush()
        return physical

    def _execute(self, window: int = DEFAULT_WINDOW
                 ) -> Iterator[ObjectRef]:
        """Stream transformed block refs through the operator DAG with
        per-operator in-flight budgets (``streaming_executor.py``)."""
        from ray_tpu_torch.data.streaming_executor import StreamingExecutor
        executor = StreamingExecutor(self._build_operators(window))
        yield from executor.execute(list(self._block_refs))

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List["DataIterator"]:
        """Split one streaming execution across ``n`` consumers.

        Each returned :class:`DataIterator` yields a disjoint subset of
        the stream's blocks (greedy pull by default, strict round-robin
        with ``equal=True``) — the multi-worker Train ingest path
        (parity: ``Dataset.streaming_split`` /
        ``operators/output_splitter.py``).
        """
        import cloudpickle

        from ray_tpu_torch.data.iterator import (DataIterator,
                                           _CoordinatorOwner,
                                           _SplitCoordinator)
        coord = _SplitCoordinator.remote(cloudpickle.dumps(self), n,
                                         equal)
        owner = _CoordinatorOwner(coord, dataset=self)
        iterators = [DataIterator(coord, i) for i in range(n)]
        for it in iterators:
            it._owner = owner     # coordinator dies with the last one
        return iterators

    def materialize(self) -> "Dataset":
        refs = list(self._execute())
        # force completion (and surface errors) before declaring it
        ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=600) \
            if refs else None
        return Dataset(refs)

    def _to_table(self):
        blocks = ray_tpu_torch.get(list(self._execute()), timeout=600)
        return concat_blocks(blocks)

    # ------------------------------------------------------- consumption
    def _iter_blocks_prefetched(self, prefetch_blocks: int
                                ) -> Iterator[Block]:
        """Materialize blocks on a background thread, ``prefetch_blocks``
        ahead of the consumer (overlaps host fetch with accelerator
        compute — reference ``iter_batches`` prefetching)."""
        import queue
        import threading

        if prefetch_blocks <= 0:
            for ref in self._execute():
                yield ray_tpu_torch.get(ref, timeout=600)
            return
        q: "queue.Queue" = queue.Queue(maxsize=prefetch_blocks)
        _END, _ERR = object(), object()
        stop = threading.Event()

        def feeder():
            gen = self._execute()
            try:
                for ref in gen:
                    block = ray_tpu_torch.get(ref, timeout=600)
                    while not stop.is_set():
                        try:
                            q.put(block, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(_END)
            except BaseException as e:  # noqa: BLE001 — reraised below
                if not stop.is_set():
                    q.put((_ERR, e))
            finally:
                gen.close()  # runs the executor's shutdown (actor pools)

        t = threading.Thread(target=feeder, daemon=True,
                             name="data-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] is _ERR:
                    raise item[1]
                yield item
        finally:
            # consumer abandoned the iterator: unblock + stop the feeder
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_blocks: int = 2) -> Iterator[Any]:
        yield from iter_fixed_batches(
            self._iter_blocks_prefetched(prefetch_blocks),
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           device=None, dtypes=None,
                           drop_last: bool = False, prefetch: int = 2,
                           batch_format: str = "numpy",
                           sharding=None) -> Iterator[Any]:
        """``iter_batches`` that lands each batch on ``device`` (the card
        unless the caller passes ``"cpu"``) ahead of the consumer: host
        assembly, the host-to-device copy and the step overlap
        (:func:`iter_device_batches`).  Counterpart of the reference's
        ``iter_jax_batches``, named as Ray names it
        (``iter_torch_batches(device=...)``); ``drop_last`` defaults to
        False as in Ray."""
        if batch_format != "numpy":
            raise ValueError(
                "iter_torch_batches requires batch_format='numpy' "
                "(pandas/pyarrow batches have no tensor form)")
        it = self.iter_batches(batch_size=batch_size,
                               batch_format=batch_format,
                               drop_last=drop_last,
                               prefetch_blocks=prefetch)
        yield from iter_device_batches(it, device=device, dtypes=dtypes,
                                       prefetch=prefetch, sharding=sharding)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for ref in self._execute():
            block = ray_tpu_torch.get(ref, timeout=600)
            yield from BlockAccessor.for_block(block).to_pylist()

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        return sum(num_rows(b)
                   for b in ray_tpu_torch.get(list(self._execute()),
                                              timeout=600))

    def schema(self):
        for ref in self._execute():
            block = ray_tpu_torch.get(ref, timeout=600)
            return BlockAccessor.for_block(block).schema()
        return None

    def num_blocks(self) -> int:
        return len(self._block_refs)

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def to_pandas(self):
        return BlockAccessor(self._to_table()).to_pandas()

    def to_arrow(self):
        return BlockAccessor(self._to_table()).to_arrow()

    # ------------------------------------------------------- aggregation
    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def _agg(self, col: Optional[str], how: str):
        """``pyarrow.compute``'s aggregate over the column: each block
        is one arrow chunk, summed pairwise (``arrow_sum``), the chunks'
        sums added in order; ``mean`` is that sum over the count."""
        blocks = [b for b in ray_tpu_torch.get(list(self._execute()),
                                               timeout=600) if b]
        if col is None:
            col = next(iter(blocks[0])) if blocks else None
        parts = [b[col][~is_null(b[col])] for b in blocks if col in b]
        n = sum(len(p) for p in parts)
        if how == "count":
            return n
        if n == 0:
            return None
        if how in ("min", "max"):
            pick = min if how == "min" else max
            return pick(getattr(np, how)(p).item()
                        for p in parts if len(p))
        total = 0.0 if parts[0].dtype.kind == "f" else 0
        for p in parts:
            total += arrow_sum(p)
        if how == "sum":
            return total
        return float(total) / n

    def sum(self, col: Optional[str] = None):
        return self._agg(col, "sum")

    def min(self, col: Optional[str] = None):
        return self._agg(col, "min")

    def max(self, col: Optional[str] = None):
        return self._agg(col, "max")

    def mean(self, col: Optional[str] = None):
        return self._agg(col, "mean")

    # ------------------------------------------------------------ split
    def split(self, n: int, *, equal: bool = True) -> List["Dataset"]:
        """Split into n datasets (Train ingest sharding)."""
        acc = BlockAccessor(self._to_table())
        rows = acc.num_rows()
        bounds = np.linspace(0, rows, n + 1).astype(int)
        out = []
        for i in range(n):
            shard = acc.slice(bounds[i], bounds[i + 1])
            out.append(Dataset([ray_tpu_torch.put(shard)]))
        return out

    def train_test_split(self, test_size: float = 0.25,
                         shuffle: bool = False,
                         seed: Optional[int] = None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        acc = BlockAccessor(ds._to_table())
        rows = acc.num_rows()
        n_test = int(rows * test_size)
        n_train = rows - n_test
        return (Dataset([ray_tpu_torch.put(acc.slice(0, n_train))]),
                Dataset([ray_tpu_torch.put(acc.slice(n_train, rows))]))

    # ------------------------------------------------------------ write
    # Writers fan out one task per block (reference: datasink write
    # tasks), so a wide dataset writes in parallel instead of pulling
    # every block through the calling process.
    def write_parquet(self, path: str) -> None:
        from ray_tpu_torch.data.io_extra import write_parquet
        write_parquet(self, path)

    def write_csv(self, path: str) -> None:
        from ray_tpu_torch.data.io_extra import write_csv
        write_csv(self, path)

    def write_tfrecords(self, path: str) -> None:
        from ray_tpu_torch.data.io_extra import write_tfrecords
        write_tfrecords(self, path)

    def write_json(self, path: str) -> None:
        from ray_tpu_torch.data.connectors import write_json
        write_json(self, path)

    def write_numpy(self, path: str, column: str) -> None:
        from ray_tpu_torch.data.connectors import write_numpy
        write_numpy(self, path, column)

    def write_webdataset(self, path: str) -> None:
        from ray_tpu_torch.data.connectors import write_webdataset
        write_webdataset(self, path)

    def __repr__(self):
        return (f"Dataset(num_blocks={len(self._block_refs)}, "
                f"ops={len(self._ops)})")


class GroupedData:
    """Hash aggregation by one key column, as ``pyarrow``'s
    ``Table.group_by(key).aggregate`` computes it: groups in the order
    their keys first appear, the key column first, then
    ``<col>_<how>``; a group's sum runs over its rows in order."""

    def __init__(self, ds: Dataset, key: str):
        self.ds = ds
        self.key = key

    def _groups(self):
        table = self.ds._to_table()
        keys = table[self.key]
        _u, first, inverse = np.unique(keys, return_index=True,
                                       return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        return table, keys[first[order]], rank[inverse.reshape(-1)]

    def _agg(self, col: str, how: str) -> Dataset:
        table, uniq, gid = self._groups()
        vals = table[col]
        g = len(uniq)
        if how in ("sum", "mean"):
            acc_dtype = np.float64 if vals.dtype.kind == "f" else np.int64
            sums = np.zeros(g, acc_dtype)
            np.add.at(sums, gid, vals.astype(acc_dtype))
            if how == "sum":
                out = sums
            else:
                out = sums.astype(np.float64) / np.bincount(gid, minlength=g)
        elif how in ("min", "max"):
            pick = np.minimum if how == "min" else np.maximum
            out = np.array([vals[gid == i][0] for i in range(g)])
            for i in range(g):
                out[i] = pick.reduce(vals[gid == i])
        else:
            raise ValueError(how)
        return Dataset([ray_tpu_torch.put({self.key: uniq,
                                           f"{col}_{how}": out})])

    def sum(self, col: str) -> Dataset:
        return self._agg(col, "sum")

    def min(self, col: str) -> Dataset:
        return self._agg(col, "min")

    def max(self, col: str) -> Dataset:
        return self._agg(col, "max")

    def mean(self, col: str) -> Dataset:
        return self._agg(col, "mean")

    def count(self) -> Dataset:
        _table, uniq, gid = self._groups()
        counts = np.bincount(gid, minlength=len(uniq)).astype(np.int64)
        return Dataset([ray_tpu_torch.put({self.key: uniq,
                                           "count_all": counts})])

    def map_groups(self, fn: Callable,
                   batch_format: str = "numpy") -> Dataset:
        table, uniq, gid = self._groups()
        acc = BlockAccessor(table)
        blocks = []
        for i in range(len(uniq)):
            group = acc.filter_mask(gid == i)
            res = fn(format_batch(group, batch_format))
            blocks.append(ray_tpu_torch.put(batch_to_block(res)))
        return Dataset(blocks)


# ------------------------------------------------------ lazy set ops
class _StreamSourceDataset(Dataset):
    """A plan whose *input blocks* are another dataset's output stream.

    Used where an op needs the full logical row set of a composite
    source (all-to-all after a union, transforms after a limit): the
    source still streams block-by-block, but this plan's operators see
    one unified input list, preserving global semantics."""

    def __init__(self, source: Dataset, ops: Optional[List[_Op]] = None):
        super().__init__([], ops)
        self._source = source

    def _with_op(self, op: _Op) -> "Dataset":
        return _StreamSourceDataset(self._source, self._ops + [op])

    def _execute(self, window: int = DEFAULT_WINDOW
                 ) -> Iterator[ObjectRef]:
        from ray_tpu_torch.data.streaming_executor import StreamingExecutor
        refs = list(self._source._execute(window))
        executor = StreamingExecutor(self._build_operators(window))
        yield from executor.execute(refs)

    def num_blocks(self) -> int:
        return self._source.num_blocks()

    def __repr__(self):
        return f"StreamSourceDataset(source={self._source!r})"


class _UnionDataset(Dataset):
    """Streaming union: each branch executes its own plan; the merged
    stream is their concatenation.  Further transforms push down into
    every branch, so laziness survives chaining."""

    def __init__(self, parts: List[Dataset]):
        super().__init__([])
        # flatten nested unions so deep chains stay one level
        flat: List[Dataset] = []
        for p in parts:
            if isinstance(p, _UnionDataset):
                flat.extend(p._parts)
            else:
                flat.append(p)
        self._parts = flat

    def _with_op(self, op: _Op) -> "Dataset":
        if isinstance(op, _MapOp):
            # stateless per-block ops distribute over the branches
            return _UnionDataset([p._with_op(op) for p in self._parts])
        # all-to-all ops (sort/shuffle/repartition) need the *global*
        # row set, and a class-UDF actor pool must be built once over
        # the merged stream (per-branch pools would double the actors
        # and the model-load cost): feed the union's stream in as one
        # input
        return _StreamSourceDataset(self, [op])

    def _execute(self, window: int = DEFAULT_WINDOW
                 ) -> Iterator[ObjectRef]:
        for p in self._parts:
            yield from p._execute(window)

    def num_blocks(self) -> int:
        return sum(p.num_blocks() for p in self._parts)

    def __repr__(self):
        return f"UnionDataset(parts={len(self._parts)})"


@ray_tpu_torch.remote(max_retries=3)
def _head_block(block: Block, n: int) -> Block:
    return BlockAccessor.for_block(block).take_rows(np.arange(n))


class _LimitDataset(Dataset):
    """Streaming limit: pulls upstream blocks only until ``n`` rows are
    satisfied (abandoning the executor's generator stops all further
    launches), trimming the final block remotely."""

    def __init__(self, parent: Dataset, n: int):
        super().__init__([])
        self._parent = parent
        self._n = n

    def _with_op(self, op: _Op) -> "Dataset":
        # transforms after a limit operate on the n-row prefix; keep
        # them lazy — the limit runs when the chained plan is consumed
        return _StreamSourceDataset(self, [op])

    def num_blocks(self) -> int:
        # upper bound: the prefix never spans more blocks than the
        # parent has (exact count is only known at consumption)
        return self._parent.num_blocks()

    def _execute(self, window: int = DEFAULT_WINDOW
                 ) -> Iterator[ObjectRef]:
        remaining = self._n
        if remaining <= 0:
            return
        for ref in self._parent._execute(window):
            block = ray_tpu_torch.get(ref, timeout=600)
            rows = num_rows(block)
            if rows <= remaining:
                remaining -= rows
                yield ref
            else:
                yield _head_block.remote(ref, remaining)
                remaining = 0
            if remaining <= 0:
                return

    def __repr__(self):
        return f"LimitDataset(n={self._n})"
