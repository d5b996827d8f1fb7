# The port's copy of ray_tpu/util/multiprocessing.py
"""``ray_tpu_torch.util.multiprocessing`` — drop-in multiprocessing.Pool.

Parity: ``python/ray/util/multiprocessing/pool.py``: the stdlib Pool
surface (map/imap/imap_unordered/starmap/apply, async variants) backed
by cluster tasks, so ``Pool(8).map(f, xs)`` fans out across nodes
instead of local forks.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
def _apply_chunk(fn, chunk, star):
    if star:
        return [fn(*item) for item in chunk]
    return [fn(item) for item in chunk]


@ray_tpu_torch.remote
def _apply_single(fn, args, kwds):
    return fn(*args, **(kwds or {}))


class AsyncResult:
    def __init__(self, refs, chunked: bool = True, single: bool = False):
        self._refs = refs
        self._chunked = chunked
        self._single = single

    def get(self, timeout: Optional[float] = None):
        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        if self._single:
            return out[0]
        if self._chunked:
            return list(itertools.chain.from_iterable(out))
        return out

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                           timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs,
                                      num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:  # noqa: BLE001
            return False


class Pool:
    """Task-backed process pool (``processes`` bounds concurrency only
    through cluster CPU resources; chunking mirrors stdlib)."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        if initializer is not None:
            # no persistent pool processes: initializers belong in the
            # function or an ActorPool
            raise NotImplementedError(
                "Pool(initializer=...) is not supported; use "
                "ray_tpu_torch.util.ActorPool for stateful workers")
        self._processes = processes or 8
        self._closed = False

    # -- helpers -------------------------------------------------------
    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def _submit(self, fn, iterable, chunksize, star) -> AsyncResult:
        if self._closed:
            raise ValueError("Pool not running")
        refs = [_apply_chunk.remote(fn, chunk, star)
                for chunk in self._chunks(iterable, chunksize)]
        return AsyncResult(refs)

    # -- stdlib surface ------------------------------------------------
    def map(self, fn, iterable, chunksize=None) -> List[Any]:
        return self._submit(fn, iterable, chunksize, False).get()

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        return self._submit(fn, iterable, chunksize, False)

    def starmap(self, fn, iterable, chunksize=None) -> List[Any]:
        return self._submit(fn, iterable, chunksize, True).get()

    def starmap_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        return self._submit(fn, iterable, chunksize, True)

    def apply(self, fn, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args=(), kwds=None) -> AsyncResult:
        if self._closed:
            raise ValueError("Pool not running")
        return AsyncResult([_apply_single.remote(fn, args, kwds)],
                           chunked=False, single=True)

    def imap(self, fn, iterable, chunksize=1):
        if self._closed:
            raise ValueError("Pool not running")
        refs = [_apply_chunk.remote(fn, chunk, False)
                for chunk in self._chunks(iterable, chunksize)]
        for ref in refs:  # submission order
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn, iterable, chunksize=1):
        if self._closed:
            raise ValueError("Pool not running")
        refs = [_apply_chunk.remote(fn, chunk, False)
                for chunk in self._chunks(iterable, chunksize)]
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for ref in ready:
                yield from ray_tpu_torch.get(ref)

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
