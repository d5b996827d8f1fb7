# The port's copy of ray_tpu/util/actor_pool.py
"""ActorPool (parity: ``python/ray/util/actor_pool.py``)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    """Round-robins work over a fixed set of actors.

    >>> pool = ActorPool([a1, a2])
    >>> list(pool.map(lambda a, v: a.double.remote(v), [1, 2, 3, 4]))
    """

    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits = []

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable, value: Any):
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending_submits)

    def _return_actor(self, actor):
        self._idle.append(actor)
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def get_next(self, timeout: float = None) -> Any:
        if not self.has_next():
            raise StopIteration("no more results")
        future = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        index, actor = self._future_to_actor.pop(future)
        self._return_actor(actor)
        return ray_tpu_torch.get(future, timeout=timeout)

    def get_next_unordered(self, timeout: float = None) -> Any:
        if not self.has_next():
            raise StopIteration("no more results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                      num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("timed out waiting for result")
        future = ready[0]
        index, actor = self._future_to_actor.pop(future)
        self._index_to_future.pop(index, None)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor):
        self._idle.append(actor)
