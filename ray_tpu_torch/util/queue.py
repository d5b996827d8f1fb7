# The port's copy of ray_tpu/util/queue.py
"""Distributed Queue (parity: ``python/ray/util/queue.py``) — an
async-actor-backed FIFO usable from any worker/driver."""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None):
        try:
            await asyncio.wait_for(self.queue.put(item), timeout)
        except asyncio.TimeoutError:
            raise Full("queue is full") from None
        return True

    async def get(self, timeout: Optional[float] = None):
        try:
            return await asyncio.wait_for(self.queue.get(), timeout)
        except asyncio.TimeoutError:
            raise Empty("queue is empty") from None

    async def put_nowait(self, item):
        if self.queue.full():
            raise Full("queue is full")
        self.queue.put_nowait(item)
        return True

    async def get_nowait(self):
        if self.queue.empty():
            raise Empty("queue is empty")
        return self.queue.get_nowait()

    async def size(self) -> int:
        return self.queue.qsize()

    async def empty(self) -> bool:
        return self.queue.empty()

    async def full(self) -> bool:
        return self.queue.full()


class Queue:
    def __init__(self, maxsize: int = 0,
                 actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        self.actor = _QueueActor.options(
            **(actor_options or {})).remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if block:
            ray_tpu_torch.get(self.actor.put.remote(item, timeout),
                              timeout=(timeout or 300) + 30)
        else:
            ray_tpu_torch.get(self.actor.put_nowait.remote(item), timeout=60)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        if block:
            return ray_tpu_torch.get(self.actor.get.remote(timeout),
                                     timeout=(timeout or 300) + 30)
        return ray_tpu_torch.get(self.actor.get_nowait.remote(), timeout=60)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.size.remote(), timeout=60)

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote(), timeout=60)

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote(), timeout=60)

    def put_async(self, item: Any):
        return self.actor.put.remote(item, None)

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
