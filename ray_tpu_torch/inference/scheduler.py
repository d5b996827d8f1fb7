"""Continuous-batching scheduler: slots, pages, request lifecycle.

Counterpart of ``ray_tpu/inference/scheduler.py`` without the prefix
walk.  Requests move ``waiting -> active(slot) -> finished``:

- **admit**: the head of the waiting queue takes a free decode slot and
  reserves ``ceil((prompt + max_new) / page_size)`` pages up front, so a
  running sequence never runs out of cache mid-decode and there is no
  preemption path.  Admission is FIFO: a head that does not fit blocks
  the queue.
- **retire**: the request's pages are released, its page-table row
  resets to the garbage page and the slot frees.

The page table and per-slot lengths live here as numpy arrays; the
engine owns the device-side cache tensors.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np

from ray_tpu_torch.inference.kv_cache import (GARBAGE_PAGE, PageAllocator,
                                              pages_needed)
from ray_tpu_torch.inference.sampling import SamplingParams


class QueueFullError(RuntimeError):
    """Typed admission rejection: the waiting queue is at its cap
    (``RAY_TPU_INFER_MAX_QUEUE``), so load is shed instead of queued."""


class DeadlineExceededError(RuntimeError):
    """Typed per-request deadline expiry (the JAX package's error;
    deadlines themselves are not ported yet)."""

    def __init__(self, rid: int, kind: str, budget_s: float,
                 waited_s: float):
        super().__init__(
            f"request {rid}: {kind} deadline of {budget_s:.3f}s "
            f"exceeded ({waited_s:.3f}s elapsed)")
        self.rid = rid
        self.kind = kind
        self.budget_s = budget_s
        self.waited_s = waited_s

    def __reduce__(self):
        return (DeadlineExceededError,
                (self.rid, self.kind, self.budget_s, self.waited_s))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams
    eos_token: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    # chosen-token model logprobs, one per generated token
    logprobs: List[float] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    pages: Optional[List[int]] = None
    submitted_ts: float = dataclasses.field(default_factory=time.monotonic)
    admitted_ts: Optional[float] = None
    done: bool = False


class SlotScheduler:
    def __init__(self, *, slots: int, page_size: int, num_pages: int,
                 max_pages_per_slot: int, max_queue: int = 0):
        self.slots = slots
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.allocator = PageAllocator(num_pages)
        self.max_queue = max_queue
        self.page_table = np.full((slots, max_pages_per_slot),
                                  GARBAGE_PAGE, np.int64)
        self.lengths = np.zeros((slots,), np.int64)   # tokens in cache
        self.free_slots: List[int] = list(range(slots - 1, -1, -1))
        self.active: Dict[int, Request] = {}          # slot -> request
        self.waiting: Deque[Request] = collections.deque()

    def submit(self, req: Request) -> None:
        need = pages_needed(len(req.prompt) + req.max_new_tokens,
                            self.page_size)
        if need > self.max_pages_per_slot:
            raise ValueError(
                f"request {req.rid}: prompt+max_new = "
                f"{len(req.prompt) + req.max_new_tokens} tokens needs "
                f"{need} pages > {self.max_pages_per_slot} per slot")
        # an unsatisfiable-even-when-idle request must raise, not queue:
        # FIFO admission would otherwise spin on it forever
        if need > self.allocator.num_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs {need} pages but the pool "
                f"only has {self.allocator.num_pages - 1} "
                "(raise RAY_TPU_INFER_PAGES or shrink the request)")
        if self.max_queue and len(self.waiting) >= self.max_queue:
            raise QueueFullError(
                f"request {req.rid}: waiting queue at its cap of "
                f"{self.max_queue} (RAY_TPU_INFER_MAX_QUEUE)")
        self.waiting.append(req)

    def try_admit(self) -> Optional[Request]:
        """Move the queue head into a free slot, or None."""
        if not self.waiting or not self.free_slots:
            return None
        req = self.waiting[0]
        need = pages_needed(len(req.prompt) + req.max_new_tokens,
                            self.page_size)
        pages = self.allocator.alloc(need)
        if pages is None:
            return None
        self.waiting.popleft()
        slot = self.free_slots.pop()
        req.slot, req.pages = slot, pages
        req.admitted_ts = time.monotonic()
        self.page_table[slot, :] = GARBAGE_PAGE
        self.page_table[slot, :len(pages)] = pages
        self.lengths[slot] = 0
        self.active[slot] = req
        return req

    def retire(self, slot: int) -> Request:
        req = self.active.pop(slot)
        self.allocator.release(req.pages)
        req.pages = None
        req.slot = None
        req.done = True
        self.page_table[slot, :] = GARBAGE_PAGE
        self.lengths[slot] = 0
        self.free_slots.append(slot)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)
