"""Continuous-batching scheduler: slots, pages, request lifecycle.

Counterpart of ``ray_tpu/inference/scheduler.py``.  Requests move
``waiting -> active(slot) -> finished``:

- **admit**: the head of the waiting queue takes a free decode slot and
  reserves ``ceil((prompt + max_new) / page_size)`` pages up front, so a
  running sequence never runs out of cache mid-decode and there is no
  preemption path.  Admission is FIFO: a head that does not fit blocks
  the queue.  With prefix caching on, admission first walks the
  prompt's full pages through the :class:`~.kv_cache.PrefixIndex`: hits
  are installed into the page-table row with a refcount each and no
  prefill compute; only the pages past the last hit are allocated, and
  the engine prefills only the uncached suffix.  With tiering on the
  walk goes on where the resident index stops: the remaining hashes
  are probed in the lower tiers (``tier_lookup``, the engine's host
  pool and page store), and every consecutive hit is planned for
  promotion (``Request.tier_plan``).  An import (``import_payload``)
  may take every full context page as a hit, and never probes the
  tiers.
- **retire**: the request's page references are released (shared pages
  live on under their other owners, registered pages at refcount 0 park
  in the idle pool), its page-table row resets to the garbage page and
  the slot frees.  :meth:`SlotScheduler.retire_hold` frees the slot but
  keeps the page references for a disaggregated export.

Decode writes land only in pages the slot owns alone: a hit page is a
full prompt page strictly before the final prompt token, so the suffix
prefill's first write, at ``cached_tokens``, is past every shared page.

The page table and per-slot lengths live here as numpy arrays; the
engine owns the device-side cache tensors.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from ray_tpu_torch.inference.kv_cache import (GARBAGE_PAGE, PageAllocator,
                                              PrefixIndex, pages_needed)
from ray_tpu_torch.inference.sampling import SamplingParams


class QueueFullError(RuntimeError):
    """Typed admission rejection: the waiting queue is at its cap
    (``RAY_TPU_INFER_MAX_QUEUE``), so load is shed instead of queued."""


class DeadlineExceededError(RuntimeError):
    """Typed per-request deadline expiry (``ttft``: never admitted within
    its time-to-first-token budget; ``total``: past its whole budget).
    The request was retired with its slot, pages and prefix references
    released; the error rides its terminal ``StepEvent``."""

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
    # deadlines in seconds from submit (None = none): the TTFT budget can
    # only expire while the request waits (admission delivers its first
    # token in the same tick); the total one at any time.  An expired
    # request carries its DeadlineExceededError here.
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    error: Optional[BaseException] = None
    # prefix-cache state: chained hashes of the prompt's full pages
    # (computed at the first admission attempt and kept for retries), how
    # many were index hits, and the tokens those hits cover
    chain_hashes: Optional[List[bytes]] = None
    n_hit_pages: int = 0
    cached_tokens: int = 0
    # speculative decoding: the resolved draft budget, 0 = plain decode,
    # k > 0 = up to k self-drafted tokens verified per tick.  Resolved at
    # submit from ``SamplingParams.spec``/``spec_k`` over the engine's
    # defaults, so planning never re-reads the config.
    spec_k: int = 0
    # disaggregated serving: ``hold_pages`` keeps the page references
    # past retirement for export_request/release_held; an
    # ``import_payload`` (a kv_cache.KVHandoff) makes admission install
    # the payload instead of prefilling
    hold_pages: bool = False
    import_payload: Optional[Any] = None
    # tiered cache: how many eligible pages past the resident hits a
    # lower tier held at admission (the engine promotes them, and
    # ``note_tier_hits`` counts the ones it installed)
    tier_plan: int = 0
    # the request's telemetry.trace.TraceContext (None = untraced)
    trace: Optional[Any] = None
    # the adapter this request decodes under (None = base).
    # ``adapter_slot`` is the engine's bank row: 0 = the identity slot,
    # -1 = not yet resolved (the engine loads and pins the adapter before
    # the request's first admission attempt); ``adapter_version`` pins
    # the store version (0 = latest, resolved in place)
    model_id: Optional[str] = None
    adapter_slot: int = 0
    adapter_version: int = 0
    # the prefix-chain root (adapter traffic salts it; base traffic keeps
    # the unsalted root, so its hashes are the JAX package's)
    hash_salt: bytes = PrefixIndex.ROOT


class SlotScheduler:
    def __init__(self, *, slots: int, page_size: int, num_pages: int,
                 max_pages_per_slot: int, prefix: bool = False,
                 max_queue: int = 0):
        self.slots = slots
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.prefix_index = PrefixIndex() if prefix else None
        self.allocator = PageAllocator(num_pages, index=self.prefix_index)
        self.max_queue = max_queue
        self.page_table = np.full((slots, max_pages_per_slot),
                                  GARBAGE_PAGE, np.int64)
        self.lengths = np.zeros((slots,), np.int64)   # tokens in cache
        self.free_slots: List[int] = list(range(slots - 1, -1, -1))
        self.active: Dict[int, Request] = {}          # slot -> request
        self.waiting: Deque[Request] = collections.deque()
        # prefix-hit accounting (tokens = pages * page_size: the prefill
        # compute the hits skipped)
        self.prefix_hit_pages = 0
        self.prefix_hit_tokens = 0
        self.prefix_requests_hit = 0
        # the engine's probe over the lower tiers: tier_lookup(chain_hash)
        # -> does the host pool or the page store hold it under the live
        # params?
        self.tier_lookup = None

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

    def _prefix_walk(self, req: Request) -> List[int]:
        """The hit pages of the prompt's full pages, front to back up to
        the first miss.  The chain hashes are computed once per request;
        the lookups re-run on every attempt, since pages registered in
        between can turn misses into hits.  The page holding the final
        prompt token is never a hit (``PrefixIndex.hit_eligible``)."""
        if self.prefix_index is None:
            req.chain_hashes = req.chain_hashes or []
            return []
        if req.chain_hashes is None:
            req.chain_hashes = PrefixIndex.chain_hashes(
                req.prompt, self.page_size, salt=req.hash_salt)
        hits: List[int] = []
        # an import never prefills: every full context page may be a hit,
        # the one holding the final context token included (its logits
        # were consumed on the prefill side)
        eligible = (len(req.chain_hashes)
                    if req.import_payload is not None
                    else PrefixIndex.hit_eligible(len(req.prompt),
                                                  self.page_size))
        for h in req.chain_hashes[:eligible]:
            page = self.prefix_index.lookup(h)
            if page is None:
                break
            hits.append(page)
        # the lower tiers, from where the resident walk stopped; advisory
        # (the engine resolves each page again at install and leaves any
        # miss to the prefill) and recomputed on every attempt
        req.tier_plan = 0
        if self.tier_lookup is not None and req.import_payload is None:
            for h in req.chain_hashes[len(hits):eligible]:
                if not self.tier_lookup(h):
                    break
                req.tier_plan += 1
        return hits

    def try_admit(self) -> Optional[Request]:
        """Move the queue head into a free slot, or None."""
        if not self.waiting or not self.free_slots:
            return None
        req = self.waiting[0]
        if req.adapter_slot == -1:
            # a tenant request that arrived after this tick resolved the
            # bank rows: it waits, unhashed, for the next tick's
            # resolution, so it never rides the identity slot and its
            # chain is hashed under the tenant's salt
            return None
        need = pages_needed(len(req.prompt) + req.max_new_tokens,
                            self.page_size)
        walk_t0 = time.monotonic()
        hits = self._prefix_walk(req)
        walk_dur = time.monotonic() - walk_t0
        # feasibility before touching any state: acquiring the idle hits
        # takes them out of the allocatable pool
        idle_hits = sum(1 for p in hits if self.allocator.is_idle(p))
        if need - len(hits) > self.allocator.free_count - idle_hits:
            return None
        # hits first: an idle hit must not be evicted by our own
        # allocation's LRU sweep
        for p in hits:
            self.allocator.acquire(p)
        fresh = self.allocator.alloc(need - len(hits))
        assert fresh is not None        # guaranteed by the check above
        self.waiting.popleft()
        slot = self.free_slots.pop()
        pages = hits + fresh
        req.slot, req.pages = slot, pages
        req.n_hit_pages = len(hits)
        req.cached_tokens = len(hits) * self.page_size
        req.admitted_ts = time.monotonic()
        self.page_table[slot, :] = GARBAGE_PAGE
        self.page_table[slot, :len(pages)] = pages
        self.lengths[slot] = 0
        self.active[slot] = req
        if hits:
            self.prefix_hit_pages += len(hits)
            self.prefix_hit_tokens += req.cached_tokens
            self.prefix_requests_hit += 1
        if req.trace is not None and req.trace.sampled:
            # only the admitting walk: a span per blocked attempt would
            # flood the ring
            from ray_tpu_torch.telemetry import trace as trace_mod
            trace_mod.record_span(
                "prefix_walk", req.trace,
                start=trace_mod.epoch_of(walk_t0), dur=walk_dur,
                hits=len(hits), tier_plan=req.tier_plan,
                eligible=len(req.chain_hashes or []))
        return req

    def note_tier_hits(self, req: Request, n_pages: int) -> None:
        """Count ``n_pages`` lower-tier pages the engine promoted for
        ``req`` before its prefill: its cached window grows by whole
        pages, and the prefix counters take them as hits (they skipped
        the same prefill).  The request joins ``requests_hit`` only if
        the resident walk found nothing."""
        if n_pages <= 0:
            return
        if req.n_hit_pages == 0:
            self.prefix_requests_hit += 1
        req.n_hit_pages += n_pages
        req.cached_tokens += n_pages * self.page_size
        self.prefix_hit_pages += n_pages
        self.prefix_hit_tokens += n_pages * self.page_size

    def register_prefix(self, req: Request) -> None:
        """Register the request's freshly prefilled full prompt pages
        (called after the prefill has written their K/V: content must be
        in the cache before a hash can hand the page to another
        request)."""
        if self.prefix_index is None:
            return
        for i in range(req.n_hit_pages, len(req.chain_hashes)):
            self.prefix_index.register(req.chain_hashes[i], req.pages[i])

    def flush_prefix(self) -> None:
        """Invalidate the whole prefix cache (a weight swap: the index is
        keyed by tokens alone, so a later hit would attend over K/V of
        the old weights).  Idle pages return to the free list; pages of
        active requests stay theirs but are unregistered, so no new
        request shares them."""
        if self.prefix_index is None:
            return
        self.allocator.flush_idle()
        self.prefix_index.clear()

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

    def retire_hold(self, slot: int) -> Request:
        """Retire like :meth:`retire` but keep the page references
        (``req.pages`` stays, refcounts unmoved): the slot frees while
        the K/V waits for ``export_request``.  The leak audit fails until
        the pages are released, which is how an orphaned export
        shows."""
        req = self.active.pop(slot)
        req.slot = None
        req.done = True
        self.page_table[slot, :] = GARBAGE_PAGE
        self.lengths[slot] = 0
        self.free_slots.append(slot)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def prefix_stats(self) -> Dict[str, Any]:
        return {
            "enabled": self.prefix_index is not None,
            "hit_pages": self.prefix_hit_pages,
            "hit_tokens": self.prefix_hit_tokens,
            "requests_hit": self.prefix_requests_hit,
            "registered_pages": (len(self.prefix_index)
                                 if self.prefix_index is not None else 0),
            "idle_pages": self.allocator.idle_count,
            "evictions": self.allocator.evictions,
        }

    def prefix_digest(self) -> frozenset:
        """The registered chain hashes (empty with prefix caching off)."""
        if self.prefix_index is None:
            return frozenset()
        return self.prefix_index.digest()
