"""Paged KV cache for continuous-batching decode, with prefix sharing.

Counterpart of ``ray_tpu/inference/kv_cache.py``: two preallocated
tensors per model, ``[n_layers, pages, page_size, heads, head_dim]`` K
and V (int8 codes plus ``[n_layers, pages, page_size, heads]`` f32
scales with ``kv_dtype="int8"``), and a host-side page table owned by
the scheduler.  Admission reserves pages from a refcounted allocator,
retirement releases them, and the cache tensors never reallocate.

Page 0 is the reserved garbage page: free slots' page-table rows and
the unreserved tail of short rows point at it, so the fixed-shape
decode step can write for inactive slots and prefill can write its
padded bucket tail without touching live pages.  The cache starts as
zeros, and decode attention never reads positions at or past a slot's
length, so garbage never reaches an output.

Prefix caching: :class:`PrefixIndex` maps chained hashes of full prompt
pages to the pages holding their K/V, and :class:`PageAllocator` parks a
registered page whose refcount falls to 0 in an idle LRU pool instead of
freeing it, so the idle cache doubles as prefix storage until allocation
pressure evicts it.

Unlike the JAX package's functional scatters, the write helpers update
the cache tensor in place (one copy of the cache, no donation needed)
and return it for symmetry with the reference.  Tiered spill (the
allocator's ``spill_hook``) and disaggregated handoff come with ROADMAP
Queue 1 item 6.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

GARBAGE_PAGE = 0


class PrefixIndex:
    """Content-addressed index over *full, immutable* KV pages.

    A page is registered under its chained hash ``h = H(parent_h,
    page_tokens)``, which covers the page's own tokens and, through the
    parent link, every token before it: a hit means the whole prefix up
    to and including this page is identical.  Admission walks a prompt's
    full pages through :meth:`lookup` front to back and stops at the
    first miss.  Host metadata only; the lifecycle (refcounts, idle LRU,
    eviction) is :class:`PageAllocator`'s, which calls :meth:`forget`
    when it evicts a registered page."""

    ROOT = b""

    def __init__(self):
        self._by_hash: Dict[bytes, int] = {}
        self._by_page: Dict[int, bytes] = {}

    @staticmethod
    def chain(parent: bytes, tokens: Sequence[int]) -> bytes:
        """``H(parent_h, page_tokens)``: 128-bit blake2b over the parent
        digest and the tokens as int64 bytes (the JAX package's hashes,
        byte for byte)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(np.asarray(tokens, np.int64).tobytes())
        return h.digest()

    @classmethod
    def chain_hashes(cls, tokens: Sequence[int], page_size: int,
                     salt: bytes = b"") -> List[bytes]:
        """Chained hashes of every *full* page of ``tokens``; ``salt``
        overrides the chain root (adapter traffic; base traffic keeps
        the unsalted root)."""
        h = salt or cls.ROOT
        out = []
        for i in range(len(tokens) // page_size):
            h = cls.chain(h, tokens[i * page_size:(i + 1) * page_size])
            out.append(h)
        return out

    @staticmethod
    def hit_eligible(n_tokens: int, page_size: int) -> int:
        """How many leading full pages of an ``n_tokens`` prompt may be
        taken as hits: the page holding the final prompt token never is,
        because that token's logits seed the first sampled token."""
        return (n_tokens - 1) // page_size

    def lookup(self, chain_hash: bytes) -> Optional[int]:
        return self._by_hash.get(chain_hash)

    def register(self, chain_hash: bytes, page: int) -> bool:
        """Map ``chain_hash -> page``; refuses (False) if either side is
        already registered, so first registration wins."""
        if chain_hash in self._by_hash or page in self._by_page:
            return False
        self._by_hash[chain_hash] = page
        self._by_page[page] = chain_hash
        return True

    def has(self, page: int) -> bool:
        return page in self._by_page

    def forget(self, page: int) -> None:
        h = self._by_page.pop(page, None)
        if h is not None:
            del self._by_hash[h]

    def clear(self) -> int:
        """Forget every registration (a weight swap makes all cached K/V
        stale); returns how many entries were dropped."""
        n = len(self._by_hash)
        self._by_hash.clear()
        self._by_page.clear()
        return n

    def digest(self) -> frozenset:
        """Snapshot of every registered chain hash (the fleet router's
        prefix-affinity signal)."""
        return frozenset(self._by_hash)

    def __len__(self) -> int:
        return len(self._by_hash)


class PageAllocator:
    """Refcounted acquire/release allocator over the page pool (page 0
    never handed out).

    :meth:`alloc` hands out pages at refcount 1, a prefix hit takes an
    extra reference with :meth:`acquire`, and :meth:`release` drops one.
    A page at refcount 0 returns to the free list, unless it is
    registered in the prefix index: then it parks in an LRU idle pool
    with its K/V intact.  ``alloc`` takes free pages first and only then
    evicts idle pages oldest first (forgetting their index entries), so
    allocation never fails while idle capacity remains."""

    def __init__(self, num_pages: int,
                 index: Optional[PrefixIndex] = None):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 garbage + 1 usable), "
                             f"got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._refcount: Dict[int, int] = {}
        # refcount-0 registered pages, insertion order = LRU -> MRU
        self._idle: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._index = index
        self.evictions = 0

    @property
    def free_count(self) -> int:
        """Pages available to ``alloc``: free plus evictable idle."""
        return len(self._free) + len(self._idle)

    @property
    def idle_count(self) -> int:
        return len(self._idle)

    def refcount(self, page: int) -> int:
        return self._refcount.get(page, 0)

    def is_idle(self, page: int) -> bool:
        return page in self._idle

    def flush_idle(self) -> int:
        """Return every idle page to the free list, forgetting its index
        entry (the bulk invalidation of a weight swap)."""
        n = len(self._idle)
        for page in self._idle:
            if self._index is not None:
                self._index.forget(page)
            self._free.append(page)
            self._free_set.add(page)
        self._idle.clear()
        return n

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages at refcount 1, or None (the caller keeps the
        request waiting).  Free pages first, then idle pages LRU first."""
        if n > self.free_count:
            return None
        pages = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
                self._free_set.discard(p)
            else:
                p, _ = self._idle.popitem(last=False)    # oldest idle
                self.evictions += 1
                if self._index is not None:
                    self._index.forget(p)
            self._refcount[p] = 1
            pages.append(p)
        return pages

    def acquire(self, page: int) -> None:
        """One more reference on a live or idle page (a prefix hit).  An
        idle page revives with its content intact, which is why admission
        acquires its hits before it allocates fresh pages."""
        if page == GARBAGE_PAGE:
            raise ValueError("acquiring the reserved garbage page")
        if page in self._idle:
            del self._idle[page]
            self._refcount[page] = 1
            return
        if page not in self._refcount:
            raise ValueError(f"acquiring unallocated page {page}")
        self._refcount[page] += 1

    def release(self, pages: List[int]) -> None:
        """Drop one reference per page.  At refcount 0 a registered page
        parks in the idle pool (MRU end); an unregistered one is freed."""
        for p in pages:
            if p == GARBAGE_PAGE:
                raise ValueError("freeing the reserved garbage page")
            rc = self._refcount.get(p)
            if rc is None:
                raise ValueError(f"double free of page {p}")
            if rc > 1:
                self._refcount[p] = rc - 1
                continue
            del self._refcount[p]
            if self._index is not None and self._index.has(p):
                self._idle[p] = None
            else:
                self._free.append(p)
                self._free_set.add(p)

    free = release

    def leak_free(self) -> bool:
        """The usable pages partition exactly into free, idle and held,
        and every idle page is registered."""
        free, idle, held = set(self._free), set(self._idle), \
            set(self._refcount)
        return (free | idle | held == set(range(1, self.num_pages))
                and not (free & idle or free & held or idle & held)
                and len(self._free) == len(self._free_set)
                and all(self._index is not None and self._index.has(p)
                        for p in idle))


class KVCache:
    """The preallocated paged K/V tensors plus their geometry.

    ``kv_dtype``: ``"model"`` stores ``dtype`` K/V; ``"int8"`` stores
    int8 codes plus per-(page, position, head) f32 scales ``k_scale`` and
    ``v_scale``.  The scales start at 0 (fresh garbage dequantizes to
    zeros), but writes routed to the garbage page overwrite them; that
    is harmless because decode attention never reads a position at or
    past a slot's length."""

    def __init__(self, *, n_layers: int, num_pages: int, page_size: int,
                 n_heads: int, head_dim: int, dtype, device,
                 kv_dtype: str = "model"):
        if kv_dtype not in ("model", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                             "expected 'model' or 'int8'")
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        shape = (n_layers, num_pages, page_size, n_heads, head_dim)
        store = torch.int8 if self.quantized else dtype
        # zeros, not empty: garbage must be finite (0 * NaN is NaN)
        self.k = torch.zeros(shape, dtype=store, device=device)
        self.v = torch.zeros(shape, dtype=store, device=device)
        if self.quantized:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
            self.v_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)

    def layer(self, i: int):
        """Layer ``i``'s cache slice as the attention hooks take it:
        ``(k, v)``, or ``(k, v, k_scale, v_scale)`` when quantized."""
        if self.quantized:
            return (self.k[i], self.v[i], self.k_scale[i], self.v_scale[i])
        return (self.k[i], self.v[i])

    @property
    def bytes(self) -> int:
        """The cache's device footprint: K/V and, when quantized, the
        scales."""
        total = 2 * self.k.numel() * self.k.element_size()
        if self.quantized:
            total += 2 * self.k_scale.numel() * self.k_scale.element_size()
        return total

    def bytes_per_slot(self, pages_per_slot: int) -> int:
        """Device bytes one fully reserved decode slot pins (codes and
        scales across all layers)."""
        L, _P, ps, H, D = self.k.shape
        per_page = 2 * L * ps * H * D * self.k.element_size()
        if self.quantized:
            per_page += 2 * L * ps * H * self.k_scale.element_size()
        return pages_per_slot * per_page


def write_prefill_at(pages, new, page_row, start: int, valid_len: int,
                     page_size: int):
    """Write a prompt's or suffix's K (or V, or their int8 codes or
    scales) at positions ``start .. start+S`` of one slot's pages, in
    place; rows past ``valid_len`` go to the garbage page explicitly.
    The cold prefill writes its whole bucket from 0 (``valid_len = S``:
    tail rows land wherever ``page_row`` maps them, the garbage page for
    unreserved entries).

    pages: [P, page_size, *rest] (one layer); new: [S, *rest];
    page_row: [max_pages] int64."""
    S = new.shape[0]
    idx = torch.arange(S, device=pages.device)
    pos = start + idx
    page = torch.where(
        idx < valid_len,
        page_row[(pos // page_size).clamp(0, page_row.shape[0] - 1)],
        GARBAGE_PAGE)
    pages[page, pos % page_size] = new
    return pages


def write_decode(pages, new, page_table, lengths, page_size: int):
    """Write one new token per slot into its page, in place.

    pages: [P, page_size, H, D]; new: [B, H, D]; page_table:
    [B, max_pages] int64; lengths: [B] int64, the token's absolute
    position (inactive slots point at the garbage page)."""
    page = page_table.gather(1, (lengths // page_size)[:, None])[:, 0]
    pages[page, lengths % page_size] = new
    return pages


def gather_pages(pages, page_table):
    """[P, page_size, *rest] x [B, max_pages] -> [B, max_pages*page, *rest]:
    the padded per-slot context of the cached prefill.  The decode step
    reads the pages in place (``ops.attention.decode_attention_paged``)."""
    B, max_pages = page_table.shape
    ps = pages.shape[1]
    ctx = pages[page_table]             # [B, max_pages, ps, *rest]
    return ctx.reshape((B, max_pages * ps) + tuple(pages.shape[2:]))


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)


def assert_tail_private(allocator: PageAllocator,
                        index: Optional[PrefixIndex],
                        pages: List[int], first_pos: int,
                        last_pos: int, page_size: int) -> None:
    """Assert the never-write-shared invariant over a slot's write
    window: every page that positions ``first_pos..last_pos`` land in is
    exclusively owned (refcount 1) and unregistered.  True by
    construction (hits and registered pages only cover full prompt pages
    strictly below the first decode position), so a failure is a
    scheduler bug, hence an assertion."""
    for idx in range(first_pos // page_size, last_pos // page_size + 1):
        page = pages[idx]
        assert allocator.refcount(page) == 1, (
            f"write window touches shared page {page} (refcount "
            f"{allocator.refcount(page)}): never-write-shared violated")
        assert index is None or not index.has(page), (
            f"write window touches prefix-registered page {page}: "
            "never-write-shared violated")
