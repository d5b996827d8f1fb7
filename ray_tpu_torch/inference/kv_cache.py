"""Paged KV cache for continuous-batching decode.

Counterpart of ``ray_tpu/inference/kv_cache.py``: two preallocated
tensors per model, ``[n_layers, pages, page_size, heads, head_dim]`` K
and V, plus a host-side page table owned by the scheduler.  Admission
reserves pages from a refcounted free list, retirement returns them,
and the cache tensors never reallocate.

Page 0 is the reserved garbage page: free slots' page-table rows and
the unreserved tail of short rows point at it, so the fixed-shape
decode step can write for inactive slots and prefill can write its
padded bucket tail without touching live pages.  The cache starts as
zeros, and decode attention never reads positions at or past a slot's
length, so garbage never reaches an output.

Unlike the JAX package's functional scatters, the write helpers update
the cache tensor in place (one copy of the cache, no donation needed)
and return it for symmetry with the reference.  Prefix sharing, int8
storage, tiered spill and disaggregated handoff are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

GARBAGE_PAGE = 0


class PageAllocator:
    """Refcounted acquire/release allocator over the page pool (page 0
    never handed out).  :meth:`alloc` hands out pages at refcount 1,
    :meth:`acquire` adds a reference, :meth:`release` drops one, and a
    page returns to the free list at refcount 0."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 garbage + 1 usable), "
                             f"got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._refcount: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refcount.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages at refcount 1, or None (the caller keeps the
        request waiting)."""
        if n > len(self._free):
            return None
        pages = []
        for _ in range(n):
            p = self._free.pop()
            self._free_set.discard(p)
            self._refcount[p] = 1
            pages.append(p)
        return pages

    def acquire(self, page: int) -> None:
        if page == GARBAGE_PAGE:
            raise ValueError("acquiring the reserved garbage page")
        if page not in self._refcount:
            raise ValueError(f"acquiring unallocated page {page}")
        self._refcount[page] += 1

    def release(self, pages: List[int]) -> None:
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
            self._free.append(p)
            self._free_set.add(p)

    free = release

    def leak_free(self) -> bool:
        """The usable pages partition exactly into free and held."""
        free, held = set(self._free), set(self._refcount)
        return (free | held == set(range(1, self.num_pages))
                and not free & held
                and len(self._free) == len(self._free_set))


class KVCache:
    """The preallocated paged K/V tensors plus their geometry."""

    def __init__(self, *, n_layers: int, num_pages: int, page_size: int,
                 n_heads: int, head_dim: int, dtype, device,
                 kv_dtype: str = "model"):
        if kv_dtype != "model":
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r} is not ported yet (ROADMAP "
                "Queue 1: the int8 cache and its decode-attention "
                "variant)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        shape = (n_layers, num_pages, page_size, n_heads, head_dim)
        # zeros, not empty: garbage must be finite (0 * NaN is NaN)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)

    @property
    def bytes(self) -> int:
        return 2 * self.k.numel() * self.k.element_size()

    def bytes_per_slot(self, pages_per_slot: int) -> int:
        L, _P, ps, H, D = self.k.shape
        return pages_per_slot * 2 * L * ps * H * D * self.k.element_size()


def write_prefill(pages, new, page_row, page_size: int):
    """Write a prompt's K (or V) into one slot's pages, in place: the
    cold (start 0, whole bucket) case of :func:`write_prefill_at`.

    pages: [P, page_size, H, D] (one layer); new: [S, H, D] (bucket-
    padded: tail rows land wherever ``page_row`` maps them, the garbage
    page for unreserved entries); page_row: [max_pages] int64."""
    return write_prefill_at(pages, new, page_row, 0, new.shape[0],
                            page_size)


def write_prefill_at(pages, new, page_row, start: int, valid_len: int,
                     page_size: int):
    """Write a suffix's K (or V) at positions ``start .. start+S`` of one
    slot's pages, in place; rows past ``valid_len`` go to the garbage
    page explicitly."""
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
    the padded per-slot context that decode attention masks by length."""
    B, max_pages = page_table.shape
    ps = pages.shape[1]
    ctx = pages[page_table]             # [B, max_pages, ps, *rest]
    return ctx.reshape((B, max_pages * ps) + tuple(pages.shape[2:]))


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)
