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
and return it for symmetry with the reference.

**Disaggregated handoff.**  :func:`export_pages` copies a held request's
pages from the card to the host into a :class:`KVHandoff` (context
tokens, chained hashes, the raw K/V; int8 codes and scales move as
they are), and :func:`import_pages` writes into another engine's fresh
pages only those it does not already hold by chain hash.

**Tiered spill.**  When :meth:`PageAllocator.alloc` reclaims an idle
prefix page, its ``spill_hook`` first demotes the contents to the
engine's :class:`HostPagePool` (tier 1), whose overflow goes on to a
shared :class:`KVPageStore` (tier 2), keyed by ``(chain_hash,
param_version)``.  A model-dtype page spills as int8 codes and scales
by default (:func:`encode_spill_page`); admission promotes a lower-tier
hit back with :func:`install_spill_page`.

Handoffs and spill entries hold **host** data only (numpy arrays, or CPU
tensors for bf16, which numpy lacks): a store is shared between
engines, and a device tensor in it would pin one engine's memory.  The
copies are synchronous (``.cpu()``, ``.to(device)``), so a host buffer
is complete when the call returns and no entry outlives a copy that
reads it.  Their ``dtype`` strings are the JAX package's names
(``"bfloat16"``, ``"float32"``, ``"int8"``), so one payload passes the
geometry and dtype checks of both packages
(``ray_tpu_torch.convert.handoff_from_jax``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.util import chaos

GARBAGE_PAGE = 0

HostArray = Union[np.ndarray, torch.Tensor]


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

    def hash_of(self, page: int) -> Optional[bytes]:
        """The chain hash a resident page is registered under (what the
        spill hook keys its demoted copy by)."""
        return self._by_page.get(page)

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
        # called as spill_hook(page, chain_hash) just before a pressure
        # eviction forgets a registered idle page (the engine's demote
        # leg); flush_idle never spills: after a weight swap the
        # contents are stale
        self.spill_hook = None

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
                    if self.spill_hook is not None:
                        h = self._index.hash_of(p)
                        if h is not None:
                            self.spill_hook(p, h)        # demote leg
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


# ------------------------------------------------- disaggregated handoff
class HandoffContentMissing(RuntimeError):
    """Typed import failure: a metadata-only (warm) handoff reached
    admission, but the resident pages it counted on had left the prefix
    index.  Everything the admission took is released before this
    surfaces; the caller re-prefills from the prompt."""

    def __init__(self, rid: int, missing_pages: int):
        super().__init__(
            f"request {rid}: metadata-only KV handoff is missing "
            f"{missing_pages} page(s) no longer resident — re-prefill "
            "from the prompt")
        self.rid = rid
        self.missing_pages = missing_pages

    def __reduce__(self):
        return (HandoffContentMissing, (self.rid, self.missing_pages))


def dtype_name(dtype) -> str:
    """A numpy or torch dtype's name as the JAX package spells it
    (``"bfloat16"``, ``"float32"``, ``"int8"``)."""
    return str(dtype).removeprefix("torch.")


def _nbytes(a: HostArray) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return a.nbytes


def _to_host(t: torch.Tensor) -> HostArray:
    """A tensor as host data: numpy, or a CPU tensor for bf16."""
    t = t.contiguous().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _as_tensor(a: HostArray) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclasses.dataclass
class KVHandoff:
    """One request's transfer of KV pages from a prefill engine to a
    decode engine.

    The context's token ids, the chained hashes of its full pages (an
    importer already holding a page by hash takes it with a refcount and
    never reads the contents), the token sampled after the context, and
    the per-page K/V on the host.  ``k``/``v`` are ``[n_layers, n_pages,
    page_size, heads, head_dim]`` in the cache's storage dtype, and
    ``k_scale``/``v_scale`` (int8 caches) ``[n_layers, n_pages,
    page_size, heads]`` f32; all None in a metadata-only handoff.  Pages
    come in :func:`pages_needed` order over ``context``; the partial tail
    page carries whatever the exporter's page held past ``len(context) %
    page_size``, which decode attention never reads."""

    context: List[int]
    page_size: int
    kv_dtype: str                   # "model" | "int8"
    dtype: str                      # storage dtype name
    chain_hashes: List[bytes]       # one per FULL context page
    next_token: int                 # the first sampled token (emitted)
    next_logprob: float
    k: Optional[HostArray] = None
    v: Optional[HostArray] = None
    k_scale: Optional[HostArray] = None
    v_scale: Optional[HostArray] = None
    # the absolute page indices the arrays carry (None = all of them)
    present: Optional[List[int]] = None
    # the request's TraceContext in wire form: importer spans join the
    # exporter's tree
    trace: Optional[dict] = None
    # the adapter the context was prefilled under (None = base)
    model_id: Optional[str] = None
    adapter_version: int = 0

    @property
    def n_pages(self) -> int:
        return pages_needed(len(self.context), self.page_size)

    @property
    def n_full_pages(self) -> int:
        return len(self.context) // self.page_size

    @property
    def page_list(self) -> List[int]:
        """Absolute indices of the pages whose contents ride along."""
        if self.k is None:
            return []
        if self.present is None:
            return list(range(self.n_pages))
        return list(self.present)

    @property
    def nbytes(self) -> int:
        """Content bytes (0 for a metadata-only handoff)."""
        return sum(_nbytes(a) for a in (self.k, self.v, self.k_scale,
                                        self.v_scale) if a is not None)

    def strip_contents(self) -> "KVHandoff":
        """The metadata-only form (a warm handoff)."""
        return dataclasses.replace(self, k=None, v=None, k_scale=None,
                                   v_scale=None, present=[])

    def strip_to(self, pages: Sequence[int]) -> "KVHandoff":
        """The form carrying only ``pages`` (absolute indices): the pages
        the target already holds by chain hash stay behind."""
        pages = list(pages)
        if not pages:
            return self.strip_contents()
        have = self.page_list
        sel = [have.index(i) for i in pages]    # raises on a bad strip
        rep = {"present": pages}
        for name in ("k", "v", "k_scale", "v_scale"):
            a = getattr(self, name)
            rep[name] = _select(a, sel) if a is not None else None
        return dataclasses.replace(self, **rep)


def _select(a: HostArray, sel: Sequence[int]) -> HostArray:
    """Pages ``sel`` (axis 1) of a host array, as a new array."""
    if isinstance(a, torch.Tensor):
        return a[:, torch.as_tensor(list(sel), dtype=torch.int64)]
    return a[:, np.asarray(list(sel), np.int64)]


def handoff_page_bytes(*, n_layers: int, page_size: int, n_heads: int,
                       head_dim: int, itemsize: int,
                       quantized: bool) -> int:
    """The content bytes one handoff page carries: K and V over all
    layers, plus their f32 scales when quantized (``head_dim + 4`` bytes
    per cached vector against ``head_dim * itemsize``)."""
    per_vector = head_dim * itemsize + (4 if quantized else 0)
    return 2 * n_layers * page_size * n_heads * per_vector


def page_contents(cache: "KVCache", pages: Sequence[int]
                  ) -> Dict[str, torch.Tensor]:
    """``pages``' K/V (and scales) gathered on the cache's device,
    ``[L, n_pages, ...]`` in page order."""
    idx = torch.as_tensor(list(pages), dtype=torch.int64,
                          device=cache.k.device)
    out = {"k": cache.k[:, idx], "v": cache.v[:, idx]}
    if cache.quantized:
        out["k_scale"] = cache.k_scale[:, idx]
        out["v_scale"] = cache.v_scale[:, idx]
    return out


def export_pages(cache: "KVCache", pages: Sequence[int]
                 ) -> Dict[str, HostArray]:
    """``pages``' contents on the host: ``{"k", "v"[, "k_scale",
    "v_scale"]}``, one gather on the card and one copy per array."""
    return {name: _to_host(t)
            for name, t in page_contents(cache, pages).items()}


def import_pages(cache: "KVCache", pages: Sequence[int],
                 handoff: KVHandoff, sel: Sequence[int]) -> None:
    """Write the handoff's pages ``sel`` (indices into its arrays) into
    ``cache`` at ``pages`` (aligned sequences), in place, between engine
    ticks.  The caller owns ``pages`` alone; the garbage page is
    refused."""
    if not len(pages):
        return
    if GARBAGE_PAGE in pages:
        raise ValueError("importing into the reserved garbage page")
    dev = cache.k.device
    idx = torch.as_tensor(list(pages), dtype=torch.int64, device=dev)
    names = ("k", "v") + (("k_scale", "v_scale") if cache.quantized
                          else ())
    for name in names:
        src = _as_tensor(_select(getattr(handoff, name), sel))
        getattr(cache, name)[:, idx] = src.to(dev)


# -------------------------------------------------------- tiered spill
SPILL_DTYPES = ("int8", "model")


def _quantize_page(x: HostArray) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 over the last axis, computed in f32
    (bf16 converts exactly): ``scale = amax / 127``, codes rounded to
    nearest, ties to even, as ``np.rint`` rounds in the reference.  A
    zero vector takes scale 0 and divides by 1.  Runs on ``x``'s
    device."""
    x = _as_tensor(x).float()
    scale = x.abs().amax(-1) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    codes = torch.round(x / safe[..., None]).clamp(-127, 127)
    return codes.to(torch.int8), scale


def encode_spill_page(contents: Dict[str, HostArray], *,
                      quantized: bool,
                      spill_dtype: str = "int8") -> Dict[str, object]:
    """One page's spill entry from a one-page :func:`page_contents`
    (on the card: quantization runs there and only the codes cross) or
    :func:`export_pages` (on the host).  int8 caches pass their codes and
    scales through; model-dtype caches quantize per vector under
    ``spill_dtype="int8"`` or keep their bytes under ``"model"``.  The
    entry holds host data."""
    k, v = (_as_tensor(contents[n])[:, 0] for n in ("k", "v"))
    if quantized:
        entry = {"fmt": "int8", "k": k, "v": v,
                 "k_scale": _as_tensor(contents["k_scale"])[:, 0],
                 "v_scale": _as_tensor(contents["v_scale"])[:, 0]}
    elif spill_dtype == "int8":
        k8, ks = _quantize_page(k)
        v8, vs = _quantize_page(v)
        entry = {"fmt": "int8", "k": k8, "v": v8,
                 "k_scale": ks, "v_scale": vs}
    else:
        entry = {"fmt": "model", "k": k, "v": v}
    return {name: _to_host(a) if isinstance(a, torch.Tensor) else a
            for name, a in entry.items()}


def spill_entry_bytes(entry: Dict[str, object]) -> int:
    """Host bytes of a spill entry: numpy arrays and tensors alike."""
    return sum(_nbytes(a) for a in entry.values()
               if isinstance(a, (np.ndarray, torch.Tensor)))


def spill_entry_matches(cache: "KVCache",
                        entry: Dict[str, object]) -> bool:
    """Whether an entry has this cache's page geometry: a shared store's
    entry from an engine of another geometry reads as a miss."""
    want = tuple(cache.k.shape[:1]) + tuple(cache.k.shape[2:])
    return tuple(entry["k"].shape) == want


def install_spill_page(cache: "KVCache", page: int,
                       entry: Dict[str, object]) -> None:
    """Write one spill entry into cache page ``page`` (the promote leg),
    in place between ticks.  int8 entries feed an int8 cache as they
    are; a model-dtype cache dequantizes them in f32 on the card and
    rounds to its dtype (to nearest even, as the reference casts)."""
    if page == GARBAGE_PAGE:
        raise ValueError("installing into the reserved garbage page")
    dev = cache.k.device
    if cache.quantized:
        if entry["fmt"] == "int8":
            k, ks = _as_tensor(entry["k"]), _as_tensor(entry["k_scale"])
            v, vs = _as_tensor(entry["v"]), _as_tensor(entry["v_scale"])
        else:
            k, ks = _quantize_page(_as_tensor(entry["k"]).to(dev))
            v, vs = _quantize_page(_as_tensor(entry["v"]).to(dev))
        cache.k[:, page] = k.to(dev)
        cache.v[:, page] = v.to(dev)
        cache.k_scale[:, page] = ks.to(dev)
        cache.v_scale[:, page] = vs.to(dev)
        return
    if entry["fmt"] == "int8":
        k, v = (_as_tensor(entry[n]).to(dev).float()
                * _as_tensor(entry[n + "_scale"]).to(dev)[..., None]
                for n in ("k", "v"))
    else:
        k, v = (_as_tensor(entry[n]).to(dev) for n in ("k", "v"))
    cache.k[:, page] = k.to(cache.k.dtype)
    cache.v[:, page] = v.to(cache.v.dtype)


class HostPagePool:
    """Tier 1: the per-engine host spill pool.

    An LRU ``(chain_hash, param_version) -> spill entry`` map with a page
    capacity.  :meth:`put` is the demote target; overflow demotes the
    oldest entry on to the shared :class:`KVPageStore` when one is
    attached, through the ``kv.spill`` chaos site (a faulted leg forgets
    the page).  :meth:`take` pops, so the local tiers stay exclusive,
    which lets the leak audit check the exact free / idle / held / host
    partition."""

    def __init__(self, capacity_pages: int,
                 store: Optional["KVPageStore"] = None):
        if capacity_pages < 0:
            raise ValueError("host pool capacity must be >= 0")
        self.capacity = capacity_pages
        self.store = store
        self._entries: "collections.OrderedDict[Tuple[bytes, int], Dict]" \
            = collections.OrderedDict()
        self.spills = 0          # entries accepted (device -> host)
        self.demotions = 0       # entries pushed on to the store
        self.dropped = 0         # overflow with no store / faulted leg
        self.hits = 0
        self.misses = 0
        self.bytes_spilled = 0
        self.bytes = 0           # current resident bytes

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple[bytes, int]) -> bool:
        return key in self._entries

    def put(self, key: Tuple[bytes, int],
            entry: Dict[str, object]) -> None:
        if self.capacity == 0:
            self._demote(key, entry)
            return
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._entries[key] = entry
        nb = spill_entry_bytes(entry)
        self.spills += 1
        self.bytes_spilled += nb
        self.bytes += nb
        while len(self._entries) > self.capacity:
            old_key, old = self._entries.popitem(last=False)
            self.bytes -= spill_entry_bytes(old)
            self._demote(old_key, old)

    def _demote(self, key, entry) -> None:
        """Host -> store leg (a plain drop without a store)."""
        if self.store is None:
            self.dropped += 1
            return
        try:
            chaos.maybe_fail("kv.spill")
        except chaos.InjectedFault:
            self.dropped += 1       # degrade: re-prefill later
            return
        self.store.put(key, entry)
        self.demotions += 1

    def take(self, key: Tuple[bytes, int]
             ) -> Optional[Dict[str, object]]:
        """Pop an entry for promotion (None on a miss)."""
        entry = self._entries.pop(key, None)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self.bytes -= spill_entry_bytes(entry)
        return entry

    def discard(self, key: Tuple[bytes, int]) -> None:
        """Drop an entry whose hash just became resident again (a
        degraded fetch fell back to prefill), so no hash sits in two
        local tiers.  Not a miss: no counter moves."""
        entry = self._entries.pop(key, None)
        if entry is not None:
            self.bytes -= spill_entry_bytes(entry)

    def clear(self) -> int:
        """Drop everything (a weight swap: the contents are stale)."""
        n = len(self._entries)
        self._entries.clear()
        self.bytes = 0
        return n

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries),
                "capacity": self.capacity, "bytes": self.bytes,
                "spills": self.spills, "demotions": self.demotions,
                "dropped": self.dropped, "hits": self.hits,
                "misses": self.misses,
                "bytes_spilled": self.bytes_spilled}


class KVPageStore:
    """Tier 2: the shared content-addressed page store.

    ``(chain_hash, param_version) -> spill entry``, shared by every
    engine holding a reference, in this process.  A put is idempotent by
    key, and :meth:`checkout`/:meth:`checkin` bracket every fetch so the
    leak audit can check that none is left in flight.  Unlike the host
    pool, :meth:`checkout` does not pop: the next engine's miss is this
    entry's hit.  A weight swap invalidates by key (the bumped version
    never matches).

    ``capacity_bytes`` (``RAY_TPU_KV_STORE_CAP``, 0 = unbounded): an
    over-cap put evicts least recently used entries (checkout recency,
    then insertion order) until the new one fits, skipping any entry
    mid-checkout; with nothing evictable the cap overshoots rather than
    drop live data.

    The reference keeps the entries in the runtime's object store when a
    runtime session is up, and in-process otherwise; the port has no
    runtime, so ``use_object_store=None`` resolves to in-process and
    ``True`` raises (ROADMAP Queue 1 item 6c)."""

    def __init__(self, use_object_store: Optional[bool] = None,
                 capacity_bytes: Optional[int] = None):
        if use_object_store:
            raise NotImplementedError(
                "KVPageStore(use_object_store=True) needs the runtime's "
                "object store, which is not ported yet (ROADMAP Queue 1 "
                "item 6c)")
        if capacity_bytes is None:
            from ray_tpu_torch.inference.config import infer_config
            capacity_bytes = infer_config().store_cap
        self.capacity_bytes = int(capacity_bytes)   # 0 = unbounded
        # recency order: move_to_end on checkout leaves the LRU entry
        # at the front
        self._entries: "collections.OrderedDict[Tuple[bytes, int], Dict]" \
            = collections.OrderedDict()
        self._bytes: Dict[Tuple[bytes, int], int] = {}
        # per-key checkout pins: an entry with a fetch in flight is
        # never evicted
        self._pins: Dict[Tuple[bytes, int], int] = {}
        self.puts = 0
        self.dup_puts = 0
        self.gets = 0
        self.misses = 0
        self.bytes_put = 0
        self.evictions = 0
        self.bytes_evicted = 0
        self.in_flight = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple[bytes, int]) -> bool:
        return key in self._entries

    @property
    def bytes(self) -> int:
        return sum(self._bytes.values())

    def _evict_for(self, incoming: int) -> None:
        if self.capacity_bytes <= 0:
            return
        resident = self.bytes
        victims = [k for k in self._entries if not self._pins.get(k)]
        for key in victims:
            if resident + incoming <= self.capacity_bytes:
                break
            nb = self._bytes.pop(key, 0)
            del self._entries[key]
            resident -= nb
            self.evictions += 1
            self.bytes_evicted += nb

    def put(self, key: Tuple[bytes, int],
            entry: Dict[str, object]) -> None:
        if key in self._entries:        # content-addressed: a no-op
            self.dup_puts += 1
            return
        nb = spill_entry_bytes(entry)
        self._evict_for(nb)
        self._entries[key] = entry
        self._bytes[key] = nb
        self.puts += 1
        self.bytes_put += nb

    def checkout(self, key: Tuple[bytes, int]
                 ) -> Optional[Dict[str, object]]:
        """Fetch an entry without removing it, pinned against eviction
        until :meth:`checkin`."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self._pins[key] = self._pins.get(key, 0) + 1
        self.gets += 1
        self.in_flight += 1
        return entry

    def checkin(self, key: Tuple[bytes, int]) -> None:
        self.in_flight -= 1
        pins = self._pins.get(key, 0) - 1
        if pins > 0:
            self._pins[key] = pins
        else:
            self._pins.pop(key, None)

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "bytes": self.bytes,
                "capacity_bytes": self.capacity_bytes,
                "puts": self.puts, "dup_puts": self.dup_puts,
                "gets": self.gets, "misses": self.misses,
                "bytes_put": self.bytes_put,
                "evictions": self.evictions,
                "bytes_evicted": self.bytes_evicted,
                "in_flight": self.in_flight}
