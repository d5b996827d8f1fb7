"""AdapterRegistry: per-engine resident-adapter bookkeeping.

Counterpart of ``ray_tpu/adapters/registry.py``, the same LRU and pin
order.

The engine's bank has ``cache_slots`` writable rows (slot 0 is the
identity).  This registry decides which factors occupy which row.
Residency is keyed by **(model_id, version)**: a republished version
is a *different* entry, so new factors land in a fresh row while
requests pinned to the old version keep decoding over untouched
factors — the "decode under the EXACT factors the prefill used"
invariant survives mid-traffic republishes and co-batched
version-pinned handoff imports.

- ``lookup``/``touch`` — LRU order over resident (tenant, version)
  pairs; an unversioned lookup resolves to the tenant's newest
  resident version;
- ``pin``/``unpin`` — every admitted request pins its exact
  (tenant, version) for its lifetime, so factors mid-decode can never
  be evicted *or overwritten* under the requests using them (the
  page-allocator hold discipline, applied to bank rows);
- ``place`` — allocate a row for a (tenant, version): the tenant's
  stale unpinned versions retire first (the publish supersedes them),
  then a free row, then the LRU unpinned entry is evicted; all rows
  pinned by in-flight requests is a typed
  :class:`~ray_tpu_torch.adapters.store.AdapterUnavailableError`
  (the router re-routes), never a hang and never an in-place swap.

Leak-audit contract: ``pinned_total == 0`` after a drain.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

from ray_tpu_torch.adapters.store import AdapterUnavailableError


class AdapterRegistry:
    def __init__(self, cache_slots: int):
        if cache_slots < 1:
            raise ValueError(f"cache_slots must be >= 1, got {cache_slots}")
        self.cache_slots = cache_slots
        # (model_id, version) -> bank slot; insertion order is LRU
        # order (move_to_end on touch)
        self._resident: "collections.OrderedDict[Tuple[str, int], int]" = \
            collections.OrderedDict()
        self._free = list(range(cache_slots, 0, -1))  # pop() yields slot 1 first
        self._pins: Dict[Tuple[str, int], int] = {}
        self.hits = 0
        self.misses = 0
        self.loads = 0
        self.evictions = 0
        self.load_seconds = 0.0

    def lookup(self, model_id: str,
               version: Optional[int] = None) -> Optional[Tuple[int, int]]:
        """Resident ``(slot, version)`` for ``model_id`` — the exact
        ``version`` when given, else the tenant's newest resident
        version (latest-tracking traffic with no store to consult)."""
        if version is not None:
            slot = self._resident.get((model_id, version))
            return None if slot is None else (slot, version)
        best: Optional[Tuple[int, int]] = None
        for (mid, v), slot in self._resident.items():
            if mid == model_id and (best is None or v > best[1]):
                best = (slot, v)
        return best

    def touch(self, model_id: str, version: int) -> None:
        self._resident.move_to_end((model_id, version))

    def pin(self, model_id: str, version: int) -> None:
        key = (model_id, version)
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, model_id: str, version: int) -> None:
        key = (model_id, version)
        n = self._pins.get(key, 0) - 1
        if n < 0:
            raise RuntimeError(
                f"unpin of {model_id!r} v{version} without a pin")
        if n == 0:
            self._pins.pop(key)
        else:
            self._pins[key] = n

    def place(self, model_id: str, version: int) -> Tuple[int, Optional[str]]:
        """Allocate a bank row for ``(model_id, version)`` ->
        ``(slot, evicted)``.

        The exact pair resident keeps its row *unless pinned* — the
        store is content-addressed, so an unpinned same-version
        re-place is a benign reinstall, but rewriting a pinned row
        would swap factors under active decodes and is refused with
        the typed error.  On a miss, the tenant's stale unpinned
        versions retire first, then a free row is taken, then the LRU
        unpinned entry of any tenant is evicted; if every row is
        pinned by in-flight requests the bank is genuinely full and
        the caller gets the typed error.  ``evicted`` names a tenant
        that fully left residency (None when only a stale version of
        a still-resident tenant retired)."""
        key = (model_id, version)
        slot = self._resident.get(key)
        if slot is not None:
            if key in self._pins:
                raise AdapterUnavailableError(
                    model_id,
                    f"version {version} is pinned by in-flight "
                    "requests — its bank row cannot be rewritten")
            self._resident.move_to_end(key)
            return slot, None
        # retire the tenant's stale unpinned versions: their factors
        # are superseded by this publish and nothing references them.
        # Strictly older only — a version-pinned handoff import of an
        # old version must not displace the tenant's latest.
        for stale in [k for k in self._resident
                      if k[0] == model_id and k[1] < version
                      and k not in self._pins]:
            self._free.append(self._resident.pop(stale))
        evicted = None
        if self._free:
            slot = self._free.pop()
        else:
            victim = next((k for k in self._resident
                           if k not in self._pins), None)
            if victim is None:
                raise AdapterUnavailableError(
                    model_id,
                    f"all {self.cache_slots} resident adapters are "
                    "pinned by in-flight requests")
            slot = self._resident.pop(victim)
            self.evictions += 1
            if not any(k[0] == victim[0] for k in self._resident):
                evicted = victim[0]
        self._resident[key] = slot
        return slot, evicted

    @property
    def resident_ids(self) -> Tuple[str, ...]:
        out = []
        for mid, _v in self._resident:
            if mid not in out:
                out.append(mid)
        return tuple(out)

    @property
    def pinned_total(self) -> int:
        return sum(self._pins.values())

    def digest(self) -> frozenset:
        """Resident tenant model_ids the router composes into
        affinity scores (version-blind: any resident version skips
        the cold store fetch)."""
        return frozenset(mid for mid, _v in self._resident)

    def stats(self) -> Dict[str, float]:
        return {
            "resident": len(self._resident),
            "tenants": len(self.resident_ids),
            "cache_slots": self.cache_slots,
            "hits": self.hits,
            "misses": self.misses,
            "loads": self.loads,
            "evictions": self.evictions,
            "pins": self.pinned_total,
            "load_seconds": round(self.load_seconds, 6),
        }
