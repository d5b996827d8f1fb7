"""AdapterStore: the fleet-shared, content-addressed adapter shelf.

Counterpart of ``ray_tpu/adapters/store.py``: multi-tenant and
multi-version, entries keyed ``(model_id, version)`` with a monotonic
per-model latest pointer.  Snapshots go through the port's object
store when a session is up (``ray_tpu_torch.put``: N replicas share
one copy), else an in-process dict serves single-process engines and
tests.  Replicas *fetch* through it on a cache miss (the disaggregated
import path too: a decode replica that receives a handoff for an
adapter it has never seen pulls the exact pinned version here and
writes it into its bank in place).

Leak-audit contract: ``in_flight`` counts checked-out fetches and must
be 0 after a fleet drain, exactly like ``KVPageStore.in_flight``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.adapters.lora import adapter_nbytes, salt_bytes


class AdapterUnavailableError(RuntimeError):
    """Typed miss/load failure for a per-request ``model_id``.

    Raised by ``engine.submit`` (unknown tenant), by the adapter load
    path (store miss, injected ``serve.adapter_load`` fault) and by a
    full-of-pinned-adapters bank.  The router treats it as a
    re-routable condition; a client sees it as a terminal typed error
    — never a hang.  ``__reduce__`` rebuilds from constructor args so
    it survives the object store (the HandoffContentMissing idiom)."""

    def __init__(self, model_id: Optional[str], reason: str):
        super().__init__(
            f"adapter {model_id!r} unavailable: {reason}")
        self.model_id = model_id
        self.reason = reason

    def __reduce__(self):
        return (AdapterUnavailableError, (self.model_id, self.reason))


class AdapterStore:
    """Versioned per-tenant adapter snapshots + scales."""

    def __init__(self, use_object_store: Optional[bool] = None):
        if use_object_store is None:
            from ray_tpu_torch._private.worker import is_initialized
            use_object_store = is_initialized()
        self._use_ray = use_object_store
        self._lock = threading.Lock()
        # (model_id, version) -> (payload, scale, nbytes); payload is a
        # host pytree or an ObjectRef
        self._entries: Dict[Tuple[str, int], Tuple[Any, float, int]] = {}
        self._latest: Dict[str, int] = {}
        # materialization memo per key (N replicas syncing one
        # publication must not pay N deserializations)
        self._mat: Dict[Tuple[str, int], Any] = {}
        self.in_flight = 0
        self.puts = 0
        self.gets = 0
        self.misses = 0
        self.bytes_published = 0

    def put(self, model_id: str, adapter, *, scale: float = 1.0,
            version: Optional[int] = None) -> int:
        """Publish an adapter snapshot; returns its version (monotonic
        per model_id unless pinned explicitly).  ``adapter`` may be a
        host pytree or an ``ObjectRef`` (LearnerGroup hands
        ``get_params_ref()`` straight through)."""
        if not model_id:
            raise ValueError("model_id must be a non-empty string")
        from ray_tpu_torch.object_ref import ObjectRef
        nbytes = 0
        if isinstance(adapter, ObjectRef):
            if self._use_ray:
                import ray_tpu_torch
                ray_tpu_torch.wait([adapter], num_returns=1)
        else:
            nbytes = adapter_nbytes(adapter)
            if self._use_ray:
                import ray_tpu_torch
                adapter = ray_tpu_torch.put(adapter)
        with self._lock:
            if version is None:
                version = self._latest.get(model_id, 0) + 1
            version = int(version)
            self._entries[(model_id, version)] = (adapter, float(scale),
                                                  nbytes)
            if version >= self._latest.get(model_id, 0):
                self._latest[model_id] = version
            self.puts += 1
            self.bytes_published += nbytes
        return version

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._latest

    def latest_version(self, model_id: str) -> Optional[int]:
        with self._lock:
            return self._latest.get(model_id)

    def salt_for(self, model_id: Optional[str],
                 version: Optional[int] = None) -> bytes:
        """Prefix-chain salt for routing-side hash computation; b"" for
        base traffic or tenants this store has never seen (a salted
        hash that matches nothing degrades to a plain affinity miss)."""
        if not model_id:
            return b""
        v = version if version is not None else self.latest_version(model_id)
        if v is None:
            return b""
        return salt_bytes(model_id, v)

    def checkout(self, model_id: str,
                 version: Optional[int] = None) -> Tuple[int, Any, float]:
        """-> ``(version, host adapter pytree, scale)``; pins the fetch
        in ``in_flight`` until :meth:`checkin`.  Raises
        :class:`AdapterUnavailableError` on a miss (unknown tenant or
        unknown pinned version)."""
        with self._lock:
            if version is None:
                version = self._latest.get(model_id)
            if version is None or (model_id, version) not in self._entries:
                self.misses += 1
                raise AdapterUnavailableError(
                    model_id,
                    "never published" if version is None
                    else f"version {version} not in store")
            payload, scale, _ = self._entries[(model_id, version)]
            self.in_flight += 1
            self.gets += 1
            mat = self._mat.get((model_id, version))
        if mat is not None:
            return version, mat, scale
        from ray_tpu_torch.object_ref import ObjectRef
        try:
            if isinstance(payload, ObjectRef):
                import ray_tpu_torch
                payload = ray_tpu_torch.get(payload)
        except Exception as err:
            # a failed materialization must not strand the pin:
            # in_flight is the leak-audit counter, and a fetch that
            # raised has nothing to check in later
            with self._lock:
                self.in_flight -= 1
            raise AdapterUnavailableError(
                model_id, f"object-store fetch of version {version} "
                f"failed: {err}") from err
        with self._lock:
            self._mat[(model_id, version)] = payload
        return version, payload, scale

    def checkin(self) -> None:
        with self._lock:
            if self.in_flight <= 0:
                raise RuntimeError("AdapterStore.checkin without a "
                                   "matching checkout")
            self.in_flight -= 1

    def get(self, model_id: str,
            version: Optional[int] = None) -> Tuple[int, Any, float]:
        """Unpinned convenience fetch (checkout + immediate checkin)."""
        out = self.checkout(model_id, version)
        self.checkin()
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "models": len(self._latest),
                "entries": len(self._entries),
                "puts": self.puts,
                "gets": self.gets,
                "misses": self.misses,
                "in_flight": self.in_flight,
                "bytes_published": self.bytes_published,
            }
