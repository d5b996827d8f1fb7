"""The meeting point: versioned weight snapshots out, trajectories back.

Counterpart of ``ray_tpu/rl/replay.py``.  Two host-side structures close
the train<->infer loop:

- :class:`WeightStore` — the learner publishes parameter snapshots
  under a monotonic version; with a session up the snapshot goes
  through the port's **object store** (``ray_tpu_torch.put``), so N
  actor processes share one copy, otherwise an in-process slot serves
  it.  Either way actors see ``(version, host tree)`` and swap it in
  with ``engine.set_params``.

- :class:`ReplayQueue` — the bounded trajectory path back.  Capacity
  is bounded (an unbounded queue converts a slow learner into
  unbounded staleness); the **staleness bound is hard**: a batch whose
  ``param_version`` lags the latest publication by more than
  ``max_lag`` is discarded at pop time, never trained on
  (arXiv:2011.03641's concurrency-limits argument, in versions instead
  of requests).  The ``overflow`` policy only governs full-queue puts:
  ``drop`` evicts the oldest batch (freshness wins), ``wait`` rejects
  the put so the producer backs off (no trajectory wasted).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Deque, List, Optional, Tuple

from ray_tpu_torch.rl.rollout import TrajectoryBatch
from ray_tpu_torch.util import chaos


class ReplayPutTimeout(RuntimeError):
    """Typed timeout for a blocking ``wait``-policy put
    (``RAY_TPU_RL_PUT_TIMEOUT``): the queue stayed full for the whole
    budget — the learner is dead or wedged, and the rollout actor must
    get control back (report to its supervisor, resync, retry) instead
    of blocking forever on a consumer that will never pop."""

    def __init__(self, timeout_s: float):
        super().__init__(
            f"ReplayQueue put timed out after {timeout_s:.3f}s: the "
            "queue stayed full (dead/wedged learner?) — rejecting the "
            "batch back to the producer (RAY_TPU_RL_PUT_TIMEOUT)")
        self.timeout_s = timeout_s

    def __reduce__(self):
        # rebuild from the constructor arg, not the message (remote
        # rollout actors ship this across the object store)
        return (ReplayPutTimeout, (self.timeout_s,))


class WeightStore:
    """Versioned param snapshots, object-store-backed when available."""

    def __init__(self, use_object_store: Optional[bool] = None):
        if use_object_store is None:
            from ray_tpu_torch._private.worker import is_initialized
            use_object_store = is_initialized()
        self._use_ray = use_object_store
        self._version = 0
        self._slot: Any = None          # host pytree or ObjectRef
        # materialized-tree memo: N driver-side actors syncing to one
        # publication must not pay N object-store fetches of the
        # identical snapshot (a whole model's bytes each, on the
        # rollout critical path)
        self._mat_version = -1
        self._mat: Any = None
        self.publish_count = 0

    @property
    def version(self) -> int:
        return self._version

    def publish(self, params, *, version: Optional[int] = None) -> int:
        """Publish a host-side snapshot (CPU tensors or numpy leaves);
        returns its version.

        ``params`` may already be an ``ObjectRef`` (the LearnerGroup
        driver hands ``get_params_ref()`` straight through — the
        snapshot never round-trips the driver).  Either way publish
        returns only once the snapshot *exists* in the object store:
        a publication isn't published until actors can fetch it, and
        the publish-latency metric must price the serialization/store
        put, not a ~µs async ref handoff.

        Fault site ``rl.publish`` fires *before* any state mutates, so
        a failed publication leaves the store serving the previous
        version — actors keep rolling out on stale-but-consistent
        weights, which is the recovery contract the supervised loop
        tests."""
        chaos.maybe_fail("rl.publish")
        from ray_tpu_torch.object_ref import ObjectRef
        if self._use_ray:
            import ray_tpu_torch
            if isinstance(params, ObjectRef):
                ray_tpu_torch.wait([params], num_returns=1)
            else:
                params = ray_tpu_torch.put(params)
        self._slot = params
        self._version = (self._version + 1 if version is None
                         else int(version))
        self.publish_count += 1
        return self._version

    def latest(self) -> Tuple[int, Any]:
        """-> (version, host tree); raises before the first publish.
        The materialized tree is memoized per version — repeated
        calls between publications fetch nothing."""
        if self._slot is None:
            raise RuntimeError("WeightStore.latest() before the first "
                               "publish — the learner seeds version 1")
        from ray_tpu_torch.object_ref import ObjectRef
        params = self._slot
        if isinstance(params, ObjectRef):
            if self._mat_version == self._version:
                return self._version, self._mat
            import ray_tpu_torch
            params = ray_tpu_torch.get(params)
            self._mat_version, self._mat = self._version, params
        return self._version, params


class ReplayQueue:
    """Bounded trajectory queue with a hard staleness bound."""

    def __init__(self, capacity: int, *, max_lag: int = 1,
                 overflow: str = "drop",
                 put_timeout: Optional[float] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if overflow not in ("drop", "wait"):
            raise ValueError(f"unknown overflow policy {overflow!r}; "
                             "expected 'drop' or 'wait'")
        if max_lag < 0:
            raise ValueError(f"max_lag must be >= 0, got {max_lag}")
        self.capacity = capacity
        self.max_lag = max_lag
        self.overflow = overflow
        # default blocking budget for ``wait``-policy puts whose call
        # passes no explicit timeout: ``RAY_TPU_RL_PUT_TIMEOUT``.
        # Single-threaded drivers (producer and consumer on one
        # thread) MUST pin this to 0 — a timed put there waits for a
        # pop that cannot happen until it returns.
        if put_timeout is None:
            from ray_tpu_torch.rl.config import rl_config
            put_timeout = rl_config().put_timeout
        self.put_timeout = float(put_timeout)
        self._q: Deque[TrajectoryBatch] = collections.deque()
        # one lock + condition makes the queue safe for supervised
        # loops that run actors on threads; pops notify blocked
        # ``wait``-policy puts
        self._cond = threading.Condition()
        self.drops_stale = 0
        self.drops_overflow = 0
        self.puts = 0
        self.pops = 0
        self.backpressure_rejections = 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def put(self, batch: TrajectoryBatch,
            timeout: Optional[float] = None) -> bool:
        """Enqueue; returns False when a full queue rejects the put
        under the ``wait`` policy (the producer backs off — nothing
        was dropped).  Under ``drop`` the oldest batch is evicted: the
        freshest trajectories always fit.

        ``timeout`` (seconds, ``wait`` policy only; defaults to the
        queue's ``put_timeout`` = ``RAY_TPU_RL_PUT_TIMEOUT``) turns
        the rejection into a bounded block: wait up to ``timeout``
        for a pop to free space, then raise :class:`ReplayPutTimeout`
        — a producer must never block forever on a dead learner.
        Both the immediate rejection and the timeout count as
        ``backpressure_rejections``."""
        if timeout is None:
            timeout = self.put_timeout
        with self._cond:
            if len(self._q) >= self.capacity:
                if self.overflow == "wait":
                    if timeout <= 0:
                        self.backpressure_rejections += 1
                        return False
                    if not self._cond.wait_for(
                            lambda: len(self._q) < self.capacity,
                            timeout=timeout):
                        self.backpressure_rejections += 1
                        raise ReplayPutTimeout(timeout)
                else:
                    self._q.popleft()
                    self.drops_overflow += 1
            self._q.append(batch)
            self.puts += 1
            return True

    def pop(self, current_version: int) -> Optional[TrajectoryBatch]:
        """Next batch fresh enough to train on, or None.

        Discards (and counts) every batch with ``param_version <
        current_version - max_lag`` — the hard bound: the learner
        never sees a trajectory generated more than ``max_lag``
        publications ago, under either overflow policy."""
        with self._cond:
            while self._q:
                batch = self._q.popleft()
                self._cond.notify_all()
                if batch.param_version < current_version - self.max_lag:
                    self.drops_stale += 1
                    continue
                self.pops += 1
                return batch
            return None

    def drain(self) -> List[TrajectoryBatch]:
        """Empty the queue (shutdown); returns the leftover batches so
        the caller can account for them — nothing silently vanishes."""
        with self._cond:
            out = list(self._q)
            self._q.clear()
            self._cond.notify_all()
            return out
