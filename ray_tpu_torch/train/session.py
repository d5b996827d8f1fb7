"""Per-worker training session: ``report`` / ``get_context`` /
``get_checkpoint``.

The port's copy of ``ray_tpu/train/session.py`` (parity: the
reference's ``python/ray/train/_internal/session.py`` and
``air/session.py``).  The user's ``train_loop_per_worker`` runs in a
thread inside the train worker actor; ``report()`` enqueues (metrics,
checkpoint) results that the BackendExecutor drains.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session_lock = threading.Lock()
_session: Optional["_TrainSession"] = None


@dataclass
class TrainContext:
    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = "experiment"
    trial_name: str = "trial"
    trial_id: str = "trial"
    mesh_axes: Optional[Dict[str, int]] = None

    def get_mesh_axes(self) -> Dict[str, int]:
        """``ScalingConfig.mesh_axes``, or ``{"dp": -1}`` (every rank
        data-parallel): ``parallel.mesh.make_mesh(**axes)`` builds the
        mesh over the workers' world."""
        return dict(self.mesh_axes or {"dp": -1})

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_trial_id(self) -> str:
        return self.trial_id


class _TrainSession:
    def __init__(self, context: TrainContext,
                 checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.context = context
        self.queue: "queue.Queue" = queue.Queue()
        self.starting_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        self.queue.put(("report", dict(metrics), checkpoint))


def init_session(context: TrainContext,
                 checkpoint: Optional[Checkpoint] = None,
                 dataset_shards=None) -> _TrainSession:
    global _session
    with _session_lock:
        _session = _TrainSession(context, checkpoint, dataset_shards)
        return _session


def shutdown_session():
    global _session
    with _session_lock:
        _session = None


def get_session() -> Optional[_TrainSession]:
    return _session


# ------------------------------------------------------------- public API
def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    s = get_session()
    if s is None:
        raise RuntimeError(
            "ray_tpu_torch.train.report() called outside a train session")
    s.report(metrics, checkpoint)


def get_context() -> TrainContext:
    s = get_session()
    return s.context if s else TrainContext()


def get_checkpoint() -> Optional[Checkpoint]:
    s = get_session()
    return s.starting_checkpoint if s else None


def get_dataset_shard(name: str = "train"):
    s = get_session()
    if s is None:
        return None
    return s.dataset_shards.get(name)
