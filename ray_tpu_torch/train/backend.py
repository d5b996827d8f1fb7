"""Backend plugins and the BackendExecutor.

The port's copy of ``ray_tpu/train/backend.py`` (parity: the
reference's ``python/ray/train/backend.py`` and
``train/_internal/backend_executor.py``): the executor starts the worker
group, lets the backend wire up the distributed runtime (collective
groups, the ``torch.distributed`` world), runs the user loop on every
worker, and streams back reported results.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingFailedError(RuntimeError):
    pass


@dataclass
class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: BackendConfig):
        pass

    def on_training_start(self, worker_group: WorkerGroup,
                          backend_config: BackendConfig):
        pass

    def on_shutdown(self, worker_group: WorkerGroup):
        pass


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK"):
        self.backend_config = backend_config
        self.backend: Backend = backend_config.backend_cls()()
        self.num_workers = num_workers
        self.resources_per_worker = resources_per_worker
        self.placement_strategy = placement_strategy
        self.worker_group: Optional[WorkerGroup] = None

    def start(self):
        self.worker_group = WorkerGroup(self.num_workers,
                                        self.resources_per_worker,
                                        self.placement_strategy)
        self.backend.on_start(self.worker_group, self.backend_config)

    def start_training(self, train_fn: Callable,
                       config: Dict[str, Any],
                       checkpoint: Optional[Checkpoint] = None,
                       dataset_shards: Optional[List[Dict]] = None,
                       experiment_name: str = "experiment",
                       trial_id: str = "trial",
                       mesh_axes: Optional[Dict[str, int]] = None):
        assert self.worker_group is not None, "call start() first"
        self.backend.on_training_start(self.worker_group,
                                       self.backend_config)
        refs = []
        for rank, worker in enumerate(self.worker_group.workers):
            ctx = TrainContext(
                world_size=self.num_workers, world_rank=rank,
                local_rank=rank, local_world_size=self.num_workers,
                experiment_name=experiment_name, trial_name=trial_id,
                trial_id=trial_id, mesh_axes=mesh_axes)
            shards = dataset_shards[rank] if dataset_shards else None
            refs.append(worker.start_train_fn.remote(
                train_fn, config, ctx, checkpoint, shards))
        ray_tpu_torch.get(refs, timeout=300)

    def iter_results(self, poll_timeout: float = 1.0,
                     overall_timeout: float = 3600.0):
        """Yield per-round lists of (metrics, checkpoint) across workers.

        A round completes when every live worker has either reported or
        finished.  Raises TrainingFailedError on any worker error."""
        assert self.worker_group is not None
        workers = self.worker_group.workers
        done = [False] * len(workers)
        deadline = time.time() + overall_timeout
        while not all(done):
            round_results: List[Optional[tuple]] = [None] * len(workers)
            for i in [i for i in range(len(workers)) if not done[i]]:
                while True:
                    if time.time() > deadline:
                        raise TrainingFailedError("training timed out")
                    item = ray_tpu_torch.get(
                        workers[i].next_report.remote(poll_timeout),
                        timeout=60 + poll_timeout)
                    if item is None:
                        continue
                    kind = item[0]
                    if kind == "error":
                        raise TrainingFailedError(
                            f"worker {i} failed:\n"
                            f"{item[1]['traceback']}")
                    if kind == "done":
                        done[i] = True
                        break
                    round_results[i] = (item[1], item[2])
                    break
            if any(r is not None for r in round_results):
                yield round_results

    def shutdown(self):
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group)
            finally:
                for w in self.worker_group.workers:
                    try:
                        ray_tpu_torch.get(w.finish.remote(), timeout=10)
                    except Exception:  # noqa: BLE001
                        pass
                self.worker_group.shutdown()
                self.worker_group = None
