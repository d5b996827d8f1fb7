"""WorkerGroup — the gang of train-worker actors.

Counterpart of ``ray_tpu/train/worker_group.py`` (parity: the
reference's ``python/ray/train/_internal/worker_group.py``).  Workers
are scheduled into a placement group built from the ScalingConfig, one
bundle each; a bundle with ``"GPU"`` gives its worker a card of its own
(a GPU worker cold-spawns and keeps its card for life).  Each worker
hosts a :class:`RayTrainWorker` that runs functions and the train loop.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.session import (TrainContext, get_session,
                                         init_session, shutdown_session)
from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy)


@ray_tpu_torch.remote
class RayTrainWorker:
    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self._train_thread: Optional[threading.Thread] = None

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def set_env(self, env: Dict[str, str]):
        import os
        os.environ.update(env)
        return True

    def node_ip(self):
        from ray_tpu_torch.util.collective import _node_ip
        return _node_ip()

    def start_train_fn(self, fn: Callable, config: Dict[str, Any],
                       context: TrainContext, checkpoint,
                       dataset_shards=None):
        session = init_session(context, checkpoint, dataset_shards)

        def runner():
            try:
                import inspect
                if len(inspect.signature(fn).parameters) == 0:
                    fn()
                else:
                    fn(config)
            except BaseException as e:  # noqa: BLE001
                session.error = e
            finally:
                session.finished.set()
                session.queue.put(("done", None, None))

        self._train_thread = threading.Thread(target=runner, daemon=True,
                                              name="train-loop")
        self._train_thread.start()
        return True

    def next_report(self, timeout: float = 1.0):
        """(kind, metrics, checkpoint) | None on timeout."""
        import queue as _q
        session = get_session()
        if session is None:
            return ("done", None, None)
        try:
            item = session.queue.get(timeout=timeout)
        except _q.Empty:
            return None
        if item[0] == "done" and session.error is not None:
            from ray_tpu_torch.exceptions import format_remote_traceback
            return ("error", {"message": str(session.error),
                              "traceback": format_remote_traceback(
                                  session.error)}, None)
        return item

    def finish(self):
        shutdown_session()
        return True


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK"):
        self.num_workers = num_workers
        self.resources = resources_per_worker
        self.pg: Optional[PlacementGroup] = None
        if num_workers > 0:
            bundles = [dict(resources_per_worker)
                       for _ in range(num_workers)]
            self.pg = placement_group(bundles, strategy=placement_strategy)
            if not self.pg.wait(60):
                remove_placement_group(self.pg)
                raise RuntimeError(
                    f"could not reserve resources for {num_workers} "
                    f"workers x {resources_per_worker}")
        self.workers: List[Any] = []
        for rank in range(num_workers):
            opts: Dict[str, Any] = {
                "num_cpus": resources_per_worker.get("CPU", 1),
                "max_restarts": 0,
            }
            if resources_per_worker.get("GPU"):
                opts["num_gpus"] = resources_per_worker["GPU"]
            extra = {k: v for k, v in resources_per_worker.items()
                     if k not in ("CPU", "GPU", "memory")}
            if extra:
                opts["resources"] = extra
            if self.pg is not None:
                opts["scheduling_strategy"] = \
                    PlacementGroupSchedulingStrategy(
                        placement_group=self.pg,
                        placement_group_bundle_index=rank)
            self.workers.append(
                RayTrainWorker.options(**opts).remote(rank, num_workers))

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get([w.execute.remote(fn, *args, **kwargs)
                                  for w in self.workers], timeout=300)

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs)
                for w in self.workers]

    def set_env(self, envs: List[Dict[str, str]]):
        ray_tpu_torch.get([w.set_env.remote(e)
                           for w, e in zip(self.workers, envs)], timeout=60)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
        if self.pg is not None:
            remove_placement_group(self.pg)
        self.workers = []

    def __len__(self):
        return len(self.workers)
