"""DataParallelTrainer — N workers, one train loop each.

Counterpart of ``ray_tpu/train/data_parallel_trainer.py`` (parity: the
reference's ``python/ray/train/data_parallel_trainer.py`` and
``base_trainer.py``): ``fit()`` starts the worker group through the
BackendExecutor, streams reports, keeps the best checkpoints, and
restarts the whole group from the latest checkpoint on failure
(``FailureConfig.max_failures``).  Each attempt's group is shut down
before the next starts and before ``fit()`` returns: its workers are
killed and their cards given back.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.backend import (BackendConfig, BackendExecutor,
                                         TrainingFailedError)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.result import Result


class DataParallelTrainer:
    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(self, train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or \
            self._default_backend_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        if self.run_config.name is None:
            self.run_config.name = (
                f"{type(self).__name__}_{uuid.uuid4().hex[:8]}")
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self._restored = False  # set by restore(): adopt prior checkpoints

    # ------------------------------------------------------------------
    def _dataset_shards(self) -> Optional[List[Dict[str, Any]]]:
        """Per-worker dataset views: a dataset with ``streaming_split``
        or ``split`` is split across the workers; any other object goes
        to every worker as it is."""
        if not self.datasets:
            return None
        n = self.scaling_config.num_workers
        shards: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                parts = ds.streaming_split(n, equal=True)
            elif hasattr(ds, "split"):
                parts = ds.split(n)
            else:
                parts = [ds] * n
            for i in range(n):
                shards[i][name] = parts[i]
        return shards

    def _save_trainer_blob(self, storage: str) -> None:
        """Enough to rebuild this trainer for ``restore`` (datasets
        excluded: resupply them at restore time)."""
        import cloudpickle
        with open(os.path.join(storage, "trainer.pkl"), "wb") as f:
            cloudpickle.dump({
                "cls": type(self),
                "train_loop_per_worker": self.train_loop_per_worker,
                "train_loop_config": self.train_loop_config,
                "backend_config": self.backend_config,
                "scaling_config": self.scaling_config,
                "run_config": self.run_config,
            }, f)

    def fit(self) -> Result:
        from ray_tpu_torch.train.storage import is_remote_uri, upload_dir
        storage = self.run_config.resolved_storage_path()
        if is_remote_uri(storage):
            # checkpoints persist straight to the remote; the small
            # trainer blob is written locally, then mirrored up
            ckpt_dir = storage.rstrip("/") + "/checkpoints"
            local = os.path.join(
                os.path.expanduser("~/ray_tpu_torch_results"),
                "_remote_mirror", self.run_config.name or "experiment")
            os.makedirs(local, exist_ok=True)
            self._save_trainer_blob(local)
            try:
                upload_dir(local, storage)
            except Exception:  # noqa: BLE001 - blob mirror best-effort
                pass
        else:
            os.makedirs(storage, exist_ok=True)
            self._save_trainer_blob(storage)
            ckpt_dir = os.path.join(storage, "checkpoints")
        ckpt_mgr = CheckpointManager(
            ckpt_dir, self.run_config.checkpoint_config,
            resume=self._restored)
        max_failures = self.run_config.failure_config.max_failures
        attempts = (max_failures + 1) if max_failures >= 0 else 10**6
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        error: Optional[BaseException] = None
        start_ckpt = self.resume_from_checkpoint

        for attempt in range(attempts):
            executor = BackendExecutor(
                self.backend_config,
                self.scaling_config.num_workers,
                self.scaling_config._resources,
                self.scaling_config.placement_strategy)
            shards = self._dataset_shards()
            try:
                executor.start()
                executor.start_training(
                    self.train_loop_per_worker, self.train_loop_config,
                    checkpoint=start_ckpt or ckpt_mgr.latest,
                    dataset_shards=shards,
                    experiment_name=self.run_config.name,
                    trial_id=self.run_config.name,
                    mesh_axes=self.scaling_config.mesh_axes)
                for round_results in executor.iter_results():
                    rank0 = next((r for r in round_results
                                  if r is not None), None)
                    if rank0 is None:
                        continue
                    metrics, checkpoint = rank0
                    metrics = dict(metrics)
                    metrics["_attempt"] = attempt
                    history.append(metrics)
                    last_metrics = metrics
                    if checkpoint is not None:
                        ckpt_mgr.register(checkpoint, metrics)
                error = None
                break
            except TrainingFailedError as e:
                error = e
                if attempt == attempts - 1 or \
                        self.run_config.failure_config.fail_fast:
                    break
                time.sleep(0.5)
            finally:
                executor.shutdown()
                del shards

        result = Result(
            metrics=last_metrics,
            checkpoint=ckpt_mgr.best_checkpoint(),
            path=storage,
            error=error,
            metrics_history=history,
            best_checkpoints=ckpt_mgr.best_checkpoints(),
        )
        if error is not None and self.run_config.failure_config.fail_fast:
            raise error
        return result

    @classmethod
    def restore(cls, path: str,
                train_loop_per_worker: Optional[Callable] = None,
                datasets: Optional[Dict[str, Any]] = None,
                **overrides) -> "DataParallelTrainer":
        """Rebuild an interrupted trainer from its storage directory;
        ``fit()`` then resumes from the latest checkpoint the previous
        run registered (parity: ``BaseTrainer.restore``)."""
        import cloudpickle

        from ray_tpu_torch.train.storage import is_remote_uri
        if is_remote_uri(path):
            # fetch only the small trainer blob; the checkpoints under
            # the same URI rehydrate lazily
            import tempfile

            import fsspec
            local = tempfile.mkdtemp(prefix="rtpu_restore_")
            fs, _, paths = fsspec.get_fs_token_paths(path.rstrip("/"))
            fs.get_file(paths[0] + "/trainer.pkl",
                        os.path.join(local, "trainer.pkl"))
            path = local
        with open(os.path.join(path, "trainer.pkl"), "rb") as f:
            blob = cloudpickle.load(f)
        trainer_cls = blob.pop("cls", cls)
        loop = train_loop_per_worker or blob.pop("train_loop_per_worker")
        blob.pop("train_loop_per_worker", None)
        blob.update(overrides)
        trainer = trainer_cls(loop, datasets=datasets, **blob)
        trainer._restored = True
        return trainer

    @staticmethod
    def can_restore(path: str) -> bool:
        return os.path.exists(os.path.join(path, "trainer.pkl"))

    def as_trainable(self):
        """Adapter so Tune can run this trainer as a trial: each trial
        fits a copy of the trainer with the trial's config merged into
        ``train_loop_config`` and returns its final metrics."""
        trainer = self

        def trainable(config):
            merged = dict(trainer.train_loop_config)
            merged.update(config)
            trainer2 = type(trainer)(
                trainer.train_loop_per_worker,
                train_loop_config=merged,
                backend_config=trainer.backend_config,
                scaling_config=trainer.scaling_config,
                run_config=trainer.run_config,
                datasets=trainer.datasets)
            result = trainer2.fit()
            if result.error:
                raise result.error
            return result.metrics

        return trainable
