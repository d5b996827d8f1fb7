# The port's copy of ray_tpu/air/integrations/mlflow.py
"""MLflow tracking (parity: ``python/ray/air/integrations/mlflow.py``
MLflowLoggerCallback).

One MLflow run per trial, driven through ``MlflowClient`` with explicit
run ids — the fluent module-level API binds to a single global "active
run", which cross-writes metrics/artifacts between concurrently
reporting trials.  Config becomes params, reports become step-indexed
metrics, persisted checkpoints optionally upload as run artifacts
(off-thread; the hook runs in the Tuner's controller loop), and the
terminal status lands on completion.  The ``mlflow`` client is not part
of the image — construction raises a clear ImportError when
absent."""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ray_tpu_torch.tune.callbacks import LoggerCallback


class MLflowLoggerCallback(LoggerCallback):
    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment_name: Optional[str] = None,
                 tags: Optional[Dict[str, str]] = None,
                 save_artifact: bool = False):
        try:
            import mlflow
        except ImportError as e:  # pragma: no cover - env-dependent
            raise ImportError(
                "MLflowLoggerCallback requires the `mlflow` package in "
                "the image (the nodes run without runtime pip installs)"
            ) from e
        self._mlflow = mlflow
        self._client = mlflow.tracking.MlflowClient(
            tracking_uri=tracking_uri)
        self._experiment_id = "0"
        if experiment_name:
            exp = self._client.get_experiment_by_name(experiment_name)
            if exp is None:
                self._experiment_id = self._client.create_experiment(
                    experiment_name)
            else:
                self._experiment_id = exp.experiment_id
        self.tags = tags or {}
        self.save_artifact = save_artifact
        self._run_ids: Dict[str, str] = {}

    def _run_id(self, trial) -> str:
        tid = trial.trial_id
        rid = self._run_ids.get(tid)
        if rid is None:
            run = self._client.create_run(
                self._experiment_id,
                tags={**self.tags, "mlflow.runName": tid})
            rid = run.info.run_id
            self._run_ids[tid] = rid
            for k, v in (getattr(trial, "config", {}) or {}).items():
                try:
                    self._client.log_param(rid, k, v)
                except Exception:  # noqa: BLE001 - non-loggable param
                    pass
        return rid

    def log_trial_result(self, trial, result: Dict) -> None:
        rid = self._run_id(trial)
        step = int(result.get("training_iteration", 0))
        ts = int(time.time() * 1000)
        for k, v in result.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._client.log_metric(rid, k, float(v),
                                        timestamp=ts, step=step)

    def log_trial_save(self, trial, checkpoint_path: str) -> None:
        """Persisted checkpoint -> MLflow run artifacts (off-thread)."""
        if not self.save_artifact:
            return
        rid = self._run_id(trial)

        def upload():
            try:
                self._client.log_artifacts(
                    rid, checkpoint_path,
                    artifact_path=f"checkpoints/{trial.trial_id}")
            except Exception:  # noqa: BLE001 — upload is best-effort
                pass

        threading.Thread(target=upload, daemon=True,
                         name="mlflow-ckpt-upload").start()

    def log_trial_end(self, trial, failed: bool) -> None:
        rid = self._run_ids.pop(trial.trial_id, None)
        if rid is not None:
            self._client.set_terminated(
                rid, "FAILED" if failed else "FINISHED")
