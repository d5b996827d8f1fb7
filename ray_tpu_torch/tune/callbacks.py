# The port's copy of ray_tpu/tune/callbacks.py
"""Experiment callbacks + logger integrations.

Parity targets: ``python/ray/tune/callback.py`` (Callback interface,
invoked by the tune controller at trial lifecycle points) and
``python/ray/tune/logger/{json,csv,tensorboardx}.py`` (per-trial result
logging).  External trackers (W&B, MLflow) live in
``ray_tpu_torch.air.integrations`` and subclass :class:`LoggerCallback` the
same way the reference's ``air/integrations/{wandb,mlflow}.py`` do.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


class Callback:
    """Hooks invoked by the Tuner's controller loop.

    Subset of the reference interface
    (``python/ray/tune/callback.py:Callback``) that the controller
    actually drives; all methods are optional overrides.
    """

    def setup(self, storage_path: str) -> None:
        """Called once before the first trial starts."""

    def on_trial_start(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial) -> None:
        pass

    def on_trial_error(self, trial, error: BaseException) -> None:
        pass

    def on_checkpoint(self, trial, checkpoint_path: str) -> None:
        """A trial checkpoint was persisted to ``checkpoint_path``."""

    def on_experiment_end(self, results) -> None:
        pass


class LoggerCallback(Callback):
    """Base for per-trial result loggers (reference:
    ``tune/logger/logger.py:LoggerCallback``): tracks per-trial state,
    funnels every lifecycle event into ``log_trial_*``."""

    def setup(self, storage_path: str) -> None:
        self.storage_path = storage_path
        os.makedirs(storage_path, exist_ok=True)

    def _trial_dir(self, trial) -> str:
        d = os.path.join(self.storage_path, trial.trial_id)
        os.makedirs(d, exist_ok=True)
        return d

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        self.log_trial_result(trial, result)

    def on_checkpoint(self, trial, checkpoint_path: str) -> None:
        self.log_trial_save(trial, checkpoint_path)

    def log_trial_save(self, trial, checkpoint_path: str) -> None:
        """Optional: persist/upload the trial's checkpoint artifact."""

    def on_trial_complete(self, trial) -> None:
        self.log_trial_end(trial, failed=False)

    def on_trial_error(self, trial, error: BaseException) -> None:
        self.log_trial_end(trial, failed=True)

    def log_trial_result(self, trial, result: Dict[str, Any]) -> None:
        raise NotImplementedError

    def log_trial_end(self, trial, failed: bool) -> None:
        pass


def _json_safe(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


class JsonLoggerCallback(LoggerCallback):
    """One JSON line per report in ``<trial>/result.json``
    (reference: ``tune/logger/json.py``)."""

    def log_trial_result(self, trial, result: Dict[str, Any]) -> None:
        path = os.path.join(self._trial_dir(trial), "result.json")
        with open(path, "a") as f:
            f.write(json.dumps({k: _json_safe(v)
                                for k, v in result.items()}) + "\n")


class CSVLoggerCallback(LoggerCallback):
    """Rolling ``<trial>/progress.csv`` (reference: ``tune/logger/csv.py``).

    The header is fixed by the FIRST report's keys; later reports write
    the intersection (the reference does the same)."""

    def __init__(self):
        self._writers: Dict[str, csv.DictWriter] = {}
        self._files: Dict[str, Any] = {}

    def log_trial_result(self, trial, result: Dict[str, Any]) -> None:
        tid = trial.trial_id
        if tid not in self._writers:
            f = open(os.path.join(self._trial_dir(trial), "progress.csv"),
                     "w", newline="")
            w = csv.DictWriter(f, fieldnames=sorted(result.keys()))
            w.writeheader()
            self._files[tid], self._writers[tid] = f, w
        w = self._writers[tid]
        w.writerow({k: _json_safe(result.get(k)) for k in w.fieldnames})
        self._files[tid].flush()

    def log_trial_end(self, trial, failed: bool) -> None:
        f = self._files.pop(trial.trial_id, None)
        if f is not None:
            f.close()
        self._writers.pop(trial.trial_id, None)


class TBXLoggerCallback(LoggerCallback):
    """TensorBoard scalars per trial (reference:
    ``tune/logger/tensorboardx.py``).  Uses ``torch.utils.tensorboard``
    when available; raises at construction otherwise so the failure is
    visible at Tuner build time, not mid-run."""

    def __init__(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:  # pragma: no cover - env-dependent
            raise ImportError(
                "TBXLoggerCallback needs torch.utils.tensorboard "
                "(pip package `tensorboard`)") from e
        self._writer_cls = SummaryWriter
        self._writers: Dict[str, Any] = {}

    def log_trial_result(self, trial, result: Dict[str, Any]) -> None:
        tid = trial.trial_id
        if tid not in self._writers:
            self._writers[tid] = self._writer_cls(
                log_dir=self._trial_dir(trial))
        step = int(result.get("training_iteration", 0))
        for k, v in result.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._writers[tid].add_scalar(k, v, global_step=step)
        self._writers[tid].flush()

    def log_trial_end(self, trial, failed: bool) -> None:
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            w.close()


DEFAULT_LOGGERS = (JsonLoggerCallback, CSVLoggerCallback)


def invoke(callbacks: Optional[List[Callback]], method: str,
           *args) -> None:
    """Best-effort fan-out: a crashing callback must not kill the
    controller loop (reference behavior: warn and continue)."""
    for cb in callbacks or []:
        try:
            getattr(cb, method)(*args)
        except Exception:  # noqa: BLE001
            import logging
            logging.getLogger(__name__).warning(
                "callback %s.%s failed", type(cb).__name__, method,
                exc_info=True)
