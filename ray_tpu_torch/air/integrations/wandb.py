# The port's copy of ray_tpu/air/integrations/wandb.py
"""Weights & Biases tracking (parity:
``python/ray/air/integrations/wandb.py`` WandbLoggerCallback).

Full run lifecycle per trial: config capture (all params, not just
numerics), every ``tune.report`` logged at its training iteration,
optional checkpoint artifact upload on each persisted checkpoint, and
a final summary + exit status on completion.  The ``wandb`` client is
not part of the image — construction raises a clear ImportError
when absent (reference behavior)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.tune.callbacks import LoggerCallback


class WandbLoggerCallback(LoggerCallback):
    def __init__(self, project: Optional[str] = None,
                 group: Optional[str] = None,
                 api_key: Optional[str] = None,
                 upload_checkpoints: bool = False,
                 **wandb_init_kwargs):
        try:
            import wandb
        except ImportError as e:  # pragma: no cover - env-dependent
            raise ImportError(
                "WandbLoggerCallback requires the `wandb` package in "
                "the image (the nodes run without runtime pip installs)"
            ) from e
        self._wandb = wandb
        if api_key:
            wandb.login(key=api_key)
        self.project = project
        self.group = group
        self.upload_checkpoints = upload_checkpoints
        self.kwargs = wandb_init_kwargs
        self._runs: Dict[str, Any] = {}

    def _run(self, trial):
        tid = trial.trial_id
        run = self._runs.get(tid)
        if run is None:
            kwargs = dict(self.kwargs)
            # merge, don't collide, with user-supplied tags
            kwargs["tags"] = list(kwargs.get("tags") or []) \
                + [f"trial:{tid}"]
            run = self._wandb.init(
                project=self.project, group=self.group, name=tid,
                config=dict(getattr(trial, "config", {}) or {}),
                reinit=True, **kwargs)
            self._runs[tid] = run
        return run

    def log_trial_result(self, trial, result: Dict[str, Any]) -> None:
        run = self._run(trial)
        step = int(result.get("training_iteration", 0)) or None
        run.log({k: v for k, v in result.items()
                 if isinstance(v, (int, float))
                 and not isinstance(v, bool)}, step=step)

    def log_trial_save(self, trial, checkpoint_path: str) -> None:
        """Persisted checkpoint -> W&B artifact (versioned per trial).

        Uploaded off-thread: the hook runs in the Tuner's controller
        loop, and a multi-GB artifact push must not stall every other
        trial's scheduling for the duration (the reference isolates
        wandb in a separate process for the same reason)."""
        if not self.upload_checkpoints:
            return
        run = self._run(trial)

        def upload():
            try:
                art = self._wandb.Artifact(
                    f"checkpoint_{trial.trial_id}", type="model")
                art.add_dir(checkpoint_path)
                run.log_artifact(art)
            except Exception:  # noqa: BLE001 — upload is best-effort
                pass

        import threading
        threading.Thread(target=upload, daemon=True,
                         name="wandb-ckpt-upload").start()

    def log_trial_end(self, trial, failed: bool) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            # final summary: last reported result, incl. non-numerics
            last = getattr(trial, "last_result", None) or {}
            for k, v in last.items():
                if k != "config":
                    try:
                        run.summary[k] = v
                    except Exception:  # noqa: BLE001
                        pass
            run.finish(exit_code=1 if failed else 0)
