# The port's copy of ray_tpu/tune/tuner.py
"""Tuner + controller (parity: ``python/ray/tune/tuner.py`` +
``tune/execution/tune_controller.py``).

Each trial is one actor executing the trainable with its config; the
controller polls reports, feeds the scheduler (ASHA early stopping), and
collects Results.  Trial-actor creation queues naturally on cluster
resources, giving max-concurrency-by-resources like the reference.  A
trial's ``{"GPU": n}`` (``tune.with_resources``) becomes the actor's
``num_gpus``: it gets the card(s) to itself, and a stopped trial's
actor is killed, which gives its cards back once its process is gone.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, FIFOScheduler
from ray_tpu_torch.tune.search.sample import resolve


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Any = None
    search_alg: Any = None
    seed: int = 0


@ray_tpu_torch.remote
class _TrialActor:
    """Runs one trial's function in a thread; streams reports."""

    def __init__(self, trial_id: str):
        self.trial_id = trial_id

    def run(self, fn: Callable, config: Dict[str, Any],
            context: TrainContext, checkpoint):
        from ray_tpu_torch.train.session import init_session
        session = init_session(context, checkpoint)

        def runner():
            try:
                import inspect
                out = fn(config)
                if isinstance(out, dict):
                    session.queue.put(("report", out, None))
            except BaseException as e:  # noqa: BLE001
                session.error = e
            finally:
                session.finished.set()
                session.queue.put(("done", None, None))

        threading.Thread(target=runner, daemon=True,
                         name=f"trial-{self.trial_id}").start()
        return True

    def next_report(self, timeout: float = 1.0):
        import queue as _q

        from ray_tpu_torch.train.session import get_session
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


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: str = "PENDING"
    actor: Any = None
    last_result: Dict[str, Any] = field(default_factory=dict)
    history: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    iterations: int = 0


class ResultGrid:
    def __init__(self, results: List[Result], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self):
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        valid = [r for r in self._results
                 if r.error is None and metric in r.metrics]
        if not valid:
            raise ValueError(f"no completed trial reported {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(valid, key=key) if mode == "max" else min(valid,
                                                             key=key)

    def get_dataframe(self):
        import pandas as pd
        rows = []
        for r in self._results:
            row = dict(r.metrics)
            row["error"] = str(r.error) if r.error else None
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 _restored_trials: Optional[List[Trial]] = None):
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        from ray_tpu_torch.tune.trainable import is_trainable_class, \
            wrap_trainable
        if is_trainable_class(trainable):
            trainable = wrap_trainable(trainable)
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        if self.run_config.name is None:
            self.run_config.name = f"tune_{uuid.uuid4().hex[:8]}"
        self._resources = getattr(trainable, "_tune_resources",
                                  {"CPU": 1.0})
        self._restored_trials = _restored_trials

    # ------------------------------------------------ experiment state ----
    def _save_experiment_state(self, storage: str,
                               trials: List[Trial]) -> None:
        """Journal the experiment for ``Tuner.restore`` (parity:
        ``tune/execution/experiment_state.py``)."""
        import json
        state = {"trials": [{
            "trial_id": t.trial_id, "config_idx": i,
            "status": t.status, "iterations": t.iterations,
            "last_result": _json_safe(t.last_result),
            "history": [_json_safe(h) for h in t.history],
            "checkpoint_path": t.checkpoint.path if t.checkpoint else None,
            "error": t.error, "config": _json_safe(t.config),
        } for i, t in enumerate(trials)]}
        tmp = os.path.join(storage, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, os.path.join(storage, "experiment_state.json"))

    def _save_tuner_blob(self, storage: str) -> None:
        import cloudpickle
        with open(os.path.join(storage, "tuner.pkl"), "wb") as f:
            cloudpickle.dump({
                "trainable": self.trainable,
                "param_space": self.param_space,
                "tune_config": self.tune_config,
                "run_config": self.run_config,
            }, f)

    @classmethod
    def restore(cls, path: str, trainable: Optional[Callable] = None,
                resume_errored: bool = False,
                restart_errored: bool = False) -> "Tuner":
        """Resume an interrupted experiment from its storage directory.

        Finished trials keep their results; unfinished ones re-run from
        their latest checkpoint.  ``resume_errored`` re-runs failed
        trials from their checkpoints; ``restart_errored`` re-runs them
        from scratch (parity: ``tune/tuner.py`` restore, reference
        ``:346``).
        """
        import json

        import cloudpickle
        with open(os.path.join(path, "tuner.pkl"), "rb") as f:
            blob = cloudpickle.load(f)
        with open(os.path.join(path, "experiment_state.json")) as f:
            state = json.load(f)
        trials = []
        for rec in state["trials"]:
            trial = Trial(trial_id=rec["trial_id"], config=rec["config"])
            trial.iterations = rec["iterations"]
            trial.last_result = rec["last_result"]
            trial.history = rec["history"]
            trial.error = rec["error"]
            if rec["checkpoint_path"] and os.path.exists(
                    rec["checkpoint_path"]):
                trial.checkpoint = Checkpoint(rec["checkpoint_path"])
            # only completed trials keep their terminal status; the rest
            # (RUNNING/PENDING at interruption) re-run from checkpoint
            status = rec["status"]
            if status == "ERROR" and (resume_errored or restart_errored):
                status = "PENDING"
                trial.error = None
                if restart_errored:
                    trial.checkpoint = None
                    trial.iterations = 0
            elif status not in ("TERMINATED", "ERROR"):
                status = "PENDING"
            trial.status = status
            trials.append(trial)
        return cls(trainable or blob["trainable"],
                   param_space=blob["param_space"],
                   tune_config=blob["tune_config"],
                   run_config=blob["run_config"],
                   _restored_trials=trials)

    # ---------------------------------------------------------- control ----
    def fit(self) -> ResultGrid:
        from ray_tpu_torch.tune.schedulers import EXPLOIT
        scheduler = self.tune_config.scheduler or FIFOScheduler()
        if getattr(scheduler, "metric", None) is None and \
                hasattr(scheduler, "metric"):
            scheduler.metric = self.tune_config.metric
        storage = self.run_config.resolved_storage_path()
        os.makedirs(storage, exist_ok=True)
        self._save_tuner_blob(storage)
        from ray_tpu_torch.tune import callbacks as cb_mod
        callbacks = list(self.run_config.callbacks or [])
        cb_mod.invoke(callbacks, "setup", storage)

        searcher = self.tune_config.search_alg
        total_trials = None
        if self._restored_trials is not None:
            trials = self._restored_trials
            searcher = None   # restored experiments replay fixed configs
        elif searcher is not None:
            # model-based search: trials are created on demand from
            # searcher.suggest as capacity frees up
            searcher.set_search_properties(self.tune_config.metric,
                                           self.tune_config.mode,
                                           self.param_space,
                                           self.tune_config.num_samples)
            trials = []
            total_trials = (searcher.total_suggestions()
                            if hasattr(searcher, "total_suggestions")
                            else None) or self.tune_config.num_samples
        else:
            configs = resolve(self.param_space,
                              self.tune_config.num_samples,
                              self.tune_config.seed)
            trials = [Trial(trial_id=f"trial_{i:05d}", config=cfg)
                      for i, cfg in enumerate(configs)]
        max_concurrent = (self.tune_config.max_concurrent_trials
                          or (4 if searcher is not None
                              else len(trials)))

        pending = [t for t in trials if t.status == "PENDING"]
        running: List[Trial] = []
        by_id = {t.trial_id: t for t in trials}
        reports: Dict[str, Any] = {}  # trial_id -> in-flight report ref
        last_save = [0.0]

        def save_state(throttled: bool = False):
            if throttled and time.monotonic() - last_save[0] < 1.0:
                return
            last_save[0] = time.monotonic()
            self._save_experiment_state(storage, trials)

        def launch(trial: Trial):
            opts = {"num_cpus": self._resources.get("CPU", 1.0)}
            if self._resources.get("GPU"):
                # a trial with a card cold-spawns its worker onto it;
                # with no card the creation is infeasible and the trial
                # errors (it never falls back to the CPU)
                opts["num_gpus"] = self._resources["GPU"]
            trial.actor = _TrialActor.options(**opts).remote(
                trial.trial_id)
            ctx = TrainContext(experiment_name=self.run_config.name,
                               trial_name=trial.trial_id,
                               trial_id=trial.trial_id)
            # fire-and-forget: the call is buffered client-side until the
            # trial actor is scheduled (it may queue behind resources)
            trial.actor.run.remote(self.trainable, trial.config, ctx,
                                   trial.checkpoint)
            trial.status = "RUNNING"
            running.append(trial)
            if hasattr(scheduler, "on_trial_add"):
                scheduler.on_trial_add(trial.trial_id, trial.config)
            cb_mod.invoke(callbacks, "on_trial_start", trial)

        def retire(trial: Trial, status: str):
            trial.status = status
            running.remove(trial)
            if status == "ERROR":
                cb_mod.invoke(callbacks, "on_trial_error", trial,
                              RuntimeError(trial.error or "trial failed"))
            else:
                cb_mod.invoke(callbacks, "on_trial_complete", trial)
            scheduler.on_trial_complete(trial.trial_id)
            if searcher is not None:
                searcher.on_trial_complete(trial.trial_id,
                                           trial.last_result or None,
                                           error=status == "ERROR")
            reports.pop(trial.trial_id, None)
            ray_tpu_torch.kill(trial.actor)
            save_state()

        def next_suggested() -> Optional[Trial]:
            if searcher is None or len(trials) >= total_trials:
                return None
            trial_id = f"trial_{len(trials):05d}"
            cfg = searcher.suggest(trial_id)
            if cfg is None:
                return None
            trial = Trial(trial_id=trial_id, config=cfg)
            trials.append(trial)
            by_id[trial_id] = trial
            return trial

        def actor_alive(trial: Trial) -> bool:
            # O(1) directory lookup: this runs per running trial per
            # poll round, so a full list_actors() scan would be
            # quadratic in cluster size (and truncates at 1000)
            from ray_tpu_torch._private.worker import global_worker
            info = global_worker().cp.get_actor_info(
                trial.actor._actor_id)
            return bool(info) and info.get("state") == "ALIVE"

        while (pending or running
               or (searcher is not None and len(trials) < total_trials)):
            while pending and len(running) < max_concurrent:
                launch(pending.pop(0))
            while (searcher is not None
                   and len(running) < max_concurrent):
                trial = next_suggested()
                if trial is None:
                    break
                launch(trial)
            if searcher is not None and not running and not pending:
                break   # searcher declined to suggest with nothing live
            # one outstanding report poll per running trial, drained in
            # one wait() instead of a serial get() per trial
            for trial in running:
                if trial.trial_id not in reports and actor_alive(trial):
                    reports[trial.trial_id] = \
                        trial.actor.next_report.remote(0.2)
            if not reports:
                time.sleep(0.05)
                continue
            ref_to_id = {ref.binary(): tid
                         for tid, ref in reports.items()}
            ready, _ = ray_tpu_torch.wait(list(reports.values()),
                                          num_returns=1, timeout=5)
            for ref in ready:
                tid = ref_to_id[ref.binary()]
                reports.pop(tid, None)
                trial = by_id[tid]
                if trial not in running:
                    continue
                try:
                    item = ray_tpu_torch.get(ref, timeout=5)
                except Exception:  # noqa: BLE001 — actor died mid-poll
                    trial.error = "trial actor died"
                    retire(trial, "ERROR")
                    continue
                if item is None:
                    continue
                kind = item[0]
                if kind == "error":
                    trial.error = item[1]["traceback"]
                    retire(trial, "ERROR")
                elif kind == "done":
                    retire(trial, "TERMINATED")
                else:
                    metrics, checkpoint = item[1], item[2]
                    trial.iterations += 1
                    metrics.setdefault("training_iteration",
                                       trial.iterations)
                    metrics["trial_id"] = trial.trial_id
                    metrics["config"] = trial.config
                    trial.last_result = metrics
                    trial.history.append(metrics)
                    cb_mod.invoke(callbacks, "on_trial_result", trial,
                                  metrics)
                    if searcher is not None:
                        searcher.on_trial_result(trial.trial_id, metrics)
                    if checkpoint is not None:
                        trial.checkpoint = checkpoint.persist(
                            os.path.join(storage, trial.trial_id))
                        if getattr(checkpoint, "_ephemeral_source",
                                   False):
                            # class-Trainable wrapper tempdir: persisted
                            # copy is durable, drop the per-step source
                            shutil.rmtree(checkpoint.path,
                                          ignore_errors=True)
                        cb_mod.invoke(callbacks, "on_checkpoint", trial,
                                      trial.checkpoint.path)
                        save_state(throttled=True)
                    decision = scheduler.on_result(trial.trial_id,
                                                   metrics)
                    if decision == STOP:
                        retire(trial, "TERMINATED")
                    elif isinstance(decision, tuple) \
                            and decision[0] == EXPLOIT:
                        _, src_id, new_config = decision
                        src = by_id.get(src_id)
                        # exploit: clone the donor's checkpoint, explore
                        # with the mutated config, relaunch in place
                        ray_tpu_torch.kill(trial.actor)
                        reports.pop(trial.trial_id, None)
                        running.remove(trial)
                        trial.config = new_config
                        if src is not None and src.checkpoint is not None:
                            trial.checkpoint = src.checkpoint
                        launch(trial)
                        save_state()

        self._save_experiment_state(storage, trials)
        results = []
        for trial in trials:
            err = None
            if trial.error:
                err = RuntimeError(
                    f"trial {trial.trial_id} failed:\n{trial.error}")
            results.append(Result(
                metrics=trial.last_result,
                checkpoint=trial.checkpoint,
                path=os.path.join(storage, trial.trial_id),
                error=err,
                metrics_history=trial.history))
        grid = ResultGrid(results, self.tune_config.metric,
                          self.tune_config.mode)
        cb_mod.invoke(callbacks, "on_experiment_end", grid)
        return grid


def _json_safe(obj):
    """Best-effort JSON projection of metrics/config dicts."""
    import json
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {k: _json_safe(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_json_safe(v) for v in obj]
        return repr(obj)
