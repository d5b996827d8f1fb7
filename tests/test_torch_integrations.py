"""Port counterparts of the tune-callback, tqdm_ray, dashboard-SPA and
wandb/mlflow cases of ``tests/test_integrations.py``: the same test
bodies run against ``ray_tpu_torch`` (the reference fakes wandb and
mlflow, which the images do not carry); plus the TensorBoard logger,
which imports ``torch.utils.tensorboard`` lazily, as the reference does.
The reference file's Data-connector cases are
``tests/test_torch_data.py``'s.

The reference file's docstring: Callbacks, logger integrations, extra
Data connectors, tqdm_ray, dashboard SPA.
"""

import json
import os

import pytest


@pytest.fixture
def ray_start_2_cpus():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_tune_callbacks_and_loggers(ray_start_2_cpus, tmp_path):
    ray = ray_start_2_cpus
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.tune.callbacks import (Callback, CSVLoggerCallback,
                                        JsonLoggerCallback)

    events = []

    class Probe(Callback):
        def setup(self, storage_path):
            events.append(("setup", storage_path))

        def on_trial_start(self, trial):
            events.append(("start", trial.trial_id))

        def on_trial_result(self, trial, result):
            events.append(("result", trial.trial_id,
                           result["score"]))

        def on_trial_complete(self, trial):
            events.append(("complete", trial.trial_id))

        def on_experiment_end(self, results):
            events.append(("end", len(results)))

    def trainable(config):
        for i in range(3):
            tune.report({"score": config["x"] * (i + 1)})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        run_config=RunConfig(name="cb", storage_path=str(tmp_path),
                             callbacks=[Probe(), JsonLoggerCallback(),
                                        CSVLoggerCallback()]))
    grid = tuner.fit()
    assert len(grid) == 2 and not grid.errors
    kinds = [e[0] for e in events]
    assert kinds.count("start") == 2 and kinds.count("complete") == 2
    assert ("end", 2) in events
    assert kinds.count("result") == 6
    # logger outputs on disk
    trial_dirs = [d for d in os.listdir(tmp_path / "cb")
                  if d.startswith("trial_")]
    assert len(trial_dirs) == 2
    for d in trial_dirs:
        lines = (tmp_path / "cb" / d / "result.json").read_text()
        assert len(lines.strip().splitlines()) == 3
        csv_text = (tmp_path / "cb" / d / "progress.csv").read_text()
        assert "score" in csv_text.splitlines()[0]


def test_tqdm_ray_publishes(ray_start_2_cpus):
    ray = ray_start_2_cpus
    from ray_tpu_torch._private.worker import global_worker

    @ray.remote
    def work():
        from ray_tpu_torch.experimental import tqdm_ray
        for _ in tqdm_ray.tqdm(range(100), desc="crunch",
                               flush_interval_s=0.0):
            pass
        return True

    assert ray.get(work.remote(), timeout=60)
    seq, msgs = global_worker().cp.poll("__tqdm__", 0, 2.0)
    assert msgs, "no progress messages published"
    assert any(m["desc"] == "crunch" and m.get("done") for m in msgs)
    assert any(m["n"] == 100 for m in msgs)


def test_dashboard_serves_spa(ray_start_2_cpus):
    import urllib.request

    from ray_tpu_torch.dashboard.app import Dashboard
    dash = Dashboard(port=0)
    # pick an ephemeral port: Dashboard binds the given port; use a
    # random high port to avoid collisions in CI
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dash.port = port
    dash.start()
    html = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/", timeout=10).read().decode()
    assert "ray_tpu_torch" in html and "renderNav" in html  # SPA, not fallback
    nodes = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/api/nodes", timeout=10).read())
    assert nodes and nodes[0]["state"] == "ALIVE"
    assert "load" in nodes[0]


def test_wandb_mlflow_full_lifecycle(ray_start_2_cpus, tmp_path,
                                     monkeypatch):
    """Run-lifecycle adapters: config capture, step metrics, checkpoint
    artifact upload, summary + exit status — driven against faked
    wandb/mlflow clients (the real ones are not in the TPU image)."""
    import sys
    import types

    events = []

    class _FakeRun:
        def __init__(self):
            self.summary = {}

        def log(self, metrics, step=None):
            events.append(("wandb.log", dict(metrics), step))

        def log_artifact(self, art):
            events.append(("wandb.artifact", art.name, art.dirs))

        def finish(self, exit_code=0):
            events.append(("wandb.finish", exit_code))

    class _FakeArtifact:
        def __init__(self, name, type):
            self.name, self.dirs = name, []

        def add_dir(self, d):
            self.dirs.append(d)

    fake_wandb = types.SimpleNamespace(
        init=lambda **kw: events.append(
            ("wandb.init", kw.get("name"), kw.get("config"),
             kw.get("tags"))) or _FakeRun(),
        Artifact=_FakeArtifact,
        login=lambda key=None: None)
    monkeypatch.setitem(sys.modules, "wandb", fake_wandb)

    class _FakeMlflowClient:
        def __init__(self, tracking_uri=None):
            pass

        def get_experiment_by_name(self, name):
            return None

        def create_experiment(self, name):
            return "exp1"

        def create_run(self, experiment_id, tags=None):
            events.append(("mlflow.start", experiment_id,
                           (tags or {}).get("mlflow.runName")))
            return types.SimpleNamespace(
                info=types.SimpleNamespace(run_id="rid1"))

        def log_param(self, rid, k, v):
            events.append(("mlflow.param", k, v))

        def log_metric(self, rid, k, v, timestamp=None, step=None):
            events.append(("mlflow.metric", rid, k, v, step))

        def log_artifacts(self, rid, d, artifact_path=None):
            events.append(("mlflow.artifacts", rid, artifact_path))

        def set_terminated(self, rid, status):
            events.append(("mlflow.end", rid, status))

    fake_mlflow = types.SimpleNamespace(
        tracking=types.SimpleNamespace(MlflowClient=_FakeMlflowClient))
    monkeypatch.setitem(sys.modules, "mlflow", fake_mlflow)

    from ray_tpu_torch import tune
    from ray_tpu_torch.air.integrations.mlflow import MLflowLoggerCallback
    from ray_tpu_torch.air.integrations.wandb import WandbLoggerCallback
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.train.checkpoint import Checkpoint

    def trainable(config):
        import json
        import os
        import tempfile
        for i in range(2):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "w.json"), "w") as f:
                json.dump({"step": i}, f)
            tune.report({"score": config["x"] * (i + 1)},
                        checkpoint=Checkpoint.from_directory(d))

    tuner = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([3])},
        run_config=RunConfig(
            name="intg", storage_path=str(tmp_path),
            callbacks=[WandbLoggerCallback(
                           project="p", tags=["user-tag"],
                           upload_checkpoints=True),
                       MLflowLoggerCallback(
                           experiment_name="exp",
                           save_artifact=True)]))
    grid = tuner.fit()
    assert not grid.errors
    # artifact uploads run off-thread; give them a beat
    import time as _t
    deadline = _t.time() + 10
    while _t.time() < deadline:
        kinds = [e[0] for e in events]
        if kinds.count("wandb.artifact") >= 2 \
                and kinds.count("mlflow.artifacts") >= 2:
            break
        _t.sleep(0.1)
    kinds = [e[0] for e in events]
    assert "wandb.init" in kinds and "wandb.finish" in kinds
    init_ev = next(e for e in events if e[0] == "wandb.init")
    assert init_ev[2] == {"x": 3}          # full config captured
    # user tags merged with the generated trial tag, not clobbered
    assert "user-tag" in init_ev[3] and any(
        t.startswith("trial:") for t in init_ev[3])
    assert kinds.count("wandb.artifact") == 2   # one per checkpoint
    assert kinds.count("mlflow.artifacts") == 2
    assert ("mlflow.param", "x", 3) in events
    assert ("mlflow.end", "rid1", "FINISHED") in events
    fin = next(e for e in events if e[0] == "wandb.finish")
    assert fin[1] == 0


def test_tensorboard_logger_writes_scalars(ray_start_2_cpus, tmp_path,
                                           monkeypatch):
    """``TBXLoggerCallback`` writes each trial's numeric results as
    scalars at their ``training_iteration`` into the trial's directory.
    tensorboard runs on its own TensorFlow stub here: importing the real
    TensorFlow would take most of the test's time."""
    import sys
    pytest.importorskip("tensorboard")
    if "tensorflow" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_file_loader import \
        EventFileLoader

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.tune.callbacks import TBXLoggerCallback

    def trainable(config):
        for i in range(3):
            tune.report({"score": config["x"] * (i + 1)})

    grid = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([2])},
        run_config=RunConfig(name="tb", storage_path=str(tmp_path),
                             callbacks=[TBXLoggerCallback()])).fit()
    assert not grid.errors
    trial_dir = tmp_path / "tb" / "trial_00000"
    files = [f for f in os.listdir(trial_dir) if "tfevents" in f]
    assert len(files) == 1, os.listdir(trial_dir)
    scalars = {}
    for event in EventFileLoader(str(trial_dir / files[0])).Load():
        for v in event.summary.value:
            if v.tag == "score":
                scalars[event.step] = float(
                    v.tensor.float_val[0] if v.HasField("tensor")
                    else v.simple_value)
    assert scalars == {1: 2.0, 2: 4.0, 3: 6.0}
