"""Port counterparts of ``tests/test_ops_components.py``: the same test
bodies run against ``ray_tpu_torch``, the PyTorch port's runtime.

Every test of the reference file has its counterpart here (the job and
autoscaler tests since ``job/`` and ``autoscaler/`` were ported);
``test_autoscaler_up_and_down``, ``test_autoscaler_v2_engine_up_and_down``
and ``test_cli_start_stop_standalone_cluster`` keep the reference's
``slow`` mark.

The reference file's docstring: Ops components: runtime_env, log
streaming, job submission, autoscaler.

Parity models: runtime_env_agent.py, log_monitor.py,
dashboard/modules/job/job_manager.py, autoscaler/_private/autoscaler.py.
"""

import os
import time

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_cluster():
    """Head + helper to add simulated nodes (extra node-manager
    processes)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_node
    ray_tpu_torch.init(num_cpus=2)
    yield global_node()
    ray_tpu_torch.shutdown()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_runtime_env_env_vars_and_working_dir(ray_start_regular, tmp_path):
    ray = ray_start_regular

    @ray.remote(runtime_env={"env_vars": {"RENV_X": "7"}})
    def read():
        import os
        return os.environ.get("RENV_X")

    @ray.remote
    def read_plain():
        import os
        return os.environ.get("RENV_X")

    assert ray.get(read.remote(), timeout=60) == "7"
    # pooled workers must not leak the env var into later tasks
    assert ray.get(read_plain.remote(), timeout=60) is None

    wd = str(tmp_path)

    @ray.remote(runtime_env={"working_dir": wd})
    def cwd():
        import os
        return os.getcwd()

    assert ray.get(cwd.remote(), timeout=60) == wd


def test_runtime_env_rejects_pip(ray_start_regular):
    ray = ray_start_regular

    @ray.remote(runtime_env={"pip": ["requests"]})
    def f():
        return 1

    with pytest.raises(ValueError):
        ray.get(f.remote(), timeout=60)


def test_runtime_env_actor_for_life(ray_start_regular):
    ray = ray_start_regular

    @ray.remote(runtime_env={"env_vars": {"ACTOR_RENV": "yes"}})
    class A:
        def read(self):
            import os
            return os.environ.get("ACTOR_RENV")

    a = A.remote()
    assert ray.get(a.read.remote(), timeout=60) == "yes"
    assert ray.get(a.read.remote(), timeout=60) == "yes"


def test_log_streaming_reaches_driver(ray_start_regular):
    """Worker prints surface on the CP pubsub channel the driver
    monitor drains (log_monitor.py parity)."""
    ray = ray_start_regular
    from ray_tpu_torch._private.log_streaming import CHANNEL
    from ray_tpu_torch._private.worker import global_worker

    @ray.remote
    def chatty():
        print("log-streaming-probe-line")
        return 1

    cursor = 0
    ray.get(chatty.remote(), timeout=60)
    deadline = time.time() + 10
    seen = []
    while time.time() < deadline:
        cursor, msgs = global_worker().cp.poll(CHANNEL, cursor, 1.0)
        seen.extend(m["line"] for m in msgs)
        if any("log-streaming-probe-line" in ln for ln in seen):
            break
    assert any("log-streaming-probe-line" in ln for ln in seen), seen


def test_job_submission_lifecycle(ray_start_regular):
    from ray_tpu_torch.job import JobSubmissionClient
    c = JobSubmissionClient()
    jid = c.submit_job(
        entrypoint="python -c 'import os; print(\"J=\" + "
                   "os.environ[\"JVAR\"])'",
        runtime_env={"env_vars": {"JVAR": "ok"}},
        metadata={"owner": "test"})
    assert c.wait_until_finished(jid, timeout=90) == "SUCCEEDED"
    assert "J=ok" in c.get_job_logs(jid)
    info = c.get_job_info(jid)
    assert info.exit_code == 0 and info.metadata == {"owner": "test"}

    bad = c.submit_job(entrypoint="exit 5")
    assert c.wait_until_finished(bad, timeout=90) == "FAILED"
    assert c.get_job_info(bad).exit_code == 5

    slow = c.submit_job(entrypoint="sleep 120")
    time.sleep(0.3)
    assert c.stop_job(slow)
    assert c.wait_until_finished(slow, timeout=30) == "STOPPED"
    ids = {j.submission_id for j in c.list_jobs()}
    assert {jid, bad, slow} <= ids
    assert c.delete_job(bad)
    assert bad not in {j.submission_id for j in c.list_jobs()}


@pytest.mark.slow
def test_autoscaler_up_and_down(ray_start_cluster):
    """Sustained queue depth launches provider nodes; idleness reaps
    them (autoscaler.py parity)."""
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import (AutoscalerConfig, LocalNodeProvider,
                                    StandardAutoscaler)

    sc = StandardAutoscaler(
        LocalNodeProvider({"CPU": 2.0}),
        AutoscalerConfig(max_workers=1, upscale_delay_s=0.3,
                         idle_timeout_s=2.0, tick_s=0.2))
    sc.start()
    try:
        @ray_tpu_torch.remote
        def work(i):
            time.sleep(1.0)
            return i

        out = ray_tpu_torch.get([work.remote(i) for i in range(6)],
                          timeout=120)
        assert sorted(out) == list(range(6))
        # node launch is slow on a loaded 1-core box: wait for the
        # scale-up decision + launch to land
        deadline = time.time() + 40
        while time.time() < deadline and not any(
                e.startswith("up: node") for e in sc.events):
            time.sleep(0.3)
        assert any(e.startswith("up:") for e in sc.events), sc.events

        deadline = time.time() + 20
        while time.time() < deadline and \
                sc.provider.non_terminated_nodes():
            time.sleep(0.3)
        assert not sc.provider.non_terminated_nodes(), sc.events
        assert any(e.startswith("down:") for e in sc.events)
    finally:
        sc.stop()


_ATTACH_SCRIPT = """
import ray_tpu_torch
ray_tpu_torch.init(address="auto")
@ray_tpu_torch.remote
def double(v):
    return v * 2
kv = ray_tpu_torch.get_actor("attachkv")
x = ray_tpu_torch.get(kv.get.remote("x"), timeout=60)
ray_tpu_torch.get(kv.put.remote("y", ray_tpu_torch.get(double.remote(x),
                                           timeout=60)), timeout=60)
ref = ray_tpu_torch.put(b"z" * 150000)          # shm from the attached driver
assert len(ray_tpu_torch.get(ref, timeout=30)) == 150000
print("ATTACH_OK")
ray_tpu_torch.shutdown()
"""


def test_attach_second_driver(ray_start_regular):
    """init(address='auto') joins the running cluster as another driver:
    shared named actors, tasks on cluster resources, shm objects
    (parity: ray.init(address=...) connect-to-existing)."""
    import subprocess
    import sys

    import ray_tpu_torch

    @ray_tpu_torch.remote
    class KV:
        def __init__(self):
            self.d = {}

        def put(self, k, v):
            self.d[k] = v
            return True

        def get(self, k):
            return self.d.get(k)

    kv = KV.options(name="attachkv").remote()
    ray_tpu_torch.get(kv.put.remote("x", 21), timeout=60)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", _ATTACH_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "ATTACH_OK" in p.stdout
    assert ray_tpu_torch.get(kv.get.remote("y"), timeout=60) == 42


def test_job_entrypoint_uses_cluster(ray_start_regular):
    """A submitted job's python entrypoint attaches to the submitting
    cluster via RAY_TPU_ADDRESS and runs tasks on it."""
    from ray_tpu_torch.job import JobSubmissionClient
    c = JobSubmissionClient()
    code = ("import ray_tpu_torch; ray_tpu_torch.init(); "
            "f = ray_tpu_torch.remote(lambda x: x + 1); "
            "print('cluster result:', ray_tpu_torch.get(f.remote(41)))")
    jid = c.submit_job(entrypoint=f"python -c \"{code}\"")
    assert c.wait_until_finished(jid, timeout=120) == "SUCCEEDED"
    assert "cluster result: 42" in c.get_job_logs(jid)


@pytest.mark.slow
def test_cli_start_stop_standalone_cluster(tmp_path):
    """ray-tpu start --head --tcp + start --address joins a worker over
    TCP; an external driver attaches and runs tasks; stop reaps all
    daemons (parity: ray start/stop)."""
    import glob
    import subprocess
    import sys
    import time as _t

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def cli(*argv, timeout=90):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", *argv], env=env,
            capture_output=True, text=True, timeout=timeout, cwd=REPO)

    try:
        out = cli("start", "--head", "--tcp", "--num-cpus", "2",
                  timeout=120)
        assert out.returncode == 0, out.stderr + out.stdout
        # the CLI liveness-probes and prints the address itself
        addr = next(tok for tok in out.stdout.split()
                    if tok.startswith("tcp://"))

        out = cli("start", "--address", addr, "--num-cpus", "2")
        assert out.returncode == 0, out.stderr

        driver = (
            "import ray_tpu_torch\n"
            "ray_tpu_torch.init(address='auto')\n"
            "f = ray_tpu_torch.remote(lambda x: x * 3)\n"
            "print('R:', sorted(ray_tpu_torch.get([f.remote(i) "
            "for i in range(6)], timeout=90)))\n"
            "print('CPUS:', ray_tpu_torch.cluster_resources().get('CPU'))\n"
            "ray_tpu_torch.shutdown()\n")
        deadline = _t.time() + 60
        ok = False
        while _t.time() < deadline and not ok:
            p = subprocess.run([sys.executable, "-c", driver], env=env,
                               capture_output=True, text=True,
                               timeout=120, cwd=REPO)
            ok = p.returncode == 0 and "CPUS: 4.0" in p.stdout
            if not ok:
                _t.sleep(1)
        assert ok, p.stdout + p.stderr
        assert "R: [0, 3, 6, 9, 12, 15]" in p.stdout
    finally:
        cli("stop")


def test_autoscaler_shape_matching(ray_start_cluster):
    """Demand is matched by resource SHAPE: a queue of accel-shaped
    tasks launches the accel node type, not the cpu type — and the
    task waits (not fails) because the shape is provisionable
    (resource_demand_scheduler.py parity)."""
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import (AutoscalerConfig, LocalNodeProvider,
                                    StandardAutoscaler)

    sc = StandardAutoscaler(
        LocalNodeProvider(node_types={
            "cpu": {"CPU": 2.0},
            "accel": {"CPU": 1.0, "accel": 4.0},
        }),
        AutoscalerConfig(max_workers=1, upscale_delay_s=0.3,
                         idle_timeout_s=60.0, tick_s=0.2))
    sc.start()
    try:
        # infeasible on the current cluster (no 'accel' resource
        # anywhere) but provisionable by the autoscaler
        @ray_tpu_torch.remote(resources={"accel": 2.0})
        def on_accel():
            return "ran"

        assert ray_tpu_torch.get(on_accel.remote(), timeout=120) == "ran"
        assert any(e.startswith("up: +accel") for e in sc.events), \
            sc.events
        assert not any(e.startswith("up: +cpu") for e in sc.events)
    finally:
        sc.stop()


def test_autoscaler_unprovisionable_shape_fails_fast(ray_start_cluster):
    """A shape that fits no launchable node type still fails fast with
    InfeasibleTaskError (the provisionable-shape relaxation only keeps
    tasks queued that a registered type could satisfy) and launches
    nothing."""
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import (AutoscalerConfig, LocalNodeProvider,
                                    StandardAutoscaler)
    from ray_tpu_torch.exceptions import InfeasibleTaskError

    sc = StandardAutoscaler(
        LocalNodeProvider(node_types={"cpu": {"CPU": 2.0}}),
        AutoscalerConfig(max_workers=1, upscale_delay_s=0.2,
                         idle_timeout_s=60.0, tick_s=0.2))
    sc.start()
    try:
        @ray_tpu_torch.remote(resources={"accel": 8.0})
        def impossible():
            return 1

        with pytest.raises(InfeasibleTaskError):
            ray_tpu_torch.get(impossible.remote(), timeout=60)
        assert not sc.provider.non_terminated_nodes()
    finally:
        sc.stop()


@pytest.mark.slow
def test_autoscaler_v2_engine_up_and_down(ray_start_cluster):
    """engine="v2": scale decisions flow through the instance
    reconciler — launch lands via QUEUED->...->RAY_RUNNING, idle
    scale-down releases the specific instance, and the table converges
    (reference: autoscaler/v2/instance_manager/reconciler.py)."""
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import (AutoscalerConfig, LocalNodeProvider,
                                    StandardAutoscaler)

    sc = StandardAutoscaler(
        LocalNodeProvider({"CPU": 2.0}),
        AutoscalerConfig(max_workers=1, upscale_delay_s=0.3,
                         idle_timeout_s=2.0, tick_s=0.2),
        engine="v2")
    sc.start()
    try:
        @ray_tpu_torch.remote
        def work(i):
            time.sleep(1.0)
            return i

        out = ray_tpu_torch.get([work.remote(i) for i in range(6)],
                          timeout=120)
        assert sorted(out) == list(range(6))
        deadline = time.time() + 40
        while time.time() < deadline and not any(
                "RAY_RUNNING" in e for e in sc.reconciler.events):
            time.sleep(0.3)
        assert any("RAY_RUNNING" in e for e in sc.reconciler.events), \
            sc.reconciler.events
        # idle reaping goes through release_node -> TERMINATED
        deadline = time.time() + 30
        while time.time() < deadline and \
                sc.provider.non_terminated_nodes():
            time.sleep(0.3)
        assert not sc.provider.non_terminated_nodes(), \
            sc.reconciler.events
        assert any("released" in e for e in sc.reconciler.events)
        summ = sc.reconciler.summary()
        assert summ["instances"].get("TERMINATED", 0) >= 1
    finally:
        sc.stop()
