"""Port counterparts of ``tests/test_observability.py``: the same test
bodies run against ``ray_tpu_torch``, the PyTorch port's runtime.

Every test of the reference file has its counterpart here
(``test_dashboard_api`` since ``dashboard/`` was ported, on a free port
rather than the reference's fixed one).
``test_device_profiling_helpers`` keeps the reference's
``slow`` mark; ``test_profile_device_trace_and_annotation`` holds the same
helpers without a session, in tier 1.

The reference file's docstring: State API, metrics, timeline, dashboard,
CLI, microbench.
"""

import json
import subprocess
import sys
import os
import time

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_state_api(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    def f():
        return 1

    @ray.remote
    class A:
        def g(self):
            return 2

    a = A.remote()
    ray.get([f.remote(), a.g.remote()])
    from ray_tpu_torch.util import state
    assert len(state.list_nodes()) == 1
    actors = state.list_actors()
    assert len(actors) == 1 and actors[0]["state"] == "ALIVE"
    # the FINISHED event is recorded when the node manager processes the
    # worker's done message, slightly after the result object commits
    deadline = time.time() + 5
    while time.time() < deadline:
        if any(t.get("state") == "FINISHED" for t in state.list_tasks()):
            break
        time.sleep(0.05)
    assert any(t.get("state") == "FINISHED" for t in state.list_tasks())
    assert state.summarize_actors().get("ALIVE") == 1


def test_timeline_chrome_trace(ray_start_regular, tmp_path):
    ray = ray_start_regular

    @ray.remote
    def slow():
        time.sleep(0.05)

    ray.get([slow.remote() for _ in range(3)])
    from ray_tpu_torch._private.profiling import timeline
    out = tmp_path / "trace.json"
    # the FINISHED task-event trails the result commit slightly
    for _ in range(50):
        timeline(str(out))
        trace = json.loads(out.read_text())
        if len(trace) >= 3:
            break
        time.sleep(0.1)
    assert len(trace) >= 3
    assert all(ev["ph"] == "X" and ev["dur"] > 0 for ev in trace)


def test_metrics_prometheus(ray_start_regular):
    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram, \
        prometheus_text
    Counter("reqs", tag_keys=("route",)).inc(
        3, tags={"route": "/api"})
    Gauge("temp").set(42.5)
    Histogram("lat", boundaries=[0.1, 1.0]).observe(0.5)
    text = prometheus_text()
    assert "temp 42.5" in text
    assert "user_counter_reqs" in text
    assert "user_histogram_lat" in text


def test_counter_accumulates_float_increments(ray_start_regular):
    """Non-integer increments accumulate exactly (the old path
    collapsed any fractional inc to +1)."""
    from ray_tpu_torch.util.metrics import Counter, prometheus_text
    c = Counter("float_ctr")
    c.inc(0.25)
    c.inc(0.5)
    c.inc(2)
    text = prometheus_text()
    (line,) = [ln for ln in text.splitlines()
               if ln.startswith("user_counter_float_ctr")
               and not ln.startswith("#")]
    assert float(line.split()[-1]) == 2.75, line


def test_histogram_prometheus_exposition(ray_start_regular):
    """Histograms render proper cumulative ``_bucket{le=...}`` /
    ``_sum`` / ``_count`` lines (they used to be recorded but never
    rendered)."""
    from ray_tpu_torch.util.metrics import Histogram, prometheus_text
    h = Histogram("svc_lat", boundaries=[0.1, 1.0, 5.0])
    for v in (0.05, 0.5, 0.5, 2.0, 99.0):
        h.observe(v)
    text = prometheus_text()
    assert "# TYPE user_histogram_svc_lat histogram" in text

    def val(sub):
        (line,) = [ln for ln in text.splitlines() if sub in ln]
        return float(line.split()[-1])

    # cumulative buckets: le=0.1 -> 1, le=1.0 -> 3, le=5.0 -> 4, +Inf=5
    assert val('svc_lat_bucket{le="0.1"}') == 1
    assert val('svc_lat_bucket{le="1.0"}') == 3
    assert val('svc_lat_bucket{le="5.0"}') == 4
    assert val('svc_lat_bucket{le="+Inf"}') == 5
    assert val("svc_lat_count") == 5
    assert val("svc_lat_sum") == pytest.approx(102.05)
    # tagged series keep their labels alongside le
    h.observe(0.5, tags={"route": "/x"})
    text = prometheus_text()
    assert 'route="/x"' in text


def test_dashboard_api(ray_start_regular):
    import requests

    from ray_tpu_torch.dashboard.app import Dashboard
    # a free port (the reference's fixed 18299 may be held by its own
    # test running beside this one)
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    free = s.getsockname()[1]
    s.close()
    port = Dashboard(free).start()
    cluster = requests.get(
        f"http://127.0.0.1:{port}/api/cluster", timeout=10).json()
    assert cluster["resources_total"]["CPU"] == 4.0
    nodes = requests.get(
        f"http://127.0.0.1:{port}/api/nodes", timeout=10).json()
    assert len(nodes) == 1
    metrics = requests.get(
        f"http://127.0.0.1:{port}/metrics", timeout=10)
    assert metrics.status_code == 200
    # per-entity drill-down + log panes (dashboard/modules parity)
    node_id = nodes[0]["node_id"]
    detail = requests.get(
        f"http://127.0.0.1:{port}/api/nodes/{node_id}",
        timeout=10).json()
    assert detail["node_id"] == node_id
    assert "debug_state" in detail
    logs = requests.get(
        f"http://127.0.0.1:{port}/api/logs?node_id={node_id}",
        timeout=10).json()
    assert isinstance(logs, list)
    if logs:
        tail = requests.get(
            f"http://127.0.0.1:{port}/api/logs/tail?"
            f"node_id={node_id}&name={logs[0]['name']}", timeout=10)
        assert tail.status_code == 200

    @ray_start_regular.remote
    class Probe:
        def ping(self):
            return 1

    a = Probe.remote()
    ray_start_regular.get(a.ping.remote())
    actors = requests.get(
        f"http://127.0.0.1:{port}/api/actors", timeout=10).json()
    aid = actors[0]["actor_id"]
    adetail = requests.get(
        f"http://127.0.0.1:{port}/api/actors/{aid}", timeout=10).json()
    assert adetail["actor_id"] == aid
    assert adetail.get("state") == "ALIVE"


def test_cli_status_and_list(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Named:
        def hi(self):
            return 1

    a = Named.options(name="cli_actor").remote()
    ray.get(a.hi.remote())
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "status"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    assert "ALIVE" in out.stdout
    out2 = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "list", "actors"],
        capture_output=True, text=True, timeout=60)
    assert "cli_actor" in out2.stdout
    # predicate filters narrow server-side rows (ray list parity)
    out3 = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "list", "actors",
         "--filter", "state=DEAD"],
        capture_output=True, text=True, timeout=60)
    assert out3.returncode == 0 and "cli_actor" not in out3.stdout
    out4 = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "list", "actors",
         "--filter", "state=ALIVE", "--limit", "1"],
        capture_output=True, text=True, timeout=60)
    assert out4.returncode == 0 and len(
        out4.stdout.strip().splitlines()) == 1


def test_cli_logs_list_and_tail(ray_start_regular):
    """``ray-tpu logs`` lists per-node worker logs and tails one
    (parity: ``ray logs``)."""
    ray = ray_start_regular

    @ray.remote
    def noisy():
        print("marker-from-worker-log")
        return 1

    ray.get(noisy.remote())
    listing = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "logs"],
        capture_output=True, text=True, timeout=60)
    assert listing.returncode == 0
    names = [line.split()[-1]
             for line in listing.stdout.strip().splitlines() if line]
    worker_logs = [n for n in names if n.startswith("worker-")]
    assert worker_logs, listing.stdout
    tail = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "logs",
         worker_logs[0]],
        capture_output=True, text=True, timeout=60)
    assert tail.returncode == 0


def test_native_store_stats_exposed(ray_start_regular):
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_node
    ref = ray_tpu_torch.put(np.zeros(200_000))  # ~1.6MB -> arena
    ray_tpu_torch.get(ref)
    stats = global_node().store.stats()
    if "arena" in stats:  # native lib built
        assert stats["arena"]["num_puts"] >= 1


def _profile_matmul(logdir):
    import torch

    from ray_tpu_torch.util.profiling import annotate, profile_device
    with profile_device(logdir) as out:
        with annotate("test-matmul"):
            x = torch.ones((128, 128))
            (x @ x).sum().item()
    return out


@pytest.mark.slow
def test_device_profiling_helpers(ray_start_regular, tmp_path):
    """profile_device captures a torch.profiler trace; annotate + memory
    stats work on the active backend."""
    import glob

    from ray_tpu_torch.util.profiling import device_memory_stats

    logdir = _profile_matmul(str(tmp_path / "prof"))
    traces = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                       recursive=True)
    assert traces, f"no trace under {logdir}"
    stats = device_memory_stats()
    assert len(stats) >= 1


def test_profile_device_trace_and_annotation(tmp_path):
    """On the CPU: the trace file is a Chrome trace whose events name the
    annotation and the matmul under it; ``device_memory_stats`` has one
    entry per device with the reference's three keys; a default log
    directory lies under the process's temporary directory."""
    import glob
    import tempfile

    from ray_tpu_torch.util.profiling import device_memory_stats

    logdir = _profile_matmul(str(tmp_path / "prof"))
    traces = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "test-matmul" in names
    assert any(n and "mm" in n for n in names), sorted(n for n in names
                                                        if n)[:20]
    stats = device_memory_stats()
    assert len(stats) >= 1
    for entry in stats.values():
        assert set(entry) == {"bytes_in_use", "peak_bytes_in_use",
                              "bytes_limit"}
    import ray_tpu_torch.util.profiling as prof
    with prof.profile_device() as default_dir:
        pass
    assert default_dir.startswith(tempfile.gettempdir())
    assert glob.glob(os.path.join(default_dir, "*.pt.trace.json"))
    import shutil
    shutil.rmtree(default_dir)


def test_stack_dump_signal(ray_start_regular):
    """``ray-tpu stack`` plumbing: the NM SIGUSR1s live workers, whose
    faulthandler writes all-thread tracebacks to their log files
    (reference: ``ray stack``)."""
    import glob
    import os
    import time

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_node

    @ray_tpu_torch.remote
    class Sleeper:
        def ready(self):
            return True

        def nap(self, t):
            time.sleep(t)
            return t

    s = Sleeper.remote()
    assert ray_tpu_torch.get(s.ready.remote(), timeout=60)
    ref = s.nap.remote(3.0)       # worker mid-call when signalled
    node = global_node()
    pids = node.node_manager.signal_stack_dump()
    assert pids, "no workers signalled"
    time.sleep(0.8)
    logs = glob.glob(os.path.join(node.session_dir, "logs",
                                  "worker-*.log"))
    dumped = any("Thread 0x" in open(p).read() or
                 "Current thread" in open(p).read() for p in logs)
    assert dumped, f"no faulthandler output in {logs}"
    assert ray_tpu_torch.get(ref, timeout=30) == 3.0   # worker survived USR1


@pytest.mark.slow
def test_async_actor_event_loop_lag_metric(ray_start_regular):
    """A blocking handler inside an async actor surfaces as the
    event-loop lag gauge (SURVEY 5.2 responsiveness sanitizer)."""
    import time

    import ray_tpu_torch

    @ray_tpu_torch.remote
    class Async:
        async def block(self, t):
            time.sleep(t)         # deliberately BLOCKS the loop
            return t

        async def ping(self):
            return "pong"

    a = Async.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    ray_tpu_torch.get(a.block.remote(1.5), timeout=60)
    time.sleep(1.2)               # monitor tick publishes the gauge
    from ray_tpu_torch.util.metrics import prometheus_text
    text = prometheus_text()
    assert "async_actor_event_loop_lag_ms" in text, text[:2000]


def test_tracing_spans_record_submit_and_execute(ray_start_regular):
    """util.tracing records submit- and task-spans once enabled
    (parity: ray.util.tracing OpenTelemetry patch points)."""
    from ray_tpu_torch.util import tracing

    tracing.clear_recorded()
    tracing.enable_tracing()
    try:
        @ray_start_regular.remote
        def traced(x):
            return x + 1

        assert ray_start_regular.get(traced.remote(1), timeout=60) == 2
        spans = tracing.recorded_spans()
        names = [s["name"] for s in spans]
        assert any(n.startswith("submit::") for n in names), names

        # execute-side spans live in the worker process: the cluster
        # flag reaches running workers within the refresh TTL, after
        # which tasks run traced there
        @ray_start_regular.remote
        def worker_traced():
            from ray_tpu_torch.util import tracing as wt
            wt._refresh(force=True)
            return wt.is_enabled()

        deadline = time.time() + 15
        while time.time() < deadline:
            if ray_start_regular.get(worker_traced.remote(), timeout=60):
                break
            time.sleep(0.5)
        assert ray_start_regular.get(worker_traced.remote(), timeout=60)
    finally:
        tracing.disable_tracing()


def test_state_api_filters_and_pagination(ray_start_regular):
    """Predicate filters (=, !=, >, contains, in) and offset windows
    (parity: ray.util.state filter/pagination semantics)."""
    from ray_tpu_torch.util import state

    @ray_start_regular.remote
    class A:
        def ping(self):
            return 1

    actors = [A.remote() for _ in range(4)]
    ray_start_regular.get([a.ping.remote() for a in actors], timeout=60)

    flt = [("class_name", "contains", "A"), ("state", "=", "ALIVE")]
    alive = state.list_actors(filters=flt)
    assert len(alive) == 4
    assert all(r["state"] != "ALIVE" for r in
               state.list_actors(filters=[("state", "!=", "ALIVE")]))
    assert state.list_actors(
        filters=[("num_restarts", ">", 0)]) == []
    import pytest as _pytest
    with _pytest.raises(TypeError):
        state.list_actors(filters=[("state", "in", "ALIVE")])
    assert len(state.list_actors(
        filters=[("state", "in", ["ALIVE", "DEAD"])])) >= 4
    # offset windows over the same filtered, stably-sorted rows must
    # stitch with no overlap and no gap
    first2 = state.list_actors(filters=flt, limit=2, offset=0)
    next2 = state.list_actors(filters=flt, limit=2, offset=2)
    ids = [r["actor_id"] for r in first2 + next2]
    assert len(ids) == 4 and len(set(ids)) == 4
    assert sorted(ids) == sorted(r["actor_id"] for r in alive)
    for a in actors:
        ray_start_regular.kill(a)
