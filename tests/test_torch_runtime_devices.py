"""The runtime's accelerator, held against the JAX package: ``"GPU"`` and
``CUDA_VISIBLE_DEVICES`` in ``ray_tpu_torch`` account for devices as
``"TPU"`` and ``TPU_VISIBLE_CHIPS`` do in ``ray_tpu`` (accounting-only
devices on a host without cards), GPU workers keep one card list for
life, CPU workers see no card, and the port's sessions are its own."""

import os
import time
import types

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import node as ref_node
from ray_tpu_torch._private import node as port_node
from ray_tpu_torch._private.worker_proc import WorkerProcess
from ray_tpu_torch.accelerators.gpu import detect_num_gpus

_PKGS = {
    "ref": (ray_tpu, "num_tpus", "TPU", "TPU_VISIBLE_CHIPS"),
    "port": (ray_tpu_torch, "num_gpus", "GPU", "CUDA_VISIBLE_DEVICES"),
}


def _wait_resources(pkg, want, timeout=30.0):
    """available_resources() as soon as it equals ``want`` (the control
    plane's view follows the node's heartbeat), or the last reading."""
    deadline = time.monotonic() + timeout
    while True:
        got = pkg.available_resources()
        if got == want or time.monotonic() > deadline:
            return got
        time.sleep(0.05)


def _quiet_reference_sweep(monkeypatch):
    """A dead head's extra-node shm root with all-decimal digits makes
    the reference's stale-session sweep fail every init on the host
    (ROADMAP Queue 3, reference side). These tests hold the port against
    the reference's session, so the reference's sweep is patched out for
    that session only; the port's own sweep runs as always."""
    monkeypatch.setattr(ref_node, "_gc_stale_sessions",
                        lambda *a, **k: None)


def _device_sequence(side, monkeypatch):
    """Two 1-device actors, a third that pends until a kill frees a
    device, a CPU task, and the resources back at their start."""
    pkg, num_kw, res, var = _PKGS[side]
    if side == "ref":
        _quiet_reference_sweep(monkeypatch)
    pkg.init(num_cpus=4, **{num_kw: 2})
    try:
        start = pkg.available_resources()
        total = pkg.cluster_resources()

        @pkg.remote(**{num_kw: 1})
        class Holder:
            def visible(self):
                import os
                return os.environ.get(var)

        @pkg.remote
        def cpu_task():
            import os
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        a, b = Holder.remote(), Holder.remote()
        seen_a, seen_b = pkg.get([a.visible.remote(), b.visible.remote()],
                                 timeout=60)
        c = Holder.remote()
        ref_c = c.visible.remote()
        ready, _ = pkg.wait([ref_c], timeout=2.0)
        pending = not ready
        pkg.kill(a)
        seen_c = pkg.get(ref_c, timeout=60)
        cpu_seen = pkg.get(cpu_task.remote(), timeout=60)
        pkg.kill(b)
        pkg.kill(c)
        t0 = time.monotonic()
        back = _wait_resources(pkg, start)
        return {"total": total[res], "start": start[res],
                "lists": sorted([seen_a, seen_b]), "pending": pending,
                "third_took_freed": seen_c == seen_a,
                "back_to_start": back == start,
                "seconds_to_release": time.monotonic() - t0,
                "cpu_task_sees": cpu_seen}
    finally:
        pkg.shutdown()


def test_device_accounting_matches_reference(monkeypatch):
    ref = _device_sequence("ref", monkeypatch)
    port = _device_sequence("port", monkeypatch)
    for rec in (ref, port):
        assert rec["total"] == rec["start"] == 2.0
        assert rec["lists"] == ["0", "1"]            # disjoint, one each
        assert rec["pending"] and rec["third_took_freed"]
        assert rec["back_to_start"], rec
        assert rec["seconds_to_release"] < 30.0
    # the same accounting, device for device
    keys = ("total", "start", "lists", "pending", "third_took_freed",
            "back_to_start")
    assert {k: ref[k] for k in keys} == {k: port[k] for k in keys}
    # a CPU worker sees no card in the port
    assert port["cpu_task_sees"] == ""


def test_gpu_worker_keeps_its_device_list_when_reused():
    """Tasks of 1, 2 and a fraction of a card on 2 accounting-only
    cards: every worker process runs all its tasks under one
    CUDA_VISIBLE_DEVICES, and workers are reused."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    try:
        def probe():
            import os
            import time
            time.sleep(0.05)
            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

        one = ray_tpu_torch.remote(num_gpus=1)(probe)
        two = ray_tpu_torch.remote(num_gpus=2)(probe)
        half = ray_tpu_torch.remote(num_gpus=0.5)(probe)
        runs = []
        for _ in range(3):
            runs += ray_tpu_torch.get([one.remote() for _ in range(6)],
                                      timeout=120)
            runs += ray_tpu_torch.get([two.remote() for _ in range(2)],
                                      timeout=120)
            runs += ray_tpu_torch.get([half.remote() for _ in range(3)],
                                      timeout=120)
        by_pid = {}
        for pid, devices in runs:
            by_pid.setdefault(pid, set()).add(devices)
        assert all(len(v) == 1 for v in by_pid.values()), by_pid
        assert len(by_pid) < len(runs)               # reuse happened
        lists = {next(iter(v)) for v in by_pid.values()}
        assert {"0", "1"} <= lists                   # one card each
        assert any(d is not None and len(d.split(",")) == 2
                   for d in lists)                   # both cards
        assert None in lists      # a fraction takes no card (reference)
    finally:
        ray_tpu_torch.shutdown()


def test_worker_refuses_a_second_device_list(monkeypatch):
    """The worker-side guard behind the node manager's reuse rule."""
    # set, then delete: monkeypatch restores the variable after the test
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    w = types.SimpleNamespace(_bound_devices=None, _node_devices=None)
    WorkerProcess._set_visible_devices(w, None)
    assert "CUDA_VISIBLE_DEVICES" not in os.environ
    WorkerProcess._set_visible_devices(w, [1])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"
    WorkerProcess._set_visible_devices(w, [1])       # same list: fine
    with pytest.raises(RuntimeError, match="bound to"):
        WorkerProcess._set_visible_devices(w, [0])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"
    # indices are within the card list the node inherited
    w = types.SimpleNamespace(_bound_devices=None, _node_devices=["4", "6"])
    WorkerProcess._set_visible_devices(w, [1, 0])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "6,4"


def test_gpu_detection_reads_visible_devices(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,3")
    assert detect_num_gpus() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert detect_num_gpus() == 0
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert detect_num_gpus() == 0                 # no card on this host
    assert "torch" not in ray_tpu_torch.accelerators.gpu.__dict__


def test_num_tpus_and_bind_raise():
    """``num_tpus`` raises (the port's accelerator is ``num_gpus``);
    ``.bind()`` builds DAG nodes since ``dag/`` was ported."""
    from ray_tpu_torch.dag import ClassNode, FunctionNode
    with pytest.raises(TypeError, match="num_gpus"):
        ray_tpu_torch.init(num_tpus=1)
    assert not ray_tpu_torch.is_initialized()
    ray_tpu_torch.init(num_cpus=1)
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()

        @ray_tpu_torch.remote(num_tpus=1)
        def f():
            return 1

        with pytest.raises(TypeError, match="num_gpus"):
            f.remote()
        assert isinstance(f.bind(), FunctionNode)

        @ray_tpu_torch.remote
        class A:
            pass

        assert isinstance(A.bind(), ClassNode)
    finally:
        ray_tpu_torch.shutdown()


def test_sessions_are_the_ports_own(monkeypatch):
    """The port's session root and shm roots are not the reference's,
    so ``address="auto"`` and the stale-session sweep never see a
    JAX-package cluster."""
    assert port_node._default_tmp_root() != ref_node._default_tmp_root()
    assert port_node._shm_root("session_x") != ref_node._shm_root(
        "session_x")
    _quiet_reference_sweep(monkeypatch)
    ray_tpu.init(num_cpus=1)
    try:
        ref_session = ray_tpu._private.worker.global_node().session_dir
        assert ref_session in [d for _a, d in ref_node._session_candidates()]
        assert ref_session not in [
            d for _a, d in port_node._session_candidates()]
    finally:
        ray_tpu.shutdown()


def _dead_pid() -> int:
    import subprocess
    import sys
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    return dead.pid


def _fake_sessions(tmp_path, monkeypatch, root_name, names, journaled=()):
    """Session dirs and shm roots of a dead head under ``tmp_path``,
    with this test's session root ``root_name`` (shm in ``tmp_path/shm``,
    as every TMPDIR shares ``/dev/shm``); returns the shm paths."""
    root = tmp_path / root_name
    monkeypatch.setattr(port_node, "_default_tmp_root", lambda: str(root))
    monkeypatch.setattr(port_node, "_shm_base",
                        lambda: str(tmp_path / "shm"))
    shm = {}
    for name in names:
        (root / name).mkdir(parents=True)
        shm[name] = port_node._shm_root(name)
        os.makedirs(shm[name])
    for name in journaled:
        (root / name / "cp_journal.bin").write_bytes(b"")
    return root, shm


def test_stale_sweep_keeps_a_journaled_session(tmp_path, monkeypatch):
    """A dead head's session with a control-plane journal survives
    another driver's sweep (a restart re-enters it); one without goes."""
    pid = _dead_pid()
    kept, gone = f"session_1_{pid}", f"session_2_{pid}"
    root, shm = _fake_sessions(tmp_path, monkeypatch, "root", [kept, gone],
                               journaled=[kept])
    port_node._gc_stale_sessions()
    assert (root / kept).is_dir()
    assert os.path.isdir(shm[kept])
    assert not (root / gone).exists()
    assert not os.path.exists(shm[gone])


def test_stale_sweep_sees_only_its_own_root(tmp_path, monkeypatch):
    """Two session roots (two TMPDIRs) share /dev/shm: each names its
    shm roots apart, and a sweep under one leaves the other's dead
    sessions, journaled or not, untouched."""
    pid = _dead_pid()
    names = [f"session_1_{pid}", f"session_2_{pid}"]
    root_a, shm_a = _fake_sessions(tmp_path, monkeypatch, "a", names,
                                   journaled=names[:1])
    root_b, _shm_b = _fake_sessions(tmp_path, monkeypatch, "b", [])
    assert port_node._shm_root(names[0]) != shm_a[names[0]]
    port_node._gc_stale_sessions()
    port_node._gc_stale_sessions(reclaim_journaled=True)
    for name in names:
        assert (root_a / name).is_dir()
        assert os.path.isdir(shm_a[name])


def test_init_starts_beside_a_stale_node_shm_root(tmp_path, monkeypatch):
    """An extra node's shm root left by a head that died before its
    shutdown (``<shm root>_node_<12 hex digits>``) whose digits happen
    all to be decimal, and a session name whose trailing number is too
    large for a pid: the sweep at ``init`` skips the first and drops the
    second, and the session starts.  The reference's sweep passes such a
    number to ``os.kill`` and fails every later ``init`` on the host
    (ROADMAP Queue 3, reference-side list)."""
    monkeypatch.setattr(port_node, "_shm_base",
                        lambda: str(tmp_path / "shm"))
    node_root = port_node._shm_root(
        "session_20261018_070142_24025_node_266937476824")
    huge = port_node._shm_root("session_20261018_070142_266937476824")
    os.makedirs(node_root)
    os.makedirs(huge)
    ray_tpu_torch.init(num_cpus=1)
    try:
        @ray_tpu_torch.remote
        def one():
            return 1

        assert ray_tpu_torch.get(one.remote(), timeout=60) == 1
    finally:
        ray_tpu_torch.shutdown()
    assert os.path.isdir(node_root)
    assert not os.path.exists(huge)


def test_stop_reclaims_a_journaled_dead_sessions_shm(tmp_path, monkeypatch):
    """``scripts stop`` frees a journaled dead session's shm objects
    (nothing restarts it after ``stop``) and keeps its journal; a
    session re-entered by a live head (its ``head_pid``) keeps both."""
    import argparse

    from ray_tpu_torch.scripts import scripts
    pid = _dead_pid()
    dead, restarted = f"session_1_{pid}", f"session_2_{pid}"
    root, shm = _fake_sessions(tmp_path, monkeypatch, "root",
                               [dead, restarted],
                               journaled=[dead, restarted])
    (root / restarted / "head_pid").write_text(str(os.getpid()))
    monkeypatch.setattr(scripts, "_pidfile",
                        lambda: str(tmp_path / "daemons.pids"))
    scripts.cmd_stop(argparse.Namespace())
    assert not os.path.exists(shm[dead])
    assert (root / dead / "cp_journal.bin").is_file()
    assert os.path.isdir(shm[restarted])
    assert (root / restarted / "cp_journal.bin").is_file()
