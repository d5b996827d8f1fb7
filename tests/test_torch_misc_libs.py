"""Port counterparts of the workflow, queue, pool and joblib cases of
``tests/test_misc_libs.py`` and of ``test_actor_pool`` in
``tests/test_collective_pg.py``: the same test bodies run against
``ray_tpu_torch.workflow``, ``util.queue``, ``util.multiprocessing``,
``util.joblib`` and ``util.ActorPool`` on the port's runtime.
``test_joblib_backend`` keeps the reference's ``slow`` mark.  The
reference file's MLP and ResNet cases are ``tests/test_torch_models.py``'s.

The reference file's docstring: DAG, workflow, queue, MLP/ResNet models.
"""

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_workflow_durable_resume(ray_start_regular, tmp_path):
    import ray_tpu_torch.workflow as workflow
    workflow.init(str(tmp_path))
    calls = []

    @ray_start_regular.remote
    def step_a():
        return 10

    @ray_start_regular.remote
    def step_b(x):
        return x * 2

    @ray_start_regular.remote
    def failing(x):
        raise RuntimeError("deliberate")

    dag_ok = step_b.bind(step_a.bind())
    assert workflow.run(dag_ok, workflow_id="wf1") == 20
    assert workflow.get_status("wf1") == "SUCCESSFUL"
    # resume of a finished workflow returns the stored output
    assert workflow.resume("wf1") == 20

    dag_fail = failing.bind(step_a.bind())
    with pytest.raises(RuntimeError):
        workflow.run(dag_fail, workflow_id="wf2")
    assert workflow.get_status("wf2") == "FAILED"
    # resume after fixing: the completed step_a is not re-run; its result
    # is replayed from storage, and the fixed continuation completes
    dag_fixed = step_b.bind(step_a.bind())
    assert workflow.resume("wf2", dag_fixed) == 20
    assert workflow.get_status("wf2") == "SUCCESSFUL"


def test_queue(ray_start_regular):
    from ray_tpu_torch.util.queue import Empty, Queue
    q = Queue(maxsize=4)
    q.put(1)
    q.put(2)
    assert q.qsize() == 2
    assert q.get() == 1
    assert q.get() == 2
    with pytest.raises(Empty):
        q.get_nowait()

    # producer/consumer across actors
    @ray_start_regular.remote
    def produce(q, n):
        for i in range(n):
            q.put(i)
        return True

    ray_start_regular.get(produce.remote(q, 3), timeout=60)
    assert [q.get(timeout=10) for _ in range(3)] == [0, 1, 2]
    q.shutdown()


def test_multiprocessing_pool(ray_start_regular):
    """ray_tpu_torch.util.multiprocessing.Pool — stdlib surface on tasks
    (parity: ray/util/multiprocessing/pool.py)."""
    from ray_tpu_torch.util.multiprocessing import Pool

    def sq(x):
        return x * x

    def add(a, b):
        return a + b

    with Pool(4) as p:
        assert p.map(sq, range(12)) == [i * i for i in range(12)]
        assert p.starmap(add, [(1, 2), (3, 4)]) == [3, 7]
        assert list(p.imap(sq, range(5))) == [0, 1, 4, 9, 16]
        assert sorted(p.imap_unordered(sq, range(5))) == [0, 1, 4, 9, 16]
        ar = p.map_async(sq, range(4))
        assert ar.get(timeout=60) == [0, 1, 4, 9]
        assert p.apply(sq, (6,)) == 36
    with pytest.raises(ValueError):
        p.map(sq, [1])  # closed


@pytest.mark.slow
def test_joblib_backend(ray_start_regular):
    """register_ray() joblib backend runs Parallel over cluster tasks
    and propagates worker exceptions (parity: ray/util/joblib)."""
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import register_ray
    register_ray()

    def sq(x):
        return x * x

    with joblib.parallel_backend("ray_tpu_torch"):
        out = joblib.Parallel(n_jobs=2)(
            joblib.delayed(sq)(i) for i in range(8))
    assert out == [i * i for i in range(8)]

    def boom(x):
        raise ValueError("kaboom")

    with pytest.raises(ValueError):
        with joblib.parallel_backend("ray_tpu_torch"):
            joblib.Parallel(n_jobs=2)(
                joblib.delayed(boom)(i) for i in range(2))


def test_workflow_events(ray_start_regular, tmp_path):
    """Event steps: a TimerListener fires and its payload is durable —
    resume replays the recorded event instead of waiting again
    (parity: python/ray/workflow/event_listener.py)."""
    import time as _time

    import ray_tpu_torch.workflow as workflow
    workflow.init(str(tmp_path))

    fire_at = _time.time() + 0.3
    wait_step = ray_start_regular.remote(
        workflow.wait_for_event(workflow.TimerListener, fire_at))

    @ray_start_regular.remote
    def after(ts):
        return ("fired", ts)

    dag = after.bind(wait_step.bind())
    t0 = _time.time()
    assert workflow.run(dag, workflow_id="wf_ev")[1] == fire_at
    assert _time.time() - t0 >= 0.25
    # resume: the event must replay from storage, not wait again
    t1 = _time.time()
    assert workflow.resume("wf_ev")[1] == fire_at
    assert _time.time() - t1 < 5.0

    # file event
    path = tmp_path / "evt.txt"
    fstep = ray_start_regular.remote(
        workflow.wait_for_event(workflow.FileEventListener, str(path)))
    import threading

    def later():
        _time.sleep(0.3)
        path.write_bytes(b"payload")
    threading.Thread(target=later, daemon=True).start()
    assert workflow.run(fstep.bind(), workflow_id="wf_ev2") == b"payload"


def test_workflow_cloud_storage_backend(ray_start_regular):
    """Workflow storage over an fsspec URI (memory://) — steps persist
    and replay through the filesystem abstraction, standing in for
    gs://bucket paths (parity: cloud workflow_storage.py)."""
    import ray_tpu_torch.workflow as workflow
    workflow.init("memory://wfstore")
    try:
        assert workflow._remote_fs is not None

        @ray_start_regular.remote
        def a():
            return 4

        @ray_start_regular.remote
        def b(x):
            return x + 1

        dag = b.bind(a.bind())
        assert workflow.run(dag, workflow_id="cloud1") == 5
        assert workflow.get_status("cloud1") == "SUCCESSFUL"
        assert workflow.resume("cloud1") == 5
        assert "cloud1" in workflow.list_all()
        workflow.delete("cloud1")
        assert workflow.get_status("cloud1") == "NOT_FOUND"
    finally:
        workflow.init()   # restore local default for other tests


def test_actor_pool(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Doubler:
        def double(self, x):
            return x * 2

    from ray_tpu_torch.util import ActorPool
    pool = ActorPool([Doubler.remote(), Doubler.remote()])
    out = list(pool.map(lambda a, v: a.double.remote(v), [1, 2, 3, 4]))
    assert out == [2, 4, 6, 8]
