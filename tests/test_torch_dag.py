"""Port counterparts of ``tests/test_compiled_dag.py`` and of the DAG
cases of ``tests/test_misc_libs.py``: the same test bodies run against
``ray_tpu_torch.dag`` (``.bind()`` on remote functions and actor classes,
compiled DAGs) and ``ray_tpu_torch.experimental.channel`` on the port's
runtime.  ``test_compiled_dag_pipeline`` keeps the reference's ``slow``
mark.

The reference files' docstrings: Compiled DAG + mutable channel tests
(parity: ``python/ray/dag/tests/experimental``); DAG, workflow, queue,
MLP/ResNet models.
"""

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_channel_roundtrip_and_close(tmp_path):
    from ray_tpu_torch.experimental.channel import (Channel, ChannelClosed)

    ch = Channel(str(tmp_path / "c0"), capacity=4096, num_readers=2)
    ch.write({"a": 1})
    assert ch.read(reader_index=0) == {"a": 1}
    # second reader has its own cursor
    assert ch.read(reader_index=1) == {"a": 1}
    ch.write([1, 2, 3])
    assert ch.read(reader_index=0) == [1, 2, 3]
    assert ch.read(reader_index=1) == [1, 2, 3]
    ch.close()
    with pytest.raises(ChannelClosed):
        ch.read(reader_index=0)
    ch.unlink()


def test_channel_capacity_enforced(tmp_path):
    from ray_tpu_torch.experimental.channel import Channel
    ch = Channel(str(tmp_path / "c1"), capacity=128)
    with pytest.raises(ValueError):
        ch.write(b"x" * 1024)
    ch.unlink()


@pytest.mark.slow
def test_compiled_dag_pipeline(ray_start_regular):
    """3-stage pipeline over channels: correct, pipelined, and much
    faster than per-call task submission (gate kept conservative here;
    ray_perf records the headline ratio)."""
    import time

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class Stage:
        def __init__(self, add):
            self.add = add

        def step(self, x):
            return x + self.add

    a, b, c = Stage.bind(1), Stage.bind(10), Stage.bind(100)
    with InputNode() as inp:
        dag = c.step.bind(b.step.bind(a.step.bind(inp)))
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(5).get() == 116
        N = 200
        t0 = time.perf_counter()
        outs, futs = [], []
        for i in range(N):
            futs.append(compiled.execute(i))
            if len(futs) >= 3:
                outs.append(futs.pop(0).get())
        outs.extend(f.get() for f in futs)
        compiled_rate = N / (time.perf_counter() - t0)
        assert outs == [i + 111 for i in range(N)]

        s1, s2, s3 = Stage.remote(1), Stage.remote(10), Stage.remote(100)
        ray_tpu_torch.get([s1.step.remote(0), s2.step.remote(0),
                     s3.step.remote(0)])
        t0 = time.perf_counter()
        M = 60
        for i in range(M):
            assert ray_tpu_torch.get(
                s3.step.remote(s2.step.remote(s1.step.remote(i)))) \
                == i + 111
        task_rate = M / (time.perf_counter() - t0)
        assert compiled_rate > 2 * task_rate, (compiled_rate, task_rate)
    finally:
        compiled.teardown()


def test_compiled_dag_multi_output(ray_start_regular):
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode, MultiOutputNode

    @ray_tpu_torch.remote
    class Worker:
        def __init__(self, k):
            self.k = k

        def mul(self, x):
            return x * self.k

    w1, w2 = Worker.bind(2), Worker.bind(3)
    with InputNode() as inp:
        dag = MultiOutputNode([w1.mul.bind(inp), w2.mul.bind(inp)])
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(7).get() == [14, 21]
        assert compiled.execute(2).get() == [4, 6]
    finally:
        compiled.teardown()


def test_compiled_dag_teardown_frees_actor(ray_start_regular):
    """After teardown the executor loop exits and the actor serves
    normal calls again."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class S:
        def step(self, x):
            return x - 1

    node = S.bind()
    with InputNode() as inp:
        dag = node.step.bind(inp)
    compiled = dag.experimental_compile()
    assert compiled.execute(3).get() == 2
    compiled.teardown()
    handle = node._get_handle({}, ())
    assert ray_tpu_torch.get(handle.step.remote(10), timeout=30) == 9


def test_compiled_dag_surfaces_stage_exception(ray_start_regular):
    """A stage exception propagates to the driver's get (not a channel
    timeout) and the pipeline stays alive for later calls."""
    import pytest as _pytest

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class S:
        def step(self, x):
            if x < 0:
                raise ValueError("negative!")
            return x + 1

    node = S.bind()
    with InputNode() as inp:
        dag = node.step.bind(inp)
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(1).get() == 2
        with _pytest.raises(RuntimeError, match="negative!"):
            compiled.execute(-1).get()
        assert compiled.execute(5).get() == 6   # loop survived
    finally:
        compiled.teardown()


def test_compiled_dag_rejects_kwargs(ray_start_regular):
    import pytest as _pytest

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class S:
        def step(self, x, scale=1):
            return x * scale

    node = S.bind()
    with InputNode() as inp:
        dag = node.step.bind(inp, scale=2)
    with _pytest.raises(TypeError, match="positional"):
        dag.experimental_compile()


def test_dag_function_bind(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    def a(x):
        return x + 1

    @ray.remote
    def b(x, y):
        return x * y

    dag = b.bind(a.bind(1), a.bind(2))
    assert ray.get(dag.execute(), timeout=60) == 2 * 3


def test_dag_diamond_runs_shared_node_once(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def get(self):
            return self.n

    c = Counter.remote()

    @ray.remote
    def shared(counter):
        import ray_tpu_torch
        return ray_tpu_torch.get(counter.incr.remote())

    @ray.remote
    def consume(x, y):
        return x + y

    node = shared.bind(c)
    dag = consume.bind(node, node)
    ray.get(dag.execute(), timeout=60)
    assert ray.get(c.get.remote()) == 1  # shared node executed once


def test_dag_actor_bind(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Model:
        def __init__(self, w):
            self.w = w

        def apply(self, x):
            return self.w * x

    from ray_tpu_torch.dag import InputNode
    with InputNode() as inp:
        model = Model.bind(3)
        dag = model.apply.bind(inp)
    assert ray.get(dag.execute(7), timeout=60) == 21


def test_dag_multi_output_node(ray_start_regular):
    """MultiOutputNode bundles branches; shared upstream runs once
    (parity: python/ray/dag/output_node.py)."""
    ray = ray_start_regular
    from ray_tpu_torch.dag import InputNode, MultiOutputNode

    @ray.remote
    class Tally:
        def __init__(self):
            self.n = 0

        def bump(self, x):
            self.n += 1
            return x + 100

        def count(self):
            return self.n

    t = Tally.remote()

    @ray.remote
    def shared(x):
        return ray.get(t.bump.remote(x))

    @ray.remote
    def left(x):
        return x * 2

    @ray.remote
    def right(x):
        return x * 3

    with InputNode() as inp:
        s = shared.bind(inp)
        dag = MultiOutputNode([left.bind(s), right.bind(s)])

    refs = dag.execute(1)
    assert ray.get(refs, timeout=60) == [202, 303]
    assert ray.get(t.count.remote(), timeout=30) == 1  # shared ran once
