"""Port counterparts of ``tests/test_failures.py``: the same test bodies
run against ``ray_tpu_torch``, the PyTorch port's runtime.

The reference file's docstring: Fault-tolerance & edge-case regressions
(reference: ``python/ray/tests/test_failure*.py``,
``test_streaming_generator.py``).
"""

import time

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_generator_read_after_completion(ray_start_regular):
    ray = ray_start_regular

    @ray.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    g = gen.remote(3)
    time.sleep(1.5)  # let the producer finish before consuming
    assert [ray.get(r) for r in g] == [0, 10, 20]


def test_wait_num_returns_cap(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    def quick(i):
        return i

    refs = [quick.remote(i) for i in range(4)]
    ray.get(list(refs))  # all complete
    ready, not_ready = ray.wait(refs, num_returns=1)
    assert len(ready) == 1
    assert len(not_ready) == 3
    ready2, rest = ray.wait(not_ready, num_returns=2)
    assert len(ready2) == 2 and len(rest) == 1


def test_retry_exceptions(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    c = Counter.remote()

    @ray.remote(max_retries=3, retry_exceptions=True)
    def flaky(counter):
        import ray_tpu_torch
        n = ray_tpu_torch.get(counter.incr.remote())
        if n < 3:
            raise RuntimeError(f"transient {n}")
        return n

    assert ray.get(flaky.remote(c), timeout=60) == 3


def test_no_retry_without_opt_in(ray_start_regular):
    ray = ray_start_regular

    @ray.remote(max_retries=3)
    def always_fails():
        raise RuntimeError("app error: no retry by default")

    with pytest.raises(RuntimeError, match="no retry"):
        ray.get(always_fails.remote(), timeout=30)


def test_worker_crash_retries_task(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Tally:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    t = Tally.remote()

    @ray.remote(max_retries=2)
    def die_once(tally):
        import os

        import ray_tpu_torch
        n = ray_tpu_torch.get(tally.incr.remote())
        if n == 1:
            os._exit(1)  # simulate worker crash
        return "survived"

    assert ray.get(die_once.remote(t), timeout=60) == "survived"


def test_worker_crash_no_retries_raises(ray_start_regular):
    ray = ray_start_regular

    @ray.remote(max_retries=0)
    def die():
        import os
        os._exit(1)

    from ray_tpu_torch.exceptions import WorkerCrashedError
    with pytest.raises(WorkerCrashedError):
        ray.get(die.remote(), timeout=60)


def test_generator_producer_death_unblocks_consumer(ray_start_regular):
    ray = ray_start_regular

    @ray.remote(max_retries=0, num_returns="streaming")
    def doomed_gen():
        yield 1
        time.sleep(0.3)
        import os
        os._exit(1)

    g = doomed_gen.remote()
    it = iter(g)
    first = ray.get(next(it), timeout=30)
    assert first == 1
    with pytest.raises(Exception):
        for r in it:
            ray.get(r, timeout=30)


def test_actor_init_failure_recycles_worker(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Bad:
        def __init__(self):
            raise ValueError("nope")

        def f(self):
            return 1

    from ray_tpu_torch._private.worker import global_node
    nm = global_node().node_manager
    for _ in range(3):
        b = Bad.remote()
        with pytest.raises(Exception):
            ray.get(b.f.remote(), timeout=30)
    time.sleep(0.5)
    stats = nm.node_stats()
    # failed creations must not leak busy workers
    assert stats["num_idle"] >= 1
    assert stats["num_workers"] <= 6


def test_chaos_worker_killer_retries_win(ray_start_regular):
    """Tasks complete correctly while a chaos killer SIGKILLs busy
    workers (parity: reference chaos release tests / resource_killer)."""
    import time

    import ray_tpu_torch
    from ray_tpu_torch.util.chaos import ResourceKiller

    @ray_tpu_torch.remote(max_retries=10)
    def slow(i):
        time.sleep(0.4)
        return i * 10

    with ResourceKiller("worker", interval_s=0.5, max_kills=3,
                        rng_seed=1) as killer:
        out = ray_tpu_torch.get([slow.remote(i) for i in range(12)],
                                timeout=180)
    assert sorted(out) == [i * 10 for i in range(12)]
    assert killer.kills, "chaos never killed anything"


@pytest.mark.slow
def test_chaos_actor_killer_restarts(ray_start_regular):
    import time

    import ray_tpu_torch
    from ray_tpu_torch.util.chaos import ResourceKiller

    @ray_tpu_torch.remote(max_restarts=5, max_task_retries=5)
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            time.sleep(0.1)
            return self.n

    c = Counter.remote()
    with ResourceKiller("actor", interval_s=0.6, max_kills=2,
                        rng_seed=2) as killer:
        results = []
        for _ in range(20):
            results.append(ray_tpu_torch.get(c.bump.remote(),
                                             timeout=120))
    assert len(results) == 20
    # each call either continues the incarnation (prev+1) or lands on a
    # fresh incarnation (counter restarted from a smaller value); a
    # double-executed bump would show a jump of +2
    for prev, cur in zip(results, results[1:]):
        assert cur == prev + 1 or cur <= prev, results
    assert killer.kills, "chaos never killed the actor"


@pytest.mark.slow
def test_oom_policy_kills_hog_and_retries(tmp_path):
    """Memory monitor: node usage over threshold kills the newest
    retriable task's worker; the retry succeeds and an unrelated
    non-retriable task is untouched (reference: memory_monitor.h +
    worker_killing_policy.cc 'newest retriable first')."""
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "memory_monitor_refresh_ms": 100,
        "memory_monitor_limit_bytes": 300 * 1024 * 1024,
        "memory_usage_threshold": 0.9,
    })
    try:
        marker = str(tmp_path / "hog_ran")

        @ray_tpu_torch.remote(max_retries=2)
        def hog(marker_path):
            import os
            import time
            if not os.path.exists(marker_path):
                with open(marker_path, "w") as f:
                    f.write("x")
                ballast = bytearray(500 * 1024 * 1024)  # noqa: F841
                time.sleep(30)  # hold memory until the monitor kills us
                return "never"
            return "retried_ok"

        @ray_tpu_torch.remote(max_retries=0)
        def friend():
            import time
            time.sleep(1.0)
            return "fine"

        f = friend.remote()
        h = hog.remote(marker)
        assert ray_tpu_torch.get(f, timeout=60) == "fine"
        assert ray_tpu_torch.get(h, timeout=120) == "retried_ok"

        # a non-retriable hog surfaces an OOM-attributed crash
        @ray_tpu_torch.remote(max_retries=0)
        def hog2():
            import time
            ballast = bytearray(500 * 1024 * 1024)  # noqa: F841
            time.sleep(30)
            return "never"

        import pytest as _pytest
        with _pytest.raises(Exception) as excinfo:
            ray_tpu_torch.get(hog2.remote(), timeout=60)
        assert "memory" in str(excinfo.value).lower()
    finally:
        ray_tpu_torch.shutdown()
