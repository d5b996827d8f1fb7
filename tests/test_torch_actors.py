"""Port counterparts of ``tests/test_actors.py``: the same test bodies
run against ``ray_tpu_torch``, the PyTorch port's runtime.

The reference file's docstring: Actor tests: creation, ordering, named
actors, restarts, async.

Modeled on the reference's ``python/ray/tests/test_actor.py`` /
``test_actor_failures.py`` coverage.
"""

import time

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_actor_basic(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Counter:
        def __init__(self, start=0):
            self.value = start

        def incr(self, by=1):
            self.value += by
            return self.value

        def get(self):
            return self.value

    c = Counter.remote(10)
    assert ray.get(c.incr.remote()) == 11
    assert ray.get(c.incr.remote(5)) == 16
    assert ray.get(c.get.remote()) == 16


def test_actor_method_ordering(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Appender:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)

        def get(self):
            return self.items

    a = Appender.remote()
    for i in range(50):
        a.add.remote(i)
    assert ray.get(a.get.remote()) == list(range(50))


def test_actor_error(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Bad:
        def boom(self):
            raise RuntimeError("actor method failed")

        def fine(self):
            return "ok"

    b = Bad.remote()
    with pytest.raises(RuntimeError, match="actor method failed"):
        ray.get(b.boom.remote())
    # actor survives method errors
    assert ray.get(b.fine.remote()) == "ok"


def test_actor_init_error(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class BadInit:
        def __init__(self):
            raise ValueError("init failed")

        def f(self):
            return 1

    b = BadInit.remote()
    with pytest.raises(Exception):
        ray.get(b.f.remote())


def test_named_actor(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Store:
        def __init__(self):
            self.d = {}

        def put(self, k, v):
            self.d[k] = v

        def get(self, k):
            return self.d.get(k)

    Store.options(name="kv").remote()
    h = ray.get_actor("kv")
    ray.get(h.put.remote("a", 1))
    assert ray.get(h.get.remote("a")) == 1
    with pytest.raises(ValueError):
        ray.get_actor("missing")


def test_actor_handle_passing(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    @ray.remote
    def bump(counter):
        import ray_tpu_torch
        return ray_tpu_torch.get(counter.incr.remote())

    c = Counter.remote()
    results = ray.get([bump.remote(c) for _ in range(4)])
    assert sorted(results) == [1, 2, 3, 4]


def test_kill_actor(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    assert ray.get(a.ping.remote()) == "pong"
    ray.kill(a)
    from ray_tpu_torch.exceptions import ActorError
    time.sleep(0.5)
    with pytest.raises(Exception):
        ray.get(a.ping.remote(), timeout=5)


def test_actor_restart(ray_start_regular):
    ray = ray_start_regular

    @ray.remote(max_restarts=1)
    class Flaky:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def die(self):
            import os
            os._exit(1)

    f = Flaky.remote()
    assert ray.get(f.incr.remote()) == 1
    f.die.remote()
    time.sleep(1.0)
    # restarted: state reset
    deadline = time.time() + 20
    while time.time() < deadline:
        try:
            assert ray.get(f.incr.remote(), timeout=10) == 1
            break
        except Exception:
            time.sleep(0.5)
    else:
        pytest.fail("actor did not restart")


def test_call_lost_with_its_incarnation_runs_at_most_once(
        ray_start_regular):
    """A direct call the actor takes and dies on before acknowledging it
    runs at most once: it is not sent again through the node manager to
    the restarted incarnation (which it would kill again, or whose
    counter it would bump), the caller gets ``ActorDiedError`` for it,
    and the new incarnation answers the next calls from its fresh state.
    The armed incarnation exits inside its direct server's
    ``call_actor``, so the connection always closes after the request
    went out and before the reply (ROADMAP Queue 3, fault 9)."""
    ray = ray_start_regular
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.exceptions import ActorDiedError

    @ray.remote(max_restarts=1)
    class Flaky:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def arm(self):
            import os

            from ray_tpu_torch._private import worker_proc

            def call_actor(handler, spec):
                os._exit(1)

            worker_proc.WorkerProcess._DirectHandler.call_actor = call_actor
            return True

    f = Flaky.remote()
    assert ray.get(f.incr.remote()) == 1
    assert ray.get(f.arm.remote())
    assert global_worker()._actor_direct(f._actor_id) is not None
    lost = f.incr.remote()
    with pytest.raises(ActorDiedError):
        ray.get(lost, timeout=60)
    assert [ray.get(f.incr.remote(), timeout=60) for _ in range(3)] == \
        [1, 2, 3]


@pytest.mark.parametrize("taken", [False, True], ids=["dropped", "taken"])
def test_call_whose_connection_drops_is_answered_once(ray_start_regular,
                                                      taken):
    """The actor's direct server closes a call's connection between its
    request and its reply while the actor lives on: its error reply
    cannot be pickled, raised after the call was queued (``taken``) or
    before.  The caller asks the same incarnation whether it took the
    call and sends it again only if it did not, so the call is answered,
    and run, exactly once either way."""
    ray = ray_start_regular
    from ray_tpu_torch._private.worker import global_worker

    @ray.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def arm(self, taken):
            import threading

            from ray_tpu_torch._private import worker_proc
            handler_cls = worker_proc.WorkerProcess._DirectHandler
            original = handler_cls.call_actor

            def call_actor(handler, spec):
                handler_cls.call_actor = original   # fires once
                if taken:
                    original(handler, spec)
                err = RuntimeError("the reply is lost")
                err.lock = threading.Lock()         # fails to pickle
                raise err

            handler_cls.call_actor = call_actor
            return True

    c = Counter.remote()
    assert ray.get(c.incr.remote()) == 1
    assert ray.get(c.arm.remote(taken))
    assert global_worker()._actor_direct(c._actor_id) is not None
    assert ray.get(c.incr.remote(), timeout=60) == 2
    assert ray.get(c.incr.remote(), timeout=60) == 3


def test_call_unread_by_a_dying_incarnation_goes_to_the_next(
        ray_start_regular):
    """A direct call that reaches an incarnation which exits before it
    reads the request was never taken: the connection resets with the
    request unread, and the caller sends the call on through the node
    manager, so the restarted incarnation answers it (ROADMAP Queue 3,
    fault 11, case a).  The armed incarnation's direct server exits as
    soon as its next request arrives, without reading it."""
    ray = ray_start_regular
    from ray_tpu_torch._private.worker import global_worker

    @ray.remote(max_restarts=1)
    class Flaky:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def arm(self):
            import os
            import select

            from ray_tpu_torch._private import protocol
            from ray_tpu_torch._private.worker import global_worker
            core = global_worker()
            direct = core.cp.get_actor_info(
                core.current_actor_id)["direct_addr"]
            original = protocol.recv_msg

            def recv_msg(sock):
                if sock.getsockname() == direct:
                    select.select([sock], [], [])
                    os._exit(1)
                return original(sock)

            protocol.recv_msg = recv_msg
            return True

        def ping(self):
            return "pong"

    f = Flaky.remote()
    assert ray.get(f.incr.remote()) == 1
    assert ray.get(f.arm.remote())
    assert global_worker()._actor_direct(f._actor_id) is not None
    # read by the server's old recv_msg, which then loops into the armed
    # one: the next request arrives at a server that will not read it
    assert ray.get(f.ping.remote(), timeout=60) == "pong"
    assert ray.get(f.incr.remote(), timeout=60) == 1
    assert ray.get(f.incr.remote(), timeout=60) == 2


def test_orphaned_incarnation_refuses_direct_calls(ray_start_regular):
    """Once an actor worker's node manager is gone, its direct server
    refuses every new call with ``protocol.Fenced`` rather than take a
    call it cannot answer: the caller relays the call through the node
    manager, and it runs exactly once (ROADMAP Queue 3, fault 11, case
    b).  The armed worker sees its node-manager channel as closed while
    the node manager lives, so the relayed call reaches the same
    incarnation over that channel."""
    ray = ray_start_regular
    from ray_tpu_torch._private.worker import global_worker

    @ray.remote
    class Counter:
        def __init__(self):
            self.n = 0
            self.refused = 0

        def incr(self):
            self.n += 1
            return self.n

        def arm(self):
            from ray_tpu_torch._private import protocol, worker_proc
            proc_cls = worker_proc.WorkerProcess
            handler_cls = proc_cls._DirectHandler
            original = handler_cls.call_actor
            proc_cls._nm_alive = lambda proc: False

            def call_actor(handler, spec):
                try:
                    return original(handler, spec)
                except protocol.Fenced:
                    self.refused += 1
                    raise

            handler_cls.call_actor = call_actor
            return True

        def refusals(self):
            return self.refused

    c = Counter.remote()
    assert ray.get(c.incr.remote()) == 1
    assert ray.get(c.arm.remote())
    assert global_worker()._actor_direct(c._actor_id) is not None
    assert ray.get(c.incr.remote(), timeout=60) == 2
    assert ray.get(c.refusals.remote(), timeout=60) == 1
    assert ray.get(c.incr.remote(), timeout=60) == 3


def test_async_actor(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class AsyncActor:
        async def slow(self, x):
            import asyncio
            await asyncio.sleep(0.05)
            return x * 2

    a = AsyncActor.remote()
    refs = [a.slow.remote(i) for i in range(8)]
    t0 = time.time()
    assert ray.get(refs, timeout=30) == [i * 2 for i in range(8)]
    # concurrent: 8 x 50ms should take far less than 400ms
    assert time.time() - t0 < 2.0


def test_threaded_actor_concurrency(ray_start_regular):
    ray = ray_start_regular

    @ray.remote(max_concurrency=4)
    class Blocking:
        def wait_a_bit(self):
            time.sleep(0.2)
            return 1

    b = Blocking.remote()
    t0 = time.time()
    assert sum(ray.get([b.wait_a_bit.remote() for _ in range(4)],
                       timeout=30)) == 4
    assert time.time() - t0 < 3.0


def test_actor_num_returns(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class M:
        @ray.method(num_returns=2)
        def two(self):
            return 1, 2

    m = M.remote()
    a, b = m.two.remote()
    assert ray.get([a, b]) == [1, 2]


def test_detached_lifetime_named_get(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class D:
        def hi(self):
            return "hi"

    D.options(name="d1", lifetime="detached").remote()
    assert ray.get(ray.get_actor("d1").hi.remote()) == "hi"


def test_direct_result_push_edge_cases(ray_start_regular):
    """Direct-channel result push: big results fall back to the CP
    flow, error results raise through the push, and entries never
    strand a get() (docs/PROTOCOL.md result push-back)."""
    import numpy as np

    ray = ray_start_regular

    @ray.remote
    class A:
        def small(self, x):
            return x * 2

        def big(self):
            # over inline_object_max_bytes: push sends the big marker
            return np.zeros(400_000, np.uint8)

        def boom(self):
            raise RuntimeError("pushed-error")

    a = A.remote()
    assert ray.get(a.small.remote(21), timeout=30) == 42
    arr = ray.get(a.big.remote(), timeout=30)
    assert arr.nbytes == 400_000
    with pytest.raises(RuntimeError, match="pushed-error"):
        ray.get(a.boom.remote(), timeout=30)
    # interleaving small/big/error keeps per-call results straight
    refs = [a.small.remote(i) for i in range(20)]
    assert ray.get(refs, timeout=30) == [i * 2 for i in range(20)]


def test_direct_push_survives_actor_kill(ray_start_regular):
    """A call in flight when the actor dies fails cleanly (the result
    stream drops; the waiter falls back to the CP flow and the death
    path resolves it)."""
    ray = ray_start_regular
    from ray_tpu_torch.exceptions import ActorDiedError, TaskError

    @ray.remote(max_restarts=0)
    class Slow:
        def nap(self, s):
            time.sleep(s)
            return "done"

        def pid(self):
            import os
            return os.getpid()

    s = Slow.remote()
    assert ray.get(s.pid.remote(), timeout=30) > 0
    ref = s.nap.remote(30)
    time.sleep(0.3)
    ray.kill(s)
    with pytest.raises((ActorDiedError, TaskError)):
        ray.get(ref, timeout=60)
