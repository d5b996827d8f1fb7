"""Port counterparts of ``tests/test_serve.py``: the same test bodies
run against ``ray_tpu_torch.serve`` on the port's runtime.

The HTTP and gRPC proxies bind a free port of this host (the reference's
fixed ports are taken by its own file when both run at once).

The reference file's docstring: Serve parity tests: deployments,
composition, replicas, HTTP, batching.
"""

import socket
import time

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_deployment_basic(ray_start_regular):
    import ray_tpu_torch.serve as serve

    @serve.deployment
    class Greeter:
        def __call__(self, name):
            return f"hello {name}"

    handle = serve.run(Greeter.bind(), name="greet")
    assert handle.remote("world").result() == "hello world"
    serve.delete("greet")


def test_function_deployment(ray_start_regular):
    import ray_tpu_torch.serve as serve

    @serve.deployment
    def double(x):
        return x * 2

    handle = serve.run(double.bind(), name="fn")
    assert handle.remote(21).result() == 42
    serve.delete("fn")


def test_composition(ray_start_regular):
    import ray_tpu_torch.serve as serve

    @serve.deployment
    class Adder:
        def __init__(self, increment):
            self.increment = increment

        def add(self, x):
            return x + self.increment

    @serve.deployment
    class Ingress:
        def __init__(self, adder):
            self.adder = adder

        def __call__(self, x):
            return self.adder.add.remote(x).result()

    app = Ingress.bind(Adder.bind(10))
    handle = serve.run(app, name="compose")
    assert handle.remote(5).result() == 15
    serve.delete("compose")


def test_multiple_replicas_spread_load(ray_start_regular):
    import os

    import ray_tpu_torch.serve as serve

    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __call__(self, _):
            return os.getpid()

    handle = serve.run(WhoAmI.bind(), name="pids")
    pids = {handle.remote(None).result() for _ in range(20)}
    assert len(pids) >= 2  # pow-2 routing reaches multiple replicas
    serve.delete("pids")


def test_actor_methods_and_state(ray_start_regular):
    import ray_tpu_torch.serve as serve

    @serve.deployment
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def __call__(self, _=None):
            return self.n

    handle = serve.run(Counter.bind(), name="ctr")
    m = handle.incr
    assert m.remote().result() == 1
    assert m.remote().result() == 2
    assert handle.remote().result() == 2
    serve.delete("ctr")


def test_http_proxy(ray_start_regular):
    import requests

    import ray_tpu_torch.serve as serve

    @serve.deployment
    class Echo:
        def __call__(self, body):
            return {"got": body}

    port = _free_port()
    serve.run(Echo.bind(), name="default", http_port=port)
    r = requests.post(f"http://127.0.0.1:{port}/", json={"a": 1},
                      timeout=30)
    assert r.status_code == 200
    assert r.json() == {"got": {"a": 1}}
    serve.shutdown()


def test_serve_batching(ray_start_regular):
    import ray_tpu_torch.serve as serve

    @serve.deployment
    class Batcher:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def handle_batch(self, items):
            self.batch_sizes.append(len(items))
            return [i * 10 for i in items]

        async def __call__(self, x):
            return await self.handle_batch(x)

        def sizes(self):
            return self.batch_sizes

    handle = serve.run(Batcher.bind(), name="batch")
    responses = [handle.remote(i) for i in range(8)]
    results = sorted(r.result() for r in responses)
    assert results == [i * 10 for i in range(8)]
    sizes = handle.sizes.remote().result()
    assert max(sizes) > 1  # concurrent calls actually coalesced
    serve.delete("batch")


def test_status_and_update(ray_start_regular):
    import ray_tpu_torch.serve as serve

    @serve.deployment(num_replicas=2)
    class V:
        def __call__(self, _=None):
            return "v1"

    serve.run(V.bind(), name="up")
    st = serve.status()
    assert st["up"]["deployments"]["V"]["num_replicas"] == 2

    @serve.deployment(num_replicas=1)
    class V:  # noqa: F811 - redeploy new version
        def __call__(self, _=None):
            return "v2"

    handle = serve.run(V.bind(), name="up")
    assert handle.remote().result() == "v2"
    assert serve.status()["up"]["deployments"]["V"]["version"] == 2
    serve.delete("up")


def test_autoscaling_up_and_down(ray_start_regular):
    """Queue depth grows replicas 1 -> 3, idleness shrinks them back
    (parity: serve/_private/autoscaling_policy.py)."""
    import ray_tpu_torch
    import ray_tpu_torch.serve as serve

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0,
        "upscale_delay_s": 0.2, "downscale_delay_s": 0.5})
    class Slow:
        async def __call__(self, x):
            import asyncio
            await asyncio.sleep(2.0)
            return x

    handle = serve.run(Slow.bind(), name="auto")

    def replicas():
        return serve.status()["auto"]["deployments"]["Slow"][
            "num_replicas"]

    assert replicas() == 1
    # pile on requests to inflate queue depth
    responses = [handle.remote(i) for i in range(8)]
    deadline = time.time() + 30
    while replicas() < 3 and time.time() < deadline:
        time.sleep(0.2)
    assert replicas() == 3, "load did not grow replicas to max"
    assert sorted(r.result(timeout_s=60) for r in responses) == list(
        range(8))
    # idle: scale back to min
    deadline = time.time() + 30
    while replicas() > 1 and time.time() < deadline:
        time.sleep(0.2)
    assert replicas() == 1, "idle deployment did not scale back down"
    serve.delete("auto")


def test_user_config_push_without_restart(ray_start_regular):
    """A redeploy that only changes user_config reaches live replicas via
    reconfigure() — same replica instance, no restart (parity:
    long-poll config push, serve/_private/long_poll.py:173)."""
    import os

    import ray_tpu_torch.serve as serve

    @serve.deployment(user_config={"factor": 2})
    class Scaler:
        def __init__(self):
            self.factor = 1
            self.constructions = os.getpid()  # marks this instance

        def reconfigure(self, config):
            self.factor = config["factor"]

        def __call__(self, x):
            return {"y": x * self.factor, "pid": self.constructions}

    app = Scaler.bind()
    handle = serve.run(app, name="cfg")
    first = handle.remote(10).result()
    assert first["y"] == 20

    # redeploy with a new user_config only
    serve.run(serve.deployment(user_config={"factor": 5})(
        Scaler.func_or_class).bind(), name="cfg")
    second = handle.remote(10).result()
    assert second["y"] == 50, "user_config update did not reach replica"
    assert second["pid"] == first["pid"], "replica was restarted"
    serve.delete("cfg")


@pytest.mark.slow
def test_downscale_drains_inflight_requests(ray_start_regular):
    """Scale-down removes replicas from routing, waits for their
    in-flight requests, then kills — no dropped requests (parity:
    replica graceful shutdown / drain)."""
    import ray_tpu_torch
    import ray_tpu_torch.serve as serve

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0,
        "upscale_delay_s": 0.2, "downscale_delay_s": 0.4})
    class Slow:
        async def __call__(self, x):
            import asyncio
            await asyncio.sleep(3.0)
            return x

    handle = serve.run(Slow.bind(), name="drain")

    def replicas():
        return serve.status()["drain"]["deployments"]["Slow"][
            "num_replicas"]

    # build load to force upscale, then send a final wave and watch the
    # downscale happen while those requests are still in flight
    first = [handle.remote(i) for i in range(6)]
    deadline = time.time() + 30
    while replicas() < 3 and time.time() < deadline:
        time.sleep(0.2)
    assert replicas() == 3
    tail = [handle.remote(100 + i) for i in range(3)]
    # every request completes despite replicas draining away
    results = [r.result(timeout_s=120) for r in first + tail]
    assert sorted(results) == sorted(list(range(6)) +
                                     [100, 101, 102])
    deadline = time.time() + 30
    while replicas() > 1 and time.time() < deadline:
        time.sleep(0.2)
    assert replicas() == 1
    serve.delete("drain")


def test_model_multiplexing(ray_start_regular):
    """@serve.multiplexed LRU-caches models per replica; requests with
    a multiplexed_model_id stick to the replica that loaded the model
    (parity: serve model multiplexing)."""
    import os

    import ray_tpu_torch.serve as serve

    @serve.deployment(num_replicas=2)
    class MuxModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return f"weights-{model_id}"

        async def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            model = await self.get_model(mid)
            return {"model": model, "pid": os.getpid(),
                    "loads": list(self.loads)}

    handle = serve.run(MuxModel.bind(), name="mux")
    # same model id -> same replica, loaded exactly once
    outs = [handle.options(multiplexed_model_id="m1").remote(i).result(
        timeout_s=60) for i in range(4)]
    assert all(o["model"] == "weights-m1" for o in outs)
    assert len({o["pid"] for o in outs}) == 1
    assert outs[-1]["loads"].count("m1") == 1
    # a second model coexists in the LRU (capacity 2)
    o2 = handle.options(multiplexed_model_id="m2").remote(0).result(
        timeout_s=60)
    assert o2["model"] == "weights-m2"
    # third model on the same replica evicts the LRU entry; reloading
    # the evicted model counts a second load on that replica
    sticky = handle.options(multiplexed_model_id="m1")
    pid1 = outs[0]["pid"]
    for mid in ("m3", "m4"):
        handle.options(multiplexed_model_id=mid).remote(0).result(
            timeout_s=60)
    again = sticky.remote(9).result(timeout_s=60)
    assert again["model"] == "weights-m1"
    serve.delete("mux")


def test_streaming_handle(ray_start_regular):
    """handle.options(stream=True) yields items as the replica produces
    them (parity: DeploymentResponseGenerator over ObjectRefGenerator)."""
    import ray_tpu_torch.serve as serve

    @serve.deployment
    class Tokens:
        def __call__(self, n):
            for i in range(n):
                yield {"token": i}

    handle = serve.run(Tokens.bind(), name="stream")
    out = list(handle.options(stream=True).remote(4))
    assert out == [{"token": i} for i in range(4)]
    serve.shutdown()


def test_streaming_async_gen_and_http(ray_start_regular):
    """Async-generator deployments stream over HTTP as ndjson chunks."""
    import json

    import requests

    import ray_tpu_torch.serve as serve

    @serve.deployment
    class AsyncTokens:
        async def __call__(self, body):
            for i in range((body or {}).get("n", 3)):
                yield {"tok": i}

    port = _free_port()
    serve.run(AsyncTokens.bind(), name="default", http_port=port)
    r = requests.post(f"http://127.0.0.1:{port}/?stream=1",
                      json={"n": 3}, timeout=30, stream=True)
    assert r.status_code == 200
    lines = [json.loads(ln) for ln in r.iter_lines() if ln]
    assert lines == [{"tok": 0}, {"tok": 1}, {"tok": 2}]
    serve.shutdown()


def test_grpc_ingress_unary_and_streaming(ray_start_regular):
    import json

    import grpc

    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.serve._private.proxy import GRPC_SERVICE

    @serve.deployment
    class Echo:
        def __call__(self, body):
            return {"got": body}

    @serve.deployment
    class Stream:
        def __call__(self, body):
            for i in range((body or {}).get("n", 2)):
                yield {"i": i}

    port = _free_port()
    serve.run(Echo.bind(), name="default", grpc_port=port)
    serve.run(Stream.bind(), name="streamer")

    from ray_tpu_torch._private.worker import global_worker  # noqa: F401
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    ident = lambda b: b  # noqa: E731
    predict = channel.unary_unary(
        f"/{GRPC_SERVICE}/Predict",
        request_serializer=ident, response_deserializer=ident)
    out = predict(json.dumps({"x": 1}).encode(), timeout=30)
    assert json.loads(out) == {"got": {"x": 1}}

    predict_stream = channel.unary_stream(
        f"/{GRPC_SERVICE}/PredictStreaming",
        request_serializer=ident, response_deserializer=ident)
    items = [json.loads(b) for b in predict_stream(
        json.dumps({"n": 3}).encode(),
        metadata=(("application", "streamer"),), timeout=30)]
    assert items == [{"i": 0}, {"i": 1}, {"i": 2}]
    channel.close()
    serve.shutdown()


def test_scale_to_zero_and_wake(ray_start_regular):
    """min_replicas=0: an idle deployment drains to zero replicas; the
    next request wakes it back up (reference: handle-side autoscaling
    metrics enable scale-to-zero)."""
    import time

    import ray_tpu_torch.serve as serve

    @serve.deployment(autoscaling_config={
        "min_replicas": 0, "max_replicas": 2,
        "target_ongoing_requests": 1.0,
        "upscale_delay_s": 0.2, "downscale_delay_s": 0.5})
    class Zero:
        def __call__(self, x):
            return x * 2

    handle = serve.run(Zero.bind(), name="ztest")

    def replicas():
        return serve.status()["ztest"]["deployments"]["Zero"][
            "num_replicas"]

    # deployed at min: zero replicas, no traffic
    assert replicas() == 0
    # first request wakes it 0 -> 1
    assert handle.remote(21).result(60) == 42
    assert replicas() >= 1
    # idle: drains back to zero
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and replicas() > 0:
        time.sleep(0.5)
    assert replicas() == 0
    # and wakes again
    assert handle.remote(5).result(60) == 10
    serve.shutdown()


def test_asgi_ingress(ray_start_regular):
    """@serve.ingress(asgi_app): path routes, query strings, status
    codes, and headers flow through the replica's ASGI cycle
    (reference: serve.ingress(fastapi_app), serve/api.py:168)."""
    import requests

    import ray_tpu_torch.serve as serve

    async def mini_asgi(scope, receive, send):
        # hand-rolled ASGI app: any framework (FastAPI included)
        # speaking ASGI plugs in the same way
        assert scope["type"] == "http"
        msg = await receive()
        body = msg.get("body", b"")
        path, q = scope["path"], scope["query_string"].decode()
        if path == "/hello":
            out, status = b'{"msg": "world"}', 200
        elif path == "/echo":
            out, status = body or b"{}", 200
        elif path == "/q":
            out, status = ('{"q": "%s"}' % q).encode(), 201
        else:
            out, status = b'{"error": "nope"}', 404
        await send({"type": "http.response.start", "status": status,
                    "headers": [(b"content-type", b"application/json"),
                                (b"x-served-by", b"mini-asgi")]})
        await send({"type": "http.response.body", "body": out})

    @serve.deployment
    @serve.ingress(mini_asgi)
    class Api:
        pass

    port = _free_port()
    serve.run(Api.bind(), name="default", http_port=port)
    base = f"http://127.0.0.1:{port}/default"
    r = requests.get(f"{base}/hello", timeout=30)
    assert r.status_code == 200 and r.json() == {"msg": "world"}
    assert r.headers["x-served-by"] == "mini-asgi"
    r = requests.post(f"{base}/echo", json={"a": 2}, timeout=30)
    assert r.json() == {"a": 2}
    r = requests.get(f"{base}/q?x=1&y=2", timeout=30)
    assert r.status_code == 201 and r.json() == {"q": "x=1&y=2"}
    assert requests.get(f"{base}/missing", timeout=30).status_code == 404
    serve.shutdown()


@pytest.mark.slow
def test_async_proxy_500_concurrent(ray_start_regular):
    """The async dispatch path holds >=500 in-flight requests without a
    thread per request (the old run_in_executor dispatch capped
    in-flight at the executor pool size)."""
    import asyncio
    import threading

    import ray_tpu_torch.serve as serve

    @serve.deployment(max_ongoing_requests=600)
    class Gate:
        def __init__(self):
            self.release = None
            self.count = 0

        async def __call__(self, body):
            import asyncio as aio
            if self.release is None:
                self.release = aio.Event()
            self.count += 1
            if self.count >= 500:
                self.release.set()
            await self.release.wait()
            return {"n": self.count}

    port = _free_port()
    serve.run(Gate.bind(), name="default", http_port=port)

    results = []

    async def storm():
        import aiohttp
        conn = aiohttp.TCPConnector(limit=600)
        async with aiohttp.ClientSession(connector=conn) as s:
            async def one():
                async with s.post(f"http://127.0.0.1:{port}/",
                                  json={}) as r:
                    return r.status
            statuses = await asyncio.gather(
                *[one() for _ in range(500)])
            results.extend(statuses)

    t = threading.Thread(target=lambda: asyncio.run(storm()))
    t.start()
    t.join(timeout=180)
    assert not t.is_alive(), "storm did not finish"
    assert len(results) == 500
    assert all(s == 200 for s in results)
    serve.shutdown()


def test_streaming_error_propagates_and_frees_slot(ray_start_regular):
    """An exception raised mid-generator inside
    ``ServeReplica.handle_request_streaming`` must surface to the
    ``DeploymentResponseGenerator`` consumer (not hang or truncate
    silently) and still decrement ``_ongoing`` — a leaked slot would
    poison pow-2 routing and autoscaling forever (r10 satellite)."""
    import ray_tpu_torch
    import ray_tpu_torch.serve as serve

    @serve.deployment
    class BoomSync:
        def __call__(self, n):
            yield "a"
            yield "b"
            raise RuntimeError("boom-sync")

    @serve.deployment
    class BoomAsync:
        async def __call__(self, n):
            yield "x"
            raise RuntimeError("boom-async")

    def drain(handle, want, marker):
        got = []
        with pytest.raises(Exception, match=marker):
            for item in handle.options(stream=True).remote(0):
                got.append(item)
        assert got == want          # items before the raise arrived
        # the finally must have run replica-side: no in-flight leak
        replica = handle._get_routing()["replicas"][0]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if ray_tpu_torch.get(replica.num_ongoing.remote(),
                                 timeout=10) == 0:
                return
            time.sleep(0.05)
        raise AssertionError("_ongoing never returned to 0")

    h1 = serve.run(BoomSync.bind(), name="boom_sync")
    drain(h1, ["a", "b"], "boom-sync")
    h2 = serve.run(BoomAsync.bind(), name="boom_async")
    drain(h2, ["x"], "boom-async")
    serve.shutdown()


def test_stream_runs_a_credit_window_ahead(ray_start_regular):
    """The port's handle streams: the replica produces at most the
    credit window past what the consumer has taken, and carries on as
    the consumer reads."""
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.serve._private.replica import _STREAM_WINDOW

    @serve.deployment
    class Counted:
        def __init__(self):
            self.produced = 0

        def __call__(self, n):
            for i in range(n):
                self.produced += 1
                yield i

        def count(self):
            return self.produced

    handle = serve.run(Counted.bind(), name="credit")
    stream = iter(handle.options(stream=True).remote(200))
    assert next(stream) == 0
    time.sleep(1.0)
    held = handle.count.remote().result()
    assert 1 < held <= _STREAM_WINDOW + 1
    assert [next(stream) for _ in range(99)] == list(range(1, 100))
    assert list(stream) == list(range(100, 200))
    assert handle.count.remote().result() == 200
    serve.delete("credit")


def test_stalled_stream_closes_its_generator(monkeypatch):
    """A stream whose consumer acknowledges nothing while the credit
    window is full is cut after ``_STREAM_STALL_S``: the user
    generator's cleanup runs, and after the window's items the stream
    ends in ``StreamStalledError``, never as a plain end (the replica
    class driven in-process)."""
    import asyncio

    import cloudpickle

    from ray_tpu_torch.serve import StreamStalledError
    from ray_tpu_torch.serve._private import replica as rep
    monkeypatch.setattr(rep, "_STREAM_STALL_S", 0.2)
    closed = []

    def tokens(n):
        try:
            for i in range(n):
                yield i
        finally:
            closed.append(True)

    replica = rep.ServeReplica._cls("app", "tokens",
                                    cloudpickle.dumps(tokens), (), {})
    replica.instance = tokens        # this process's, not a pickled copy
    out = []

    async def run():
        async for i in replica.handle_request_streaming(
                "__call__", (200,), {}, "", "stream-1"):
            out.append(i)

    t0 = time.monotonic()
    with pytest.raises(StreamStalledError, match="closed after 32 items"):
        asyncio.run(asyncio.wait_for(run(), timeout=30))
    assert out == list(range(rep._STREAM_WINDOW))
    assert time.monotonic() - t0 >= 0.2
    assert closed == [True]
    assert replica._ongoing == 0 and not replica._stream_acks
