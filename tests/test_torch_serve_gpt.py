"""Port parity: the GPT serve deployment
(``ray_tpu_torch.inference.serve_gpt``).

Across the packages: the JAX ``GPTDeployment`` and the port's, both
driven directly through ``func_or_class`` at ``GPTConfig.tiny`` f32 on
the same parameters (the port's from ``convert.params_from_jax`` of the
reference's ``init_params(cfg, PRNGKey(0))``, injected through
``_build_engine``), give the same greedy streams token for token and
logprobs within 1e-5.

Then the port's counterparts of the reference's deployment tests
(``tests/test_inference.py``'s ``test_gpt_deployment_*`` and
``tests/test_fleet.py::test_idle_stream_reaper_frees_dropped_generator``),
driving the class directly as the reference does, and ``serve.run`` of
the deployment on the port's runtime, on the CPU
(``engine_config={"device": "cpu"}``): its stream equals an offline port
engine's, the deployment's arguments carry no torch into the controller,
and a replica asking for ``num_gpus=1`` takes the (accounting-only) card
from inside the controller and gives it back at ``serve.delete``.
"""

import asyncio
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference.serve_gpt import GPTDeployment as JaxDeployment
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.inference import (DeadlineExceededError,
                                     InferenceEngine, QueueFullError)
from ray_tpu_torch.inference import serve_gpt
from ray_tpu_torch.inference.serve_gpt import (GPTDeployment,
                                               ReplicaDrainingError,
                                               StreamIdleError)
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.util import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = {"dtype": torch.float32}
_ENGINE_KW = {"device": "cpu", "slots": 2, "page_size": 16,
              "buckets": (16, 32, 64), "telemetry": False}
# compiled steps of the JAX deployment's engine, shared in this file
_JAX_EXEC = {}


def _prompt(n, vocab=512, seed=0):
    return [int(t) for t in
            np.random.RandomState(seed).randint(0, vocab, n)]


def _dep(**engine_over):
    return GPTDeployment.func_or_class(
        model="tiny", model_config=F32,
        engine_config={**_ENGINE_KW, **engine_over})


def _collect(dep, payload, timeout=60):
    async def run():
        return [item async for item in dep(payload)]
    return asyncio.run(asyncio.wait_for(run(), timeout=timeout))


def _offline(prompt, max_new, **kw):
    """The port's own engine on the deployment's preset and seed."""
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    params = tgpt.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    engine = InferenceEngine(cfg, params, **{**_ENGINE_KW, **kw})
    return engine.generate([prompt], max_new_tokens=max_new,
                           return_logprobs=True)


# --------------------------------------------------- the JAX deployment
def _concurrent(dep, payloads):
    """Start every request before any is read, then drain them all:
    the requests share the engine's decode batch."""
    async def run():
        agens = [dep(p) for p in payloads]
        firsts = [await a.__anext__() for a in agens]
        rests = await asyncio.gather(*[_drain(a) for a in agens])
        return [[f] + r for f, r in zip(firsts, rests)]

    async def _drain(agen):
        return [item async for item in agen]
    return asyncio.run(asyncio.wait_for(run(), timeout=120))


def test_deployment_matches_jax_deployment(monkeypatch):
    """Greedy streams through both deployments, three requests sharing
    the batch: tokens equal, logprobs within 1e-5."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    built = []

    def build(model, model_config, engine_config, seed):
        assert (model, seed) == ("tiny", 0)
        built.append(engine_config)
        return tcfg, InferenceEngine(tcfg, tparams, **engine_config)

    monkeypatch.setattr(serve_gpt, "_build_engine", build)
    geometry = {"slots": 2, "page_size": 16, "buckets": (16, 32, 64),
                "telemetry": False}
    jdep = JaxDeployment.func_or_class(
        model="tiny", model_config={"dtype": jnp.float32},
        engine_config={**geometry, "executable_cache": _JAX_EXEC})
    tdep = GPTDeployment.func_or_class(
        model="tiny", engine_config={**geometry, "device": "cpu"})
    assert built == [{**geometry, "device": "cpu"}]
    payloads = [{"tokens": _prompt(n, seed=s), "max_new_tokens": m,
                 "logprobs": True}
                for n, s, m in ((9, 1, 7), (21, 2, 5), (40, 3, 6))]
    jout, tout = _concurrent(jdep, payloads), _concurrent(tdep, payloads)
    for j, t, p in zip(jout, tout, payloads):
        assert len(t) == p["max_new_tokens"]
        assert [i["token"] for i in t] == [i["token"] for i in j]
        np.testing.assert_allclose([i["logprob"] for i in t],
                                   [i["logprob"] for i in j],
                                   rtol=0, atol=1e-5)
    assert not tdep.engine.has_work() and tdep.engine.leak_free()


def test_deployment_pickles_by_reference():
    """The class crosses to the replica as a reference into this module
    (a class shipped by value carries whatever torch state its
    functions reach, which cloudpickle cannot pickle)."""
    import cloudpickle
    blob = cloudpickle.dumps(GPTDeployment.func_or_class)
    assert len(blob) < 200
    assert pickle.loads(blob) is GPTDeployment.func_or_class
    assert GPTDeployment.name == "GPTDeployment"
    assert GPTDeployment.max_ongoing_requests == 32


def test_build_engine_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTDeployment.func_or_class(model="tiny", model_config=F32)
    with pytest.raises(ValueError, match="unknown model preset"):
        GPTDeployment.func_or_class(model="gpt5",
                                    engine_config={"device": "cpu"})
    dep = GPTDeployment.func_or_class(
        model="tiny", model_config={"dtype": "float32"},
        engine_config=dict(_ENGINE_KW))
    assert dep.cfg.dtype is torch.float32
    assert dep.engine.device == torch.device("cpu")


# ---------------------------------- counterparts of the reference tests
def test_gpt_deployment_queue_full_is_stream_error():
    """The typed rejection is the stream's error at its first item, not
    a silently parked request."""
    dep = _dep(slots=1, max_queue=1)
    dep.engine.submit([1, 2, 3], max_new_tokens=4)   # fills the queue
    with pytest.raises(QueueFullError):
        _collect(dep, {"tokens": [7, 8, 9], "max_new_tokens": 4},
                 timeout=30)
    assert not dep._queues


def test_gpt_deployment_streams_logprobs():
    """``"logprobs": True``: items are {token, logprob} dicts whose
    logprobs match the offline engine's."""
    dep = _dep()
    prompt = [3, 1, 4, 1, 5]
    items = _collect(dep, {"tokens": prompt, "max_new_tokens": 4,
                           "logprobs": True})
    assert all(set(i) == {"token", "logprob"} for i in items)
    want_toks, want_lps = _offline(prompt, 4)
    assert [i["token"] for i in items] == want_toks[0]
    np.testing.assert_allclose([i["logprob"] for i in items],
                               want_lps[0], rtol=1e-6)


def test_gpt_deployment_pump_failure_propagates():
    """A step failure in the pump reaches every streaming consumer."""
    dep = _dep()

    def boom():
        raise RuntimeError("step exploded")
    dep.engine.step = boom
    with pytest.raises(RuntimeError, match="step exploded"):
        _collect(dep, {"tokens": [1, 2, 3], "max_new_tokens": 4},
                 timeout=30)
    assert not dep._queues            # consumer cleaned up its queue


def test_gpt_deployment_abandoned_stream_cancels():
    """A consumer that stops iterating frees its slot within a tick."""
    dep = _dep()

    async def run():
        agen = dep({"tokens": [1, 2, 3], "max_new_tokens": 60})
        async for _tok in agen:
            break                     # consumer walks away
        await agen.aclose()           # triggers the finally -> cancel
        await dep._pump_task          # pump drains the cancel and exits

    asyncio.run(asyncio.wait_for(run(), timeout=60))
    assert not dep.engine.scheduler.active
    assert not dep.engine.scheduler.waiting
    assert not dep.engine._requests
    # far fewer decode ticks than the 59 an unread request would burn
    assert dep.engine.call_counts["decode"] <= 3


def test_gpt_deployment_deadline_is_stream_error():
    """A deadline expiry is the typed stream error, and the payload's
    deadline keys reach the engine."""
    dep = _dep(slots=1)
    # slot 1 is busy; the deadlined request queues behind it and blows
    # its TTFT budget on the first pump tick
    dep.engine.submit(_prompt(6), max_new_tokens=8)

    async def run():
        agen = dep({"tokens": _prompt(6, seed=2), "max_new_tokens": 4,
                    "ttft_deadline_s": 1e-4})
        await asyncio.sleep(0.01)
        return [tok async for tok in agen]

    with pytest.raises(DeadlineExceededError):
        asyncio.run(asyncio.wait_for(run(), timeout=60))
    assert not dep._queues
    assert dep.engine.deadline_exceeded == 1


def test_gpt_deployment_graceful_drain():
    """``drain()``: admission stops with a typed error, in-flight
    streams finish, the engine ends idle."""
    dep = _dep()

    async def run():
        agen = dep({"tokens": _prompt(6), "max_new_tokens": 6})
        first = await agen.__anext__()          # stream is in flight
        drain_task = asyncio.create_task(dep.drain())
        await asyncio.sleep(0.01)
        with pytest.raises(ReplicaDrainingError):
            async for _ in dep({"tokens": [1, 2], "max_new_tokens": 2}):
                pass
        rest = [tok async for tok in agen]
        report = await drain_task
        return first, rest, report

    first, rest, report = asyncio.run(
        asyncio.wait_for(run(), timeout=60))
    assert len([first] + rest) == 6
    assert report["drained"] is True
    assert report["active"] == 0 and report["waiting"] == 0
    assert report["free_slots"] == 2
    assert not dep.engine.has_work()
    assert dep.telemetry_summary()["draining"] is True


def test_gpt_deployment_drain_survives_dead_pump():
    """``drain()`` does not hang when the pump died with work still in
    the engine: it retires the leftovers host-side and reports idle."""
    dep = _dep()
    chaos.install_faults("infer.decode@1")
    try:
        async def run():
            agen = dep({"tokens": _prompt(6), "max_new_tokens": 6})
            with pytest.raises(chaos.InjectedFault):
                async for _ in agen:
                    pass                 # pump dies on the decode tick
            return await asyncio.wait_for(dep.drain(), timeout=30)

        report = asyncio.run(asyncio.wait_for(run(), timeout=60))
    finally:
        chaos.clear_faults()
    assert report["drained"] is True
    assert report["active"] == 0 and report["waiting"] == 0
    assert not dep.engine.has_work()
    assert dep.engine.scheduler.allocator.free_count == \
        dep.engine.scheduler.allocator.num_pages - 1


def test_gpt_deployment_drain_timeout_on_wedged_pump():
    """``drain(timeout_s=...)`` on a pump that never finishes reports
    ``drained: False`` without touching engine state."""
    dep = _dep()

    async def run():
        dep.engine.submit(_prompt(6), max_new_tokens=4)
        # a "pump" that never finishes stands in for a wedged step
        dep._pump_task = asyncio.get_running_loop().create_task(
            asyncio.sleep(60))
        report = await asyncio.wait_for(
            dep.drain(poll_s=0.01, timeout_s=0.1), timeout=10)
        dep._pump_task.cancel()
        return report

    report = asyncio.run(asyncio.wait_for(run(), timeout=60))
    assert report["drained"] is False
    assert "wedged" in report["reason"]
    assert report["active"] + report["waiting"] == 1  # state untouched
    dep.engine.drain_requests()            # test cleanup
    assert not dep.engine.has_work()


def test_idle_stream_reaper_frees_dropped_generator():
    """A consumer that holds its stream but stops pumping it no longer
    pins a slot to ``max_new_tokens``: the reaper cancels the request,
    frees slot and pages, and leaves a typed StreamIdleError for any
    late reader."""
    dep = GPTDeployment.func_or_class(
        model="tiny", model_config=F32, engine_config=dict(_ENGINE_KW),
        stream_idle_s=0.03)

    async def main():
        agen = dep({"tokens": [1, 2, 3], "max_new_tokens": 50})
        await agen.__anext__()           # pump once, then go silent,
        deadline = time.monotonic() + 10  # HOLDING the generator
        while time.monotonic() < deadline:
            await asyncio.sleep(0.02)
            st = dep.engine.stats()
            if st["active"] == 0 and st["waiting"] == 0:
                break
        st = dep.engine.stats()
        assert dep.streams_reaped == 1
        assert st["active"] == 0
        assert st["free_slots"] == _ENGINE_KW["slots"]
        assert not dep._queues and not dep.engine._requests
        # the reaper fired well before 50 decode ticks were paid
        assert st["ticks"] < 40
        with pytest.raises(StreamIdleError, match="STREAM_IDLE"):
            async for _ in agen:
                pass

    asyncio.run(asyncio.wait_for(main(), timeout=30))


def test_stream_idle_knob_reaches_the_deployment(monkeypatch):
    from ray_tpu_torch.inference.config import infer_config
    monkeypatch.setenv("RAY_TPU_INFER_STREAM_IDLE", "0.25")
    infer_config(refresh=True)
    try:
        assert _dep().stream_idle_s == 0.25
    finally:
        monkeypatch.delenv("RAY_TPU_INFER_STREAM_IDLE")
        infer_config(refresh=True)
    assert _dep().stream_idle_s is None


# ------------------------------------------------ on the port's runtime
@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


_CPU_APP = dict(model="tiny", model_config={"dtype": "float32"},
                engine_config=dict(_ENGINE_KW))


def test_gpt_deployment_streams_tokens(ray_start_regular):
    """``serve.run`` of the deployment on the CPU: the handle's stream
    equals the offline engine's, with logprobs on the same items."""
    import ray_tpu_torch.serve as serve
    handle = serve.run(GPTDeployment.bind(**_CPU_APP), name="gpt")
    prompt = _prompt(6)
    got = list(handle.options(stream=True).remote(
        {"tokens": prompt, "max_new_tokens": 5}))
    want_toks, want_lps = _offline(prompt, 5)
    assert got == want_toks[0]
    items = list(handle.options(stream=True).remote(
        {"tokens": prompt, "max_new_tokens": 5, "logprobs": True}))
    assert [i["token"] for i in items] == want_toks[0]
    np.testing.assert_allclose([i["logprob"] for i in items],
                               want_lps[0], rtol=1e-6)
    summary = handle.telemetry_summary.remote().result()
    assert summary["stats"]["active"] == 0
    serve.delete("gpt")


_UNPICKLE_PROBE = r"""
import pickle, sys
pickle.loads(sys.stdin.buffer.read())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_deployment_arguments_carry_no_torch():
    """What ``serve.run`` sends the controller (a CPU actor) unpickles
    without torch: the class travels as bytes, the dtype by name."""
    import cloudpickle

    from ray_tpu_torch.serve import _collect_deployments
    out = []
    _collect_deployments(GPTDeployment.options(
        ray_actor_options={"num_gpus": 1}).bind(**_CPU_APP), "gpt", out)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = subprocess.run([sys.executable, "-c", _UNPICKLE_PROBE],
                         input=cloudpickle.dumps(out), cwd=REPO, env=env,
                         capture_output=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert out[0]["actor_options"] == {"num_gpus": 1}


@pytest.fixture
def ray_with_a_card():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_gpu_replica_created_by_the_controller(ray_with_a_card):
    """``num_gpus=1``: the controller (itself an actor) creates the
    replica on the node's one card (accounting-only here, so the engine
    runs on the CPU as asked), the card is held while the app runs and
    comes back at ``serve.delete``; the replica's process binds the
    card's ``CUDA_VISIBLE_DEVICES`` and was spawned, not forked from
    the CPU workers' template."""
    ray = ray_with_a_card
    import ray_tpu_torch.serve as serve

    @serve.deployment(ray_actor_options={"num_gpus": 1})
    class Where:
        def __call__(self, _=None):
            import sys
            main = sys.modules["__main__"]
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    os.path.basename(getattr(main, "__file__", "")))

    def gpus_free_reaches(n):
        # the control plane's view follows the node's next heartbeat
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                ray.available_resources().get("GPU", 0) != n:
            time.sleep(0.1)
        return ray.available_resources().get("GPU", 0) == n

    handle = serve.run(Where.bind(), name="where")
    assert handle.remote().result() == ("0", "worker_proc.py")
    assert gpus_free_reaches(0)
    serve.delete("where")
    assert gpus_free_reaches(1)

    handle = serve.run(GPTDeployment.options(
        ray_actor_options={"num_gpus": 1}).bind(**_CPU_APP), name="gpt")
    prompt = _prompt(9, seed=4)
    got = list(handle.options(stream=True).remote(
        {"tokens": prompt, "max_new_tokens": 4}))
    assert got == _offline(prompt, 4)[0][0]
    serve.delete("gpt")


def test_dropped_handle_stream_is_reaped(ray_start_regular):
    """A handle consumer that holds its stream but stops reading: the
    replica stops a credit window ahead of it, the deployment's tokens
    sit unread, and the idle-stream reaper cancels the request and frees
    its slot; a late reader gets the buffered tokens, then the typed
    error."""
    import ray_tpu_torch.serve as serve
    handle = serve.run(GPTDeployment.bind(**_CPU_APP, stream_idle_s=0.2),
                       name="gpt")
    stream = iter(handle.options(stream=True).remote(
        {"tokens": [1, 2, 3], "max_new_tokens": 100}))
    first = next(stream)            # take one item, then hold it unread
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        summary = handle.telemetry_summary.remote().result()
        if summary["streams_reaped"] and not summary["stats"]["active"]:
            break
        time.sleep(0.05)
    assert summary["streams_reaped"] == 1
    assert summary["stats"]["active"] == 0
    assert summary["stats"]["free_slots"] == _ENGINE_KW["slots"]
    assert summary["stats"]["calls"]["decode"] < 99
    late = [first]
    with pytest.raises(Exception, match="STREAM_IDLE"):
        for tok in stream:
            late.append(tok)
    assert 1 < len(late) < 100
    assert late == _offline([1, 2, 3], 100)[0][0][:len(late)]
    serve.delete("gpt")
