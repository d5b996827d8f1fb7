"""Port counterparts of ``tests/test_resilience.py``'s RL tests: the
replay queue's timed put and ``resilience/supervisor.py``'s supervised
loop in ``ray_tpu_torch``, at ``test_rl.py``'s tiny config on the CPU.

The reference's ``restart_compiles`` has no meaning in an eager engine;
its counterpart is ``restart_builds``: the kernel library built nothing
after a replacement was spawned, which holds by construction (the library
is built at most once per process).  Every thread wait has its own
timeout.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.util import chaos

MODEL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq=64)
_KW = {"slots": 6, "page_size": 16, "buckets": (16,), "telemetry": False}


@pytest.fixture(scope="module")
def tiny_rl():
    return tgpt.GPTConfig(**MODEL, dtype=torch.float32)


@pytest.fixture(scope="module")
def rl_learner_fns(tiny_rl):
    """One policy-gradient step builder shared by every supervised-loop
    test (per-test seeds re-init the state)."""
    from ray_tpu_torch.models import training
    return training.build_gpt_rl_train(
        tiny_rl, baseline="rloo", optimizer=training.rl_optimizer(1e-2, 1.0),
        device="cpu")


@pytest.fixture(autouse=True)
def _no_faults():
    chaos.clear_faults()
    yield
    chaos.clear_faults()


def _rlcfg(**over):
    from ray_tpu_torch.rl import RLConfig
    base = dict(actors=1, batch=6, horizon=8, queue=4, max_lag=2,
                overflow="drop", publish_every=1, baseline="rloo",
                temperature=1.0)
    base.update(over)
    return RLConfig(**base)


def _batch(v):
    from ray_tpu_torch.rl.rollout import TrajectoryBatch
    return TrajectoryBatch(tokens=np.zeros((1, 4), np.int32),
                           targets=np.full((1, 4), -1, np.int32),
                           rewards=np.zeros((1,), np.float32),
                           logprobs=[[0.0]], completions=[[1]],
                           param_version=v)


# --------------------------------------------------------- replay timeout
def test_replay_put_timeout_typed_and_counted():
    from ray_tpu_torch.rl import rl_config
    from ray_tpu_torch.rl.replay import ReplayPutTimeout, ReplayQueue
    q = ReplayQueue(1, max_lag=1, overflow="wait", put_timeout=0)
    assert q.put(_batch(1)) is True
    # non-blocking rejection: False, counted
    assert q.put(_batch(1)) is False
    assert q.backpressure_rejections == 1
    # timed rejection: typed error, counted
    t0 = time.monotonic()
    with pytest.raises(ReplayPutTimeout, match="RAY_TPU_RL_PUT_TIMEOUT") \
            as ei:
        q.put(_batch(1), timeout=0.15)
    assert 0.1 < time.monotonic() - t0 < 5.0
    assert q.backpressure_rejections == 2
    # crosses the object store: rebuilt from its argument
    assert pickle.loads(pickle.dumps(ei.value)).timeout_s == 0.15
    # a concurrent pop frees space: the blocked put completes
    popper = threading.Timer(0.1, lambda: q.pop(1))
    popper.start()
    assert q.put(_batch(1), timeout=5.0) is True
    popper.join(timeout=5.0)
    assert not popper.is_alive()
    assert q.backpressure_rejections == 2
    # the knob plumbs through rl_config, as the queue's default
    os.environ["RAY_TPU_RL_PUT_TIMEOUT"] = "2.5"
    try:
        assert rl_config(refresh=True).put_timeout == 2.5
        assert ReplayQueue(1, overflow="wait").put_timeout == 2.5
        os.environ["RAY_TPU_RL_PUT_TIMEOUT"] = "-1"
        assert rl_config(refresh=True).put_timeout == 0.0
    finally:
        del os.environ["RAY_TPU_RL_PUT_TIMEOUT"]
        rl_config(refresh=True)


# --------------------------------------------------- supervised RL loop
def test_rl_kill_recovery_acceptance(tmp_path, tiny_rl, rl_learner_fns):
    """Kill a rollout actor mid-loop and the learner mid-loop (restored
    from its checkpoint): the loop completes with both faults fired, one
    restart of each, the records rolled back with the learner, no kernel
    built after the replacement, the engines drained clean, and the
    recovered run still learning, its final third near the undisturbed
    run's.  An undisturbed supervised run reproduces ``run_rl_loop``'s
    trajectories."""
    from ray_tpu_torch.resilience import (TrainCheckpointer,
                                          run_supervised_rl_loop)
    from ray_tpu_torch.rl import run_rl_loop
    cfg = tiny_rl
    # seed 1, not the reference's 3: the port's sampler draws other
    # tokens, and at seed 3 its undisturbed run hits the target token
    # in 3 of 12 rollouts and does not learn in 12 steps (seeds 3, 6 and
    # 7 stay flat, 1, 2 and 4 learn), so the recovery bar would hold
    # nothing; the learning bar itself is held over seeds in
    # test_torch_rl.py::test_rl_loop_reward_improves_end_to_end
    steps, seed = 12, 1
    kw = dict(rlcfg=_rlcfg(), seed=seed, lr=1e-2, engine_kwargs=_KW,
              device="cpu")
    base = run_supervised_rl_loop(cfg, steps=steps,
                                  learner_fns=rl_learner_fns,
                                  telemetry=True, **kw)
    assert base["actor_restarts"] == 0 and base["learner_restarts"] == 0
    plain = run_rl_loop(cfg, steps=4, telemetry=False, **kw)
    assert plain["reward_curve"] == base["reward_curve"][:4]
    curve_b = base["reward_curve"]
    third = len(curve_b) // 3
    base_first = float(np.mean(curve_b[:third]))
    base_final = float(np.mean(curve_b[-third:]))
    assert base_final > base_first + 0.5

    plan = chaos.install_faults("rl.rollout@4,rl.learner@7")
    with TrainCheckpointer(str(tmp_path / "rl"), every=0, keep=3) as ck:
        rec = run_supervised_rl_loop(cfg, steps=steps,
                                     learner_fns=rl_learner_fns, ckpt=ck,
                                     ckpt_every=2, telemetry=True, **kw)
    chaos.clear_faults()
    assert ("rl.rollout", 4) in plan.fired
    assert ("rl.learner", 7) in plan.fired
    assert rec["actor_restarts"] == 1 and rec["learner_restarts"] == 1
    assert rec["telemetry"]["actor_restarts"] == 1
    assert rec["telemetry"]["learner_restarts"] == 1
    assert rec["restart_builds"] == [0]
    curve_r = rec["reward_curve"]
    third_r = len(curve_r) // 3
    rec_first = float(np.mean(curve_r[:third_r]))
    rec_final = float(np.mean(curve_r[-third_r:]))
    assert rec_final > rec_first + 0.25
    assert abs(rec_final - base_final) < 2.0, (rec_final, base_final)
    assert len(curve_r) == steps
    for st in rec["engine_stats"]:
        assert st["active"] == 0 and st["waiting"] == 0
    for eng in rec["actors"]:
        assert eng.leak_free()


def test_rl_killed_loop_resumes_with_bounded_loss(tmp_path, tiny_rl,
                                                  rl_learner_fns):
    """A learner death past the in-place restart budget kills the loop;
    a rerun with ``resume=True`` restores the checkpointed learner and
    finishes, having re-run at most the checkpoint interval."""
    from ray_tpu_torch.resilience import (TrainCheckpointer,
                                          run_supervised_rl_loop)
    cfg = tiny_rl
    d = str(tmp_path / "rl")
    kw = dict(rlcfg=_rlcfg(), seed=5, lr=1e-2, engine_kwargs=_KW,
              learner_fns=rl_learner_fns, telemetry=False, device="cpu")
    chaos.install_faults("rl.learner@5")
    with TrainCheckpointer(d, every=0, keep=3) as ck:
        with pytest.raises(chaos.InjectedFault):
            run_supervised_rl_loop(cfg, steps=6, ckpt=ck, ckpt_every=2,
                                   max_learner_restarts=0, **kw)
    chaos.clear_faults()
    with TrainCheckpointer(d, every=0, keep=3) as ck2:
        rec = run_supervised_rl_loop(cfg, steps=6, ckpt=ck2, ckpt_every=2,
                                     resume=True, **kw)
    assert rec["resumed_from"] is not None
    assert rec["steps"] == 6
    # killed at learner step 5 with ckpt_every=2: restored from step 4
    assert len(rec["reward_curve"]) == 2
    assert rec["learner"].steps == 6


@pytest.mark.slow
def test_publish_failure_is_survived(tiny_rl, rl_learner_fns):
    """An injected ``rl.publish`` failure skips one publication: actors
    keep rolling out on the previous version and the loop completes."""
    from ray_tpu_torch.resilience import run_supervised_rl_loop
    plan = chaos.install_faults("rl.publish@3")
    res = run_supervised_rl_loop(tiny_rl, steps=4, rlcfg=_rlcfg(), seed=7,
                                 lr=1e-2, engine_kwargs=_KW,
                                 learner_fns=rl_learner_fns,
                                 telemetry=False, device="cpu")
    chaos.clear_faults()
    assert ("rl.publish", 3) in plan.fired
    assert res["publish_failures"] == 1
    assert res["steps"] == 4
    assert res["param_version"] == res["publishes"]


def test_rollout_engine_ignores_serve_deadlines(monkeypatch, tiny_rl):
    """A rollout actor's engine does not inherit the serving deadlines
    (an expired rollout request would truncate a trajectory)."""
    from ray_tpu_torch.inference import infer_config
    from ray_tpu_torch.rl import RolloutActor
    monkeypatch.setenv("RAY_TPU_INFER_TTFT_DEADLINE", "0.001")
    monkeypatch.setenv("RAY_TPU_INFER_DEADLINE", "0.001")
    infer_config(refresh=True)
    try:
        params = tgpt.init_params(tiny_rl, torch.Generator().manual_seed(0),
                                  device="cpu")
        actor = RolloutActor(tiny_rl, params, engine_kwargs=_KW,
                             device="cpu")
        assert actor.engine.ttft_deadline is None
        assert actor.engine.deadline is None
    finally:
        monkeypatch.delenv("RAY_TPU_INFER_TTFT_DEADLINE")
        monkeypatch.delenv("RAY_TPU_INFER_DEADLINE")
        infer_config(refresh=True)
