"""Port counterparts of ``tests/test_rl.py``: the actor/learner RL loop of
``ray_tpu_torch.rl`` held against the JAX package's ``ray_tpu.rl`` on the
CPU, at ``test_rl.py``'s tiny config (vocab 128, d 64, 2 layers, 4 heads,
f32).

Both sides get the same inputs: the reference's ``init_params`` cross
over through ``convert.params_from_jax``, the reference learner's state
through ``convert.rl_state_from_jax``, and numpy batches made from a
seed.  Tolerances:

- config, rewards, batch layout, advantages, queue counters: exact;
- ``pg_grad_fn`` against the reference's: the loss within 1e-5
  relative, every gradient leaf within 1e-4 of its largest value, with
  and without ``accum_steps=2`` and with ``lora=``;
- greedy ``RolloutActor`` streams: token-equal to the reference's, the
  logprobs within 1e-5;
- replay: the reference loop's own trajectory batches fed to a port
  learner started at the reference's state give, over 6 steps,
  ``pg_loss``, ``logp_mean``, ``entropy`` and ``grad_norm`` within 1e-5
  relative and final params within 1e-4 of each leaf's largest value.

The sampler is the port's counter-based one, so sampled trajectories are
not the reference's draws: sampled loops are held by replay, and the
reward-improves test runs the port's own loop at the reference's bar.
The reference's compile counters have no meaning in an eager engine;
the weight-swap tests hold what they stand for: one resident snapshot,
written in place, nothing allocated after the first swap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.convert import (adapter_from_jax, params_from_jax,
                                   params_to_numpy, rl_state_from_jax)
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.util import chaos

MODEL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq=64)
_KW = {"slots": 6, "page_size": 16, "buckets": (16,), "telemetry": False}
# compiled steps of the JAX engines, shared across this file's tests
_JAX_EXEC = {}


@pytest.fixture(scope="module")
def tiny_rl():
    from ray_tpu.models import gpt as jgpt
    jcfg = jgpt.GPTConfig(**MODEL, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**MODEL, dtype=torch.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(autouse=True)
def _no_faults():
    chaos.clear_faults()
    yield
    chaos.clear_faults()


def _engine(tcfg, params, **over):
    from ray_tpu_torch.inference import InferenceEngine
    return InferenceEngine(tcfg, params, device="cpu", **{**_KW, **over})


def _pg_batch(seed=1, B=4, S=20):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, MODEL["vocab_size"], (B, S)).astype(np.int32)
    targets = np.full((B, S), -1, np.int32)
    targets[:, 7:15] = tokens[:, 8:16]       # the "completion" window
    targets[1, 12:15] = -1                   # rows of different lengths
    return {"tokens": tokens, "targets": targets,
            "rewards": rng.randn(B).astype(np.float32)}


def _close_tree(got, want, bound, what):
    """Every leaf of ``got`` within ``bound`` of ``want``'s largest
    value (numpy trees, the same keys)."""
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, bound, f"{what}/{k}")
            continue
        w = np.asarray(w)
        err = np.max(np.abs(np.asarray(got[k]) - w))
        assert err <= bound * (np.max(np.abs(w)) + 1e-12), \
            (f"{what}/{k}", err, np.max(np.abs(w)))


# ----------------------------------------------------------------- config
def test_rl_config_env_knobs(monkeypatch):
    """The same ``RAY_TPU_RL_*`` values give the same config on both
    sides, the defaults and the loud corrections included."""
    from ray_tpu.rl import rl_config as jrl_config
    from ray_tpu_torch.rl import rl_config

    def both():
        a, b = rl_config(refresh=True), jrl_config(refresh=True)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        return a

    cfg = both()
    assert (cfg.actors, cfg.batch, cfg.horizon) == (1, 8, 16)
    assert (cfg.queue, cfg.max_lag, cfg.overflow) == (4, 1, "drop")
    assert (cfg.publish_every, cfg.baseline) == (1, "rloo")
    assert cfg.temperature == 1.0 and cfg.put_timeout == 0.0
    for name, val in (("ACTORS", "3"), ("BATCH", "4"), ("HORIZON", "8"),
                      ("QUEUE", "2"), ("MAX_LAG", "2"),
                      ("OVERFLOW", "wait"), ("PUBLISH_EVERY", "4"),
                      ("BASELINE", "mean"), ("TEMPERATURE", "0.7"),
                      ("PUT_TIMEOUT", "2.5")):
        monkeypatch.setenv(f"RAY_TPU_RL_{name}", val)
    cfg = both()
    assert (cfg.actors, cfg.batch, cfg.horizon) == (3, 4, 8)
    assert (cfg.queue, cfg.max_lag, cfg.overflow) == (2, 2, "wait")
    assert (cfg.publish_every, cfg.baseline) == (4, "mean")
    assert cfg.temperature == 0.7 and cfg.put_timeout == 2.5
    for name, val in (("OVERFLOW", "bogus"), ("BASELINE", "gae"),
                      ("MAX_LAG", "-1"), ("QUEUE", "0"),
                      ("TEMPERATURE", "0.0"), ("PUT_TIMEOUT", "-1")):
        monkeypatch.setenv(f"RAY_TPU_RL_{name}", val)
    cfg = both()
    assert cfg.overflow == "drop" and cfg.baseline == "rloo"
    assert cfg.max_lag == 0 and cfg.queue == 4
    assert cfg.temperature == 1.0 and cfg.put_timeout == 0.0
    for name in ("ACTORS", "BATCH", "HORIZON", "QUEUE", "MAX_LAG",
                 "OVERFLOW", "PUBLISH_EVERY", "BASELINE", "TEMPERATURE",
                 "PUT_TIMEOUT"):
        monkeypatch.delenv(f"RAY_TPU_RL_{name}", raising=False)
    both()


# ----------------------------------------------------------------- reward
def test_target_token_reward():
    from ray_tpu.rl import batch_rewards as jbatch
    from ray_tpu.rl import target_token_reward as jreward
    from ray_tpu_torch.rl import batch_rewards, target_token_reward
    r = target_token_reward(7)
    assert r([7, 1, 7, 7]) == 3.0 and r([]) == 0.0
    r = target_token_reward(7, length_penalty=0.5, eos_token=9)
    assert r([7, 1, 7, 9]) == 2.0 - 0.5 * 3 and r([9]) == 0.0
    rng = np.random.RandomState(3)
    comps = [list(rng.randint(0, 12, rng.randint(0, 9))) for _ in range(20)]
    for kw in ({}, {"length_penalty": 0.25}, {"eos_token": 3,
                                              "length_penalty": 0.1}):
        j = jreward(5, **kw)
        got = batch_rewards(target_token_reward(5, **kw), comps)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jbatch(j, comps))


def test_trajectories_to_batch_layout():
    from ray_tpu.rl import trajectories_to_batch as jpack
    from ray_tpu_torch.rl import trajectories_to_batch
    out = trajectories_to_batch([[5, 6], [5, 6, 7]], [[10, 11, 12], [20]],
                                seq_len=8)
    assert list(out["targets"][0]) == [-1, 10, 11, 12, -1, -1, -1, -1]
    assert list(out["targets"][1]) == [-1, -1, 20, -1, -1, -1, -1, -1]
    ref = jpack([[5, 6], [5, 6, 7]], [[10, 11, 12], [20]], seq_len=8)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(out[k], ref[k])
        assert out[k].dtype == ref[k].dtype
    with pytest.raises(ValueError, match="seq_len"):
        trajectories_to_batch([[1, 2]], [[3, 4]], seq_len=3)
    # an empty prompt would train as a silent no-op: refused
    with pytest.raises(ValueError, match="empty prompt"):
        trajectories_to_batch([[]], [[3]], seq_len=4)


# ------------------------------------------------------------- advantages
def test_rl_advantages():
    from ray_tpu.models.training import rl_advantages as jadv
    r = np.array([1.0, 2.0, 6.0], np.float32)
    np.testing.assert_allclose(ttrain.rl_advantages(r, "rloo").numpy(),
                               [1 - 4.0, 2 - 3.5, 6 - 1.5], rtol=1e-6)
    for baseline in ("rloo", "mean", "none"):
        for x in (r, np.array([3.0], np.float32),
                  np.random.RandomState(2).randn(8).astype(np.float32)):
            np.testing.assert_allclose(
                ttrain.rl_advantages(torch.from_numpy(x), baseline).numpy(),
                np.asarray(jadv(jnp.asarray(x), baseline)), rtol=1e-6,
                atol=1e-7)
    with pytest.raises(ValueError, match="baseline"):
        ttrain.rl_advantages(r, "gae")
    with pytest.raises(ValueError, match="baseline"):
        ttrain.build_gpt_rl_train(tgpt.GPTConfig(**MODEL,
                                                 dtype=torch.float32),
                                  baseline="gae", device="cpu")


# ------------------------------------------------------- learner parity
def _lora_pair(jcfg, tcfg):
    from ray_tpu.adapters import LoraConfig as JLora
    from ray_tpu.adapters import lora as jlora
    from ray_tpu_torch.adapters import LoraConfig
    kw = dict(enabled=True, rank=4, scale=0.5)
    jl, tl = JLora(**kw), LoraConfig(**kw)
    ja = jlora.init_adapter(jcfg, jl, jax.random.PRNGKey(11), random_b=True)
    return jl, tl, ja, adapter_from_jax(jax.tree.map(np.asarray, ja), tcfg,
                                        tl, device="cpu")


@pytest.mark.parametrize("mode", ["plain", "accum2", "lora"])
def test_pg_grads_match_reference(tiny_rl, mode):
    """``pg_grad_fn`` against the reference's on the same params and
    batch: the loss within 1e-5 relative, the metrics likewise, every
    gradient leaf within 1e-4 of its largest value."""
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh
    jcfg, jparams, tcfg, tparams = tiny_rl
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    kw, tkw = {}, {}
    jp, tp = jparams, tparams
    if mode == "accum2":
        kw = tkw = {"accum_steps": 2}
    if mode == "lora":
        jl, tl, jp, tp = _lora_pair(jcfg, tcfg)
        kw = {"lora": jl, "base_params": jparams}
        tkw = {"lora": tl, "base_params": tparams}
    jfns = jtrain.build_gpt_rl_train(jcfg, mesh, baseline="rloo", **kw)
    tfns = ttrain.build_gpt_rl_train(tcfg, baseline="rloo", device="cpu",
                                     **tkw)
    assert tfns["accum_steps"] == jfns["accum_steps"]
    batch = _pg_batch()
    (jloss, jm), jgrads = jfns["pg_grad_fn"](jp, batch)
    (loss, m), grads = tfns["pg_grad_fn"](tp, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert sorted(m) == sorted(jm)
    for k in jm:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-6), k
    assert float(m["action_tokens"]) == 4 * 8 - 3
    _close_tree(params_to_numpy(grads), jax.tree.map(np.asarray, jgrads),
                1e-4, mode)


# --------------------------------------------------- weight publication
def test_weight_swap_never_aliases_the_callers_tensors(tiny_rl):
    """Fault 14: after ``set_params(B)``, writing into B in place must
    not change what the engine generates, and no engine tensor may share
    storage with B."""
    _j, _jp, tcfg, tparams = tiny_rl
    a = tparams
    b = tgpt.init_params(tcfg, torch.Generator().manual_seed(5),
                         device="cpu")
    engine = _engine(tcfg, a)
    engine.set_params(b, version=1)
    prompt = [3, 17, 42, 9, 100]
    first = engine.generate([prompt], max_new_tokens=6)
    b_ptrs = {t.untyped_storage().data_ptr()
              for t in ttrain._leaves(b)}
    with torch.no_grad():
        for t in ttrain._leaves(b):
            t.add_(1.0)
    assert engine.generate([prompt], max_new_tokens=6) == first
    assert not b_ptrs & {t.untyped_storage().data_ptr()
                         for t in ttrain._leaves(engine.params)}


def test_weight_publication_one_snapshot_in_place(tiny_rl):
    """The reference's zero-recompile/donation contract in an eager
    engine: >= 3 published versions swap into a live engine mid-traffic;
    from the first swap on the engine's tensors keep their addresses
    (nothing allocated, one resident snapshot), the version follows, and
    the swapped engine decodes as a fresh one over the same weights."""
    _j, _jp, tcfg, tparams = tiny_rl
    from ray_tpu_torch.inference import SamplingParams
    engine = _engine(tcfg, tparams)
    prompt = list(np.random.RandomState(5).randint(0, 128, 9))
    engine.generate([prompt], max_new_tokens=4)
    host = params_to_numpy(tparams)
    ptrs = None
    for v in (1, 2, 3, 4):
        engine.submit(prompt, max_new_tokens=5,
                      sampling=SamplingParams(temperature=1.0, seed=v))
        engine.step()
        assert engine.set_params(host, version=v) == v
        now = [t.data_ptr() for t in ttrain._leaves(engine.params)]
        if ptrs is None:
            ptrs = now
            assert not set(ptrs) & {t.data_ptr()
                                    for t in ttrain._leaves(tparams)}
        assert now == ptrs
        while engine.has_work():
            engine.step()
    assert engine.stats()["param_version"] == 4
    assert engine.leak_free()
    base = _engine(tcfg, tparams)
    assert engine.generate([prompt], max_new_tokens=4) == \
        base.generate([prompt], max_new_tokens=4)
    with pytest.raises(ValueError, match="engine holds"):
        engine.set_params({**host, "ln_f": host["ln_f"][:3]}, version=5)


def test_weight_swap_invalidates_prefix_cache(tiny_rl):
    """A swap flushes the content-keyed prefix cache: the same prompt
    re-prefills cold, and its trajectory is what the new params give
    teacher-forced."""
    _j, _jp, tcfg, tparams = tiny_rl
    engine = _engine(tcfg, tparams, buckets=(16, 64))
    prompt = list(np.random.RandomState(71).randint(0, 128, 37))
    engine.generate([prompt], max_new_tokens=2)
    assert engine.stats()["prefix"]["registered_pages"] == 2
    new = tgpt.init_params(tcfg, torch.Generator().manual_seed(9),
                           device="cpu")
    engine.set_params(params_to_numpy(new), version=1)
    st = engine.stats()
    assert st["prefix"]["registered_pages"] == 0
    assert st["prefix"]["idle_pages"] == 0
    (toks,), (lps,) = engine.generate([prompt], max_new_tokens=4,
                                      return_logprobs=True)
    assert engine.stats()["prefix"]["requests_hit"] == 0
    full = torch.tensor([prompt + toks[:-1]])
    with torch.no_grad():
        logits, _ = tgpt.forward(new, full, tcfg)
    rows = logits[0, len(prompt) - 1:len(prompt) - 1 + len(toks)]
    ref = torch.log_softmax(rows, -1)
    assert toks == rows.argmax(-1).tolist()
    np.testing.assert_allclose(lps, [float(ref[i, t]) for i, t in
                                     enumerate(toks)], rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------ the queue
def _traj(version, pkg="port"):
    if pkg == "port":
        from ray_tpu_torch.rl.rollout import TrajectoryBatch
    else:
        from ray_tpu.rl.rollout import TrajectoryBatch
    z = np.zeros((1, 2), np.int32)
    return TrajectoryBatch(tokens=z, targets=z,
                           rewards=np.zeros(1, np.float32), logprobs=[[]],
                           completions=[[]], param_version=version)


def test_replay_queue_staleness_and_overflow():
    from ray_tpu_torch.rl import ReplayQueue
    q = ReplayQueue(2, max_lag=1, overflow="drop")
    assert q.put(_traj(1)) and q.put(_traj(2))
    assert q.put(_traj(3)) and len(q) == 2
    assert q.drops_overflow == 1
    got = q.pop(current_version=4)
    assert got is not None and got.param_version == 3
    assert q.drops_stale == 1
    assert q.pop(4) is None
    w = ReplayQueue(1, max_lag=0, overflow="wait", put_timeout=0)
    assert w.put(_traj(1))
    assert not w.put(_traj(2))
    assert w.drops_overflow == 0 and len(w) == 1
    assert w.pop(2) is None
    assert w.drops_stale == 1
    assert w.drain() == []
    with pytest.raises(ValueError):
        ReplayQueue(0)
    with pytest.raises(ValueError):
        ReplayQueue(1, overflow="sometimes")
    with pytest.raises(ValueError):
        ReplayQueue(1, max_lag=-1)


def test_replay_queue_staleness_fuzz():
    """Random publish/put/pop interleavings through the port's queue and
    the reference's side by side: the same pops, the same counters; the
    learner never sees a batch more than max_lag publications old, and
    every put is accounted for."""
    from ray_tpu.rl import ReplayQueue as JQueue
    from ray_tpu_torch.rl import ReplayQueue
    rng = np.random.RandomState(7)
    for max_lag in (0, 1, 3):
        for overflow in ("drop", "wait"):
            q = ReplayQueue(3, max_lag=max_lag, overflow=overflow,
                            put_timeout=0)
            j = JQueue(3, max_lag=max_lag, overflow=overflow,
                       put_timeout=0)
            version, trained = 1, 0
            for _ in range(400):
                op = rng.rand()
                if op < 0.4:
                    assert q.put(_traj(version)) == \
                        j.put(_traj(version, "ref"))
                elif op < 0.7:
                    a, b = q.pop(version), j.pop(version)
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert a.param_version == b.param_version
                        assert a.param_version >= version - max_lag
                        trained += 1
                else:
                    version += 1
                assert len(q) == len(j) <= 3
            for name in ("puts", "pops", "drops_stale", "drops_overflow",
                         "backpressure_rejections"):
                assert getattr(q, name) == getattr(j, name), name
            leftover = len(q.drain())
            assert q.puts == (trained + q.drops_stale + q.drops_overflow
                              + leftover)


# ------------------------------------------------------------- rollouts
def test_greedy_rollouts_match_reference(tiny_rl):
    """Greedy rollout actors on both sides: token-equal completions, the
    same batch arrays and rewards, logprobs within 1e-5; the port's
    logprobs are the teacher-forced ``log_softmax`` of its forward."""
    from ray_tpu.rl import RolloutActor as JActor
    from ray_tpu.rl import target_token_reward as jreward
    from ray_tpu_torch.rl import RolloutActor, target_token_reward
    jcfg, jparams, tcfg, tparams = tiny_rl
    rng = np.random.RandomState(4)
    prompts = [list(rng.randint(0, 128, n)) for n in (4, 4, 7, 2)]
    kw = dict(horizon=8, seq_len=16, seed=5)
    ja = JActor(jcfg, jparams, temperature=0.0,
                engine_kwargs={**_KW, "executable_cache": _JAX_EXEC})
    ta = RolloutActor(tcfg, tparams, temperature=0.0, engine_kwargs=_KW,
                      device="cpu")
    jb = ja.rollout(prompts, reward_fn=jreward(7), **kw)
    tb = ta.rollout(prompts, reward_fn=target_token_reward(7), **kw)
    assert tb.completions == jb.completions
    for k in ("tokens", "targets", "rewards"):
        np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k))
    for a, b in zip(tb.logprobs, jb.logprobs):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    assert tb.gen_tokens == jb.gen_tokens == 4 * 8
    assert ta.idle() and tb.param_version == 0
    with torch.no_grad():
        logits, _ = tgpt.forward(tparams, torch.from_numpy(
            tb.tokens).long(), tcfg)
    logp = torch.log_softmax(logits, -1)
    for b, p in enumerate(prompts):
        got = [float(logp[b, len(p) - 1 + i, t])
               for i, t in enumerate(tb.completions[b])]
        np.testing.assert_allclose(tb.logprobs[b], got, atol=1e-5)


# --------------------------------------------------------------- replay
def test_replay_parity_with_reference_loop(tiny_rl, monkeypatch):
    """The reference loop's own trajectory batches, recorded as its
    rollout actor makes them, train a port learner started at the
    reference learner's state (``rl_state_from_jax``): over 6 steps
    ``pg_loss``, ``logp_mean``, ``entropy`` and ``grad_norm`` within 1e-5
    relative of the reference's, the final params within 1e-4 of each
    leaf's largest value."""
    from ray_tpu.rl import RLConfig as JRLConfig
    from ray_tpu.rl import InProcessLearner as JLearner
    from ray_tpu.rl import run_rl_loop as jrun
    from ray_tpu.rl import rollout as jrollout
    from ray_tpu_torch.rl import InProcessLearner
    jcfg, _jp, tcfg, _tp = tiny_rl
    recorded = []
    real = jrollout.RolloutActor.rollout

    def record(self, *a, **k):
        out = real(self, *a, **k)
        recorded.append(out.as_learner_batch())
        return out

    monkeypatch.setattr(jrollout.RolloutActor, "rollout", record)
    rlcfg = JRLConfig(actors=1, batch=6, horizon=8, queue=4, max_lag=1,
                      overflow="drop", publish_every=1, baseline="rloo",
                      temperature=1.0)
    # lr 1e-3: Adam moves a parameter whose gradient is ~0 by up to lr
    # times ~|g| / eps in a direction set by the last bits of g, so over
    # 6 steps the two sides' summation orders part such parameters by
    # ~lr / 100; at 1e-3 that stays inside the 1e-4 bound
    steps, seed, lr = 6, 3, 1e-3
    res = jrun(jcfg, steps=steps, rlcfg=rlcfg, seed=seed, lr=lr,
               engine_kwargs={**_KW, "executable_cache": _JAX_EXEC},
               telemetry=False)
    assert res["drops_stale"] == res["drops_overflow"] == 0
    assert len(recorded) >= steps
    start = JLearner(jcfg, lr=lr, seed=seed).state_host()
    learner = InProcessLearner(tcfg, lr=lr, seed=seed, device="cpu")
    learner.load_state(rl_state_from_jax(start, tcfg, device="cpu"))
    for i, (batch, want) in enumerate(zip(recorded, res["history"])):
        got = learner.update(batch)
        for k in ("pg_loss", "logp_mean", "entropy", "grad_norm",
                  "reward_mean", "reward_max", "action_tokens"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), (i, k)
        assert got["step"] == want["step"] == i + 1
    final = res["learner"].state.params
    _close_tree(params_to_numpy(learner.state.params),
                jax.tree.map(np.asarray, final), 1e-4, "params")
    assert learner.steps == steps


# --------------------------------------------------------------- the loop
def test_rl_loop_reward_improves_end_to_end(tiny_rl):
    """The port's own loop: REINFORCE/RLOO through engine rollouts, the
    policy-gradient learner, versioned publications and the bounded
    queue improves the programmatic reward across thirds of the run, the
    reference's bar.  Its sampler's draws are not the reference's, so
    the bar is held over seeds 0-5 of the reference test's setting: a
    run whose first rollouts hit the target token once or never can
    stay flat for 8 steps (the reference's own loop meets the bar on 4
    of these 6 seeds: 0, 2, 3 and 5), and the port must meet it on at
    least as many.  Every run keeps staleness within its bound,
    publishes every step and drains its engines clean."""
    from ray_tpu_torch.rl import RLConfig, run_rl_loop
    _j, _jp, tcfg, _tp = tiny_rl
    rlcfg = RLConfig(actors=2, batch=6, horizon=8, queue=4, max_lag=1,
                     overflow="drop", publish_every=1, baseline="rloo",
                     temperature=1.0)
    improved = []
    for seed in range(6):
        res = run_rl_loop(tcfg, steps=8, rlcfg=rlcfg, seed=seed, lr=5e-2,
                          engine_kwargs=dict(_KW), device="cpu")
        curve = np.array(res["reward_curve"])
        thirds = [t.mean() for t in np.array_split(curve, 3)]
        if thirds[0] < thirds[1] < thirds[2] and curve[-1] > curve[0]:
            improved.append(seed)
        assert all(h["param_version_lag"] <= rlcfg.max_lag
                   for h in res["history"])
        assert res["telemetry"]["version_lag_max"] <= rlcfg.max_lag
        assert res["publishes"] >= res["steps"] + 1
        for stats in res["engine_stats"]:
            assert stats["param_version"] >= 1
        assert res["leftover_batches"] == 0
        for eng in res["actors"]:
            assert not eng.scheduler.active and not eng.scheduler.waiting
            assert eng.leak_free()
    assert len(improved) >= 4, improved


@pytest.mark.slow
def test_rl_loop_staleness_drops_over_lag_batches(tiny_rl):
    """max_lag=0 with three actor replicas racing one learner: the later
    replicas' batches go stale mid-round and are dropped, never
    trained."""
    from ray_tpu_torch.rl import RLConfig, run_rl_loop
    _j, _jp, tcfg, _tp = tiny_rl
    rlcfg = RLConfig(actors=3, batch=2, horizon=4, queue=4, max_lag=0,
                     overflow="drop", publish_every=1, baseline="rloo",
                     temperature=1.0)
    res = run_rl_loop(tcfg, steps=4, rlcfg=rlcfg, seed=11, lr=1e-3,
                      engine_kwargs=dict(_KW), device="cpu")
    assert res["drops_stale"] > 0
    assert all(h["param_version_lag"] == 0 for h in res["history"])
    assert res["telemetry"]["drops"]["stale"] == res["drops_stale"]
    assert res["leftover_batches"] <= rlcfg.actors


@pytest.mark.slow
def test_rl_loop_wait_policy_backpressure(tiny_rl):
    """overflow="wait" end to end: a full queue rejects the put, the
    actor holds the batch and re-enqueues it once the learner drains;
    every rollout is trained, dropped for staleness or handed back."""
    from ray_tpu_torch.rl import RLConfig, run_rl_loop
    _j, _jp, tcfg, _tp = tiny_rl
    rlcfg = RLConfig(actors=2, batch=2, horizon=4, queue=1, max_lag=8,
                     overflow="wait", publish_every=1, baseline="rloo",
                     temperature=1.0)
    res = run_rl_loop(tcfg, steps=3, rlcfg=rlcfg, seed=13, lr=1e-3,
                      engine_kwargs=dict(_KW), device="cpu")
    assert res["steps"] == 3 and res["drops_overflow"] == 0
    tel = res["telemetry"]
    assert tel["backpressure_rejections"] > 0
    assert tel["rollouts"] == (res["steps"] + res["drops_stale"]
                               + res["leftover_batches"])


@pytest.mark.slow
def test_gpt_policy_learner_protocol(tiny_rl):
    """The LearnerGroup-hosted learner class driven directly:
    init_state/update move params and report the metric schema."""
    from ray_tpu_torch.rl import GPTPolicyLearner, RLLearnerConfig
    from ray_tpu_torch.rl.rollout import trajectories_to_batch
    _j, _jp, tcfg, _tp = tiny_rl
    learner = GPTPolicyLearner(tcfg, RLLearnerConfig(lr=1e-2, seed=0,
                                                     device="cpu"))
    params, opt_state = learner.init_state(torch.Generator().manual_seed(0))
    arrays = trajectories_to_batch([[1, 2, 3]] * 4,
                                   [[4, 5], [6, 7], [8, 9], [4, 4]],
                                   seq_len=8)
    batch = {**arrays, "rewards": np.array([1, 0, 0, 2], np.float32)}
    p0 = {k: v.copy() for k, v in params_to_numpy(params)["layers"].items()}
    params, opt_state, metrics = learner.update(params, opt_state, batch)
    for key in ("pg_loss", "reward_mean", "entropy", "total_loss",
                "logp_mean"):
        assert np.isfinite(metrics[key]), (key, metrics)
    moved = params_to_numpy(params)
    assert max(float(np.max(np.abs(moved["layers"][k] - p0[k])))
               for k in p0) > 0


# ----------------------------------------------------------- the group
@pytest.fixture
def port_session():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=3)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_learner_group_two_cpu_learners_match_one(tiny_rl, port_session):
    """Two CPU learner actors on the host ring: after 2 updates both
    hold the same params, equal (within 1e-5 of each leaf's largest
    value) to one in-process learner's 2 updates on the full batches;
    the loss and reward metrics agree, and publish_params versions the
    snapshot.  The
    group's default ``learner_cls`` is the reference's, PPO: it builds a
    PPO learner actor whose params are the module's tree."""
    from ray_tpu_torch.rl import InProcessLearner, LearnerGroupAdapter
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
    from ray_tpu_torch.rllib.core.rl_module import (DiscreteMLPModule,
                                                    MLPModuleConfig)
    _j, _jp, tcfg, _tp = tiny_rl
    ppo = LearnerGroup(DiscreteMLPModule(MLPModuleConfig()),
                       PPOConfig(device="cpu"), num_learners=1)
    try:
        got = ppo.get_params()
        assert set(got) == {"layers", "pi", "vf"}
        assert tuple(got["pi"]["w"].shape) == (64, 2)
    finally:
        ppo.stop()
    group = LearnerGroupAdapter(tcfg, num_learners=2, lr=1e-2, seed=4,
                                device="cpu")
    solo = InProcessLearner(tcfg, lr=1e-2, seed=4, device="cpu")
    try:
        for seed in (1, 2):
            batch = _pg_batch(seed=seed, B=6, S=16)
            got, want = group.update(batch), solo.update(batch)
            # (logp_mean and entropy are per-shard means averaged over the
            # learners, as the reference's group reports them)
            for k in ("pg_loss", "reward_mean", "reward_max"):
                assert got[k] == pytest.approx(want[k], rel=1e-5,
                                               abs=1e-6), k
        a, b = (params_to_numpy(p) for p in group.group.get_all_params())
        _close_tree(a, b, 0.0, "rank 1 vs rank 0")
        _close_tree(a, params_to_numpy(solo.state.params), 1e-4, "solo")
        v1, ref = group.publish_ref()
        assert v1 == 1 and group.publish_ref()[0] == 2
        _close_tree(params_to_numpy(port_session.get(ref, timeout=60)), a,
                    0.0, "published")
    finally:
        group.stop()


@pytest.mark.slow
def test_rl_loop_on_learner_group(tiny_rl, port_session):
    """The learner group as the loop's learner host (num_learners=2):
    trajectory batches shard across learner actors, gradients allreduce,
    snapshots publish through the object store.  Started from the same
    params and seeds, the group-hosted loop draws the in-process loop's
    trajectories: the same reward curve, and the learner metrics within
    1e-5 relative (the loss) at every step."""
    from ray_tpu_torch.rl import RLConfig, run_rl_loop
    _j, _jp, tcfg, _tp = tiny_rl
    rlcfg = RLConfig(actors=1, batch=6, horizon=8, queue=4, max_lag=1,
                     overflow="drop", publish_every=1, baseline="rloo",
                     temperature=1.0)
    kw = dict(steps=4, rlcfg=rlcfg, seed=3, lr=5e-2,
              engine_kwargs=dict(_KW), device="cpu")
    res = run_rl_loop(tcfg, num_learners=2, **kw)
    solo = run_rl_loop(tcfg, **kw)
    assert res["steps"] == 4 and res["param_version"] >= 5
    assert res["reward_curve"] == solo["reward_curve"]
    for got, want in zip(res["history"], solo["history"]):
        assert got["pg_loss"] == pytest.approx(want["pg_loss"], rel=1e-5,
                                               abs=1e-6)
    assert res["leftover_batches"] == 0


# -------------------------------------------------------------- telemetry
def test_rl_telemetry_summary():
    """The RL recorder's summary block for the same record calls as the
    reference's (``tests/test_telemetry.py::test_rl_telemetry_summary``):
    the same keys and values, and the disabled no-op."""
    from ray_tpu.telemetry import RLTelemetry as JTel
    from ray_tpu.telemetry.config import TelemetryConfig as JConfig
    from ray_tpu_torch.telemetry import RLTelemetry, TelemetryConfig

    def drive(tel):
        for i in range(3):
            tel.record_rollout(0.1, tokens=50, param_version=i + 1)
        tel.record_learner_step(1.0, version_lag=0)      # cold start
        tel.record_learner_step(0.01, version_lag=0)
        tel.record_learner_step(0.01, version_lag=2)
        for v in (1, 2, 3, 4):
            tel.record_publish(0.002, version=v)
        tel.record_backpressure()
        tel.record_actor_restart()
        tel.record_actor_restart()
        tel.record_learner_restart()
        tel.record_queue_counters(drops_stale=5, drops_overflow=1)
        return tel.summary()

    out = drive(RLTelemetry(config=TelemetryConfig(enabled=True)))
    ref = drive(JTel(config=JConfig(enabled=True)))
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        assert out[k] == (pytest.approx(v) if isinstance(v, float) else v), k
    assert out["rollout_tokens_per_sec"] == pytest.approx(500.0)
    assert out["learner_steps_per_sec"] == pytest.approx(100.0)
    assert out["drops"] == {"stale": 5, "overflow": 1}
    off = RLTelemetry(config=TelemetryConfig(enabled=False))
    off.record_rollout(0.1, tokens=1, param_version=1)
    off.record_actor_restart()
    assert off.summary() == {"enabled": False}


# -------------------------------------------------------- prompt datasets
def _docs(pkg, vocab=64, shards=3, docs=20):
    if pkg == "port":
        from ray_tpu_torch.data import SyntheticDocs
    else:
        from ray_tpu.data import SyntheticDocs
    return SyntheticDocs(7, num_shards=shards, docs_per_shard=docs,
                         vocab=vocab, min_len=3, max_len=12)


def test_prompt_dataset_matches_reference_and_resumes():
    """``PromptDataset`` draws the reference's prompts row for row from
    the same document source (short documents skipped alike), its cursor
    round-trips to the same continuation, and the loud refusals hold."""
    from ray_tpu.rl.rollout import PromptDataset as JPrompts
    from ray_tpu_torch.rl.rollout import PromptDataset
    a = PromptDataset(_docs("port"), prompt_len=4, readers=0)
    j = JPrompts(_docs("ref"), prompt_len=4, readers=0)
    first, second = a.next_prompts(5), a.next_prompts(7)
    assert first == j.next_prompts(5) and second == j.next_prompts(7)
    assert all(len(p) == 4 for p in first + second)
    assert a.skipped_short == j.skipped_short
    np.testing.assert_array_equal(a.cursor_array(), j.cursor_array())
    b = PromptDataset(_docs("port"), prompt_len=4, readers=0)
    assert b.next_prompts(5) == first
    c = PromptDataset(_docs("port"), prompt_len=4, cursor=b.cursor_array(),
                      readers=0)
    assert c.next_prompts(7) == second
    with pytest.raises(ValueError, match="geometry mismatch"):
        PromptDataset(_docs("port"), prompt_len=9, cursor=b.cursor_array())
    with pytest.raises(ValueError, match="no document"):
        PromptDataset(_docs("port"), prompt_len=99,
                      readers=0).next_prompts(1)


def test_rl_loop_draws_prompts_from_source(tiny_rl):
    """``run_rl_loop(prompt_source=...)`` feeds the rollout actors from
    the document schedule and returns the prompt cursor, which resumes
    the schedule where the run left it."""
    from ray_tpu_torch.data import StreamCursor
    from ray_tpu_torch.rl import RLConfig, run_rl_loop
    from ray_tpu_torch.rl.rollout import PromptDataset
    _j, _jp, tcfg, _tp = tiny_rl
    rlcfg = RLConfig(actors=1, batch=2, horizon=4, queue=2, max_lag=2,
                     overflow="drop", publish_every=1, baseline="rloo",
                     temperature=1.0)
    out = run_rl_loop(tcfg, steps=2, rlcfg=rlcfg,
                      prompt_source=_docs("port", vocab=128, shards=2,
                                          docs=16),
                      prompt_len=4, seed=3, lr=1e-2,
                      engine_kwargs={"slots": 2, "page_size": 16,
                                     "buckets": (16,), "telemetry": False},
                      telemetry=False, device="cpu")
    assert out["steps"] == 2
    cur = StreamCursor.from_array(out["prompt_cursor"])
    assert cur.docs >= 2 * rlcfg.batch
    ref = PromptDataset(_docs("port", vocab=128, shards=2, docs=16),
                        prompt_len=4, readers=0)
    ref.next_prompts(2 * rlcfg.batch)
    resumed = PromptDataset(_docs("port", vocab=128, shards=2, docs=16),
                            prompt_len=4, cursor=out["prompt_cursor"],
                            readers=0)
    assert resumed.next_prompts(3) == ref.next_prompts(3)
