"""Port counterparts of ``tests/test_rllib.py``: ``ray_tpu_torch.rllib``
held against the JAX package's ``ray_tpu.rllib`` on the CPU.

Both sides get the same inputs: the reference's ``init_params`` cross
over through ``convert.rl_module_params_from_jax``, and batches, actions
and the SAC update's noise are numpy arrays made from a seed (the port's
draws are a ``torch.Generator``'s, not ``jax.random``'s, so nothing
sampled is compared).  Tolerances, all f32:

- ``_compute_gae``: bit-equal to the reference's and to the hand values;
- ``vtrace_targets``: within 1e-6 of the reference's and of a numpy loop;
- the modules' forward passes: within 1e-6;
- one PPO, DQN, BC, IMPALA and SAC update: the metrics within 1e-5
  relative, every parameter after the update within 1e-5 of its leaf's
  largest value;
- env runners with fed actions: observations, rewards, terminations and
  episode returns equal; the logp and values within 1e-5 relative (a
  value head of std 1 gives values near 4, where f32 summation order
  moves the last digits).

The learning tests are the reference's, with its ``slow`` mark and its
thresholds, on the port's own runs, ``test_ppo_in_tune`` among them
(``PPO.as_trainable`` under ``tune.run``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.convert import rl_module_params_from_jax

def _port(tree):
    return rl_module_params_from_jax(jax.tree.map(np.asarray, tree),
                                     device="cpu")


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    """A port tree's leaves as numpy, in ``jax.tree.leaves``' order."""
    return _leaves(jax.tree.map(lambda t: t.detach().numpy(), tree))


def _close_params(got, want, what, rel=1e-5):
    g, w = _port_leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (what, i)
        bound = rel * max(float(np.max(np.abs(b))), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=bound,
                                   err_msg=f"{what}: leaf {i}")


def _close_metrics(got, want, what, rel=1e-5, atol=1e-7):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rel,
                                   atol=atol, err_msg=f"{what}: {k}")


def _ppo_batch(seed, n=256, obs_dim=4, num_actions=2):
    rng = np.random.default_rng(seed)
    adv = rng.standard_normal(n).astype(np.float32)
    values = rng.standard_normal(n).astype(np.float32)
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, num_actions, n).astype(np.int64),
            "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
            "values": values, "advantages": adv,
            "value_targets": (adv + values).astype(np.float32)}


# ---------------------------------------------------------------------------
# the reference's tier-1 tests
# ---------------------------------------------------------------------------

def test_gae_computation():
    from ray_tpu.rllib.algorithms.ppo import _compute_gae as ref_gae
    from ray_tpu_torch.rllib.algorithms.ppo import _compute_gae
    batch = {
        "rewards": np.array([1.0, 1.0, 1.0], np.float32),
        "values": np.array([0.5, 0.5, 0.5], np.float32),
        "terminateds": np.array([0.0, 0.0, 1.0], np.float32),
        "bootstrap_value": np.float32(0.0),
    }
    out = _compute_gae(batch, gamma=1.0, lam=1.0)
    np.testing.assert_allclose(out["advantages"], [2.5, 1.5, 0.5])
    np.testing.assert_allclose(out["value_targets"], [3.0, 2.0, 1.0])
    rng = np.random.default_rng(0)
    T = 64
    batch = {"rewards": rng.standard_normal(T).astype(np.float32),
             "values": rng.standard_normal(T).astype(np.float32),
             "terminateds": (rng.random(T) < 0.1).astype(np.float32),
             "bootstrap_value": np.float32(0.7)}
    got, want = _compute_gae(batch, 0.99, 0.95), ref_gae(batch, 0.99, 0.95)
    for k in ("advantages", "value_targets"):
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


def test_vtrace_matches_numpy_reference():
    """V-trace recursion against the reference's (within 1e-6) and a
    straightforward numpy loop (the reference test's 1e-4)."""
    from ray_tpu.rllib.algorithms.impala import vtrace_targets as ref_vt
    from ray_tpu_torch.rllib.algorithms.impala import vtrace_targets

    rng = np.random.default_rng(0)
    B, T = 3, 7
    gamma, rho_clip, c_clip = 0.9, 1.0, 1.0
    behavior = rng.normal(size=(B, T)).astype(np.float32)
    target = behavior + rng.normal(scale=0.3, size=(B, T)).astype(
        np.float32)
    rewards = rng.normal(size=(B, T)).astype(np.float32)
    dones = (rng.random((B, T)) < 0.15).astype(np.float32)
    values = rng.normal(size=(B, T)).astype(np.float32)
    boot = rng.normal(size=(B,)).astype(np.float32)
    args = (behavior, target, rewards, dones, values, boot)

    vs, pg = vtrace_targets(*map(torch.from_numpy, args), gamma=gamma,
                            rho_clip=rho_clip, c_clip=c_clip)
    vs, pg = vs.numpy(), pg.numpy()
    jvs, jpg = jax.jit(lambda *a: ref_vt(
        *a, gamma=gamma, rho_clip=rho_clip, c_clip=c_clip))(*args)
    np.testing.assert_allclose(vs, np.asarray(jvs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pg, np.asarray(jpg), rtol=1e-6, atol=1e-6)
    for b in range(B):
        rho = np.minimum(np.exp(target[b] - behavior[b]), rho_clip)
        c = np.minimum(np.exp(target[b] - behavior[b]), c_clip)
        nv = np.concatenate([values[b, 1:], boot[b:b + 1]])
        nt = 1.0 - dones[b]
        delta = rho * (rewards[b] + gamma * nv * nt - values[b])
        acc = 0.0
        vmv = np.zeros(T)
        for t in reversed(range(T)):
            acc = delta[t] + gamma * c[t] * nt[t] * acc
            vmv[t] = acc
        vs_ref = values[b] + vmv
        vs_next = np.concatenate([vs_ref[1:], boot[b:b + 1]])
        pg_ref = rho * (rewards[b] + gamma * vs_next * nt - values[b])
        np.testing.assert_allclose(vs[b], vs_ref, rtol=1e-4)
        np.testing.assert_allclose(pg[b], pg_ref, rtol=1e-4)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_modules_forward_match_reference():
    """``DiscreteMLPModule``, ``SquashedGaussianModule`` (distribution
    parameters, a sample with the reference's noise, the deterministic
    action) and ``TwinQModule`` on the reference's params: within 1e-6.
    The port's own init has the reference's structure, shapes and
    scales (zero biases, the heads' std near their ``out_scale``)."""
    from ray_tpu.rllib.core import rl_module as ref
    from ray_tpu_torch.rllib.core import rl_module as port

    rng = np.random.default_rng(1)
    obs = rng.standard_normal((16, 4)).astype(np.float32)
    jm = ref.DiscreteMLPModule(ref.MLPModuleConfig(hidden=(32, 32)))
    tm = port.DiscreteMLPModule(port.MLPModuleConfig(hidden=(32, 32)))
    jp = jm.init_params(jax.random.PRNGKey(0))
    logits, value = tm.forward(_port(jp), torch.from_numpy(obs))
    jl, jv = jm.forward(jp, obs)
    np.testing.assert_allclose(logits.numpy(), jl, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(value.numpy(), jv, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.action_dist(logits).numpy(),
                               jm.action_dist(jl), rtol=1e-6, atol=1e-6)
    own = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.init_params(torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), own))
    for a, b in zip(_port_leaves(own), _leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert abs(float(own["pi"]["w"].std()) - 0.01) < 0.004
    assert not own["vf"]["b"].any()

    ccfg = dict(obs_dim=3, act_dim=2, act_low=(-2.0, -1.0),
                act_high=(2.0, 3.0), hidden=(32, 32))
    ja = ref.SquashedGaussianModule(ref.ContinuousModuleConfig(**ccfg))
    ta = port.SquashedGaussianModule(port.ContinuousModuleConfig(**ccfg))
    jq = ref.TwinQModule(ref.ContinuousModuleConfig(**ccfg))
    tq = port.TwinQModule(port.ContinuousModuleConfig(**ccfg))
    jap, jqp = ja.init_params(jax.random.PRNGKey(1)), \
        jq.init_params(jax.random.PRNGKey(2))
    cobs = rng.standard_normal((16, 3)).astype(np.float32)
    tobs = torch.from_numpy(cobs)
    for got, want in zip(ta.dist_params(_port(jap), tobs),
                         ja.dist_params(jap, cobs)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (16, 2)))
    act, logp = ta.sample(_port(jap), tobs, eps=torch.from_numpy(eps.copy()))
    jact, jlogp = ja.sample(jap, cobs, key)
    np.testing.assert_allclose(act.numpy(), jact, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), jlogp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ta.deterministic(_port(jap), tobs).numpy(),
                               ja.deterministic(jap, cobs), rtol=1e-6,
                               atol=1e-6)
    q1, q2 = tq.forward(_port(jqp), tobs, act)
    jq1, jq2 = jq.forward(jqp, cobs, jact)
    np.testing.assert_allclose(q1.detach().numpy(), jq1, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(q2.detach().numpy(), jq2, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# learners on fed batches
# ---------------------------------------------------------------------------

def test_ppo_update_matches_reference():
    """One ``PPOLearner.update`` (2 epochs of 2 minibatches, the
    reference's permutations) from the reference's params: the last
    minibatch's metrics and every parameter afterwards."""
    from ray_tpu.rllib.algorithms.ppo import PPOConfig as JCfg
    from ray_tpu.rllib.algorithms.ppo import PPOLearner as JLearner
    from ray_tpu.rllib.core import rl_module as ref
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core import rl_module as port

    kw = dict(num_sgd_epochs=2, minibatch_size=128, lr=3e-4, grad_clip=0.5)
    jl = JLearner(ref.DiscreteMLPModule(ref.MLPModuleConfig()), JCfg(**kw))
    tl = PPOLearner(port.DiscreteMLPModule(port.MLPModuleConfig()),
                    PPOConfig(**kw, device="cpu"))
    jp, jo = jl.init_state(jax.random.PRNGKey(0))
    params = _port(jp)
    opt = tl.tx.init(params)
    batch = _ppo_batch(2)
    jp, jo, jm = jl.update(jp, jo, batch)
    params, opt, m = tl.update(params, opt, batch)
    _close_metrics(m, jm, "ppo")
    _close_params(params, jp, "ppo")
    assert opt.count == 4


def test_ppo_normalises_advantages_with_the_population_std():
    """``jnp.std`` is ddof 0: on a minibatch of 2 rows the unbiased std
    would halve the surrogate's scale; the port's loss equals the
    reference's there."""
    from ray_tpu.rllib.algorithms.ppo import PPOConfig as JCfg
    from ray_tpu.rllib.algorithms.ppo import PPOLearner as JLearner
    from ray_tpu.rllib.core import rl_module as ref
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core import rl_module as port
    from ray_tpu_torch.rllib.core.learner import batch_to

    kw = dict(num_sgd_epochs=1, minibatch_size=2, entropy_coeff=0.0,
              vf_coeff=0.0)
    jl = JLearner(ref.DiscreteMLPModule(ref.MLPModuleConfig()), JCfg(**kw))
    tl = PPOLearner(port.DiscreteMLPModule(port.MLPModuleConfig()),
                    PPOConfig(**kw, device="cpu"))
    jp, jo = jl.init_state(jax.random.PRNGKey(5))
    batch = _ppo_batch(3, n=2)
    grads, jm = jl._grad(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tl.grad(_port(jp), batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(tm["policy_loss"]),
                               float(jm["policy_loss"]), rtol=1e-5)


def test_dqn_update_matches_reference():
    """One double-DQN ``_update`` with a target network that differs from
    the online one: its metrics and the online params afterwards."""
    from ray_tpu.rllib.algorithms.dqn import DQNConfig as JCfg
    from ray_tpu.rllib.algorithms.dqn import DQNLearner as JLearner
    from ray_tpu.rllib.core import rl_module as ref
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, DQNLearner
    from ray_tpu_torch.rllib.core import rl_module as port

    for double_q in (True, False):
        jl = JLearner(ref.DiscreteMLPModule(ref.MLPModuleConfig()),
                      JCfg(double_q=double_q))
        tl = DQNLearner(port.DiscreteMLPModule(port.MLPModuleConfig()),
                        DQNConfig(double_q=double_q, device="cpu"))
        jp, jo = jl.init_state(jax.random.PRNGKey(0))
        jt, _ = jl.init_state(jax.random.PRNGKey(1))
        params, target = _port(jp), _port(jt)
        opt = tl.tx.init(params)
        rng = np.random.default_rng(4)
        n = 64
        batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
                 "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, n).astype(np.int64),
                 "rewards": (rng.random(n) * 2).astype(np.float32),
                 "terminateds": (rng.random(n) < 0.2).astype(np.float32)}
        for _ in range(2):
            jp, jo, jm = jl._update(jp, jt, jo, batch)
            params, opt, m = tl.update(params, target, opt, batch)
        _close_metrics(m, jm, f"dqn double_q={double_q}")
        _close_params(params, jp, f"dqn double_q={double_q}")


def test_bc_update_matches_reference():
    """One BC step: the reference's ``BC._update`` (built over a stub
    dataset) against :class:`BCLearner` from the same params."""
    import pyarrow as pa

    from ray_tpu.rllib.algorithms.bc import BC as JBC
    from ray_tpu.rllib.algorithms.bc import BCConfig as JCfg
    from ray_tpu_torch.rllib.algorithms.bc import BCConfig, BCLearner
    from ray_tpu_torch.rllib.core import rl_module as port

    rng = np.random.default_rng(6)
    obs = rng.standard_normal((96, 4)).astype(np.float32)
    actions = rng.integers(0, 2, 96).astype(np.int64)

    class _Rows:
        def to_arrow(self):
            return pa.table({"obs": [o.tolist() for o in obs],
                             "actions": actions.tolist()})

    jbc = JBC(JCfg(), _Rows())
    tl = BCLearner(port.DiscreteMLPModule(port.MLPModuleConfig()),
                   BCConfig(device="cpu"))
    params = _port(jbc.params)
    opt = tl.tx.init(params)
    jp, jo = jbc.params, jbc.opt_state
    for _ in range(2):
        jp, jo, jloss, jacc = jbc._update(jp, jo, obs, actions)
        params, opt, loss, acc = tl.update(params, opt, obs, actions)
    _close_metrics({"loss": loss, "action_accuracy": acc},
                   {"loss": jloss, "action_accuracy": jacc}, "bc")
    _close_params(params, jp, "bc")
    np.testing.assert_array_equal(tl.act(params, obs).numpy(),
                                  np.asarray(jbc._act(jp, obs)))


def test_impala_update_matches_reference():
    """One V-trace step on a stacked [4, 16] segment batch with off-policy
    behaviour logps: the metrics and the params after the clipped
    RMSProp update."""
    from ray_tpu.rllib.algorithms.impala import IMPALAConfig as JCfg
    from ray_tpu.rllib.algorithms.impala import IMPALALearner as JLearner
    from ray_tpu.rllib.algorithms.impala import \
        stack_segments as ref_stack
    from ray_tpu.rllib.core import rl_module as ref
    from ray_tpu_torch.rllib.algorithms.impala import (IMPALAConfig,
                                                       IMPALALearner,
                                                       stack_segments)
    from ray_tpu_torch.rllib.core import rl_module as port

    rng = np.random.default_rng(7)
    T = 16
    segs = [{"obs": rng.standard_normal((T, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, T).astype(np.int64),
             "logp": np.log(rng.uniform(0.2, 0.8, T)).astype(np.float32),
             "values": rng.standard_normal(T).astype(np.float32),
             "rewards": np.ones(T, np.float32),
             "terminateds": (rng.random(T) < 0.1).astype(np.float32),
             "bootstrap_value": np.float32(rng.standard_normal())}
            for _ in range(4)]
    batch = stack_segments(segs)
    want = ref_stack(segs)
    assert batch.keys() == want.keys()
    for k in batch:
        np.testing.assert_array_equal(batch[k], want[k])
    kw = dict(lr=5e-3, grad_clip=0.5)
    jl = JLearner(ref.DiscreteMLPModule(ref.MLPModuleConfig()), JCfg(**kw))
    tl = IMPALALearner(port.DiscreteMLPModule(port.MLPModuleConfig()),
                       IMPALAConfig(**kw, device="cpu"))
    jp, jo = jl.init_state(jax.random.PRNGKey(0))
    params = _port(jp)
    opt = tl.tx.init(params)
    for _ in range(2):
        jp, jo, jm = jl.update(jp, jo, batch)
        params, opt, m = tl.update(params, opt, batch)
    _close_metrics(m, jm, "impala")
    _close_params(params, jp, "impala")


def test_sac_update_matches_reference_with_fed_noise():
    """One SAC update (critics, actor, alpha, polyak) twice, with the
    reference's reparameterisation noise fed in: the metrics, and the
    actor, critic, target critic and log alpha afterwards."""
    from ray_tpu.rllib.algorithms.sac import SACConfig as JCfg
    from ray_tpu.rllib.algorithms.sac import SACLearner as JLearner
    from ray_tpu.rllib.core import rl_module as ref
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig, SACLearner
    from ray_tpu_torch.rllib.core import rl_module as port

    ccfg = dict(obs_dim=3, act_dim=1, act_low=(-2.0,), act_high=(2.0,),
                hidden=(32, 32))
    kw = dict(actor_lr=1e-3, critic_lr=1e-3, alpha_lr=1e-3)
    jl = JLearner(ref.SquashedGaussianModule(ref.ContinuousModuleConfig(
        **ccfg)), ref.TwinQModule(ref.ContinuousModuleConfig(**ccfg)),
        JCfg(**kw))
    tl = SACLearner(port.SquashedGaussianModule(
        port.ContinuousModuleConfig(**ccfg)),
        port.TwinQModule(port.ContinuousModuleConfig(**ccfg)),
        SACConfig(**kw, device="cpu"))
    jstate = jl.init_state(jax.random.PRNGKey(0))
    st = tl.init_state(torch.Generator().manual_seed(0))
    ap, cp = _port(jstate[0]), _port(jstate[1])
    from ray_tpu_torch.rllib.algorithms.dqn import _clone
    from ray_tpu_torch.rllib.algorithms.sac import SACState
    st = SACState(ap, cp, _clone(cp), st.log_alpha, tl.tx_actor.init(ap),
                  tl.tx_critic.init(cp), st.opt_alpha)
    rng = np.random.default_rng(8)
    n = 32
    batch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
             "next_obs": rng.standard_normal((n, 3)).astype(np.float32),
             "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
             "rewards": rng.standard_normal(n).astype(np.float32),
             "terminateds": (rng.random(n) < 0.1).astype(np.float32)}
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        k1, k2 = jax.random.split(key)
        noise = np.stack([np.asarray(jax.random.normal(k, (n, 1)))
                          for k in (k1, k2)])
        jstate, jm = jl._update(jstate, batch, key)
        st, m = tl.update(st, batch, noise)
    _close_metrics(m, jm, "sac")
    for i, what in enumerate(("actor", "critic", "target critic")):
        _close_params(st[i], jstate[i], f"sac {what}")
    np.testing.assert_allclose(float(st.log_alpha), float(jstate[3]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# env runners with fed actions
# ---------------------------------------------------------------------------

def _fed_sampler_ref(module, actions):
    it = iter(actions)

    def fake(params, obs, key):
        logits, v = module.forward(params, obs)
        a = jnp.asarray([next(it)])
        logp = jnp.take_along_axis(jax.nn.log_softmax(logits),
                                   a[:, None], -1)[:, 0]
        return a, logp, v

    return fake


def _fed_sampler_port(module, actions):
    it = iter(actions)

    def fake(params, obs):
        a = torch.tensor([next(it)])
        with torch.no_grad():
            logits, v = module.forward(params, obs)
        return a, torch.log_softmax(logits, -1)[:, a[0]], v

    return fake


def test_env_runner_with_fed_actions_matches_reference():
    """``SingleAgentEnvRunner`` (the actor's class, in process) on
    CartPole with the reference's env seed and the same fed actions over
    two rollouts of 64 (episodes end and reset inside them): the same
    observations, rewards, terminations and episode metrics; the logp,
    values and bootstrap within 1e-5 relative.  ``sample_off_policy`` at epsilon 1
    draws its actions from the runner's numpy RNG on both sides: the
    same transitions."""
    import cloudpickle

    from ray_tpu.rllib.core import rl_module as ref
    from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner as JR
    from ray_tpu_torch.rllib.core import rl_module as port
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    jm = ref.DiscreteMLPModule(ref.MLPModuleConfig())
    tm = port.DiscreteMLPModule(port.MLPModuleConfig())
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = _port(jp)
    jr = JR._cls("CartPole-v1", cloudpickle.dumps(jm), 64, seed=3)
    tr = SingleAgentEnvRunner._cls("CartPole-v1", cloudpickle.dumps(tm),
                                   64, seed=3)
    rng = np.random.default_rng(9)
    for _ in range(2):
        fed = rng.integers(0, 2, 65).tolist()
        jr._jit_sample = _fed_sampler_ref(jm, fed)
        jr._key = jax.random.PRNGKey(0)
        tr._sample_fn = _fed_sampler_port(tm, fed)
        want, got = jr.sample(jp), tr.sample(tp)
        assert got.keys() == want.keys()
        for k in ("obs", "actions", "rewards", "terminateds"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("logp", "values", "bootstrap_value"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert tr.get_metrics() == jr.get_metrics()
    assert tr.get_metrics()["num_episodes"] >= 1
    want = jr.sample_off_policy(jp, epsilon=1.0)
    got = tr.sample_off_policy(tp, epsilon=1.0)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tr.get_metrics() == jr.get_metrics()


def test_multi_agent_cartpole_matches_reference():
    """``MultiAgentCartPole`` under the same seed and actions: the same
    observation, reward and termination dicts, ``__all__`` included."""
    from ray_tpu.rllib.env.multi_agent_env import MultiAgentCartPole as J
    from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentCartPole

    je, te = J(num_agents=2, seed=4), MultiAgentCartPole(num_agents=2,
                                                          seed=4)
    assert te.agents == je.agents and te.num_agents == 2
    jo, _ = je.reset()
    to, _ = te.reset()
    rng = np.random.default_rng(10)
    for _ in range(60):
        for a in je.agents:
            np.testing.assert_array_equal(to.get(a), jo.get(a))
        acts = {a: int(rng.integers(2)) for a in jo}
        jo, jr, jt, jtr, _ = je.step(acts)
        to, tr, tt, ttr, _ = te.step(acts)
        assert (tr, tt, ttr) == (jr, jt, jtr)
        if jt["__all__"]:
            jo, _ = je.reset(seed=11)
            to, _ = te.reset(seed=11)


# ---------------------------------------------------------------------------
# the learner group
# ---------------------------------------------------------------------------

@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=3)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_learner_group_ppo_two_cpu_learners_match_one(ray_start_regular):
    """``LearnerGroup(module, config)`` builds the reference's default,
    PPO learners: two CPU learner actors on the host ring hold the same
    params after 2 updates, equal (within 1e-5 of each leaf's largest
    value) to one in-process learner's 2 updates on the full batches.
    One minibatch an epoch, and advantages already standardised in each
    half, so the halves' mean gradient is the full batch's."""
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
    from ray_tpu_torch.rllib.core.rl_module import (DiscreteMLPModule,
                                                    MLPModuleConfig)

    cfg = PPOConfig(num_sgd_epochs=1, minibatch_size=64, lr=1e-3, seed=2,
                    device="cpu")
    module = DiscreteMLPModule(MLPModuleConfig())
    group = LearnerGroup(module, cfg, num_learners=2)
    solo = PPOLearner(module, cfg)
    params, opt = solo.init_state(torch.Generator().manual_seed(2))
    try:
        for seed in (11, 12):
            batch = _ppo_batch(seed, n=64)
            for half in (slice(0, 32), slice(32, 64)):
                a = batch["advantages"][half]
                batch["advantages"][half] = (a - a.mean()) / a.std()
            got = group.update(batch)
            params, opt, want = solo.update(params, opt, batch)
            assert np.isfinite(list(got.values())).all()
            np.testing.assert_allclose(got["vf_loss"], want["vf_loss"],
                                       rtol=1e-5)
        a, b = group.get_all_params()
        for x, y in zip(_port_leaves(a), _port_leaves(b)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(_port_leaves(a), _port_leaves(params)):
            bound = 1e-5 * float(np.max(np.abs(y)))
            np.testing.assert_allclose(x, y, rtol=0, atol=bound)
    finally:
        group.stop()


# ---------------------------------------------------------------------------
# the reference's learning tests (slow), on the port's own runs
# ---------------------------------------------------------------------------

def _cpu(cfg):
    cfg.device = "cpu"
    return cfg


@pytest.mark.slow
def test_ppo_in_tune(ray_start_regular, tmp_path):
    import ray_tpu_torch.tune as tune
    from ray_tpu_torch.rllib.algorithms.ppo import PPO

    trainable = PPO.as_trainable(
        {"env": "CartPole-v1", "num_env_runners": 1,
         "rollout_length": 128, "device": "cpu"}, stop_iters=2)
    results = tune.run(trainable,
                       config={"lr": tune.grid_search([3e-4, 1e-3])},
                       metric="episode_return_mean", mode="max",
                       storage_path=str(tmp_path))
    assert len(results) == 2
    assert results.get_best_result().metrics["training_iteration"] == 2


@pytest.mark.slow
def test_ppo_learns_cartpole(ray_start_regular):
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    algo = _cpu(PPOConfig()
                .environment("CartPole-v1")
                .env_runners(num_env_runners=2, rollout_length=256)
                .training(lr=3e-4, minibatch_size=128, num_sgd_epochs=6,
                          seed=1)).build()
    try:
        first = algo.train()
        last = None
        for _ in range(11):
            last = algo.train()
        assert last["episode_return_mean"] > first["episode_return_mean"]
        assert last["timesteps_total"] == 12 * 2 * 256
        assert np.isfinite(last["learner/total_loss"])
    finally:
        algo.stop()


@pytest.mark.slow
def test_ppo_learner_group_ddp(ray_start_regular):
    """num_learners=2: gradients allreduced on the host ring across
    learner actors, params stay identical, and PPO still improves on
    CartPole."""
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    algo = _cpu(PPOConfig()
                .environment("CartPole-v1")
                .env_runners(num_env_runners=2, rollout_length=256)
                .training(lr=3e-4, minibatch_size=128, num_sgd_epochs=6,
                          num_learners=2, num_cpus_per_learner=0.5,
                          seed=1)).build()
    try:
        first = algo.train()
        last = None
        for _ in range(9):
            last = algo.train()
        assert last["episode_return_mean"] > first["episode_return_mean"]
        assert np.isfinite(last["learner/total_loss"])
        a, b = algo.learner_group.get_all_params()
        for x, y in zip(_port_leaves(a), _port_leaves(b)):
            np.testing.assert_allclose(x, y, rtol=1e-6)
    finally:
        algo.stop()


@pytest.mark.slow
def test_dqn_learns_cartpole(ray_start_regular):
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig
    algo = _cpu(DQNConfig()
                .environment("CartPole-v1")
                .env_runners(num_env_runners=1, rollout_length=256)
                .training(learn_start=300, updates_per_iteration=64,
                          epsilon_decay_steps=3000, seed=3)).build()
    try:
        first = algo.train()
        last = None
        for _ in range(20):
            last = algo.train()
        assert last["episode_return_mean"] > \
            first["episode_return_mean"] * 1.5
        assert last["buffer_size"] > 3000
        assert np.isfinite(last["learner/loss"])
        assert last["epsilon"] < first["epsilon"]
    finally:
        algo.stop()


@pytest.mark.slow
def test_bc_offline_clones_expert(ray_start_regular):
    """BC trains from an offline ``ray_tpu_torch.data`` dataset (no env
    interaction) and the cloned policy beats random in the live env."""
    import gymnasium as gym

    import ray_tpu_torch.data as data
    from ray_tpu_torch.rllib.algorithms.bc import BCConfig

    env = gym.make("CartPole-v1")
    rows = []
    obs, _ = env.reset(seed=0)
    for _ in range(2000):
        a = 1 if obs[2] + 0.5 * obs[3] > 0 else 0
        rows.append({"obs": obs.astype(np.float32).tolist(),
                     "actions": a})
        obs, _, term, trunc, _ = env.step(a)
        if term or trunc:
            obs, _ = env.reset()
    env.close()
    ds = data.from_items(rows)

    algo = _cpu(BCConfig().environment("CartPole-v1")
                .offline_data(ds)
                .training(updates_per_iteration=64,
                          train_batch_size=256)).build()
    for _ in range(15):
        metrics = algo.train()
    assert metrics["action_accuracy"] > 0.85, metrics
    ev = algo.evaluate(num_episodes=5)
    assert ev["episode_return_mean"] > 100, ev


@pytest.mark.slow
def test_impala_learns_cartpole(ray_start_regular):
    from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig
    algo = _cpu(IMPALAConfig()
                .environment("CartPole-v1")
                .env_runners(2, rollout_length=128)
                .training(lr=5e-3, segments_per_iteration=2,
                          seed=1)).build()
    try:
        first = None
        best = -np.inf
        for _ in range(25):
            result = algo.train()
            ret = result["episode_return_mean"]
            if not np.isnan(ret):
                if first is None:
                    first = ret
                best = max(best, ret)
        assert first is not None
        assert best > max(first * 1.5, 40.0), (first, best)
    finally:
        algo.stop()


@pytest.mark.slow
def test_impala_multi_learner_ici():
    """2 learners + 4 env runners, gradients over the ``ici`` collective
    group (one gloo ``torch.distributed`` world on the CPU)."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig
    ray_tpu_torch.init(num_cpus=6)
    algo = _cpu(IMPALAConfig()
                .environment("CartPole-v1")
                .env_runners(4, rollout_length=64)
                .training(lr=5e-3, segments_per_iteration=4,
                          num_learners=2, learner_backend="ici",
                          seed=2)).build()
    try:
        returns = []
        for _ in range(12):
            result = algo.train()
            if not np.isnan(result["episode_return_mean"]):
                returns.append(result["episode_return_mean"])
        a, b = algo.learner_group.get_all_params()
        for x, y in zip(_port_leaves(a), _port_leaves(b)):
            np.testing.assert_allclose(x, y, rtol=1e-5)
        assert returns and returns[-1] > 15.0
    finally:
        algo.stop()
        ray_tpu_torch.shutdown()


@pytest.mark.slow
def test_sac_learns_pendulum(ray_start_regular):
    from ray_tpu_torch.rllib import SACConfig
    algo = _cpu(SACConfig()
                .environment("Pendulum-v1")
                .env_runners(1, rollout_length=256)
                .training(learn_start=500, train_batch_size=128,
                          updates_per_iteration=256, actor_lr=1e-3,
                          critic_lr=1e-3, alpha_lr=1e-3, seed=0)).build()
    try:
        first, returns = None, []
        for _ in range(40):
            result = algo.train()
            r = result["episode_return_mean"]
            if not np.isnan(r):
                if first is None:
                    first = r
                returns.append(r)
        assert returns, "no episodes completed"
        best_late = max(returns[-5:])
        assert best_late > -800, (first, returns[-5:])
        assert best_late > first + 250, (first, best_late)
    finally:
        algo.stop()


@pytest.mark.slow
def test_multi_agent_ppo_two_agent_cartpole(ray_start_regular):
    from ray_tpu_torch.rllib import MultiAgentPPOConfig
    from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentCartPole

    cfg = _cpu(MultiAgentPPOConfig()
               .env_runners(2, rollout_length=256)
               .training(lr=5e-3, num_sgd_epochs=4, minibatch_size=128,
                         seed=0))
    cfg.env_factory = lambda: MultiAgentCartPole(num_agents=2)
    cfg.multi_agent(
        policies=("p0", "p1"),
        policy_mapping_fn=lambda agent: ("p0" if agent == "agent_0"
                                         else "p1"))
    algo = cfg.build()
    try:
        returns = []
        for _ in range(14):
            result = algo.train()
            if not np.isnan(result["episode_return_mean"]):
                returns.append(result["episode_return_mean"])
        assert returns and max(returns) > 120.0, returns[-5:]
        assert set(algo.states) == {"p0", "p1"}
    finally:
        algo.stop()
