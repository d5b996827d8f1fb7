"""PPO — proximal policy optimization.

Counterpart of ``ray_tpu/rllib/algorithms/ppo.py`` (parity: the
reference's ``rllib/algorithms/ppo/``, new stack): the algorithm drives
env-runner actors (sampling on the CPU) and a learner (clipped-surrogate
minibatch SGD on its device, the card unless ``device="cpu"``);
``num_learners > 1`` scales out as a data-parallel
:class:`~ray_tpu_torch.rllib.core.learner_group.LearnerGroup` whose
actors average gradients on the host ring.  ``PPO.as_trainable`` is the
Tune hook: a function trainable that reports each ``train()``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core import learner as lrn
from ray_tpu_torch.rllib.core.rl_module import (DiscreteMLPModule,
                                                MLPModuleConfig)


class _ConfigBuilder:
    """The reference's fluent config methods."""

    def environment(self, env: str, env_config: Optional[Dict] = None):
        self.env = env
        if env_config:
            self.env_config = env_config
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_length: Optional[int] = None):
        self.num_env_runners = num_env_runners
        if rollout_length:
            self.rollout_length = rollout_length
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training param {k!r}")
            setattr(self, k, v)
        return self


@dataclass
class PPOConfig(_ConfigBuilder):
    """Builder-style config (parity: AlgorithmConfig/PPOConfig).
    ``device``: where the learners run (None: the card)."""
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_env_runners: int = 2
    rollout_length: int = 256
    num_learners: int = 1          # >1: data-parallel LearnerGroup
    learner_backend: str = "host"  # "host" ring | "ici" device world
    num_cpus_per_learner: float = 1.0
    num_gpus_per_learner: float = 0.0
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_sgd_epochs: int = 6
    minibatch_size: int = 128
    grad_clip: float = 0.5
    hidden: tuple = (64, 64)
    seed: int = 0
    device: Optional[str] = None

    def build(self) -> "PPO":
        return PPO(self)


def _compute_gae(batch: Dict[str, np.ndarray], gamma: float,
                 lam: float) -> Dict[str, np.ndarray]:
    rewards = batch["rewards"]
    values = batch["values"]
    terminateds = batch["terminateds"]
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last_gae = 0.0
    next_value = float(batch["bootstrap_value"])
    for t in reversed(range(T)):
        nonterminal = 1.0 - terminateds[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    out = dict(batch)
    out["advantages"] = adv
    out["value_targets"] = adv + values
    return out


class PPOLearner:
    """The PPO update (parity: rllib/core/learner + ppo_learner): the
    clipped surrogate, the value loss and the entropy bonus, through
    ``clip_by_global_norm(grad_clip)`` and Adam.  The parameters are
    updated in place."""

    def __init__(self, module: DiscreteMLPModule, config: PPOConfig,
                 device=None):
        from ray_tpu_torch.models.training import rl_optimizer
        self.module = module
        self.config = config
        self.device = lrn.learner_device(device, config)
        self.tx = rl_optimizer(config.lr, config.grad_clip)

    def loss_fn(self, params, batch):
        cfg = self.config
        logits, values = self.module.forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        # jnp.std: the population std (ddof 0)
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - cfg.clip_param,
                              1 + cfg.clip_param) * adv
        pi_loss = -torch.mean(torch.minimum(unclipped, clipped))
        vf_loss = torch.mean((values - batch["value_targets"]) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
        total = (pi_loss + cfg.vf_coeff * vf_loss
                 - cfg.entropy_coeff * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_ratio": ratio.mean()}

    def grad(self, params, batch):
        loss, metrics, grads = lrn.value_and_grad_aux(self.loss_fn, params,
                                                      batch)
        metrics["total_loss"] = loss
        return grads, metrics

    def apply(self, params, opt_state, grads):
        return params, self.tx.update(grads, opt_state, params)

    def init_state(self, generator: torch.Generator):
        params = self.module.init_params(generator, device=self.device)
        return params, self.tx.init(params)

    def update(self, params, opt_state, train_batch: Dict[str, np.ndarray],
               allreduce: Optional[Callable] = None):
        """Minibatch SGD epochs.  With ``allreduce`` (LearnerGroup data
        parallelism), every step's gradients are averaged across the
        learners before the optimizer applies them, so all learners take
        the same steps."""
        cfg = self.config
        n = len(train_batch["obs"])
        metrics = {}
        rng = np.random.default_rng(0)
        # the batch goes to the learner's device once; each epoch's
        # permutation (the reference's numpy draws) once an epoch
        data = lrn.batch_to({k: v for k, v in train_batch.items()
                             if k != "bootstrap_value"}, self.device)
        for _ in range(cfg.num_sgd_epochs):
            perm = torch.as_tensor(rng.permutation(n), device=self.device)
            for start in range(0, n, cfg.minibatch_size):
                idx = perm[start:start + cfg.minibatch_size]
                mb = {k: v[idx] for k, v in data.items()}
                grads, metrics = self.grad(params, mb)
                if allreduce is not None:
                    grads = allreduce(grads)
                params, opt_state = self.apply(params, opt_state, grads)
        return params, opt_state, lrn.host_metrics(metrics)


def _probe_discrete(config):
    """(the config's discrete policy module, the env's observation
    shape), from one probe of the env's spaces."""
    import gymnasium as gym
    probe = gym.make(config.env, **config.env_config)
    obs_shape = probe.observation_space.shape
    num_actions = int(probe.action_space.n)
    probe.close()
    return DiscreteMLPModule(MLPModuleConfig(
        obs_dim=int(np.prod(obs_shape)), num_actions=num_actions,
        hidden=tuple(config.hidden))), obs_shape


def _runner_returns(env_runners):
    """The env runners' metrics and the finite episode-return means."""
    runner_metrics = ray_tpu_torch.get(
        [r.get_metrics.remote() for r in env_runners], timeout=120)
    returns = [m["episode_return_mean"] for m in runner_metrics
               if not np.isnan(m["episode_return_mean"])]
    mean = float(np.mean(returns)) if returns else float("nan")
    return runner_metrics, mean


class PPO:
    """Algorithm driver (parity: the ``Algorithm.train()`` loop)."""

    def __init__(self, config: PPOConfig):
        import cloudpickle

        from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
        self.config = config
        self.module, _ = _probe_discrete(config)
        self.learner_group = None
        if config.num_learners > 1:
            from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
            self.learner_group = LearnerGroup(
                self.module, config, num_learners=config.num_learners,
                num_cpus_per_learner=config.num_cpus_per_learner,
                num_gpus_per_learner=config.num_gpus_per_learner,
                backend=config.learner_backend)
            self.params, self.opt_state = None, None
            self.learner = None
        else:
            self.learner = PPOLearner(self.module, config)
            self.params, self.opt_state = self.learner.init_state(
                torch.Generator().manual_seed(int(config.seed)))
        blob = cloudpickle.dumps(self.module)
        self.env_runners = [
            SingleAgentEnvRunner.remote(
                config.env, blob, config.rollout_length,
                seed=config.seed + i, env_config=config.env_config)
            for i in range(config.num_env_runners)]
        self.iteration = 0
        self.timesteps_total = 0

    def _params_ref(self):
        if self.learner_group is not None:
            # rank 0's params straight into the env runners: no driver
            # round trip or re-put of the full tree
            return self.learner_group.get_params_ref()
        return ray_tpu_torch.put(lrn.host_params(self.params))

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        params_ref = self._params_ref()
        batches = ray_tpu_torch.get(
            [runner.sample.remote(params_ref)
             for runner in self.env_runners], timeout=600)
        processed = [
            _compute_gae(b, self.config.gamma, self.config.lambda_)
            for b in batches]
        train_batch = {
            k: np.concatenate([p[k] for p in processed])
            for k in processed[0] if k != "bootstrap_value"}
        if self.learner_group is not None:
            learner_metrics = self.learner_group.update(train_batch)
        else:
            self.params, self.opt_state, learner_metrics = \
                self.learner.update(self.params, self.opt_state,
                                    train_batch)
        runner_metrics, ret = _runner_returns(self.env_runners)
        self.iteration += 1
        n = len(train_batch["obs"])
        if self.learner_group is not None:
            n -= n % self.learner_group.world  # trimmed rows never train
        self.timesteps_total += n
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self.timesteps_total,
            "episode_return_mean": ret,
            "num_episodes": sum(m["num_episodes"]
                                for m in runner_metrics),
            "time_this_iter_s": time.time() - t0,
            **{f"learner/{k}": v for k, v in learner_metrics.items()},
        }

    def stop(self):
        lrn.stop_actors(self.env_runners)
        if self.learner_group is not None:
            self.learner_group.stop()

    # Tune integration: PPO as a function trainable
    @staticmethod
    def as_trainable(config_dict: Dict[str, Any],
                     stop_iters: int = 10) -> Callable:
        def trainable(tune_config):
            import ray_tpu_torch.tune as tune
            merged = dict(config_dict)
            merged.update(tune_config)
            cfg = PPOConfig(**merged)
            algo = cfg.build()
            try:
                for _ in range(stop_iters):
                    tune.report(algo.train())
            finally:
                algo.stop()
        return trainable
