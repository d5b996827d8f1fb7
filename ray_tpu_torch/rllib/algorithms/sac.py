"""SAC — soft actor-critic (continuous control).

Counterpart of ``ray_tpu/rllib/algorithms/sac.py`` (parity: the
reference's ``rllib/algorithms/sac/``, new stack): off-policy
actor-critic with twin clipped double-Q critics, a tanh-squashed
Gaussian policy, automatic entropy-temperature tuning and
polyak-averaged target critics.  One :meth:`SACLearner.update` runs the
critic, actor and alpha steps and the polyak average on the learner's
device; replay stays in host numpy (``dqn.ReplayBuffer``, continuous
actions).  The reparameterised draws come from a ``torch.Generator``
(not ``jax.random``'s): a parity run feeds the reference's noise in.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.dqn import ReplayBuffer, _clone
from ray_tpu_torch.rllib.algorithms.ppo import (_ConfigBuilder,
                                                _runner_returns)
from ray_tpu_torch.rllib.core import learner as lrn
from ray_tpu_torch.rllib.core.rl_module import (ContinuousModuleConfig,
                                                SquashedGaussianModule,
                                                TwinQModule)


@dataclass
class SACConfig(_ConfigBuilder):
    env: str = "Pendulum-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_env_runners: int = 1
    rollout_length: int = 128
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005              # polyak target coefficient
    initial_alpha: float = 1.0
    target_entropy: Optional[float] = None   # default: -act_dim
    buffer_size: int = 100_000
    learn_start: int = 1_000
    train_batch_size: int = 256
    updates_per_iteration: int = 64
    hidden: tuple = (256, 256)
    seed: int = 0
    device: Optional[str] = None

    def build(self) -> "SAC":
        return SAC(self)


class SACState(NamedTuple):
    """The reference's state tuple: (actor params, critic params, target
    critic params, log alpha, the three optimizers' states)."""
    actor: Any
    critic: Any
    target_critic: Any
    log_alpha: Any
    opt_actor: Any
    opt_critic: Any
    opt_alpha: Any


class SACLearner:
    """One SAC update: critics, then the actor on the new critics, then
    alpha, then the polyak average.  Updates the state's tensors in
    place and returns it."""

    def __init__(self, actor: SquashedGaussianModule, critic: TwinQModule,
                 config: SACConfig, device=None):
        self.actor = actor
        self.critic = critic
        self.config = config
        self.device = lrn.learner_device(device, config)
        cfg = config
        self.target_entropy = (cfg.target_entropy
                               if cfg.target_entropy is not None
                               else -float(actor.config.act_dim))
        self.tx_actor = lrn.adam(cfg.actor_lr)
        self.tx_critic = lrn.adam(cfg.critic_lr)
        self.tx_alpha = lrn.adam(cfg.alpha_lr)

    def critic_loss(self, cp, ap, tcp, log_alpha, batch, eps):
        cfg = self.config
        with torch.no_grad():
            next_a, next_logp = self.actor.sample(ap, batch["next_obs"],
                                                  eps=eps)
            q1t, q2t = self.critic.forward(tcp, batch["next_obs"], next_a)
            alpha = torch.exp(log_alpha)
            soft_q = torch.minimum(q1t, q2t) - alpha * next_logp
            target = batch["rewards"] + cfg.gamma * \
                (1.0 - batch["terminateds"]) * soft_q
        q1, q2 = self.critic.forward(cp, batch["obs"], batch["actions"])
        loss = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
        return loss, {"q1_mean": torch.mean(q1), "critic_loss": loss}

    def actor_loss(self, ap, cp, log_alpha, batch, eps):
        a, logp = self.actor.sample(ap, batch["obs"], eps=eps)
        q1, q2 = self.critic.forward(cp, batch["obs"], a)
        alpha = torch.exp(log_alpha).detach()
        loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
        return loss, {"actor_loss": loss, "entropy": -torch.mean(logp),
                      "logp_mean": torch.mean(logp)}

    def init_state(self, generator: torch.Generator) -> SACState:
        ap = self.actor.init_params(generator, device=self.device)
        cp = self.critic.init_params(generator, device=self.device)
        log_alpha = {"a": torch.tensor(
            np.log(self.config.initial_alpha), dtype=torch.float32,
            device=self.device)}
        return SACState(ap, cp, _clone(cp), log_alpha["a"],
                        self.tx_actor.init(ap), self.tx_critic.init(cp),
                        self.tx_alpha.init(log_alpha))

    def noise(self, generator: torch.Generator, batch_size: int):
        """The update's two reparameterisation draws, [2, B, act_dim]
        (the critic's target actions, then the actor's)."""
        shape = (2, batch_size, self.actor.config.act_dim)
        return torch.randn(shape, generator=generator).to(self.device)

    def update(self, state: SACState, batch: Dict[str, np.ndarray], noise
               ) -> "tuple[SACState, Dict[str, torch.Tensor]]":
        """One step on a sampled minibatch; ``noise`` [2, B, act_dim]
        (:meth:`noise`, or the reference's fed in)."""
        ap, cp, tcp, log_alpha, opt_a, opt_c, opt_al = state
        b = lrn.batch_to(batch, self.device)
        noise = torch.as_tensor(noise).to(self.device)
        closs, cmetrics, cgrads = lrn.value_and_grad_aux(
            lambda p: self.critic_loss(p, ap, tcp, log_alpha, b, noise[0]),
            cp)
        opt_c = self.tx_critic.update(cgrads, opt_c, cp)
        aloss, ametrics, agrads = lrn.value_and_grad_aux(
            lambda p: self.actor_loss(p, cp, log_alpha, b, noise[1]), ap)
        opt_a = self.tx_actor.update(agrads, opt_a, ap)
        # d/d log_alpha of -log_alpha * (logp_mean + target_entropy)
        algrad = -(ametrics["logp_mean"] + self.target_entropy)
        alpha_tree = {"a": log_alpha}
        opt_al = self.tx_alpha.update({"a": algrad.reshape(())}, opt_al,
                                      alpha_tree)
        tau = self.config.tau
        from ray_tpu_torch.models.training import _leaves
        with torch.no_grad():
            for t, o in zip(_leaves(tcp), _leaves(cp)):
                t.copy_((1 - tau) * t + tau * o)
        metrics = {**cmetrics, **ametrics, "alpha": torch.exp(log_alpha)}
        metrics.pop("logp_mean", None)
        return SACState(ap, cp, tcp, log_alpha, opt_a, opt_c, opt_al), \
            metrics


class SAC:
    """Algorithm driver (parity: ``SAC.train()``)."""

    def __init__(self, config: SACConfig):
        import cloudpickle
        import gymnasium as gym

        from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
        self.config = config
        probe = gym.make(config.env, **config.env_config)
        obs_shape = probe.observation_space.shape
        space = probe.action_space
        probe.close()
        mcfg = ContinuousModuleConfig(
            obs_dim=int(np.prod(obs_shape)),
            act_dim=int(np.prod(space.shape)),
            act_low=tuple(np.asarray(space.low).ravel().tolist()),
            act_high=tuple(np.asarray(space.high).ravel().tolist()),
            hidden=tuple(config.hidden))
        self.actor = SquashedGaussianModule(mcfg)
        self.critic = TwinQModule(mcfg)
        self.learner = SACLearner(self.actor, self.critic, config)
        self.state = self.learner.init_state(
            torch.Generator().manual_seed(int(config.seed)))
        self._gen = torch.Generator().manual_seed(int(config.seed) + 1)
        blob = cloudpickle.dumps(self.actor)
        self.env_runners = [
            SingleAgentEnvRunner.remote(
                config.env, blob, config.rollout_length,
                seed=config.seed + i, env_config=config.env_config)
            for i in range(config.num_env_runners)]
        self.buffer = ReplayBuffer(config.buffer_size, obs_shape,
                                   seed=config.seed)
        # continuous actions: retype the buffer's action storage
        self.buffer.actions = np.zeros(
            (config.buffer_size, mcfg.act_dim), np.float32)
        self.iteration = 0
        self.timesteps_total = 0
        self.updates_total = 0

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        cfg = self.config
        params_ref = ray_tpu_torch.put(lrn.host_params(self.state.actor))
        warmup = self.timesteps_total < cfg.learn_start
        batches = ray_tpu_torch.get(
            [r.sample_continuous.remote(params_ref, warmup)
             for r in self.env_runners], timeout=600)
        for b in batches:
            self.buffer.add_batch(b)
            self.timesteps_total += len(b["obs"])

        metrics: Dict[str, Any] = {}
        if len(self.buffer) >= cfg.learn_start:
            for _ in range(cfg.updates_per_iteration):
                mb = self.buffer.sample(cfg.train_batch_size)
                self.state, metrics = self.learner.update(
                    self.state, mb,
                    self.learner.noise(self._gen, cfg.train_batch_size))
                self.updates_total += 1
        _, ret = _runner_returns(self.env_runners)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self.timesteps_total,
            "updates_total": self.updates_total,
            "buffer_size": len(self.buffer),
            "episode_return_mean": ret,
            "time_this_iter_s": time.time() - t0,
            **{f"learner/{k}": v for k, v in
               lrn.host_metrics(metrics).items()},
        }

    def stop(self):
        lrn.stop_actors(self.env_runners)

