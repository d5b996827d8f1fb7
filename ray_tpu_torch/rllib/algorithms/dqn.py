"""DQN — deep Q-learning (double DQN + target network).

Counterpart of ``ray_tpu/rllib/algorithms/dqn.py`` (parity: the
reference's ``rllib/algorithms/dqn/``, new stack): env runners collect
epsilon-greedy transitions into a replay buffer; the learner takes TD
steps against a periodically synced target network (double-DQN action
selection) on its device.  The buffer stays in host numpy, seeded.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.ppo import (_ConfigBuilder,
                                                _probe_discrete,
                                                _runner_returns)
from ray_tpu_torch.rllib.core import learner as lrn
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule


@dataclass
class DQNConfig(_ConfigBuilder):
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_env_runners: int = 1
    rollout_length: int = 128
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_size: int = 50_000
    learn_start: int = 500          # min transitions before updates
    train_batch_size: int = 64
    updates_per_iteration: int = 32
    target_update_freq: int = 200   # updates between target syncs
    double_q: bool = True
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 5_000
    hidden: tuple = (64, 64)
    seed: int = 0
    device: Optional[str] = None

    def build(self) -> "DQN":
        return DQN(self)


class ReplayBuffer:
    """Uniform ring buffer over numpy transition arrays (reference:
    ``rllib/utils/replay_buffers/replay_buffer.py``)."""

    def __init__(self, capacity: int, obs_shape, seed: int = 0):
        self.capacity = capacity
        self.obs = np.zeros((capacity,) + tuple(obs_shape), np.float32)
        self.next_obs = np.zeros_like(self.obs)
        self.actions = np.zeros((capacity,), np.int64)
        self.rewards = np.zeros((capacity,), np.float32)
        self.terminateds = np.zeros((capacity,), np.float32)
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(batch["obs"])
        for i in range(n):
            j = self._idx
            self.obs[j] = batch["obs"][i]
            self.next_obs[j] = batch["next_obs"][i]
            self.actions[j] = batch["actions"][i]
            self.rewards[j] = batch["rewards"][i]
            self.terminateds[j] = batch["terminateds"][i]
            self._idx = (self._idx + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def __len__(self) -> int:
        return self._size

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx],
                "rewards": self.rewards[idx],
                "terminateds": self.terminateds[idx]}


def _take(q, idx):
    return q.gather(-1, idx[:, None])[:, 0]


class DQNLearner:
    """The double-DQN TD update (the reference's dqn_learner): Huber
    loss (delta 1) against the target network, Adam.  The parameters
    are updated in place."""

    def __init__(self, module: DiscreteMLPModule, config: DQNConfig,
                 device=None):
        self.module = module
        self.config = config
        self.device = lrn.learner_device(device, config)
        self.tx = lrn.adam(config.lr)

    def loss_fn(self, params, target_params, batch):
        cfg = self.config
        module = self.module
        q, _ = module.forward(params, batch["obs"])
        q_sa = _take(q, batch["actions"])
        with torch.no_grad():
            q_next_t, _ = module.forward(target_params, batch["next_obs"])
            if cfg.double_q:
                q_next_online, _ = module.forward(params,
                                                  batch["next_obs"])
                q_next = _take(q_next_t, torch.argmax(q_next_online, -1))
            else:
                q_next = torch.max(q_next_t, dim=-1).values
            target = batch["rewards"] + cfg.gamma * \
                (1.0 - batch["terminateds"]) * q_next
        td = q_sa - target
        loss = F.huber_loss(q_sa, target, reduction="mean", delta=1.0)
        return loss, {"td_error_mean": torch.mean(torch.abs(td)),
                      "q_mean": torch.mean(q_sa)}

    def init_state(self, generator: torch.Generator):
        params = self.module.init_params(generator, device=self.device)
        return params, self.tx.init(params)

    def update(self, params, target_params, opt_state,
               batch: Dict[str, np.ndarray]):
        """One TD step on a sampled minibatch -> (params, opt_state,
        metrics as tensors)."""
        mb = lrn.batch_to(batch, self.device)
        loss, metrics, grads = lrn.value_and_grad_aux(
            self.loss_fn, params, target_params, mb)
        opt_state = self.tx.update(grads, opt_state, params)
        metrics["loss"] = loss
        return params, opt_state, metrics


def _clone(tree):
    from ray_tpu_torch.models.training import _leaves, _rebuild
    return _rebuild(tree, [t.detach().clone() for t in _leaves(tree)])


class DQN:
    """Algorithm driver (parity: ``DQN.train()``)."""

    def __init__(self, config: DQNConfig):
        import cloudpickle

        from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
        self.config = config
        self.module, obs_shape = _probe_discrete(config)
        self.learner = DQNLearner(self.module, config)
        self.params, self.opt_state = self.learner.init_state(
            torch.Generator().manual_seed(int(config.seed)))
        # the learner updates in place: the target is a copy
        self.target_params = _clone(self.params)
        blob = cloudpickle.dumps(self.module)
        self.env_runners = [
            SingleAgentEnvRunner.remote(
                config.env, blob, config.rollout_length,
                seed=config.seed + i, env_config=config.env_config)
            for i in range(config.num_env_runners)]
        self.buffer = ReplayBuffer(config.buffer_size, obs_shape,
                                   seed=config.seed)
        self.iteration = 0
        self.timesteps_total = 0
        self.updates_total = 0

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.timesteps_total /
                   max(cfg.epsilon_decay_steps, 1))
        return cfg.epsilon_start + frac * (cfg.epsilon_end -
                                           cfg.epsilon_start)

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        cfg = self.config
        eps = self._epsilon()
        params_ref = ray_tpu_torch.put(lrn.host_params(self.params))
        batches = ray_tpu_torch.get(
            [r.sample_off_policy.remote(params_ref, eps)
             for r in self.env_runners], timeout=600)
        for b in batches:
            self.buffer.add_batch(b)
            self.timesteps_total += len(b["obs"])

        metrics: Dict[str, Any] = {}
        if len(self.buffer) >= cfg.learn_start:
            for _ in range(cfg.updates_per_iteration):
                mb = self.buffer.sample(cfg.train_batch_size)
                self.params, self.opt_state, metrics = self.learner.update(
                    self.params, self.target_params, self.opt_state, mb)
                self.updates_total += 1
                if self.updates_total % cfg.target_update_freq == 0:
                    self.target_params = _clone(self.params)
        _, ret = _runner_returns(self.env_runners)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self.timesteps_total,
            "updates_total": self.updates_total,
            "epsilon": eps,
            "buffer_size": len(self.buffer),
            "episode_return_mean": ret,
            "time_this_iter_s": time.time() - t0,
            **{f"learner/{k}": v for k, v in
               lrn.host_metrics(metrics).items()},
        }

    def stop(self):
        lrn.stop_actors(self.env_runners)
