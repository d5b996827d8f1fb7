"""BC — behavior cloning from offline data.

Counterpart of ``ray_tpu/rllib/algorithms/bc.py`` (parity: the
reference's ``rllib/algorithms/bc/``, offline RL new stack): no env
interaction — the policy is supervised on logged (obs, action) pairs
read through ``ray_tpu_torch.data``.  Evaluation optionally rolls the
cloned policy in a live env.  The supervised step is
:class:`BCLearner`, which the reference inlines in ``BC``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.ppo import _probe_discrete
from ray_tpu_torch.rllib.core import learner as lrn
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule


@dataclass
class BCConfig:
    env: str = "CartPole-v1"              # for eval rollouts + spaces
    env_config: Dict[str, Any] = field(default_factory=dict)
    lr: float = 1e-3
    train_batch_size: int = 256
    updates_per_iteration: int = 32
    hidden: tuple = (64, 64)
    seed: int = 0
    evaluation_num_episodes: int = 5
    device: Optional[str] = None

    def environment(self, env: str, env_config: Optional[Dict] = None):
        self.env = env
        if env_config:
            self.env_config = env_config
        return self

    def offline_data(self, dataset) -> "BCConfig":
        """``dataset``: a ray_tpu_torch.data.Dataset with 'obs' and
        'actions' columns (reference: config.offline_data(input_=...))."""
        self._dataset = dataset
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training param {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "BC":
        return BC(self, getattr(self, "_dataset", None))


class BCLearner:
    """The cloning step: the mean negative log-likelihood of the logged
    actions, Adam; the parameters are updated in place."""

    def __init__(self, module: DiscreteMLPModule, config: BCConfig,
                 device=None):
        self.module = module
        self.config = config
        self.device = lrn.learner_device(device, config)
        self.tx = lrn.adam(config.lr)

    def loss_fn(self, params, obs, actions):
        logits, _ = self.module.forward(params, obs)
        logp = torch.log_softmax(logits, -1)
        nll = -logp.gather(-1, actions[:, None])[:, 0]
        acc = torch.mean((torch.argmax(logits, -1) == actions).float())
        return torch.mean(nll), {"action_accuracy": acc}

    def init_state(self, generator: torch.Generator):
        params = self.module.init_params(generator, device=self.device)
        return params, self.tx.init(params)

    def update(self, params, opt_state, obs, actions):
        """-> (params, opt_state, loss, accuracy), the last two as
        tensors."""
        b = lrn.batch_to({"obs": obs, "actions": actions}, self.device)
        loss, metrics, grads = lrn.value_and_grad_aux(
            self.loss_fn, params, b["obs"], b["actions"])
        opt_state = self.tx.update(grads, opt_state, params)
        return params, opt_state, loss, metrics["action_accuracy"]

    @torch.no_grad()
    def act(self, params, obs):
        logits, _ = self.module.forward(
            params, torch.as_tensor(obs).to(self.device))
        return torch.argmax(logits, -1)


class BC:
    """Offline supervised policy cloning + optional live evaluation."""

    def __init__(self, config: BCConfig, dataset):
        if dataset is None:
            raise ValueError("BCConfig.offline_data(dataset) is required")
        self.config = config
        self.module, _ = _probe_discrete(config)
        self.learner = BCLearner(self.module, config)
        self.params, self.opt_state = self.learner.init_state(
            torch.Generator().manual_seed(int(config.seed)))
        # materialize the offline dataset once; epochs shuffle in memory
        rows = dataset.take_all()
        self._obs = np.stack([np.asarray(r["obs"], np.float32)
                              for r in rows])
        self._actions = np.asarray([r["actions"] for r in rows], np.int64)
        self._rng = np.random.default_rng(config.seed)
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        cfg = self.config
        n = len(self._obs)
        loss = acc = torch.zeros(())
        for _ in range(cfg.updates_per_iteration):
            idx = self._rng.integers(0, n, size=min(
                cfg.train_batch_size, n))
            self.params, self.opt_state, loss, acc = self.learner.update(
                self.params, self.opt_state, self._obs[idx],
                self._actions[idx])
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "loss": float(loss), "action_accuracy": float(acc),
                "num_samples": n,
                "time_this_iter_s": time.time() - t0}

    def evaluate(self, num_episodes: Optional[int] = None
                 ) -> Dict[str, Any]:
        """Greedy rollouts of the cloned policy in the live env."""
        import gymnasium as gym
        episodes = num_episodes or self.config.evaluation_num_episodes
        env = gym.make(self.config.env, **self.config.env_config)
        returns = []
        for ep in range(episodes):
            obs, _ = env.reset(seed=self.config.seed + ep)
            done, total = False, 0.0
            while not done:
                a = int(self.learner.act(
                    self.params, np.asarray(obs, np.float32)[None, :])[0])
                obs, rew, term, trunc, _ = env.step(a)
                total += rew
                done = term or trunc
            returns.append(total)
        env.close()
        return {"episode_return_mean": float(np.mean(returns)),
                "num_episodes": episodes}

    def stop(self):
        pass
