"""Multi-agent PPO.

Counterpart of ``ray_tpu/rllib/algorithms/multi_agent_ppo.py`` (parity:
the reference's multi-agent stack, ``config.multi_agent(policies=...,
policy_mapping_fn=...)`` over ``rllib/core/rl_module/
multi_rl_module.py``).  One :class:`PPOLearner` per policy; runners
return per-policy batches (``MultiAgentEnvRunner``); each policy updates
on its own agents' experience.  Shared-policy setups (all agents -> one
policy id) give parameter sharing for free.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.ppo import (PPOConfig, PPOLearner,
                                                _runner_returns)
from ray_tpu_torch.rllib.core import learner as lrn
from ray_tpu_torch.rllib.core.rl_module import (DiscreteMLPModule,
                                                MLPModuleConfig)


@dataclass
class MultiAgentPPOConfig(PPOConfig):
    env_factory: Optional[Callable] = None     # () -> MultiAgentEnv
    policies: tuple = ("shared",)              # policy ids
    policy_mapping_fn: Optional[Callable] = None  # agent_id -> policy

    def multi_agent(self, policies, policy_mapping_fn):
        self.policies = tuple(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    def __init__(self, config: MultiAgentPPOConfig):
        import cloudpickle

        from ray_tpu_torch.rllib.env.multi_agent_env import \
            MultiAgentEnvRunner
        if config.env_factory is None:
            raise ValueError("MultiAgentPPOConfig.env_factory required")
        self.config = config
        probe = config.env_factory()
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        mapping = config.policy_mapping_fn or (lambda agent: "shared")
        self.modules = {
            pid: DiscreteMLPModule(MLPModuleConfig(
                obs_dim=obs_dim, num_actions=num_actions,
                hidden=tuple(config.hidden)))
            for pid in config.policies}
        self.learners = {pid: PPOLearner(m, config)
                         for pid, m in self.modules.items()}
        # one generator, drawn in policy order: each policy its own init
        gen = torch.Generator().manual_seed(int(config.seed))
        self.states = {pid: self.learners[pid].init_state(gen)
                       for pid in self.modules}
        self.env_runners = [
            MultiAgentEnvRunner.remote(
                cloudpickle.dumps(config.env_factory),
                cloudpickle.dumps(self.modules),
                cloudpickle.dumps(mapping),
                rollout_length=config.rollout_length,
                gamma=config.gamma, lam=config.lambda_,
                seed=config.seed + i)
            for i in range(config.num_env_runners)]
        self.iteration = 0
        self.timesteps_total = 0

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        params_ref = ray_tpu_torch.put(
            {pid: lrn.host_params(st[0]) for pid, st in self.states.items()})
        results = ray_tpu_torch.get(
            [r.sample.remote(params_ref) for r in self.env_runners],
            timeout=600)
        merged: Dict[str, List] = {}
        for res in results:
            for pid, batch in res.items():
                merged.setdefault(pid, []).append(batch)
        metrics: Dict[str, Any] = {}
        for pid, batches in merged.items():
            train_batch = {
                k: np.concatenate([b[k] for b in batches])
                for k in batches[0] if k != "bootstrap_value"}
            self.timesteps_total += len(train_batch["obs"])
            params, opt_state = self.states[pid]
            params, opt_state, m = self.learners[pid].update(
                params, opt_state, train_batch)
            self.states[pid] = (params, opt_state)
            metrics.update({f"{pid}/{k}": v for k, v in m.items()})
        _, ret = _runner_returns(self.env_runners)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self.timesteps_total,
            "episode_return_mean": ret,
            "time_this_iter_s": time.time() - t0,
            **metrics,
        }

    def stop(self):
        lrn.stop_actors(self.env_runners)
