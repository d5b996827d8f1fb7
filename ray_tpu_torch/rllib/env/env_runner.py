"""EnvRunner — the sampling actor.

Counterpart of ``ray_tpu/rllib/env/env_runner.py`` (parity: the
reference's ``rllib/env/single_agent_env_runner.py``): owns a gym env,
rolls out the current policy and returns batched trajectories as numpy
host arrays; the learner moves them to its device.  Runners sample on
the CPU, their draws from a ``torch.Generator`` seeded from the runner's
numpy RNG (not ``jax.random``'s, so parity runs feed actions in).  The
params a runner is handed are a tree of CPU tensors (a learner's
``host_copy``).  ``gymnasium`` is imported by the runner, never by this
module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch


def _obs_row(obs) -> torch.Tensor:
    return torch.as_tensor(np.asarray(obs, np.float32)[None, :])


class _EpisodeStats:
    """Completed-episode returns and lengths (the runners' metrics)."""

    def _init_stats(self):
        self._episode_return = 0.0
        self._episode_len = 0
        self.completed_returns: List[float] = []
        self.completed_lengths: List[int] = []

    def _record(self, rew) -> None:
        self._episode_return += rew
        self._episode_len += 1

    def _close_episode(self) -> None:
        self.completed_returns.append(self._episode_return)
        self.completed_lengths.append(self._episode_len)
        self._episode_return = 0.0
        self._episode_len = 0

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "episode_return_mean": (float(np.mean(
                self.completed_returns[-100:]))
                if self.completed_returns else float("nan")),
            "episode_len_mean": (float(np.mean(
                self.completed_lengths[-100:]))
                if self.completed_lengths else float("nan")),
            "num_episodes": len(self.completed_returns),
        }


@ray_tpu_torch.remote
class SingleAgentEnvRunner(_EpisodeStats):
    def __init__(self, env_name: str, module_blob: bytes,
                 rollout_length: int = 256, seed: int = 0,
                 env_config: Optional[Dict[str, Any]] = None):
        import cloudpickle
        import gymnasium as gym
        self.env = gym.make(env_name, **(env_config or {}))
        self.module = cloudpickle.loads(module_blob)
        self.rollout_length = rollout_length
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self._init_stats()
        self._sample_fn = None
        self._gen: Optional[torch.Generator] = None

    def _generator(self) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator().manual_seed(
                int(self.rng.integers(2 ** 31)))
        return self._gen

    def _sampler(self):
        """``(params, obs [1, d]) -> (action, logp, value)``, each [1]."""
        if self._sample_fn is None:
            gen = self._generator()
            module = self.module

            def sample(params, obs):
                return module.sample_actions(params, obs, gen)

            self._sample_fn = sample
        return self._sample_fn

    def sample(self, params) -> Dict[str, np.ndarray]:
        """Roll out ``rollout_length`` steps; returns trajectory arrays."""
        sampler = self._sampler()
        T = self.rollout_length
        obs_buf = np.zeros((T,) + np.shape(self.obs), np.float32)
        act_buf = np.zeros((T,), np.int64)
        logp_buf = np.zeros((T,), np.float32)
        val_buf = np.zeros((T,), np.float32)
        rew_buf = np.zeros((T,), np.float32)
        done_buf = np.zeros((T,), np.float32)
        for t in range(T):
            a, logp, v = sampler(params, _obs_row(self.obs))
            a = int(a[0])
            obs_buf[t] = self.obs
            act_buf[t] = a
            logp_buf[t] = float(logp[0])
            val_buf[t] = float(v[0])
            nxt, rew, terminated, truncated, _ = self.env.step(a)
            rew_buf[t] = rew
            done_buf[t] = float(terminated)
            self._record(rew)
            if terminated or truncated:
                self._close_episode()
                nxt, _ = self.env.reset()
            self.obs = nxt
        # bootstrap value for the final state
        _, _, last_v = sampler(params, _obs_row(self.obs))
        return {"obs": obs_buf, "actions": act_buf, "logp": logp_buf,
                "values": val_buf, "rewards": rew_buf,
                "terminateds": done_buf,
                "bootstrap_value": np.float32(float(last_v[0]))}

    def sample_off_policy(self, params,
                          epsilon: float = 0.1) -> Dict[str, np.ndarray]:
        """Epsilon-greedy rollout returning (s, a, r, s', done)
        transitions, the replay buffer's food for value-based learners
        (DQN; the reference's single_agent_env_runner in off-policy
        mode)."""
        T = self.rollout_length
        obs_buf = np.zeros((T,) + np.shape(self.obs), np.float32)
        next_buf = np.zeros_like(obs_buf)
        act_buf = np.zeros((T,), np.int64)
        rew_buf = np.zeros((T,), np.float32)
        done_buf = np.zeros((T,), np.float32)
        n_actions = self.env.action_space.n
        for t in range(T):
            if self.rng.random() < epsilon:
                a = int(self.rng.integers(n_actions))
            else:
                with torch.no_grad():
                    q, _ = self.module.forward(params, _obs_row(self.obs))
                a = int(torch.argmax(q, dim=-1)[0])
            obs_buf[t] = self.obs
            act_buf[t] = a
            nxt, rew, terminated, truncated, _ = self.env.step(a)
            rew_buf[t] = rew
            done_buf[t] = float(terminated)
            next_buf[t] = nxt
            self._record(rew)
            if terminated or truncated:
                self._close_episode()
                nxt, _ = self.env.reset()
            self.obs = nxt
        return {"obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
                "next_obs": next_buf, "terminateds": done_buf}

    def sample_continuous(self, params, warmup_random: bool = False
                          ) -> Dict[str, np.ndarray]:
        """Stochastic continuous-action rollout (SAC exploration):
        actions drawn from the squashed-Gaussian policy (or the env's
        action space during warmup), transitions for the replay
        buffer."""
        gen = self._generator()
        T = self.rollout_length
        act_dim = int(np.prod(self.env.action_space.shape))
        obs_buf = np.zeros((T,) + np.shape(self.obs), np.float32)
        next_buf = np.zeros_like(obs_buf)
        act_buf = np.zeros((T, act_dim), np.float32)
        rew_buf = np.zeros((T,), np.float32)
        done_buf = np.zeros((T,), np.float32)
        for t in range(T):
            if warmup_random:
                a = self.env.action_space.sample().astype(np.float32)
            else:
                with torch.no_grad():
                    act, _ = self.module.sample(params, _obs_row(self.obs),
                                                gen)
                a = act[0].numpy().astype(np.float32)
            obs_buf[t] = self.obs
            act_buf[t] = a.reshape(act_dim)
            nxt, rew, terminated, truncated, _ = self.env.step(
                a.reshape(self.env.action_space.shape))
            rew_buf[t] = rew
            done_buf[t] = float(terminated)
            next_buf[t] = nxt
            self._record(rew)
            if terminated or truncated:
                self._close_episode()
                nxt, _ = self.env.reset()
            self.obs = np.asarray(nxt, np.float32)
        return {"obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
                "next_obs": next_buf, "terminateds": done_buf}
