"""Multi-agent environments + runner.

Counterpart of ``ray_tpu/rllib/env/multi_agent_env.py`` (parity: the
reference's ``rllib/env/multi_agent_env.py:29`` and the multi-agent
episode collection of ``rllib/env/multi_agent_env_runner.py``).

The API is the reference's dict convention: ``reset() -> (obs_dict,
info_dict)``, ``step(action_dict) -> (obs, rewards, terminateds,
truncateds, infos)`` with an ``"__all__"`` key in terminateds/truncateds
signalling the episode's end.  Agents map to policies through
``policy_mapping_fn(agent_id)``; the runner groups each policy's
transitions and hands back per-policy PPO train batches (GAE computed
per agent trajectory at collection time, by ``ppo._compute_gae``).  The
runner samples on the CPU, its draws from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch


class MultiAgentEnv:
    """Base class: subclass and implement reset/step over agent dicts."""

    agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    @property
    def num_agents(self) -> int:
        return len(self.agents)


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPoles, one per agent (the reference's standard
    multi-agent smoke env, ``rllib/examples/envs/classes/
    multi_agent.py`` MultiAgentCartPole)."""

    def __init__(self, num_agents: int = 2, seed: int = 0):
        import gymnasium as gym
        self.agents = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {a: gym.make("CartPole-v1") for a in self.agents}
        self._seed = seed
        first = self._envs[self.agents[0]]
        self.observation_space = first.observation_space
        self.action_space = first.action_space

    def reset(self, *, seed: Optional[int] = None):
        obs, infos = {}, {}
        for i, a in enumerate(self.agents):
            o, info = self._envs[a].reset(
                seed=(seed or self._seed) + i)
            obs[a] = o
            infos[a] = info
        self._done = {a: False for a in self.agents}
        return obs, infos

    def step(self, action_dict: Dict[str, Any]):
        obs, rews, terms, truncs, infos = {}, {}, {}, {}, {}
        for a, act in action_dict.items():
            if self._done[a]:
                continue
            o, r, te, tr, info = self._envs[a].step(act)
            obs[a], rews[a], infos[a] = o, float(r), info
            terms[a], truncs[a] = te, tr
            if te or tr:
                self._done[a] = True
        terms["__all__"] = all(self._done.values())
        truncs["__all__"] = False
        return obs, rews, terms, truncs, infos


@ray_tpu_torch.remote(num_cpus=1)
class MultiAgentEnvRunner:
    """Collect multi-agent rollouts; emit per-POLICY PPO batches.

    GAE runs here, per agent trajectory, so the learner receives flat
    (obs, actions, logp, advantages, value_targets) concatenations: the
    per-segment bookkeeping never crosses the actor boundary."""

    def __init__(self, env_factory_blob: bytes, modules_blob: bytes,
                 mapping_blob: bytes, rollout_length: int = 200,
                 gamma: float = 0.99, lam: float = 0.95, seed: int = 0):
        import cloudpickle
        self.env = cloudpickle.loads(env_factory_blob)()
        self.modules = cloudpickle.loads(modules_blob)  # policy -> module
        self.mapping = cloudpickle.loads(mapping_blob)
        self.rollout_length = rollout_length
        self.gamma = gamma
        self.lam = lam
        self.rng = np.random.default_rng(seed)
        self._gen: Optional[torch.Generator] = None
        self.completed_returns: List[float] = []
        self._obs, _ = self.env.reset(seed=seed)
        self._ep_return = 0.0

    def _sample(self, policy_id: str, params, ob):
        """(action, logp, value) of one agent's observation."""
        if self._gen is None:
            self._gen = torch.Generator().manual_seed(
                int(self.rng.integers(2 ** 31)))
        a, logp, v = self.modules[policy_id].sample_actions(
            params, torch.as_tensor(np.asarray(ob, np.float32)[None]),
            self._gen)
        return int(a[0]), float(logp[0]), float(v[0])

    def sample(self, params_by_policy: Dict[str, Any]
               ) -> Dict[str, Dict[str, np.ndarray]]:
        from ray_tpu_torch.rllib.algorithms.ppo import _compute_gae

        # per-agent open trajectory buffers
        traj = {a: {k: [] for k in ("obs", "actions", "logp", "values",
                                    "rewards", "terminateds")}
                for a in self.env.agents}
        closed: Dict[str, List[Dict[str, np.ndarray]]] = {}

        def close_agent(agent: str, bootstrap: float):
            t = traj[agent]
            if not t["obs"]:
                return
            batch = {k: np.asarray(v, np.float32) for k, v in t.items()}
            batch["obs"] = np.asarray(t["obs"], np.float32)
            batch["actions"] = np.asarray(t["actions"], np.int64)
            batch["bootstrap_value"] = np.float32(bootstrap)
            closed.setdefault(self.mapping(agent), []).append(
                _compute_gae(batch, self.gamma, self.lam))
            for v in t.values():
                v.clear()

        for _ in range(self.rollout_length):
            actions: Dict[str, Any] = {}
            stats: Dict[str, Tuple[int, float, float]] = {}
            for agent, ob in self._obs.items():
                pid = self.mapping(agent)
                stats[agent] = self._sample(pid, params_by_policy[pid], ob)
                actions[agent] = stats[agent][0]
            nxt, rews, terms, truncs, _ = self.env.step(actions)
            for agent in list(actions):
                act, logp, val = stats[agent]
                t = traj[agent]
                t["obs"].append(np.asarray(self._obs[agent], np.float32))
                t["actions"].append(act)
                t["logp"].append(logp)
                t["values"].append(val)
                t["rewards"].append(rews.get(agent, 0.0))
                term = bool(terms.get(agent, False))
                t["terminateds"].append(float(term))
                self._ep_return += rews.get(agent, 0.0)
                if term or truncs.get(agent, False):
                    close_agent(agent, 0.0)
            if terms.get("__all__") or truncs.get("__all__"):
                self.completed_returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs, _ = self.env.reset(
                    seed=int(self.rng.integers(2 ** 31)))
            else:
                self._obs = nxt
        # close still-open trajectories with bootstrapped values
        for agent in self.env.agents:
            if traj[agent]["obs"]:
                pid = self.mapping(agent)
                ob = self._obs.get(agent)
                boot = 0.0
                if ob is not None:
                    boot = self._sample(pid, params_by_policy[pid], ob)[2]
                close_agent(agent, boot)
        return {pid: {k: np.concatenate([b[k] for b in batches])
                      if k != "bootstrap_value" else np.float32(0)
                      for k in batches[0]}
                for pid, batches in closed.items()}

    def get_metrics(self) -> Dict[str, Any]:
        recent = self.completed_returns[-100:]
        return {"episode_return_mean": (float(np.mean(recent))
                                        if recent else float("nan")),
                "episodes_total": len(self.completed_returns)}
