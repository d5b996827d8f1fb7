"""IMPALA — importance-weighted asynchronous actor-learner architecture.

Counterpart of ``ray_tpu/rllib/algorithms/impala.py`` (parity: the
reference's ``rllib/algorithms/impala/``, Espeholt et al. 2018):
env-runner actors sample *continuously* with whatever (stale) policy
params they were last handed; the learner consumes completed rollout
segments as they arrive and corrects for the policy lag with V-trace.

The V-trace targets run as a reversed loop over time on the learner's
device; segments keep their [B, T] structure.  ``num_learners > 1``
scales out through the data-parallel
:class:`~ray_tpu_torch.rllib.core.learner_group.LearnerGroup`: the host
ring (``"host"``) or one ``torch.distributed`` world (``"ici"``: NCCL
on the card, gloo on the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.ppo import (_ConfigBuilder,
                                                _probe_discrete,
                                                _runner_returns)
from ray_tpu_torch.rllib.core import learner as lrn
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule


@dataclass
class IMPALAConfig(_ConfigBuilder):
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_env_runners: int = 4
    rollout_length: int = 64
    # segments consumed per train() call (async: whichever finish first)
    segments_per_iteration: int = 4
    num_learners: int = 1
    learner_backend: str = "host"      # "host" ring | "ici" device world
    num_cpus_per_learner: float = 1.0
    num_gpus_per_learner: float = 0.0
    lr: float = 5e-4
    gamma: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 40.0
    hidden: tuple = (64, 64)
    seed: int = 0
    device: Optional[str] = None

    def build(self) -> "IMPALA":
        return IMPALA(self)


def vtrace_targets(behavior_logp, target_logp, rewards, terminateds,
                   values, bootstrap_value, *, gamma: float,
                   rho_clip: float, c_clip: float):
    """V-trace corrected targets (all inputs [B, T] tensors; bootstrap
    [B]).

    Returns (vs [B, T], pg_advantages [B, T]); the caller detaches
    both.  The time recursion runs backwards, one step at a time.
    """
    log_rho = target_logp - behavior_logp
    rho = torch.clamp(torch.exp(log_rho), max=rho_clip)
    c = torch.clamp(torch.exp(log_rho), max=c_clip)
    next_values = torch.cat([values[:, 1:], bootstrap_value[:, None]], 1)
    nonterminal = 1.0 - terminateds
    deltas = rho * (rewards + gamma * next_values * nonterminal - values)
    acc = torch.zeros_like(values[:, 0])
    steps = []
    for t in reversed(range(values.shape[1])):
        acc = deltas[:, t] + gamma * c[:, t] * nonterminal[:, t] * acc
        steps.append(acc)
    vs = values + torch.stack(steps[::-1], dim=1)
    vs_next = torch.cat([vs[:, 1:], bootstrap_value[:, None]], 1)
    pg_adv = rho * (rewards + gamma * vs_next * nonterminal - values)
    return vs, pg_adv


@dataclasses.dataclass
class RMSPropState:
    nu: Any


@dataclasses.dataclass(frozen=True)
class ClippedRMSProp:
    """``optax.chain(clip_by_global_norm(grad_clip), rmsprop(lr, decay,
    eps))``: the second moment starts at 0, ``eps`` sits inside the
    square root and there is no bias correction (optax's defaults).  The
    clip divides by the norm exactly.  Updates the parameters and the
    moment in place."""
    lr: float
    grad_clip: float
    decay: float = 0.99
    eps: float = 0.1

    def init(self, params) -> RMSPropState:
        from ray_tpu_torch.models.training import _leaves, _rebuild
        return RMSPropState(_rebuild(params, [torch.zeros_like(p)
                                              for p in _leaves(params)]))

    @torch.no_grad()
    def update(self, grads, state: RMSPropState, params) -> RMSPropState:
        from ray_tpu_torch.models.training import _leaves, global_norm
        g_norm = global_norm(grads)
        keep = g_norm < self.grad_clip
        for p, g, nu in zip(_leaves(params), _leaves(grads),
                            _leaves(state.nu)):
            g = torch.where(keep, g, g / g_norm * self.grad_clip)
            nu.copy_((1 - self.decay) * g.square() + self.decay * nu)
            p.copy_(p + (torch.rsqrt(nu + self.eps) * g) * -self.lr)
        return state


class IMPALALearner:
    """The V-trace update (parity: impala_learner.py + vtrace):
    policy gradient on the V-trace advantages, the value loss against
    vs and the entropy bonus, through the clipped RMSProp.  The
    parameters are updated in place."""

    def __init__(self, module: DiscreteMLPModule, config: IMPALAConfig,
                 device=None):
        self.module = module
        self.config = config
        self.device = lrn.learner_device(device, config)
        self.tx = ClippedRMSProp(config.lr, config.grad_clip)

    def loss_fn(self, params, batch):
        cfg = self.config
        B, T = batch["rewards"].shape
        obs = batch["obs"].reshape((B * T,) + tuple(batch["obs"].shape[2:]))
        logits, values = self.module.forward(params, obs)
        logp_all = torch.log_softmax(logits, -1)
        target_logp = logp_all.gather(
            -1, batch["actions"].reshape(-1)[:, None])[:, 0].reshape(B, T)
        values = values.reshape(B, T)
        with torch.no_grad():
            vs, pg_adv = vtrace_targets(
                batch["logp"], target_logp, batch["rewards"],
                batch["terminateds"], values, batch["bootstrap_value"],
                gamma=cfg.gamma, rho_clip=cfg.vtrace_rho_clip,
                c_clip=cfg.vtrace_c_clip)
        pi_loss = -torch.mean(target_logp * pg_adv)
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
        total = (pi_loss + cfg.vf_coeff * vf_loss
                 - cfg.entropy_coeff * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "mean_rho": torch.mean(torch.exp(
                           target_logp - batch["logp"]))}

    def init_state(self, generator: torch.Generator):
        params = self.module.init_params(generator, device=self.device)
        return params, self.tx.init(params)

    def update(self, params, opt_state, train_batch: Dict[str, np.ndarray],
               allreduce: Optional[Callable] = None):
        """One V-trace step over a stacked [B, T] segment batch."""
        batch = lrn.batch_to(train_batch, self.device)
        loss, metrics, grads = lrn.value_and_grad_aux(self.loss_fn, params,
                                                      batch)
        metrics["total_loss"] = loss
        if allreduce is not None:
            grads = allreduce(grads)
        opt_state = self.tx.update(grads, opt_state, params)
        return params, opt_state, lrn.host_metrics(metrics)


def stack_segments(segments: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    """[ {key: [T,...]} x B ]  ->  {key: [B, T, ...]} (+bootstrap [B])."""
    out = {}
    for key in segments[0]:
        if key == "bootstrap_value":
            out[key] = np.asarray([s[key] for s in segments], np.float32)
        else:
            out[key] = np.stack([s[key] for s in segments])
    return out


class IMPALA:
    """Async algorithm driver.

    Every env runner always has a sample in flight; ``train()`` drains
    whichever segments complete first, resubmits those runners at once
    with the *current* params (so sampling never stops for learning),
    then takes one V-trace step on the collected batch.  The
    behavior-vs-target policy lag this creates is what V-trace corrects.
    """

    def __init__(self, config: IMPALAConfig):
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
                backend=config.learner_backend,
                learner_cls="ray_tpu_torch.rllib.algorithms.impala."
                            "IMPALALearner")
            self.params = None
            self.learner = None
        else:
            self.learner = IMPALALearner(self.module, config)
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
        # async pump: one standing sample per runner
        self._inflight: Dict[bytes, Any] = {}   # ref bytes -> (idx, ref)
        params_ref = self._params_ref()
        for i in range(len(self.env_runners)):
            self._submit(i, params_ref)

    def _params_ref(self):
        if self.learner_group is not None:
            return self.learner_group.get_params_ref()
        return ray_tpu_torch.put(lrn.host_params(self.params))

    def _submit(self, runner_idx: int, params_ref) -> None:
        ref = self.env_runners[runner_idx].sample.remote(params_ref)
        self._inflight[ref.binary()] = (runner_idx, ref)

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        want = self.config.segments_per_iteration
        segments: List[Dict[str, np.ndarray]] = []
        params_ref = self._params_ref()
        while len(segments) < want:
            refs = [pair[1] for pair in self._inflight.values()]
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=600)
            for ref in ready:
                idx, _ = self._inflight.pop(ref.binary())
                segments.append(ray_tpu_torch.get(ref, timeout=600))
                # resubmit at once with the current (possibly stale)
                # params: sampling never waits for learning
                self._submit(idx, params_ref)
                if len(segments) >= want:
                    break
        train_batch = stack_segments(segments)
        if self.learner_group is not None:
            learner_metrics = self.learner_group.update(train_batch)
        else:
            self.params, self.opt_state, learner_metrics = \
                self.learner.update(self.params, self.opt_state,
                                    train_batch)
        runner_metrics, ret = _runner_returns(self.env_runners)
        self.iteration += 1
        self.timesteps_total += int(np.prod(
            train_batch["rewards"].shape))
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
