"""RL learners over :func:`ray_tpu_torch.models.training.build_gpt_rl_train`.

Counterpart of ``ray_tpu/rl/learner.py``.  Two hosting modes for the
same policy-gradient step:

- :class:`InProcessLearner` — one learner advanced in-process, its
  state's tensors updated in place;
- :class:`GPTPolicyLearner` — the **LearnerGroup protocol** class
  (``init_state(generator)`` / ``update(params, opt_state, batch,
  allreduce=)``), so ``rllib/core/learner_group.py`` hosts GPT policy
  learners: N learner actors, gradients allreduced on the host ring
  between ``pg_grad_fn`` and ``apply_grads_fn``, the same optimizer step
  everywhere.  ``learner_cls="ray_tpu_torch.rl.learner.GPTPolicyLearner"``
  with the pickled ``GPTConfig`` as the module is all the group needs.

A snapshot's host form is a tree of CPU tensors, always a copy, never
the learner's live tensors (numpy has no bf16).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class RLLearnerConfig:
    """LearnerGroup-side config for :class:`GPTPolicyLearner` (the
    pickle-friendly counterpart of the driver's knobs).

    ``lora=True`` hosts **adapter-only** learners: params are the LoRA
    A/B tree and the frozen base is drawn from ``base_seed`` inside every
    learner actor (a ``torch.Generator``, so all ranks freeze the same
    base; it is not the reference's ``jax.random`` base), and
    ``publish_params`` snapshots shrink to adapter bytes.  ``device``:
    where each learner runs (None: the card)."""
    lr: float = 1e-3
    grad_clip: float = 1.0
    baseline: str = "rloo"
    seed: int = 0
    lora: bool = False
    lora_rank: int = 8
    lora_scale: float = 1.0
    base_seed: int = 0
    device: Optional[str] = None


def host_copy(tree):
    """A copy of a tree of tensors (in dicts, tuples, NamedTuples and
    dataclasses) in fresh host memory; other leaves as they are."""
    from ray_tpu_torch.resilience.checkpoint import _host_tree
    return _host_tree(tree)


class InProcessLearner:
    """One learner replica advanced in-process.  ``device``: where it
    runs (None: the card)."""

    def __init__(self, cfg, *, mesh=None, baseline: str = "rloo",
                 lr: float = 1e-3, grad_clip: float = 1.0,
                 optimizer=None, seed: int = 0, fns=None,
                 lora=None, base_params=None, device=None):
        from ray_tpu_torch.models import training
        self.cfg = cfg
        self.mesh = mesh
        # ``fns``: a pre-built ``build_gpt_rl_train`` dict, shared by
        # learners of one geometry (supervised-loop restarts, tests);
        # baseline/optimizer/mesh/device are baked into it, so they are
        # ignored when it is passed
        self.fns = fns or training.build_gpt_rl_train(
            cfg, mesh, baseline=baseline,
            optimizer=optimizer or training.rl_optimizer(lr, grad_clip),
            lora=lora, base_params=base_params, device=device)
        self.state = self.fns["init_fn"](
            torch.Generator().manual_seed(int(seed)))
        self.steps = 0

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        self.state, metrics = self.fns["step_fn"](
            self.state, self.fns["shard_batch"](batch))
        self.steps += 1
        return {k: float(v) for k, v in metrics.items()}

    def params_host(self):
        """The publication form: a host copy of the params (CPU
        tensors), what ``WeightStore.publish`` ships and
        ``engine.set_params`` copies in; the live state stays here."""
        return host_copy(self.state.params)

    def publish_adapter(self, store, model_id: str, *,
                        scale: Optional[float] = None) -> int:
        """Adapter-only publication: put the current A/B snapshot into
        an :class:`~ray_tpu_torch.adapters.AdapterStore` under
        ``model_id`` and return the new version.  The bytes on the wire
        are ``adapters.adapter_nbytes``: rank-sized, not model-sized."""
        lcfg = self.fns.get("lora")
        if lcfg is None:
            raise ValueError(
                "learner was not built with lora=...; its params are "
                "full model weights — publish those through WeightStore")
        return store.put(model_id, self.params_host(),
                         scale=lcfg.scale if scale is None else scale)

    def state_host(self):
        """The checkpoint form: a host copy of the whole ``TrainState``
        (params, the optimizer's count and moments, step), what the
        supervised loop persists so a restored learner takes the
        identical next step."""
        return host_copy(self.state)

    def load_state(self, host_state) -> None:
        """Restore from a :meth:`state_host`-shaped snapshot (or one
        from ``convert.rl_state_from_jax``): each tensor goes to the
        device of the live leaf it replaces."""
        from ray_tpu_torch.models.training import AdamWState, TrainState
        from ray_tpu_torch.resilience.checkpoint import _load_into
        st = _load_into(self.state, host_state)
        opt = st.opt_state
        self.state = TrainState(st.params,
                                AdamWState(int(opt.count), opt.mu, opt.nu),
                                int(st.step))
        self.steps = self.state.step


class GPTPolicyLearner:
    """LearnerGroup-hosted GPT policy-gradient learner.

    The group's ``_LearnerActor`` holds (params, opt_state) and calls
    ``update`` per trajectory-batch shard; with ``allreduce`` set
    (num_learners > 1) the gradients ride the host collective ring
    between ``pg_grad_fn`` and ``apply_grads_fn``, so every learner takes
    the same step."""

    def __init__(self, module, config: RLLearnerConfig):
        from ray_tpu_torch.models import gpt as gpt_mod
        from ray_tpu_torch.models import training
        from ray_tpu_torch.ops.substrate import resolve_device
        self.cfg = module                     # a pickled GPTConfig
        self.config = config
        device = resolve_device(config.device)
        self.tx = training.rl_optimizer(config.lr, config.grad_clip)
        lora = base = None
        if config.lora:
            from ray_tpu_torch.adapters import LoraConfig
            lora = LoraConfig(enabled=True, rank=config.lora_rank,
                              scale=config.lora_scale)
            # every learner draws the same frozen base from the shared
            # seed: identical steps on identical state hold for the
            # adapter too
            base = gpt_mod.init_params(
                self.cfg, torch.Generator().manual_seed(config.base_seed),
                device=device)
        self.fns = training.build_gpt_rl_train(
            self.cfg, None, baseline=config.baseline, optimizer=self.tx,
            lora=lora, base_params=base, device=device)
        self._steps = 0

    def init_state(self, generator: torch.Generator):
        state = self.fns["init_fn"](generator)
        return state.params, state.opt_state

    def update(self, params, opt_state,
               train_batch: Dict[str, np.ndarray],
               allreduce: Optional[Callable] = None):
        batch = self.fns["shard_batch"](train_batch)
        (loss, metrics), grads = self.fns["pg_grad_fn"](params, batch)
        if allreduce is not None:
            grads = allreduce(grads)
        params, opt_state = self.fns["apply_grads_fn"](params, opt_state,
                                                       grads)
        self._steps += 1
        out = {k: float(v) for k, v in metrics.items()}
        out["total_loss"] = float(loss)
        out["step"] = float(self._steps)
        return params, opt_state, out


class LearnerGroupAdapter:
    """Drives a :class:`~ray_tpu_torch.rllib.core.learner_group.
    LearnerGroup` of :class:`GPTPolicyLearner` actors behind the
    ``update`` / ``params_host`` surface of :class:`InProcessLearner`, so
    ``run_rl_loop`` does not care where its learner runs.
    ``publish_ref()`` exposes the group's versioned object-store
    snapshot (``publish_params``), so a publication skips the driver.

    The baseline is applied **here, over the full batch**, and the hosted
    learners run baseline-free on the resulting advantages: the group
    shards the batch before the learners see it, so an in-learner RLOO
    would use per-shard leave-one-out baselines, a different (and at
    shard size 1, silently baseline-free) estimator."""

    def __init__(self, cfg, *, num_learners: int = 1,
                 baseline: str = "rloo", lr: float = 1e-3,
                 grad_clip: float = 1.0, seed: int = 0,
                 lora: bool = False, lora_rank: int = 8,
                 lora_scale: float = 1.0, base_seed: int = 0,
                 device: Optional[str] = None,
                 num_gpus_per_learner: float = 0.0):
        from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
        self.baseline = baseline
        self.lora_scale = lora_scale if lora else None
        self.group = LearnerGroup(
            module=cfg,
            config=RLLearnerConfig(lr=lr, grad_clip=grad_clip,
                                   baseline="none", seed=seed,
                                   lora=bool(lora), lora_rank=lora_rank,
                                   lora_scale=lora_scale,
                                   base_seed=base_seed, device=device),
            num_learners=num_learners,
            num_gpus_per_learner=num_gpus_per_learner,
            learner_cls="ray_tpu_torch.rl.learner.GPTPolicyLearner")
        self.steps = 0

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        from ray_tpu_torch.models.training import rl_advantages
        rewards = np.asarray(batch["rewards"], np.float32)
        batch = {"tokens": np.asarray(batch["tokens"], np.int32),
                 "targets": np.asarray(batch["targets"], np.int32),
                 "rewards": rl_advantages(rewards,
                                          self.baseline).numpy()}
        metrics = self.group.update(batch)
        # the learners saw advantages in the rewards slot, so their
        # reward_mean/max report advantage statistics; restore the true
        # rewards' so both hosting modes emit the same metrics
        metrics["reward_mean"] = float(np.mean(rewards))
        metrics["reward_max"] = float(np.max(rewards))
        self.steps += 1
        return metrics

    def params_host(self):
        return self.group.get_params()

    def publish_ref(self):
        """(version, ObjectRef) from the group: the object-store
        publication path."""
        return self.group.publish_params()

    def publish_adapter(self, store, model_id: str) -> int:
        """Adapter-only publication through the group's object-store
        snapshot: the rank-0 params ObjectRef (the adapter tree in lora
        mode) is shelved under ``(model_id, version)`` with the group's
        version pinned as the store's."""
        if self.lora_scale is None:
            raise ValueError(
                "group was not built with lora=True; its params are "
                "full model weights — publish via publish_ref()")
        version, ref = self.group.publish_params()
        return store.put(model_id, ref, scale=self.lora_scale,
                         version=version)

    def stop(self):
        self.group.stop()
