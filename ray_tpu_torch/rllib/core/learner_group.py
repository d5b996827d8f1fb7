"""LearnerGroup — data-parallel learner actors with gradient allreduce.

Counterpart of ``ray_tpu/rllib/core/learner_group.py``: N learner actors
each hold a full copy of the module and its optimizer state and update
on their shard of the train batch; the gradients are flattened into one
buffer, summed over the group on the host ring of
``ray_tpu_torch.util.collective``, divided by the world size and put
back, so every learner takes the same optimizer step and the params
never part.  A learner actor may hold a card (``num_gpus_per_learner``)
and run its learner there.

The group hosts the ``ray_tpu_torch.rl`` actor/learner loop's learners
(``learner_cls="ray_tpu_torch.rl.learner.GPTPolicyLearner"``): batches
there are trajectory batches (``tokens``/``targets``/``rewards``, no
``obs``), and :meth:`LearnerGroup.publish_params` hands out the versioned
object-store weight snapshots the rollout actors swap in.  The default
``learner_cls`` is the reference's, PPO
(:class:`~ray_tpu_torch.rllib.algorithms.ppo.PPOLearner`); each learner
runs where its config's ``device`` says (None: the card).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch

PPO_LEARNER = "ray_tpu_torch.rllib.algorithms.ppo.PPOLearner"


@ray_tpu_torch.remote
class _LearnerActor:
    def __init__(self, module_blob: bytes, config, rank: int, world: int,
                 group_name: str, backend: str = "host",
                 learner_cls: str = PPO_LEARNER):
        import importlib

        import cloudpickle

        mod_path, cls_name = learner_cls.rsplit(".", 1)
        cls = getattr(importlib.import_module(mod_path), cls_name)
        module = cloudpickle.loads(module_blob)
        self.learner = cls(module, config)
        self.rank, self.world = rank, world
        if world > 1:
            from ray_tpu_torch.util import collective
            collective.init_collective_group(world, rank,
                                             backend=backend,
                                             group_name=group_name)
            self._group_name = group_name
        # the same seed everywhere: params start in sync and stay in
        # sync because every step applies the same allreduced gradient
        self.params, self.opt_state = self.learner.init_state(
            torch.Generator().manual_seed(int(config.seed)))

    def _allreduce(self, grads):
        """The group's mean of ``grads``: one flat f32 buffer on the
        host ring, divided by the world size, each leaf put back in its
        dtype and on its device."""
        from ray_tpu_torch.models.training import _leaves, _rebuild
        from ray_tpu_torch.util import collective
        leaves = _leaves(grads)
        flat = torch.cat([g.detach().reshape(-1).float().cpu()
                          for g in leaves])
        summed = collective.allreduce(flat.numpy(),
                                      group_name=self._group_name)
        mean = torch.from_numpy(np.asarray(summed, np.float32)
                                / np.float32(self.world))
        out, off = [], 0
        for g in leaves:
            n = g.numel()
            out.append(mean[off:off + n].view(g.shape).to(g.device,
                                                          g.dtype))
            off += n
        return _rebuild(grads, out)

    def update(self, shard: Dict[str, np.ndarray]) -> Dict[str, float]:
        allreduce = self._allreduce if self.world > 1 else None
        self.params, self.opt_state, metrics = self.learner.update(
            self.params, self.opt_state, shard, allreduce=allreduce)
        return metrics

    def get_params(self):
        """A host copy of the params (CPU tensors)."""
        from ray_tpu_torch.rl.learner import host_copy
        return host_copy(self.params)

    def ping(self):
        return self.rank


class LearnerGroup:
    """Driver-side fan-out over N learner actors."""

    def __init__(self, module, config, num_learners: int = 2,
                 num_cpus_per_learner: float = 1.0,
                 num_gpus_per_learner: float = 0.0,
                 backend: str = "host",
                 learner_cls: str = PPO_LEARNER):
        import cloudpickle
        blob = cloudpickle.dumps(module)
        group = f"learner_{uuid.uuid4().hex[:8]}"
        self._group = group
        self._backend = backend
        opts: Dict[str, Any] = {"num_cpus": num_cpus_per_learner}
        if num_gpus_per_learner:
            opts["num_gpus"] = num_gpus_per_learner
        self.world = num_learners
        self.actors = [
            _LearnerActor.options(**opts).remote(
                blob, config, rank, num_learners, group,
                backend, learner_cls)
            for rank in range(num_learners)]
        ray_tpu_torch.get([a.ping.remote() for a in self.actors],
                          timeout=300)
        self._param_version = 0

    @staticmethod
    def _batch_len(train_batch: Dict[str, np.ndarray]) -> int:
        """Leading batch dimension: ``obs`` for env batches, else the
        first array leaf (RL trajectory batches carry ``tokens``/
        ``targets``/``rewards`` and no ``obs``)."""
        if "obs" in train_batch:
            return len(train_batch["obs"])
        for v in train_batch.values():
            if getattr(v, "ndim", 0) >= 1:
                return v.shape[0]
        raise ValueError("train batch has no array leaves to shard")

    def update(self, train_batch: Dict[str, np.ndarray]
               ) -> Dict[str, float]:
        """Shard the batch on axis 0 across learners; every learner must
        see the same number of steps (collective lockstep), so the batch
        is trimmed to a multiple of the world size.  Arrays whose leading
        dim differs from the batch's are dropped from the shards."""
        n = self._batch_len(train_batch)
        usable = n - n % self.world
        per = usable // self.world
        if per == 0:
            raise ValueError(
                f"train batch of {n} rows cannot feed {self.world} "
                "learners — reduce num_learners or sample more")
        shards: List[Dict[str, np.ndarray]] = []
        for r in range(self.world):
            sl = slice(r * per, (r + 1) * per)
            shards.append({k: v[sl] for k, v in train_batch.items()
                           if getattr(v, "ndim", 0) >= 1
                           and v.shape[0] == n})
        metrics = ray_tpu_torch.get(
            [a.update.remote(shard)
             for a, shard in zip(self.actors, shards)], timeout=600)
        out: Dict[str, float] = {}
        for key in metrics[0]:
            out[key] = float(np.mean([m[key] for m in metrics]))
        return out

    def get_params(self):
        return ray_tpu_torch.get(self.actors[0].get_params.remote(),
                                 timeout=120)

    def get_all_params(self):
        """Every learner's params (tests hold them equal)."""
        return ray_tpu_torch.get([a.get_params.remote()
                                  for a in self.actors], timeout=120)

    def get_params_ref(self):
        """ObjectRef of rank 0's params, to pass straight into a
        downstream task without a driver round trip."""
        return self.actors[0].get_params.remote()

    def publish_params(self):
        """-> ``(version, ObjectRef)``: a *versioned* weight snapshot
        through the object store.  The learners stay in lockstep, so rank
        0's params are the group's; the monotonic version is what rollout
        actors pin with ``engine.set_params(..., version=...)`` and what
        the staleness bound prices lag in."""
        self._param_version += 1
        return self._param_version, self.get_params_ref()

    def stop(self):
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass
        if self.world > 1:
            # the ring's rendezvous mailbox is a detached actor; kill it
            # or every LearnerGroup leaks one
            try:
                ray_tpu_torch.kill(ray_tpu_torch.get_actor(
                    f"__collective_{self._group}"))
            except Exception:  # noqa: BLE001
                pass
