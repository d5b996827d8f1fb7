"""TorchTrainer and TorchConfig: data parallelism over one
``torch.distributed`` world.

The counterparts of the JAX package's ``JaxTrainer`` / ``JaxConfig``
(``ray_tpu/train/jax/config.py``; the port has no ``train/jax``) and of
its ``TorchTrainer`` (``ray_tpu/train/torch/config.py``, parity: the
reference's ``python/ray/train/torch/config.py``).  :class:`TorchConfig`
takes over ``JaxConfig``'s duties:

- one process world across the workers: every worker joins the
  ``util.collective`` process-group backend (``"ici"``) under
  :data:`WORLD_GROUP`; rank 0 starts the rendezvous store and
  publishes its address in the control-plane KV under a key of this
  attempt's own, then every rank calls ``init_process_group``.
  ``backend`` None means NCCL when the workers hold cards
  (``ScalingConfig(use_gpu=True)``: ``torch.cuda.set_device(0)`` first,
  the worker's one visible card) and gloo otherwise.  A worker given a
  card that finds none raises, and a failed NCCL init raises: neither
  turns into gloo.  ``timeout_s`` bounds every collective, so a rank
  whose peers died raises instead of hanging the restart;
- ``host_collective``: a ``util.collective`` host group (the object
  store rings) named ``collective_group_name`` for small control-plane
  reductions;
- a restart re-initialises the world cleanly: each attempt's workers
  destroy any live process group first, and the group is torn down
  with its workers.

Inside the loop, ``parallel.mesh.make_mesh(dp=-1)`` is the mesh over
the world and ``models.training.build_gpt_train(cfg, mesh)`` reduces
its gradients over it.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup

# The ``util.collective`` name of the process world every worker joins.
WORLD_GROUP = "train_world"


@dataclass
class TorchConfig(BackendConfig):
    backend: Optional[str] = None       # "nccl" | "gloo" | None: by card
    timeout_s: int = 180
    host_collective: bool = True
    collective_group_name: str = ""     # the host group's name

    def backend_cls(self):
        return _TorchBackend


def _init_world(world_size: int, rank: int, group_name: str,
                rendezvous: str, backend: Optional[str], timeout_s: float,
                want_gpu: bool):
    """In a worker: a clean ``torch.distributed`` world of this
    attempt.  Returns (backend, seconds to a ready world)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.util import collective
    if want_gpu and not torch.cuda.is_available():
        import os
        raise RuntimeError(
            "a train worker given a card (use_gpu=True, "
            f"CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}"
            ") finds no CUDA device")
    if dist.is_initialized():
        dist.destroy_process_group()
    collective.destroy_collective_group(group_name)
    collective.init_collective_group(
        world_size, rank, backend="ici", group_name=group_name,
        timeout=float(timeout_s), dist_backend=backend,
        rendezvous=rendezvous)
    group = collective.get_group(group_name)
    return group.backend, group.init_s


def _init_host_collective(world_size: int, rank: int, group_name: str):
    from ray_tpu_torch.util import collective
    if not collective.is_group_initialized(group_name):
        collective.init_collective_group(world_size, rank, backend="host",
                                         group_name=group_name)
    return True


def _teardown(names):
    from ray_tpu_torch.util import collective
    for name in names:
        collective.destroy_collective_group(name)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class _TorchBackend(Backend):
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: TorchConfig):
        n = len(worker_group)
        if n == 0:
            return
        cfg = backend_config
        if cfg.host_collective:
            cfg.collective_group_name = (cfg.collective_group_name
                                         or f"train_{uuid.uuid4().hex[:8]}")
            ray_tpu_torch.get(
                [w.execute.remote(_init_host_collective, n, rank,
                                  cfg.collective_group_name)
                 for rank, w in enumerate(worker_group.workers)],
                timeout=120)
        want_gpu = bool(worker_group.resources.get("GPU"))
        rendezvous = f"{WORLD_GROUP}_{uuid.uuid4().hex}"
        inits = ray_tpu_torch.get(
            [w.execute.remote(_init_world, n, rank, WORLD_GROUP,
                              rendezvous, cfg.backend, cfg.timeout_s,
                              want_gpu)
             for rank, w in enumerate(worker_group.workers)],
            timeout=cfg.timeout_s + 60)
        self.backend = inits[0][0]
        self.init_s = max(s for _, s in inits)
        self._names = [WORLD_GROUP] + (
            [cfg.collective_group_name] if cfg.host_collective else [])
        self._host_store = (f"__collective_{cfg.collective_group_name}"
                            if cfg.host_collective else None)

    def on_shutdown(self, worker_group: WorkerGroup):
        names = getattr(self, "_names", [])
        try:
            ray_tpu_torch.get([w.execute.remote(_teardown, names)
                               for w in worker_group.workers], timeout=30)
        except Exception:  # noqa: BLE001 — the workers are killed next
            pass
        if getattr(self, "_host_store", None):
            try:
                ray_tpu_torch.kill(ray_tpu_torch.get_actor(
                    self._host_store))
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass


def prepare_model(model, parallel_strategy: Optional[str] = "ddp"):
    """Wrap a torch model for data parallelism (parity:
    ``train_loop_utils.prepare_model``): DDP over the live world of more
    than one rank, on the worker's card when it has one."""
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel as DDP
    if parallel_strategy == "ddp" and dist.is_initialized() and \
            dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            model = model.to(torch.device("cuda", 0))
            return DDP(model, device_ids=[0])
        return DDP(model)
    return model


def prepare_data_loader(data_loader):
    """Shard a DataLoader across the workers with a DistributedSampler."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return data_loader
    sampler = DistributedSampler(data_loader.dataset)
    return DataLoader(data_loader.dataset,
                      batch_size=data_loader.batch_size,
                      sampler=sampler,
                      num_workers=0,
                      collate_fn=data_loader.collate_fn,
                      drop_last=data_loader.drop_last)


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer with the torch backend: the counterpart of
    ``JaxTrainer``.  The loop runs per worker; inside it, build the mesh
    (``parallel.mesh.make_mesh(dp=-1)``) and the step
    (``models.training.build_gpt_train(cfg, mesh)``)."""

    def __init__(self, train_loop_per_worker, *,
                 torch_config: Optional[TorchConfig] = None,
                 backend_config: Optional[TorchConfig] = None, **kwargs):
        # backend_config is accepted as an alias so restore() can rebuild
        # a TorchTrainer from the generic trainer blob
        super().__init__(train_loop_per_worker,
                         backend_config=torch_config or backend_config
                         or TorchConfig(),
                         **kwargs)
