"""Train configuration types.

Counterpart of ``ray_tpu/train/config.py`` (parity: the reference's
``python/ray/air/config.py``: ScalingConfig, RunConfig, FailureConfig,
CheckpointConfig).  ``ScalingConfig.use_gpu`` gives each worker one card
(``"GPU": 1``) where the JAX package's ``use_tpu`` gives it a TPU host.
``RunConfig.callbacks`` are tune's experiment callbacks: the Tuner
invokes them (``tune/callbacks.py``).
``ScalingConfig.mesh_axes`` is the reference's field: each worker's
training context carries it (``TrainContext.get_mesh_axes``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # the logical mesh over the workers' world (axis name -> size, -1
    # fills from the world); a worker reads it as
    # train.get_context().get_mesh_axes() and passes it to
    # parallel.mesh.make_mesh
    mesh_axes: Optional[Dict[str, int]] = None

    @property
    def _resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res

    def as_placement_group_factory(self):
        from ray_tpu_torch.util.placement_group import placement_group
        bundles = [self._resources for _ in range(self.num_workers)]
        return lambda: placement_group(bundles,
                                       strategy=self.placement_strategy)


@dataclass
class FailureConfig:
    max_failures: int = 0
    fail_fast: bool = False


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    # experiment callbacks (ray_tpu_torch.tune.callbacks.Callback):
    # invoked by the Tuner controller at trial lifecycle points
    callbacks: Optional[list] = None
    verbose: int = 1

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results")
        return os.path.join(base, self.name or "experiment")
