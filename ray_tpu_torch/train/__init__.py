"""``ray_tpu_torch.train`` — distributed training (parity: ``ray.train``;
counterpart of ``ray_tpu/train``).  ``TorchTrainer`` / ``TorchConfig``
(:mod:`.torch`) take the place of the JAX package's ``JaxTrainer`` /
``JaxConfig``: one ``torch.distributed`` world across the workers, NCCL
on the card and gloo on the CPU."""

from ray_tpu_torch.train.backend import (Backend,  # noqa: F401
                                         BackendConfig, BackendExecutor,
                                         TrainingFailedError)
from ray_tpu_torch.train.checkpoint import (Checkpoint,  # noqa: F401
                                            load_pytree, save_pytree)
from ray_tpu_torch.train.config import (CheckpointConfig,  # noqa: F401
                                        FailureConfig, RunConfig,
                                        ScalingConfig)
from ray_tpu_torch.train.data_parallel_trainer import \
    DataParallelTrainer  # noqa: F401
from ray_tpu_torch.train.result import Result  # noqa: F401
from ray_tpu_torch.train.session import (get_checkpoint,  # noqa: F401
                                         get_context, get_dataset_shard,
                                         report)
from ray_tpu_torch.train.worker_group import WorkerGroup  # noqa: F401

__all__ = [
    "Backend", "BackendConfig", "BackendExecutor", "TrainingFailedError",
    "Checkpoint", "save_pytree", "load_pytree", "CheckpointConfig",
    "FailureConfig", "RunConfig", "ScalingConfig", "DataParallelTrainer",
    "Result", "get_checkpoint", "get_context", "get_dataset_shard",
    "report", "WorkerGroup",
]
