"""``ray_tpu_torch.train.torch`` — TorchTrainer and TorchConfig, the
counterparts of the JAX package's ``JaxTrainer`` and ``JaxConfig``."""

from ray_tpu_torch.train.torch.config import (TorchConfig,  # noqa: F401
                                              TorchTrainer, prepare_data_loader,
                                              prepare_model)

__all__ = ["TorchConfig", "TorchTrainer", "prepare_model",
           "prepare_data_loader"]
