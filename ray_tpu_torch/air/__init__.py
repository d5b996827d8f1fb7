# The port's copy of ray_tpu/air/__init__.py
"""AIR-shared plumbing (parity: ``python/ray/air``): run/checkpoint
configs live in ``ray_tpu_torch.train.config``; tracker integrations in
``ray_tpu_torch.air.integrations``."""

from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                        RunConfig, ScalingConfig)

__all__ = ["CheckpointConfig", "FailureConfig", "RunConfig",
           "ScalingConfig"]
