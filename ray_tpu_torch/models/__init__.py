"""``ray_tpu_torch.models`` — the GPT family in PyTorch."""

from ray_tpu_torch.models.gpt import (GPTConfig, forward,  # noqa: F401
                                      init_params)

__all__ = ["GPTConfig", "forward", "init_params"]
