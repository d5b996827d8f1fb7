"""``ray_tpu_torch.parallel`` — single-device attention reference
(the ring and mesh layers come with multi-GPU training)."""

from ray_tpu_torch.parallel.ring_attention import local_attention  # noqa: F401

__all__ = ["local_attention"]
