"""``ray_tpu_torch.parallel`` — meshes, sharding rules, differentiable
collectives, and ring and Ulysses sequence parallelism."""

from ray_tpu_torch.parallel.ring_attention import local_attention  # noqa: F401

__all__ = ["local_attention"]
