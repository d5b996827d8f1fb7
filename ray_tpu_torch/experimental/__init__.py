# The port's copy of ray_tpu/experimental/__init__.py
"""``ray_tpu_torch.experimental`` — incubating features (parity:
``ray.experimental``): mutable channels + compiled DAG execution."""

from ray_tpu_torch.experimental.channel import Channel, ChannelClosed

__all__ = ["Channel", "ChannelClosed"]
