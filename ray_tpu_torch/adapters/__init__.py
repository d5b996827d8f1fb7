"""``ray_tpu_torch.adapters`` — multi-tenant LoRA serving and
adapter-only training.

Counterpart of ``ray_tpu/adapters``: one base model plus many
per-tenant low-rank adapters.

- :mod:`~ray_tpu_torch.adapters.lora` — the math: A/B factor init, the
  merged-weights oracle, and the engine's **adapter bank** (``[N, L,
  in, r]`` stacked factors, slot 0 the all-zeros identity), which the
  step functions read every call, so a load or republish is a write
  into it and nothing is rebuilt.
- :mod:`~ray_tpu_torch.adapters.store` — :class:`AdapterStore`, the
  fleet-shared publication point keyed ``(model_id, version)``.
- :mod:`~ray_tpu_torch.adapters.registry` — :class:`AdapterRegistry`,
  which bank row holds which ``(model_id, version)``: LRU over the
  unpinned residents, pins from in-flight requests.
- :mod:`~ray_tpu_torch.adapters.config` — :class:`LoraConfig` and the
  ``RAY_TPU_LORA*`` / ``RAY_TPU_ADAPTER_CACHE`` knobs.

The engine applies each slot's adapter inside the batched steps
(``models.gpt.lora_delta``: gather the factors by slot id, two skinny
matmuls), so co-batched tenants share one tick; requests without a
``model_id`` ride slot 0 and equal an adapter-free engine.
"""

from ray_tpu_torch.adapters.config import ALL_TARGETS, LoraConfig, lora_config
from ray_tpu_torch.adapters.lora import (adapter_nbytes, bank_install,
                                         bank_zeros, init_adapter,
                                         merge_adapter, salt_bytes,
                                         target_dims)
from ray_tpu_torch.adapters.registry import AdapterRegistry
from ray_tpu_torch.adapters.store import AdapterStore, AdapterUnavailableError

__all__ = [
    "ALL_TARGETS", "LoraConfig", "lora_config", "target_dims",
    "init_adapter", "merge_adapter", "bank_zeros", "bank_install",
    "adapter_nbytes", "salt_bytes", "AdapterStore",
    "AdapterUnavailableError", "AdapterRegistry",
]
