"""``ray_tpu_torch`` — the PyTorch/CUDA port of ``ray_tpu``.

A second package beside the JAX one, written in PyTorch for NVIDIA
Hopper cards: where ``ray_tpu`` drops to a Pallas kernel for the TPU,
this package has a hand-written CUDA kernel (``ops/csrc``), built with
``nvcc`` on first use.  It imports neither ``jax`` nor ``ray_tpu``; its
tests hold it against the JAX package.

Ported so far: the GPT model (:mod:`ray_tpu_torch.models.gpt`), the
paged-KV inference engine with prefix caching, the int8 KV cache,
speculative decoding, disaggregated KV handoff, the tiered KV cache,
deadlines, telemetry and request tracing (:mod:`ray_tpu_torch.inference`,
:mod:`ray_tpu_torch.quant`, :mod:`ray_tpu_torch.telemetry`,
:mod:`ray_tpu_torch.util`, :mod:`ray_tpu_torch.resilience`), the
single-device training step (:mod:`ray_tpu_torch.models.training`) and
the ten kernel entry points on those paths (attention forward and
backward, decode attention and its int8 variant, the fused out-proj
epilogue forward and backward, flash-CE forward and backward, RMSNorm
forward and backward).  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from ray_tpu_torch.inference import (InferenceEngine,  # noqa: F401
                                     SamplingParams)
from ray_tpu_torch.models.gpt import GPTConfig, init_params  # noqa: F401

__all__ = ["GPTConfig", "init_params", "InferenceEngine", "SamplingParams"]
