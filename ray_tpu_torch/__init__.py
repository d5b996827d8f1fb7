"""``ray_tpu_torch`` — the PyTorch/CUDA port of ``ray_tpu``.

A second package beside the JAX one, written in PyTorch for NVIDIA
Hopper cards: where ``ray_tpu`` drops to a Pallas kernel for the TPU,
this package has a hand-written CUDA kernel (``ops/csrc``), built with
``nvcc`` on first use.  It imports neither ``jax`` nor ``ray_tpu``; its
tests hold it against the JAX package.

This slice ports the serving path: the GPT model
(:mod:`ray_tpu_torch.models.gpt`), the paged-KV inference engine
(:mod:`ray_tpu_torch.inference`) and the three kernels on that path
(prefill attention, decode attention, the fused out-proj epilogue).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from ray_tpu_torch.inference import (InferenceEngine,  # noqa: F401
                                     SamplingParams)
from ray_tpu_torch.models.gpt import GPTConfig, init_params  # noqa: F401

__all__ = ["GPTConfig", "init_params", "InferenceEngine", "SamplingParams"]
