"""``ray_tpu_torch.quant`` — block-scaled int8 quantization (the int8 KV
cache's codes and scales, and the overlap schedule's int8 wire), the
port of ``ray_tpu.quant``."""

from ray_tpu_torch.quant.block_scale import (INT8_MAX,  # noqa: F401
                                             data_salt,
                                             dequantize_block,
                                             quant_error_bound,
                                             quantize_block,
                                             quantize_block_ref,
                                             stochastic_generator,
                                             wire_bytes)

__all__ = ["INT8_MAX", "quantize_block", "quantize_block_ref",
           "dequantize_block", "quant_error_bound", "wire_bytes",
           "stochastic_generator", "data_salt"]
