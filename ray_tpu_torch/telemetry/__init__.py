"""``ray_tpu_torch.telemetry`` — step accounting for the port (the
analytic FLOP count and MFU; the per-step recorder comes later)."""

from ray_tpu_torch.telemetry.flops import (  # noqa: F401
    H100_PEAK_TFLOPS, gpt_fwd_flops_per_token, gpt_train_flops_per_token,
    mfu)

__all__ = ["H100_PEAK_TFLOPS", "gpt_fwd_flops_per_token",
           "gpt_train_flops_per_token", "mfu"]
