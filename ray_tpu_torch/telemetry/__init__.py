"""``ray_tpu_torch.telemetry`` — the analytic FLOP count and MFU
(:mod:`.flops`), the inference recorder (:mod:`.infer`), per-request
tracing and the flight recorder (:mod:`.trace`); the per-step training
recorder comes later (ROADMAP Queue 1 item 7)."""

from ray_tpu_torch.telemetry.flops import (  # noqa: F401
    H100_PEAK_TFLOPS, gpt_fwd_flops_per_token, gpt_train_flops_per_token,
    mfu)

__all__ = ["H100_PEAK_TFLOPS", "gpt_fwd_flops_per_token",
           "gpt_train_flops_per_token", "mfu"]
