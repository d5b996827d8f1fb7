"""``ray_tpu_torch.telemetry`` — the per-step training recorder
(:mod:`.step`: :class:`StepTelemetry`, :func:`instrument`), the analytic
FLOP count and MFU (:mod:`.flops`), the inference recorder
(:mod:`.infer`), the fleet recorder (:mod:`.fleet`), the RL loop's
(:mod:`.rl`), the checkpoint,
data-plane and elastic recorders (:mod:`.ckpt`, :mod:`.data`,
:mod:`.elastic`), per-request tracing
and the flight recorder (:mod:`.trace`), and the Chrome-trace exporter
(:mod:`.chrome_trace`)."""

from ray_tpu_torch.telemetry import chrome_trace  # noqa: F401
from ray_tpu_torch.telemetry.ckpt import CkptTelemetry  # noqa: F401
from ray_tpu_torch.telemetry.data import DataTelemetry  # noqa: F401
from ray_tpu_torch.telemetry.elastic import ElasticTelemetry  # noqa: F401
from ray_tpu_torch.telemetry.config import (TelemetryConfig,  # noqa: F401
                                            telemetry_config)
from ray_tpu_torch.telemetry.fleet import FleetTelemetry  # noqa: F401
from ray_tpu_torch.telemetry.rl import RLTelemetry  # noqa: F401
from ray_tpu_torch.telemetry.flops import (  # noqa: F401
    H100_PEAK_TFLOPS, gpt_fwd_flops_per_token, gpt_train_flops_per_token,
    mfu)
from ray_tpu_torch.telemetry.step import (StepTelemetry,  # noqa: F401
                                          instrument, recorders)

__all__ = ["TelemetryConfig", "telemetry_config", "StepTelemetry",
           "instrument", "recorders", "FleetTelemetry", "RLTelemetry",
           "chrome_trace",
           "CkptTelemetry", "DataTelemetry", "ElasticTelemetry",
           "H100_PEAK_TFLOPS", "gpt_fwd_flops_per_token",
           "gpt_train_flops_per_token", "mfu"]
