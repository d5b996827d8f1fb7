"""Telemetry env knobs, the port's copy of
``ray_tpu/telemetry/config.py``.

- ``RAY_TPU_TELEMETRY`` (default ``1``): recorders on.  ``0`` turns
  every recorder into a no-op: the engine checks ``enabled`` before it
  touches one.  An unknown value falls back to ``1`` with a line on
  stderr.
- ``RAY_TPU_PROFILE`` (default unset): a directory for profiler
  captures; read here for the step recorder (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    enabled: bool = True
    profile_dir: Optional[str] = None


_CONFIG: Optional[TelemetryConfig] = None


def telemetry_config(refresh: bool = False) -> TelemetryConfig:
    """The process-wide :class:`TelemetryConfig` (env read once)."""
    global _CONFIG
    if _CONFIG is None or refresh:
        raw = os.environ.get("RAY_TPU_TELEMETRY", "1")
        if raw not in ("0", "1"):
            print(f"RAY_TPU_TELEMETRY={raw!r} unknown; using '1'",
                  file=sys.stderr)
            raw = "1"
        _CONFIG = TelemetryConfig(
            enabled=(raw == "1"),
            profile_dir=os.environ.get("RAY_TPU_PROFILE") or None,
        )
    return _CONFIG
