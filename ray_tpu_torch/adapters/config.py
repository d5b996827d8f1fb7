"""LoRA / adapter-serving knobs (``RAY_TPU_LORA_*``, ``RAY_TPU_ADAPTER_CACHE``).

Counterpart of ``ray_tpu/adapters/config.py``, read as it reads them.

Follows the frozen-dataclass + cached ``*_config(refresh=...)`` pattern
of :mod:`ray_tpu_torch.inference.config`: every knob validates with a warning
and falls back to its default rather than crashing the process.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional, Tuple

# Every matmul in layer_apply that can carry a low-rank delta.  ``w3``
# only exists under swiglu activation and is dropped at bank-build time
# for other activations.
ALL_TARGETS: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def _warn(msg: str) -> None:
    print(f"ray_tpu_torch.adapters: {msg}", file=sys.stderr)


def _pos_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        val = int(raw)
    except ValueError:
        _warn(f"{name}={raw!r} is not an integer; using {default}")
        return default
    if val <= 0:
        _warn(f"{name}={val} must be positive; using {default}")
        return default
    return val


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Geometry of the per-engine adapter bank.

    ``rank`` and ``targets`` fix the shapes of the engine's bank; loading
    or republishing adapters writes into it in place and never
    allocates a new one.
    ``cache_slots`` is the per-replica LRU capacity — the bank holds
    ``cache_slots + 1`` rows, with slot 0 reserved as the all-zeros
    identity that base (adapter-free) traffic rides.
    """

    enabled: bool = False
    rank: int = 8
    scale: float = 1.0
    targets: Tuple[str, ...] = ALL_TARGETS
    cache_slots: int = 8

    @property
    def bank_slots(self) -> int:
        """Total bank rows, including the identity slot 0."""
        return self.cache_slots + 1


_CACHED: Optional[LoraConfig] = None


def lora_config(refresh: bool = False) -> LoraConfig:
    """Read ``RAY_TPU_LORA`` (enable), ``RAY_TPU_LORA_RANK``,
    ``RAY_TPU_LORA_TARGETS`` (csv subset of matmul names) and
    ``RAY_TPU_ADAPTER_CACHE`` (resident adapters per replica)."""
    global _CACHED
    if _CACHED is not None and not refresh:
        return _CACHED

    enabled = os.environ.get("RAY_TPU_LORA", "0").lower() in ("1", "true", "yes")
    rank = _pos_int("RAY_TPU_LORA_RANK", 8)
    cache_slots = _pos_int("RAY_TPU_ADAPTER_CACHE", 8)

    targets: Tuple[str, ...] = ALL_TARGETS
    raw = os.environ.get("RAY_TPU_LORA_TARGETS")
    if raw:
        picked = tuple(t.strip() for t in raw.split(",") if t.strip())
        bad = [t for t in picked if t not in ALL_TARGETS]
        if bad or not picked:
            _warn(f"RAY_TPU_LORA_TARGETS={raw!r} has unknown targets "
                  f"{bad} (valid: {ALL_TARGETS}); using all targets")
        else:
            # canonical order keeps the bank's layout stable across
            # permuted csv spellings
            targets = tuple(t for t in ALL_TARGETS if t in picked)

    _CACHED = LoraConfig(enabled=enabled, rank=rank, targets=targets,
                         cache_slots=cache_slots)
    return _CACHED
