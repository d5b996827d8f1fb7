"""Shared substrate for the port's kernel families.

Counterpart of ``ray_tpu/ops/substrate.py``.  What carries over is the
part that means something on any device: the masking constant, the
reasoned dispatch gates (:class:`Support`) and the env-knob readers.
The interpret-mode policy and the ``CompilerParams`` shim are Pallas
matters and have no Hopper meaning; :func:`resolve_device` takes their
place as the one rule for where the port runs.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Union

import torch

# masking constant for online-softmax kernels (finite: -inf would turn
# fully-masked rows into NaN through exp/max arithmetic)
NEG_INF = -1e30


class Support(NamedTuple):
    """A dispatch-gate verdict that carries its reason.

    Truthy iff the kernel path applies; ``reason`` states why not (or
    which path was chosen) so the tests can assert on why."""
    ok: bool
    reason: str = ""

    def __bool__(self) -> bool:
        return self.ok


def supported(reason: str = "") -> Support:
    return Support(True, reason)


def unsupported(reason: str) -> Support:
    return Support(False, reason)


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def env_flag(name: str, default: bool = True) -> bool:
    """Boolean env knob: unset -> ``default``; ``"0"`` is the one
    falsey spelling (matches the JAX package's ``RAY_TPU_*`` gates)."""
    return os.environ.get(name, "1" if default else "0") != "0"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: without one this raises rather than
    drifting to the CPU.  The CPU is taken only when the caller asks
    for it (``device="cpu"``), as the tests do."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def on_cuda(device) -> bool:
    """Whether a gate's ``device`` argument names a CUDA device."""
    return device is not None and torch.device(device).type == "cuda"


def require_built(what: str, value, built: tuple, item: str) -> None:
    """Raise unless ``value`` is among the shapes a kernel is built for.

    On a CUDA device the port launches a kernel or raises: a shape the
    JAX package's kernel takes but no kernel here is built for is an
    error naming the ROADMAP Queue 2 item that would build it, never a
    quiet trip through a plain version."""
    if value not in built:
        raise NotImplementedError(
            f"{what}={value}: no kernel is built for it (built for "
            f"{built}; ROADMAP Queue 2 item {item})")


def check_cuda_args(name: str, *tensors: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device (and of ``dtype`` when given): what the kernels take."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every input must be on one CUDA "
                             f"device, got {t.device} beside {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
