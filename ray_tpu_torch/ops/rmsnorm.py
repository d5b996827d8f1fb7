"""RMSNorm with a hand-written forward and backward.

Counterpart of ``ray_tpu/ops/rmsnorm.py``.  :func:`rmsnorm` is
differentiable in ``x`` and ``scale`` through :class:`RMSNorm`.  On a CUDA
tensor its forward launches ``csrc/rmsnorm_fwd.cu`` (the port of the
Pallas ``_fwd_kernel``) and its backward ``csrc/rmsnorm_bwd.cu``
(``_bwd_kernel``); on a CPU tensor both run their plain versions.  The
model takes this path when ``models.gpt._PALLAS_NORM`` is on
(``RAY_TPU_PALLAS_NORM=1``), as the JAX package does.

rstd is a plain ``[N]`` f32 vector: the TPU kernel's ``[N, 128]`` lane
broadcast is a VMEM layout with no Hopper meaning.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.substrate import (Support, check_cuda_args, is_cuda,
                                         on_cuda, require_built, supported)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widths the kernels are built for (the d_model of GPTConfig.tiny,
# gpt2, gpt2_medium and gpt2_large), read by supports(), which the
# wrappers' checks call; other widths: ROADMAP Queue 2 item A
_KERNEL_WIDTHS = (64, 768, 1024, 1280)

rmsnorm_fwd_kernel = _build.Kernel(
    "rmsnorm_fwd", *[_build.PTR] * 4, _build.INT, _build.INT, _build.FLOAT,
    _build.INT, _build.PTR)
rmsnorm_bwd_kernel = _build.Kernel(
    "rmsnorm_bwd", *[_build.PTR] * 7, *[_build.INT] * 3, _build.PTR)
# rows per dscale partial of the backward kernel (csrc/rmsnorm_bwd.cu)
_BWD_ROWS = 128


def plain_rmsnorm_fwd(x, scale, *, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version: ``(y, rstd)`` for x [N, d],
    statistics in f32, ``y = (x * rstd) * scale`` rounded to x's dtype."""
    x32 = x.float()
    rstd = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    y = (x32 * rstd * scale.float()).to(x.dtype)
    return y, rstd[:, 0]


def plain_rmsnorm_bwd(x, scale, rstd, dy
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's plain version: ``(dx, dscale)``, in f32,
    ``dx`` rounded to x's dtype and ``dscale`` summed over every row in
    f32 and cast to the scale's dtype."""
    xhat = x.float() * rstd[:, None]
    dy32 = dy.float()
    dxhat = dy32 * scale.float()
    m = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - xhat * m)
    return dx.to(x.dtype), (dy32 * xhat).sum(0).to(scale.dtype)


def supports(d: int, *, device=None) -> Support:
    """Whether rows of width ``d`` take the kernels on ``device``: on the
    CPU every width (the plain versions); on a CUDA device the widths in
    ``_KERNEL_WIDTHS``, and any other raises (no plain version stands in
    for a kernel on the card)."""
    if not on_cuda(device):
        return supported("the plain version (not a CUDA device)")
    require_built("the RMSNorm kernels: d", d, _KERNEL_WIDTHS, "A")
    return supported("RMSNorm kernels")


def _check_kernel_args(name: str, x, scale) -> None:
    N, d = x.shape
    if scale.shape != (d,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} does not "
                         f"match x {tuple(x.shape)}")
    check_cuda_args(name, x, scale, dtype=x.dtype)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    supports(d, device=x.device)
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(f"{name}: x and scale must be 16-byte aligned "
                         "(the kernel reads rows in 16-byte vectors)")


def rmsnorm_fwd(x, scale, *, eps: float = 1e-6
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, rstd)`` for x [N, d]; the kernel on CUDA tensors."""
    if not is_cuda(x):
        return plain_rmsnorm_fwd(x, scale, eps=eps)
    _check_kernel_args("rmsnorm", x, scale)
    N, d = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty((N,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rmsnorm_fwd_kernel(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), rstd.data_ptr(),
            N, d, eps, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    return y, rstd


def rmsnorm_bwd(x, scale, rstd, dy) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)``; the kernel on CUDA tensors."""
    if not is_cuda(x):
        return plain_rmsnorm_bwd(x, scale, rstd, dy)
    _check_kernel_args("rmsnorm_bwd", x, scale)
    N, d = x.shape
    if dy.shape != x.shape or rstd.shape != (N,):
        raise ValueError("rmsnorm_bwd: dy must match x and rstd be [N]")
    check_cuda_args("rmsnorm_bwd", x, dy, dtype=x.dtype)
    check_cuda_args("rmsnorm_bwd", x, rstd)
    if rstd.dtype != torch.float32:
        raise ValueError("rmsnorm_bwd: rstd must be f32")
    if dy.data_ptr() % 16:
        raise ValueError("rmsnorm_bwd: dy must be 16-byte aligned")
    dev = x.device
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    dsp = torch.empty((-(-N // _BWD_ROWS), d), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        rmsnorm_bwd_kernel(
            x.data_ptr(), scale.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dsp.data_ptr(), N, d,
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    return dx, dscale


class RMSNorm(torch.autograd.Function):
    """The custom VJP of ``rmsnorm.py:rmsnorm``: saves ``(x, scale,
    rstd)`` and returns ``(dx, dscale)``."""

    @staticmethod
    def forward(ctx, x2, scale, eps):
        y, rstd = rmsnorm_fwd(x2, scale, eps=eps)
        ctx.save_for_backward(x2, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x2, scale, rstd, dy.contiguous())
        return dx, dscale, None


def rmsnorm(x, scale, eps: float = 1e-6) -> torch.Tensor:
    """``y = x * rsqrt(mean(x^2, -1) + eps) * scale``, fused forward and
    backward.  x: [..., d] (any leading dims), scale: [d]."""
    shape = x.shape
    y = RMSNorm.apply(x.reshape(-1, shape[-1]), scale, eps)
    return y.reshape(shape)
