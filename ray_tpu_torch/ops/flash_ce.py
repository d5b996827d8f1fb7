"""Flash-CE: streamed-logits cross-entropy (vocab matmul + online
logsumexp), with an optional final-RMSNorm prologue.

Counterpart of ``ray_tpu/ops/flash_ce.py``.  :func:`flash_ce_sum` and
:func:`flash_ce_norm_sum` return ``(sum_nll, n_valid)`` and are
differentiable through :class:`FlashCE`.  On a CUDA tensor the forward
launches ``csrc/flash_ce_fwd.cu`` (the port of the Pallas ``_fwd_kernel``)
and the backward ``csrc/flash_ce_bwd.cu`` (``_bwd_kernel``); each takes the
norm prologue as a compile-time flag.  On a CPU tensor both run their
plain versions, which materialise the ``[N, V]`` logits.

The kernels take the head as ``w = head^T [V, d]``, the tied embedding's
own layout, so the training path's head (``embed.T``) reaches them with no
copy, and its gradient goes back as the transpose of ``dw``.

Dispatch is the caller's: ``mode`` and ``enabled`` are arguments (the
JAX package's ``RAY_TPU_CE`` and ``RAY_TPU_FUSE_NORM`` knobs do not reach
the port).  Masked ``-1`` targets count in neither the loss nor the
gradients; a vocab that is not a multiple of the kernel's tile is masked
inside the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.substrate import (Support, check_cuda_args, is_cuda,
                                         supported, unsupported)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the width the kernels are built for: GPT-2's d_model; other widths come
# with the configurations that need them
_KERNEL_WIDTH = 768
# the dscale scratch of the backward: one [d] partial per row block of the
# dx kernel, whose smallest row block is 16 rows
_BWD_MIN_ROWS = 16

flash_ce_fwd_kernel = _build.Kernel(
    "flash_ce_fwd", *[_build.PTR] * 7, *[_build.INT] * 3, _build.FLOAT,
    _build.INT, _build.INT, _build.PTR)
flash_ce_bwd_kernel = _build.Kernel(
    "flash_ce_bwd", *[_build.PTR] * 11, *[_build.INT] * 5, _build.PTR)


def supports(N: int, d: int, V: int) -> bool:
    """Shapes the streamed formulation takes (the JAX gate: ``d`` is the
    contraction and accumulator width of every tile)."""
    return d % 128 == 0 and 0 < d <= 2048 and N > 0 and V > 1


def uses_flash_ce(N: int, d: int, V: int, *, mode: str = "flash",
                  n_devices: int = 1) -> bool:
    """Whether the loss head takes the flash-CE path for this shape."""
    return mode == "flash" and n_devices <= 1 and supports(N, d, V)


def uses_flash_ce_norm(N: int, d: int, V: int, *, mode: str = "flash",
                       n_devices: int = 1, norm: str = "rmsnorm",
                       has_bias: bool = False,
                       enabled: bool = True) -> Support:
    """Dispatch gate (with reason) for the final-norm-fused CE path:
    the flash-CE conditions plus ``enabled`` (the caller's
    ``fuse_norm``) and a norm the prologue can fuse."""
    if not enabled:
        return unsupported("disabled (fuse_norm=False)")
    if norm != "rmsnorm":
        return unsupported(f"norm={norm!r}: only rmsnorm fuses")
    if has_bias:
        return unsupported("bias norms (GPT-2 exact-architecture mode) "
                           "stay on the plain path")
    if not uses_flash_ce(N, d, V, mode=mode, n_devices=n_devices):
        return unsupported(
            f"flash-CE path declined (mode={mode!r}, n_devices={n_devices},"
            f" N={N}, d={d}, V={V})")
    return supported("flash-CE with fused final-norm prologue")


def _rms(x, scale, eps: float):
    """(y, rstd): y = rmsnorm(x) * scale in x's dtype, f32 statistics."""
    x32 = x.float()
    rstd = torch.rsqrt(x32.square().mean(-1) + eps)
    return (x32 * rstd[:, None] * scale.float()).to(x.dtype), rstd


# ---------------------------------------------------------------------------
# the kernels and their plain versions
# ---------------------------------------------------------------------------

def plain_flash_ce_fwd(x, w, targets, norm=None
                       ) -> Tuple[torch.Tensor, ...]:
    """The forward kernel's plain version: ``(lse, true)`` [N] f32, plus
    ``rstd`` [N] with ``norm = (scale, eps)``.  w is head^T [V, d]."""
    rstd = None
    if norm is not None:
        x, rstd = _rms(x, *norm)
    logits = torch.matmul(x.float(), w.float().T)
    lse = torch.logsumexp(logits, -1)
    true = torch.where(targets >= 0, logits.gather(
        1, targets.clamp_min(0).long()[:, None])[:, 0], 0.0)
    return (lse, true) if rstd is None else (lse, true, rstd)


def plain_flash_ce_bwd(x, w, targets, lse, srow, norm=None
                       ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's plain version: ``(dx, dw)`` in the input
    dtype, plus ``dscale`` [d] f32 with ``norm = (scale, eps, rstd)``.
    ``srow`` [N] f32 is the loss cotangent where the target is live and 0
    where it is masked; ``dl`` is rounded to the head's dtype before both
    products (``flash_ce.py:329``)."""
    y = x
    if norm is not None:
        scale, _eps, rstd = norm
        y = (x.float() * rstd[:, None] * scale.float()).to(x.dtype)
    V = w.shape[0]
    logits = torch.matmul(y.float(), w.float().T)
    p = torch.exp(logits - lse[:, None])
    onehot = (torch.arange(V, device=x.device)[None, :]
              == targets.long()[:, None]).float()
    dl = ((p - onehot) * srow[:, None]).to(w.dtype).float()
    dy = torch.matmul(dl, w.float())
    dw = torch.matmul(dl.T, y.float()).to(w.dtype)
    if norm is None:
        return dy.to(x.dtype), dw
    xhat = x.float() * rstd[:, None]
    dxhat = dy * scale.float()
    m = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - xhat * m)
    return dx.to(x.dtype), dw, (dy * xhat).sum(0)


def _check_ce_args(name: str, x, w, targets, scale) -> None:
    N, d = x.shape
    check_cuda_args(name, x, w, *([] if scale is None else [scale]),
                    dtype=x.dtype)
    check_cuda_args(name, x, targets)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if d != _KERNEL_WIDTH:
        raise ValueError(f"{name}: the kernel is built for d="
                         f"{_KERNEL_WIDTH}, got d={d}")
    if w.shape[1] != d or targets.shape != (N,) or \
            targets.dtype != torch.int32:
        raise ValueError(f"{name}: w must be [V, {d}] and targets int32 "
                         f"[{N}]")
    if any(t.data_ptr() % 16 for t in (x, w) + (() if scale is None
                                                 else (scale,))):
        raise ValueError(f"{name}: x, w and scale must be 16-byte aligned "
                         "(the kernels copy rows in 16-byte vectors)")


def flash_ce_fwd(x, w, targets, norm=None) -> Tuple[torch.Tensor, ...]:
    """``(lse, true[, rstd])``; the kernel on CUDA tensors."""
    if not is_cuda(x):
        return plain_flash_ce_fwd(x, w, targets, norm)
    scale, eps = (None, 0.0) if norm is None else norm
    _check_ce_args("flash_ce", x, w, targets, scale)
    N, d = x.shape
    dev = x.device
    lse, true, rstd = (torch.empty((N,), dtype=torch.float32, device=dev)
                       for _ in range(3))
    with torch.cuda.device(dev):
        flash_ce_fwd_kernel(
            x.data_ptr(), w.data_ptr(), targets.data_ptr(),
            None if scale is None else scale.data_ptr(), lse.data_ptr(),
            true.data_ptr(), rstd.data_ptr(), N, d, w.shape[0], eps,
            int(norm is not None), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    return (lse, true) if norm is None else (lse, true, rstd)


def flash_ce_bwd(x, w, targets, lse, srow, norm=None
                 ) -> Tuple[torch.Tensor, ...]:
    """``(dx, dw[, dscale])``; the kernel on CUDA tensors."""
    if not is_cuda(x):
        return plain_flash_ce_bwd(x, w, targets, lse, srow, norm)
    scale, rstd = (None, None) if norm is None else (norm[0], norm[2])
    _check_ce_args("flash_ce_bwd", x, w, targets, scale)
    check_cuda_args("flash_ce_bwd", x, lse, srow,
                    *([] if rstd is None else [rstd]), dtype=None)
    N, d = x.shape
    dev = x.device
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    dsp = dscale = None
    if norm is not None:
        dsp = torch.empty((-(-N // _BWD_MIN_ROWS), d), dtype=torch.float32,
                          device=dev)
        dscale = torch.empty((d,), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        flash_ce_bwd_kernel(
            x.data_ptr(), w.data_ptr(), targets.data_ptr(), lse.data_ptr(),
            srow.data_ptr(), ptr(scale), ptr(rstd), dx.data_ptr(),
            dw.data_ptr(), ptr(dsp), ptr(dscale), N, d, w.shape[0],
            int(norm is not None), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    return (dx, dw) if norm is None else (dx, dw, dscale)


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------

class FlashCE(torch.autograd.Function):
    """The custom VJP of ``_flash_ce`` / ``_flash_ce_norm``: forward
    ``(sum_nll, n_valid)``; the residuals are [N]-sized (lse, and rstd
    with the prologue) plus the inputs the gradients contract against.
    ``head`` is [d, V]; the kernels read its transpose in place."""

    @staticmethod
    def forward(ctx, x, head, targets, scale, eps):
        w = head.T if head.T.is_contiguous() else head.T.contiguous()
        targets = targets.to(torch.int32).contiguous()
        norm = None if scale is None else (scale, eps)
        out = flash_ce_fwd(x, w, targets, norm)
        lse, true = out[0], out[1]
        mask = (targets >= 0).float()
        ctx.save_for_backward(x, w, targets, lse, scale,
                              None if scale is None else out[2])
        ctx.eps = eps
        n_valid = mask.sum()
        ctx.mark_non_differentiable(n_valid)
        return ((lse - true) * mask).sum(), n_valid

    @staticmethod
    def backward(ctx, gs, _gn):
        x, w, targets, lse, scale, rstd = ctx.saved_tensors
        srow = torch.where(targets >= 0, gs.float(), 0.0).contiguous()
        norm = None if scale is None else (scale, ctx.eps, rstd)
        out = flash_ce_bwd(x, w, targets, lse, srow, norm)
        dx, dw = out[0], out[1]
        dscale = None if scale is None else out[2].to(scale.dtype)
        return dx, dw.T, None, dscale, None


def _xla_ce_sum(x, head, targets):
    """The dense formulation (the reference's fallback for shapes the
    kernel declines, and the parity oracle): f32 logits from ``x @
    head``, ``(sum_nll, n_valid)``."""
    logits = torch.matmul(x.float(), head.float())
    lse = torch.logsumexp(logits, -1)
    true = logits.gather(1, targets.clamp_min(0).long()[:, None])[:, 0]
    mask = (targets >= 0).float()
    return ((lse - true) * mask).sum(), mask.sum()


def flash_ce_sum(x, head, targets):
    """Streamed-logits cross-entropy: ``(sum_nll, n_valid)``.

    x [N, d], head [d, V], targets [N] (-1 = masked).  Differentiable in
    (x, head).  Shapes :func:`supports` declines take the dense
    formulation (same numerics, no streaming)."""
    N, d = x.shape
    if not supports(N, d, head.shape[1]):
        return _xla_ce_sum(x, head, targets)
    return FlashCE.apply(x, head, targets, None, 0.0)


def flash_ce_norm_sum(x, head, targets, norm_scale, *, eps: float = 1e-6):
    """Final-norm-fused streamed-logits CE: ``(sum_nll, n_valid)``.

    x [N, d] is the raw residual stream (before the final norm); the
    kernels compute ``rmsnorm(x) * norm_scale`` in the vocab matmul's
    prologue, keep only the [N] statistics, and return the norm-scale
    gradient.  Differentiable in (x, head, norm_scale).  Shapes
    :func:`supports` declines take the unfused formulation."""
    N, d = x.shape
    if not supports(N, d, head.shape[1]):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
        y = (x32 * norm_scale.float()).to(x.dtype)
        return _xla_ce_sum(y, head, targets)
    return FlashCE.apply(x, head.to(x.dtype), targets, norm_scale, eps)

