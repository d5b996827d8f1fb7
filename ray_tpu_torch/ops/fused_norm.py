"""Fused norm epilogue: out-proj matmul + residual add + RMSNorm.

Counterpart of ``ray_tpu/ops/fused_norm.py``.  :func:`matmul_residual_norm`
is differentiable in all four operands through :class:`MatmulResidualNorm`.
On a CUDA tensor its forward launches ``csrc/matmul_residual_norm.cu``
(the port of the Pallas ``_fwd_kernel``) and its backward
``csrc/matmul_residual_norm_bwd.cu`` (``_bwd_kernel`` with the partial
sums of ``_mrn_bwd``): bf16 on the tensor cores (``wgmma``), f32 on the
CUDA cores, chosen by dtype alone.  On a CPU tensor both run their plain
versions.
Dispatch is the caller's: :func:`out_proj_norm_plan` is the reasoned
gate, with the JAX package's reasons; its mesh clause narrows to tensor
parallelism (a kernel here runs per rank on whole rows, so only a tp
split of the out-proj declines it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.substrate import (Support, check_cuda_args, is_cuda,
                                         on_cuda, require_built, supported,
                                         unsupported)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widths d the kernels are built for (the d_model of gpt2,
# gpt2_medium and gpt2_large), read by supports(), which the model's
# dispatch and the wrappers' checks both call; other widths come with the
# configurations that need them (ROADMAP Queue 2 item A)
_KERNEL_WIDTHS = (768, 1024, 1280)

matmul_residual_norm_kernel = _build.Kernel(
    "matmul_residual_norm_fwd", *[_build.PTR] * 7, *[_build.INT] * 3,
    _build.FLOAT, _build.INT, _build.PTR)
matmul_residual_norm_bwd_kernel = _build.Kernel(
    "matmul_residual_norm_bwd", *[_build.PTR] * 13, *[_build.INT] * 4,
    _build.PTR)
# the backward kernel's f32 scratch (csrc/matmul_residual_norm_bwd.cu):
# dscale partials, one [d] row per block of _BWD_ROWS rows (the da
# kernel's 64-row blocks), and dw partials, one [K, d] per slice of N;
# _BWD_SPLITS = 7 slices give the dw kernel 6 x 6 x 7 = 252 blocks of
# 128 x 128 at K = d = 768, two an SM, all resident on 132 SMs, in 16.5
# MB (PR 4's 8 slices took 18.9)
_BWD_ROWS = 64
_BWD_SPLITS = 7


def supports(N: int, K: int, d: int, *, device=None) -> Support:
    """Shapes the fused epilogue takes (the JAX gate's limits: the
    kernel holds a full ``d`` row per block and a ``[rows, K]`` slab in
    shared memory).  On a CUDA ``device`` a width the JAX gate takes but
    no kernel is built for (not in ``_KERNEL_WIDTHS``) raises; the CPU's
    plain version takes any."""
    if N <= 0:
        return unsupported(f"N={N} has no rows")
    if K % 128:
        return unsupported(f"K={K} not lane-aligned (128)")
    if d % 128:
        return unsupported(f"d={d} not lane-aligned (128)")
    if K > 1536 or d > 1536:
        return unsupported(f"K={K}, d={d}: the row slab and product tile "
                           "exceed the shared-memory budget (cap 1536)")
    if on_cuda(device):
        require_built("the out-proj epilogue: d", d, _KERNEL_WIDTHS, "A")
    return supported("fused out-proj epilogue kernel")


def out_proj_norm_plan(N: int, K: int, d: int, *, norm: str = "rmsnorm",
                       has_bias: bool = False, seq: Optional[int] = None,
                       enabled: bool = True, tp_size: int = 1,
                       device=None) -> Support:
    """The out-proj epilogue dispatch gate, with reasons.  ``enabled`` is
    the caller's ``fuse_norm`` choice (an argument: no environment knob
    reaches the port); ``tp_size`` the tensor-parallel width the block
    runs at; ``device`` is where the operands lie (on a CUDA device a
    width no kernel is built for raises, see :func:`supports`)."""
    if not enabled:
        return unsupported("disabled (fuse_norm=False)")
    if tp_size > 1:
        return unsupported(f"tp={tp_size}: the row-parallel out-proj's sum "
                           "over tp sits between the matmul and the "
                           "residual add")
    if norm != "rmsnorm":
        return unsupported(f"norm={norm!r}: only rmsnorm fuses")
    if has_bias:
        return unsupported("bias projections/norms (GPT-2 exact-"
                           "architecture mode) stay on the plain path")
    if seq is not None and seq <= 1:
        return unsupported("decode step (S=1): per-token kernel "
                           "launches lose to the plain epilogue")
    return supports(N, K, d, device=device)


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The bf16 kernels copy by TMA and in 16-byte vectors."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every operand must be 16-byte aligned")


def plain_matmul_residual_norm(a, w, resid, scale, *, eps: float = 1e-6
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The kernel's plain version (mirrors ``xla_matmul_residual_norm``):
    the f32 product is cast to the storage dtype before the residual
    add; the norm statistics are f32.  Returns ``(r, y, rstd)``."""
    p = torch.matmul(a.float(), w.float()).to(resid.dtype)
    r = resid + p
    r32 = r.float()
    rstd = torch.rsqrt(r32.square().mean(-1, keepdim=True) + eps)
    y = (r32 * rstd * scale.float()).to(r.dtype)
    return r, y, rstd[:, 0]


def matmul_residual_norm_fwd(a, w, resid, scale, *, eps: float = 1e-6
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(r, y, rstd)``; the kernel on CUDA tensors."""
    N, K = a.shape
    d = w.shape[1]
    ok = supports(N, K, d, device=a.device)
    if not ok:
        raise ValueError(f"matmul_residual_norm cannot tile: {ok.reason}")
    if not is_cuda(a):
        return plain_matmul_residual_norm(a, w, resid, scale, eps=eps)
    if w.shape != (K, d) or resid.shape != (N, d) or scale.shape != (d,):
        raise ValueError(f"matmul_residual_norm: shapes a {tuple(a.shape)}"
                         f", w {tuple(w.shape)}, resid "
                         f"{tuple(resid.shape)}, scale {tuple(scale.shape)}"
                         " do not line up")
    check_cuda_args("matmul_residual_norm", a, w, resid, scale,
                    dtype=a.dtype)
    if a.dtype not in _DTYPE_CODES:
        raise ValueError("matmul_residual_norm: the kernel takes float32 "
                         f"or bfloat16, got {a.dtype}")
    _check_aligned("matmul_residual_norm", a, w, resid, scale)
    r = torch.empty_like(resid)
    y = torch.empty_like(resid)
    rstd = torch.empty((N,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        matmul_residual_norm_kernel(
            a.data_ptr(), w.data_ptr(), resid.data_ptr(), scale.data_ptr(),
            r.data_ptr(), y.data_ptr(), rstd.data_ptr(), N, K, d, eps,
            _DTYPE_CODES[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
    return r, y, rstd


def plain_matmul_residual_norm_bwd(a, w, rout, scale, rstd, drout, dy
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor]:
    """The backward kernel's plain version (``_bwd_kernel`` plus the
    partial sums of ``_mrn_bwd``): ``(da, dw, dresid, dscale)``, the norm
    backward in f32, ``dr`` rounded to the storage dtype before both
    products, dscale in f32 cast to the scale's dtype."""
    r32 = rout.float()
    xhat = r32 * rstd[:, None]
    dy32 = dy.float()
    dxhat = dy32 * scale.float()
    m = (dxhat * xhat).mean(-1, keepdim=True)
    dr = rstd[:, None] * (dxhat - xhat * m) + drout.float()
    dresid = dr.to(rout.dtype)
    dp = dr.to(w.dtype).float()
    da = torch.matmul(dp, w.float().T).to(a.dtype)
    dw = torch.matmul(a.float().T, dp).to(w.dtype)
    dscale = (dy32 * xhat).sum(0).to(scale.dtype)
    return da, dw, dresid, dscale


def matmul_residual_norm_bwd(a, w, rout, scale, rstd, drout, dy
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """``(da, dw, dresid, dscale)``; the kernel on CUDA tensors."""
    if not is_cuda(a):
        return plain_matmul_residual_norm_bwd(a, w, rout, scale, rstd,
                                              drout, dy)
    N, K = a.shape
    d = w.shape[1]
    if (w.shape != (K, d) or rout.shape != (N, d) or drout.shape != (N, d)
            or dy.shape != (N, d) or scale.shape != (d,)
            or rstd.shape != (N,)):
        raise ValueError("matmul_residual_norm_bwd: shapes do not line up")
    check_cuda_args("matmul_residual_norm_bwd", a, w, rout, scale, drout, dy,
                    dtype=a.dtype)
    check_cuda_args("matmul_residual_norm_bwd", a, rstd,
                    dtype=None)
    if a.dtype not in _DTYPE_CODES or rstd.dtype != torch.float32:
        raise ValueError("matmul_residual_norm_bwd: the kernel takes float32"
                         " or bfloat16 operands and an f32 rstd")
    ok = supports(N, K, d, device=a.device)
    if not ok:
        raise ValueError(f"matmul_residual_norm_bwd cannot tile: "
                         f"{ok.reason}")
    _check_aligned("matmul_residual_norm_bwd", a, w, rout, scale, drout, dy)
    dev = a.device
    da = torch.empty_like(a)
    dw = torch.empty_like(w)
    dresid = torch.empty_like(rout)
    dscale = torch.empty((d,), dtype=torch.float32, device=dev)
    dsp = torch.empty((-(-N // _BWD_ROWS), d), dtype=torch.float32,
                      device=dev)
    dwp = torch.empty((_BWD_SPLITS, K, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        matmul_residual_norm_bwd_kernel(
            a.data_ptr(), w.data_ptr(), rout.data_ptr(), scale.data_ptr(),
            rstd.data_ptr(), drout.data_ptr(), dy.data_ptr(), da.data_ptr(),
            dw.data_ptr(), dresid.data_ptr(), dscale.data_ptr(),
            dsp.data_ptr(), dwp.data_ptr(), N, K, d, _DTYPE_CODES[a.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    return da, dw, dresid, dscale.to(scale.dtype)


class MatmulResidualNorm(torch.autograd.Function):
    """The custom VJP of ``fused_norm.py:_mrn``: saves ``(a, w, rout,
    scale, rstd)`` (the residual stream once, never both sides of the
    add) and returns ``(da, dw, dresid, dscale)``."""

    @staticmethod
    def forward(ctx, a, w, resid, scale, eps):
        r, y, rstd = matmul_residual_norm_fwd(a, w, resid, scale, eps=eps)
        ctx.save_for_backward(a, w, r, scale, rstd)
        return r, y

    @staticmethod
    def backward(ctx, drout, dy):
        a, w, rout, scale, rstd = ctx.saved_tensors
        drout = torch.zeros_like(rout) if drout is None else drout
        dy = torch.zeros_like(rout) if dy is None else dy
        da, dw, dresid, dscale = matmul_residual_norm_bwd(
            a, w, rout, scale, rstd, drout.contiguous(), dy.contiguous())
        return da, dw, dresid, dscale, None


def matmul_residual_norm(a, w, resid, scale, *, eps: float = 1e-6
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(resid + a @ w, rmsnorm(resid + a @ w) * scale)``, fused.

    a [N, K], w [K, d], resid [N, d], scale [d].  Differentiable in all
    four operands.  Shapes :func:`supports` declines raise (and, on a
    CUDA tensor, widths no kernel is built for): dispatch is the
    caller's job (:func:`out_proj_norm_plan`)."""
    ok = supports(a.shape[0], a.shape[1], w.shape[1], device=a.device)
    if not ok:
        raise ValueError(f"matmul_residual_norm cannot tile: {ok.reason}")
    return MatmulResidualNorm.apply(a, w, resid, scale, eps)
