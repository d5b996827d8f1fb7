"""Fused norm epilogue: out-proj matmul + residual add + RMSNorm.

Counterpart of ``ray_tpu/ops/fused_norm.py``, forward only.  On a CUDA
tensor :func:`matmul_residual_norm` launches
``csrc/matmul_residual_norm.cu`` (the port of the Pallas ``_fwd_kernel``);
on a CPU tensor it runs :func:`plain_matmul_residual_norm`.  Dispatch is
the caller's: :func:`out_proj_norm_plan` is the reasoned gate, with the
JAX package's reasons minus the mesh clause (a kernel here runs per
rank, so a mesh does not decline it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.substrate import (Support, check_cuda_args, is_cuda,
                                         supported, unsupported)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the width the kernel is built for: GPT-2's d_model; other widths come
# with the configurations that need them
_KERNEL_WIDTH = 768

matmul_residual_norm_kernel = _build.Kernel(
    "matmul_residual_norm_fwd", *[_build.PTR] * 7, *[_build.INT] * 3,
    _build.FLOAT, _build.INT, _build.PTR)


def supports(N: int, K: int, d: int) -> Support:
    """Shapes the fused epilogue takes (the JAX gate's limits: the
    kernel holds a full ``d`` row per block and a ``[rows, K]`` slab in
    shared memory)."""
    if N <= 0:
        return unsupported(f"N={N} has no rows")
    if K % 128:
        return unsupported(f"K={K} not lane-aligned (128)")
    if d % 128:
        return unsupported(f"d={d} not lane-aligned (128)")
    if K > 1536 or d > 1536:
        return unsupported(f"K={K}, d={d}: the row slab and product tile "
                           "exceed the shared-memory budget (cap 1536)")
    return supported("fused out-proj epilogue kernel")


def out_proj_norm_plan(N: int, K: int, d: int, *, norm: str = "rmsnorm",
                       has_bias: bool = False, seq: Optional[int] = None
                       ) -> Support:
    """The out-proj epilogue dispatch gate, with reasons.  It has only
    structural reasons: no knob turns the kernel off."""
    if norm != "rmsnorm":
        return unsupported(f"norm={norm!r}: only rmsnorm fuses")
    if has_bias:
        return unsupported("bias projections/norms (GPT-2 exact-"
                           "architecture mode) stay on the plain path")
    if seq is not None and seq <= 1:
        return unsupported("decode step (S=1): per-token kernel "
                           "launches lose to the plain epilogue")
    return supports(N, K, d)


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
    ok = supports(N, K, d)
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
    if d != _KERNEL_WIDTH:
        raise ValueError(f"matmul_residual_norm: the kernel is built for "
                         f"d={_KERNEL_WIDTH}, got d={d}")
    if w.data_ptr() % 32:
        raise ValueError("matmul_residual_norm: w must be 32-byte aligned "
                         "(tensor-core fragments load it in place)")
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


def matmul_residual_norm(a, w, resid, scale, *, eps: float = 1e-6
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(resid + a @ w, rmsnorm(resid + a @ w) * scale)``, fused.

    a [N, K], w [K, d], resid [N, d], scale [d].  Shapes
    :func:`supports` declines raise: dispatch is the caller's job
    (:func:`out_proj_norm_plan`)."""
    r, y, _rstd = matmul_residual_norm_fwd(a, w, resid, scale, eps=eps)
    return r, y

