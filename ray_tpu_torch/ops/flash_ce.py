"""Flash-CE: streamed-logits cross-entropy (vocab matmul + online
logsumexp), with an optional final-RMSNorm prologue.

Counterpart of ``ray_tpu/ops/flash_ce.py``.  :func:`flash_ce_sum` and
:func:`flash_ce_norm_sum` return ``(sum_nll, n_valid)`` and are
differentiable through :class:`FlashCE`.  On a CUDA tensor the forward
launches ``csrc/flash_ce_fwd.cu`` (the port of the Pallas ``_fwd_kernel``)
and the backward ``csrc/flash_ce_bwd.cu`` (``_bwd_kernel``): bf16 on the
tensor cores (``wgmma`` GEMMs fed by TMA, ``csrc/flash_ce_tc.cuh``), f32
on the CUDA cores, chosen by dtype alone.  On a CPU tensor both run their
plain versions, which materialise the ``[N, V]`` logits, or with
``tile_v`` / ``chunk_rows`` follow the bf16 kernels' order of work.

The kernels take the head as ``w = head^T [V, d]``, rows contiguous: the
tied embedding's own layout, so the training path's head (``embed.T``)
reaches them with no copy, and its gradient goes back as the transpose
of ``dw``.  An untied head (``lm_head [d, V]``) has a strided transpose:
:class:`FlashCE` copies it to contiguous ``[V, d]`` rows once a step
(forward), and the wrappers refuse any non-contiguous ``x``, ``w`` or
``targets`` (``substrate.check_cuda_args``).  Any V > 1 runs: the last
vocab tile's columns past V (50,257 = 392 x 128 + 81 for HF GPT-2) are
masked in the forward's statistics and the true logit, and give a zero
``dl`` in the backward.

Dispatch is the caller's: ``mode`` and ``enabled`` are arguments (the
JAX package's ``RAY_TPU_CE`` and ``RAY_TPU_FUSE_NORM`` knobs do not reach
the port).  Masked ``-1`` targets count in neither the loss nor the
gradients; a vocab that is not a multiple of the kernel's tile is masked
inside the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.substrate import (Support, check_cuda_args, is_cuda,
                                         on_cuda, require_built, supported,
                                         unsupported)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widths d the kernels are built for, by dtype, read by supports(),
# which the model's dispatch and the wrappers' checks both call: the bf16
# kernels take d as a runtime loop bound and are checked on the card
# (chip_smoke.py --edges) at the d_model of gpt2, gpt2_medium and
# gpt2_large; the f32 kernels are built for 768 only (other widths:
# ROADMAP Queue 2 item A)
_KERNEL_WIDTHS = {torch.bfloat16: (768, 1024, 1280), torch.float32: (768,)}
flash_ce_fwd_kernel = _build.Kernel(
    "flash_ce_fwd", *[_build.PTR] * 8, *[_build.INT] * 3, _build.FLOAT,
    _build.INT, _build.INT, _build.PTR)
flash_ce_bwd_kernel = _build.Kernel(
    "flash_ce_bwd", *[_build.PTR] * 11, *[_build.INT] * 5, _build.PTR)


def supports(N: int, d: int, V: int, *, device=None,
             dtype=None) -> Support:
    """Shapes the streamed formulation takes (the JAX gate: ``d`` is the
    contraction and accumulator width of every tile).  On a CUDA
    ``device`` a width the JAX gate takes but no kernel of ``dtype`` is
    built for (not in ``_KERNEL_WIDTHS``) raises; the CPU's plain
    versions take any."""
    if not (d % 128 == 0 and 0 < d <= 2048 and N > 0 and V > 1):
        return unsupported(f"N={N}, d={d}, V={V}: the streamed "
                           "formulation takes d % 128 == 0, d <= 2048")
    if on_cuda(device):
        require_built(f"the flash-CE kernels ({dtype}): d", d,
                      _KERNEL_WIDTHS.get(dtype, ()), "A")
    return supported("flash-CE kernels")


def uses_flash_ce_norm(N: int, d: int, V: int, *, mode: str = "flash",
                       n_devices: int = 1, norm: str = "rmsnorm",
                       has_bias: bool = False, enabled: bool = True,
                       device=None, dtype=None) -> Support:
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
    if mode != "flash" or n_devices > 1:
        return unsupported(f"flash-CE path declined (mode={mode!r}, "
                           f"n_devices={n_devices})")
    ok = supports(N, d, V, device=device, dtype=dtype)
    if not ok:
        return unsupported(f"flash-CE path declined (N={N}, d={d}, V={V}; "
                           f"{ok.reason})")
    return supported("flash-CE with fused final-norm prologue")


def _rms(x, scale, eps: float):
    """(y, rstd): y = rmsnorm(x) * scale in x's dtype, f32 statistics."""
    x32 = x.float()
    rstd = torch.rsqrt(x32.square().mean(-1) + eps)
    return (x32 * rstd[:, None] * scale.float()).to(x.dtype), rstd


# ---------------------------------------------------------------------------
# the kernels and their plain versions
# ---------------------------------------------------------------------------

def plain_flash_ce_fwd(x, w, targets, norm=None, *,
                       tile_v: Optional[int] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The forward kernel's plain version: ``(lse, true)`` [N] f32, plus
    ``rstd`` [N] with ``norm = (scale, eps)``.  w is head^T [V, d].

    With ``tile_v``, the bf16 kernel's order of work: the logits of one
    ``tile_v``-column vocab tile at a time, each tile's row max ``m``
    and sum of ``exp(s - m)`` folded into the running pair in tile order,
    and the true logit taken from the tile that holds the target."""
    rstd = None
    if norm is not None:
        x, rstd = _rms(x, *norm)
    V = w.shape[0]
    live = targets >= 0
    tgt = targets.clamp_min(0).long()[:, None]
    if tile_v is None:
        logits = torch.matmul(x.float(), w.float().T)
        lse = torch.logsumexp(logits, -1)
        true = torch.where(live, logits.gather(1, tgt)[:, 0], 0.0)
    else:
        m = l = None
        true = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for v0 in range(0, V, tile_v):
            s = torch.matmul(x.float(), w[v0:v0 + tile_v].float().T)
            mt = s.amax(-1)
            lt = torch.exp(s - mt[:, None]).sum(-1)
            if m is None:
                m, l = mt, lt
            else:
                mn = torch.maximum(m, mt)
                l = l * torch.exp(m - mn) + lt * torch.exp(mt - mn)
                m = mn
            here = live & (targets >= v0) & (targets < v0 + s.shape[1])
            true = torch.where(here, s.gather(
                1, (tgt - v0).clamp(0, s.shape[1] - 1))[:, 0], true)
        lse = m + torch.log(l.clamp_min(1e-30))
    return (lse, true) if rstd is None else (lse, true, rstd)


def plain_flash_ce_bwd(x, w, targets, lse, srow, norm=None, *,
                       chunk_rows: Optional[int] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's plain version: ``(dx, dw)`` in the input
    dtype, plus ``dscale`` [d] f32 with ``norm = (scale, eps, rstd)``.
    ``srow`` [N] f32 is the loss cotangent where the target is live and 0
    where it is masked; ``dl`` is rounded to the head's dtype before both
    products (``flash_ce.py:329``).

    With ``chunk_rows``, the bf16 kernel's order of work: dl of one chunk
    of rows at a time, its dy and its share of dw, the shares added in
    f32 in chunk order and dw rounded once."""
    y = x
    if norm is not None:
        scale, _eps, rstd = norm
        y = (x.float() * rstd[:, None] * scale.float()).to(x.dtype)
    N, V = x.shape[0], w.shape[0]
    step = N if chunk_rows is None else chunk_rows
    cols = torch.arange(V, device=x.device)[None, :]
    dys, dw = [], None
    for r0 in range(0, N, step):
        yc = y[r0:r0 + step].float()
        logits = torch.matmul(yc, w.float().T)
        p = torch.exp(logits - lse[r0:r0 + step, None])
        onehot = (cols == targets[r0:r0 + step].long()[:, None]).float()
        dl = ((p - onehot) * srow[r0:r0 + step, None]).to(w.dtype).float()
        dys.append(torch.matmul(dl, w.float()))
        part = torch.matmul(dl.T, yc)
        dw = part if dw is None else dw + part
    dy = torch.cat(dys)
    dw = dw.to(w.dtype)
    if norm is None:
        return dy.to(x.dtype), dw
    xhat = x.float() * rstd[:, None]
    dxhat = dy * scale.float()
    m = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - xhat * m)
    return dx.to(x.dtype), dw, (dy * xhat).sum(0)


def _check_width(name: str, N: int, d: int, V: int, dtype) -> None:
    ok = supports(N, d, V, device="cuda", dtype=dtype)
    if not ok:
        raise ValueError(f"{name}: {ok.reason}")


def _check_ce_args(name: str, x, w, targets, scale) -> None:
    N, d = x.shape
    check_cuda_args(name, x, w, *([] if scale is None else [scale]),
                    dtype=x.dtype)
    check_cuda_args(name, x, targets)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    _check_width(name, N, d, w.shape[0], x.dtype)
    if w.shape[1] != d or targets.shape != (N,) or \
            targets.dtype != torch.int32:
        raise ValueError(f"{name}: w must be [V, {d}] and targets int32 "
                         f"[{N}]")
    if any(t.data_ptr() % 16 for t in (x, w) + (() if scale is None
                                                 else (scale,))):
        raise ValueError(f"{name}: x, w and scale must be 16-byte aligned "
                         "(the kernels copy rows in 16-byte vectors)")


def _workspace(symbol: str, N: int, d: int, V: int, norm: bool, dtype,
               dev) -> torch.Tensor:
    """The scratch an entry point takes, sized by the library itself."""
    n = _build.query(symbol, N, d, V, int(norm), _DTYPE_CODES[dtype])
    return torch.empty((max(n, 1),), dtype=torch.uint8, device=dev)


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
        ws = _workspace("flash_ce_fwd_workspace", N, d, w.shape[0],
                        norm is not None, x.dtype, dev)
        flash_ce_fwd_kernel(
            x.data_ptr(), w.data_ptr(), targets.data_ptr(),
            None if scale is None else scale.data_ptr(), lse.data_ptr(),
            true.data_ptr(), rstd.data_ptr(), ws.data_ptr(), N, d,
            w.shape[0], eps, int(norm is not None), _DTYPE_CODES[x.dtype],
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
    dscale = None
    if norm is not None:
        dscale = torch.empty((d,), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        ws = _workspace("flash_ce_bwd_workspace", N, d, w.shape[0],
                        norm is not None, x.dtype, dev)
        flash_ce_bwd_kernel(
            x.data_ptr(), w.data_ptr(), targets.data_ptr(), lse.data_ptr(),
            srow.data_ptr(), ptr(scale), ptr(rstd), dx.data_ptr(),
            dw.data_ptr(), ptr(dscale), ws.data_ptr(), N, d, w.shape[0],
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
    ``head`` is [d, V]; the kernels read its transpose in place when it
    is contiguous (the tied embedding's), else a contiguous copy."""

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
    (x, head).  Shapes :func:`supports` declines (on x's device, in x's
    dtype) take the dense formulation (same numerics, no streaming)."""
    N, d = x.shape
    if not supports(N, d, head.shape[1], device=x.device, dtype=x.dtype):
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
    if not supports(N, d, head.shape[1], device=x.device, dtype=x.dtype):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
        y = (x32 * norm_scale.float()).to(x.dtype)
        return _xla_ce_sum(y, head, targets)
    return FlashCE.apply(x, head.to(x.dtype), targets, norm_scale, eps)

