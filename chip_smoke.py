#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the checks below
    python3 chip_smoke.py --profile        # where the serving time goes
    python3 chip_smoke.py --profile train  # where a training step's goes

1. Start-up: prints the card (``nvidia-smi`` name and power limit), the
   torch and CUDA versions, and builds the kernels from
   ``ray_tpu_torch/ops/csrc`` with ``nvcc`` (timed).
2. Kernel phase: every kernel of the serving and training paths against
   its plain PyTorch version (computed in f32 on the same inputs) at the
   main paths' shapes, in bf16 and in f32, with its time, the plain
   version's, one PyTorch library call's as a yardstick, and the least
   time the card could take (``bound_ms``).
3. Engine phase: GPT-2 124M (random weights from a seed, bf16) serves
   16 requests through the paged-KV engine; every request must finish,
   the engine must be leak-free, and each kernel's launch count must be
   what the run implies.
4. Correctness: two greedy requests' logits against the port's
   teacher-forced ``forward`` on the CPU in f32 over the same weights.
5. Training phase: GPT-2 124M in bf16 trains 10 steps at batch 24 x
   1024 through ``build_gpt_train`` (flash attention with in-kernel
   RoPE, the fused epilogue, flash-CE with the norm prologue); prints
   ms/step, tokens/s, MFU and peak memory, checks the loss and the exact
   launch counts of every step.
6. Training correctness: one step's loss and every gradient of the
   kernel path against the port's plain path (local attention, unfused
   epilogue, dense CE) at full width and depth, batch 2 x 1024: in f32
   under a summation-order bound, and in bf16 against the f32 plain path.

Any failure raises and the script exits non-zero.  The line before the
last is ``{"kernels": [...]}``; the last is ``{"ok": true, "device":
...}``.  Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of the cards this port targets (NVIDIA data sheets,
# SXM parts, dense): device-memory bytes/s and bf16 tensor-core flop/s
PEAKS = {"H100": (3.35e12, 989e12), "H200": (4.8e12, 989e12)}

# bf16 kernel against its plain version computed in f32 on the same
# inputs.  A value may be off by ``rtol`` of itself (the bf16 rounding of
# the output, 2^-9, with headroom) plus ``row`` of its row's rms: p and
# the product are rounded to bf16 inside the kernel, which moves a value
# by a small share of its own row's scale.  A row of a long prefill has
# values ~0.04, so the bound there is ~1e-3, where a k tile dropped late
# in a 1024-long row moves o by ~1e-2.
BF16_TOL = dict(rtol=2 ** -7, row=2 ** -5)
# the f32 statistics (lse, rstd) from the same bf16 inputs: summation
# order and, for rstd, the bf16 rounding of r (~1.5e-4 of rstd per row,
# ~5e-4 at worst over 1024 rows)
LSE_TOL = dict(atol=2e-4)
RSTD_TOL = dict(rtol=2e-3)
# the f32 instantiations on the same inputs, against the same f32 plain
# version: summation order only (the CPU tests' bounds)
F32_TOL = dict(atol=2e-5, rtol=2e-5)
F32_MATMUL_TOL = dict(atol=1e-4, rtol=1e-4)   # 768-term products


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}: add them to "
                       "PEAKS before quoting a bound")


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, from CUDA events over ``iters``
    calls after a warm-up.  A spin kernel queued first keeps the card
    busy while the host enqueues the calls, so the events time the
    device's work and not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(what: str, got, ref, *, atol: float = 0.0, rtol: float = 0.0,
          row: float = 0.0) -> float:
    """Raise unless ``|got - ref| <= atol + rtol |ref| + row rms(ref
    row)`` everywhere (a row is the last dimension); print the largest
    share of that bound used, and return the max abs error."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (got - ref).abs()
    tol = atol + rtol * ref.abs()
    if row:
        tol = tol + row * ref.square().mean(-1, keepdim=True).sqrt()
    # an exact zero (a masked row) uses none of a zero bound
    share = torch.where(err > 0, err / tol, 0.0).max().item()
    print(f"  {what}: max_abs_err={err.max().item():.3e} "
          f"share_of_tol={share:.3f}", flush=True)
    if share > 1:
        raise AssertionError(
            f"{what}: {int((err > tol).sum())} values outside atol={atol} "
            f"rtol={rtol} row={row}")
    return err.max().item()


def bound(nbytes: float, flops: float, bw: float, peak: float):
    tb, tf = nbytes / bw * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class Recorder:
    """The ``{"kernels": [...]}`` rows: one per kernel, reporting the
    last (largest main-path) shape measured and the largest error seen
    over all its shapes."""

    def __init__(self, name: str):
        self.bw, self.peak = peaks(name)
        self.rows = {}

    def record(self, kernel, shape, err, ms, plain_ms, lib_ms, nbytes,
               flops, source, replaces):
        b_ms, b_by = bound(nbytes, flops, self.bw, self.peak)
        print(f"kernel {kernel} {shape}: max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
              flush=True)
        row = self.rows.setdefault(kernel, {
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(shape=shape, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def _randn(g, dev):
    def randn(*shape, s=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)
    return randn


def _f32(*xs):
    return [x.float() for x in xs]


def kernel_phase(rec: Recorder, dev) -> None:
    """The serving path's kernels against their plain versions at its
    shapes: the bf16 instantiation (timed) and, on the same inputs, the
    f32 one held to the summation-order bound."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(0)
    randn = _randn(g, dev)
    bf = torch.bfloat16
    print(f"tolerances: bf16 {BF16_TOL}, lse {LSE_TOL}, rstd {RSTD_TOL}, "
          f"f32 {F32_TOL}, f32 matmul {F32_MATMUL_TOL}", flush=True)

    # prefill attention at [1, S, 12, 64]
    H, D = 12, 64
    scale = D ** -0.5
    for S in (32, 128, 1024):
        q, k, v = (randn(1, S, H, D) for _ in range(3))
        o, lse = A.flash_attention_fwd(q, k, v, scale=scale)
        o_ref, lse_ref = A.plain_flash_attention_fwd(*_f32(q, k, v),
                                                     scale=scale)
        o32, lse32 = A.flash_attention_fwd(*_f32(q, k, v), scale=scale)
        torch.cuda.synchronize()
        what = f"flash_attention_fwd S={S}"
        err = max(check(f"{what} o", o, o_ref, **BF16_TOL),
                  check(f"{what} lse", lse, lse_ref, **LSE_TOL))
        check(f"{what} f32 o", o32, o_ref, **F32_TOL)
        check(f"{what} f32 lse", lse32, lse_ref, **F32_TOL)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec.record("flash_attention_fwd", [1, S, H, D], err,
                   time_ms(lambda: A.flash_attention_fwd(q, k, v,
                                                         scale=scale)),
                   time_ms(lambda: A.plain_flash_attention_fwd(
                       q, k, v, scale=scale)),
                   time_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True)),
                   4 * S * H * D * 2 + H * S * 4,
                   4 * H * D * S * (S + 1) / 2,
                   "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
                   "ray_tpu/ops/attention.py:477")

    # decode attention at [8, 1024, 12, 64]; positions >= lengths hold
    # NaN, which the kernel must never read
    B, S = 8, 1024
    lengths = torch.tensor([1, 1024, 37, 128, 129, 500, 777, 1000],
                           dtype=torch.int32, device=dev)
    q = randn(B, H, D)
    k, v = randn(B, S, H, D), randn(B, S, H, D)
    dead = (torch.arange(S, device=dev)[None, :]
            >= lengths[:, None].long())[..., None, None]
    k = k.masked_fill(dead, float("nan"))
    v = v.masked_fill(dead, float("nan"))
    o = A.decode_attention(q, k, v, lengths)
    o_ref = A.plain_decode_attention(*_f32(q, k, v), lengths, scale=scale)
    o32 = A.decode_attention(*_f32(q, k, v), lengths)
    torch.cuda.synchronize()
    err = check("decode_attention", o, o_ref, **BF16_TOL)
    check("decode_attention f32", o32, o_ref, **F32_TOL)
    mask = ~dead[:, :, 0, 0][:, None, None, :]          # [B, 1, 1, S]
    qs = q[:, :, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    valid = int(lengths.sum())
    rec.record("decode_attention", [B, S, H, D], err,
               time_ms(lambda: A.decode_attention(q, k, v, lengths)),
               time_ms(lambda: A.plain_decode_attention(q, k, v, lengths,
                                                        scale=scale)),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qs, kt, vt, attn_mask=mask)),
               2 * B * H * D * 2 + valid * H * D * 2 * 2,
               4 * H * D * valid,
               "ray_tpu_torch/ops/csrc/decode_attention.cu",
               "ray_tpu/ops/attention.py:1387")

    # out-proj + residual + rmsnorm at N in {32, 1024}, K = d = 768
    for N in (32, 1024):
        epilogue_fwd_check(rec, randn, g, dev, N, bf)


def epilogue_fwd_check(rec: Recorder, randn, g, dev, N: int, bf) -> None:
    import torch.nn.functional as F

    from ray_tpu_torch.ops import fused_norm as FN

    K = d = 768
    eps = 1e-6
    a = randn(N, K)
    w = randn(K, d, s=K ** -0.5)
    resid = randn(N, d)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
    got = FN.matmul_residual_norm_fwd(a, w, resid, sc, eps=eps)
    want = FN.plain_matmul_residual_norm(*_f32(a, w, resid, sc), eps=eps)
    got32 = FN.matmul_residual_norm_fwd(*_f32(a, w, resid, sc), eps=eps)
    torch.cuda.synchronize()
    what = f"matmul_residual_norm N={N}"
    err = max(check(f"{what} r", got[0], want[0], **BF16_TOL),
              check(f"{what} y", got[1], want[1], **BF16_TOL),
              check(f"{what} rstd", got[2], want[2], **RSTD_TOL))
    for part, x, y in zip("r y rstd".split(), got32, want):
        check(f"{what} f32 {part}", x, y, **F32_MATMUL_TOL)
    rec.record("matmul_residual_norm_fwd", [N, K, d], err,
               time_ms(lambda: FN.matmul_residual_norm_fwd(
                   a, w, resid, sc, eps=eps)),
               time_ms(lambda: FN.plain_matmul_residual_norm(
                   a, w, resid, sc, eps=eps)),
               time_ms(lambda: F.rms_norm(torch.addmm(resid, a, w), (d,),
                                          sc, eps)),
               (N * K + K * d + N * d + d) * 2 + 2 * N * d * 2 + N * 4,
               2 * N * K * d,
               "ray_tpu_torch/ops/csrc/matmul_residual_norm.cu",
               "ray_tpu/ops/fused_norm.py:202")


# the training path's shapes (bench.py:1932-1935): GPT-2 124M at batch
# 24 x 1024, so N = 24576 rows, d = 768, V = 50304, 12 heads of 64
TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_D = 24, 1024, 12, 64
TRAIN_N, TRAIN_V = TRAIN_B * TRAIN_S, 50304
# bf16 gradients against their plain version in f32 on the same inputs.
# The kernels round p and ds (attention), dr (the epilogue) and dl
# (flash-CE) to bf16 before their products, as the reference does; each
# moves a gradient by a few 2^-9 of its terms, which sum with random
# signs, so the bound is a share of the row's rms plus a share of the
# value: the forward's bound, doubled for the two rounded products that
# feed each gradient.
GRAD_BF16_TOL = dict(rtol=2 ** -6, row=2 ** -4)
# the flash-CE statistics from bf16 y: lse averages the score errors
# away, the true logit is one score of ~0.55 whose 768 terms each carry
# a 2^-9 rounding of y (~3e-3 at the extreme of 24576 rows)
CE_LSE_TOL = dict(atol=1e-3)
CE_TRUE_TOL = dict(atol=8e-3)
# f32 gradients from products over up to 50304 terms (flash-CE) or 24576
# rows (dw): summation order, ~1e-6 of the row scale
F32_GRAD_TOL = dict(atol=1e-5, rtol=1e-4, row=1e-4)


def train_kernel_phase(rec: Recorder, dev) -> None:
    """The training path's kernels against their plain versions at its
    shapes: the flash forward with its RoPE tables, the attention
    backward, the epilogue forward and backward at N = 24576, flash-CE
    forward and backward with the norm prologue.  bf16 (timed) and f32,
    each against the plain version in f32 on the same inputs."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import flash_ce as FC
    from ray_tpu_torch.ops import fused_norm as FN

    g = torch.Generator(device=dev).manual_seed(1)
    randn = _randn(g, dev)
    bf = torch.bfloat16
    print(f"training tolerances: grads bf16 {GRAD_BF16_TOL}, CE lse "
          f"{CE_LSE_TOL}, CE true {CE_TRUE_TOL}, grads f32 {F32_GRAD_TOL}",
          flush=True)

    # attention at [24, 1024, 12, 64] with the RoPE tables of the
    # training path (positions 0..S-1, theta 10000, cast to bf16).  The
    # bf16 kernel rounds the rotated q and k to bf16 (attention.py:_rot),
    # so its plain version in f32 takes them so rounded (qr, kr) and
    # applies the transposed rotation to dq and dk itself; the f32 kernel
    # is held to the plain version with the rotation inside, in f32.
    B, S, H, D = TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_D
    scale = D ** -0.5
    q, k, v, do = (randn(B, S, H, D) for _ in range(4))
    rope = A.rope_tables(torch.arange(S, device=dev), D, 10000.0, bf)
    rope32 = _f32(*rope)
    qr, kr = (A._rot(x, *rope).float() for x in (q, k))
    o, lse = A.flash_attention_fwd(q, k, v, scale=scale, rope=rope)
    o_ref, lse_ref = A.plain_flash_attention_fwd(qr, kr, v.float(),
                                                 scale=scale)
    o_ref32, lse_ref32 = A.plain_flash_attention_fwd(
        *_f32(q, k, v), scale=scale, rope=rope32)
    o32, lse32 = A.flash_attention_fwd(*_f32(q, k, v), scale=scale,
                                       rope=rope32)
    torch.cuda.synchronize()
    what = "flash_attention_fwd rope [24,1024,12,64]"
    err = max(check(f"{what} o", o, o_ref, **BF16_TOL),
              check(f"{what} lse", lse, lse_ref, **LSE_TOL))
    check(f"{what} f32 o", o32, o_ref32, **F32_TOL)
    check(f"{what} f32 lse", lse32, lse_ref32, **F32_TOL)
    del o_ref, lse_ref, o_ref32, lse_ref32, o32, lse32
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    tokens = B * S * H * D
    rec.record("flash_attention_fwd", [B, S, H, D], err,
               time_ms(lambda: A.flash_attention_fwd(q, k, v, scale=scale,
                                                     rope=rope), 5),
               time_ms(lambda: A.plain_flash_attention_fwd(
                   q, k, v, scale=scale, rope=rope), 3),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True), 5),
               4 * tokens * 2 + B * H * S * 4 + 2 * S * D * 2,
               4 * B * H * D * S * (S + 1) / 2,
               "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
               "ray_tpu/ops/attention.py:477")

    # the backward on the same inputs, with the bf16 forward's o and lse
    grads = A.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                  rope=rope)
    dq_r, dk_r, dv_r = A.plain_flash_attention_bwd(
        qr, kr, v.float(), o.float(), lse, do.float(), scale=scale)
    refs = (A._rot_t(dq_r, *rope32), A._rot_t(dk_r, *rope32), dv_r)
    del dq_r, dk_r, dv_r, qr, kr
    torch.cuda.synchronize()
    what = "flash_attention_bwd rope [24,1024,12,64]"
    err = max(check(f"{what} {n}", x, y, **GRAD_BF16_TOL)
              for n, x, y in zip(("dq", "dk", "dv"), grads, refs))
    del grads, refs
    refs32 = A.plain_flash_attention_bwd(*_f32(q, k, v, o), lse,
                                         do.float(), scale=scale,
                                         rope=rope32)
    grads32 = A.flash_attention_bwd(*_f32(q, k, v, o), lse, do.float(),
                                    scale=scale, rope=rope32)
    torch.cuda.synchronize()
    for n, x, y in zip(("dq", "dk", "dv"), grads32, refs32):
        check(f"{what} f32 {n}", x, y, **F32_GRAD_TOL)
    del refs32, grads32
    torch.cuda.empty_cache()

    def sdpa_fwd_bwd():
        a, b, c = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        F.scaled_dot_product_attention(a, b, c, is_causal=True).backward(dot)

    rec.record("flash_attention_bwd", [B, S, H, D], err,
               time_ms(lambda: A.flash_attention_bwd(
                   q, k, v, o, lse, do, scale=scale, rope=rope), 5),
               time_ms(lambda: A.plain_flash_attention_bwd(
                   q, k, v, o, lse, do, scale=scale, rope=rope), 3),
               time_ms(sdpa_fwd_bwd, 5),
               8 * tokens * 2 + B * H * S * 4 + 2 * S * D * 2,
               5 * 2 * B * H * D * S * (S + 1) / 2,
               "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
               "ray_tpu/ops/attention.py:925")
    del q, k, v, do, o, lse, qt, kt, vt, dot
    torch.cuda.empty_cache()

    # the out-proj epilogue at the training path's N, forward then
    # backward with cotangents into both outputs
    N, K = TRAIN_N, 768
    d = K
    epilogue_fwd_check(rec, randn, g, dev, N, bf)
    a = randn(N, K)
    w = randn(K, d, s=K ** -0.5)
    resid = randn(N, d)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
    rout, _y, rstd = FN.matmul_residual_norm_fwd(a, w, resid, sc)
    drout, dy = randn(N, d), randn(N, d)
    ins = (a, w, rout, sc, rstd, drout, dy)
    ins32 = (*_f32(a, w, rout, sc), rstd, *_f32(drout, dy))
    got = FN.matmul_residual_norm_bwd(*ins)
    want = FN.plain_matmul_residual_norm_bwd(*ins32)
    got32 = FN.matmul_residual_norm_bwd(*ins32)
    torch.cuda.synchronize()
    what = f"matmul_residual_norm_bwd N={N}"
    names = ("da", "dw", "dresid", "dscale")
    err = max(check(f"{what} {n}", x, y, **GRAD_BF16_TOL)
              for n, x, y in zip(names, got, want))
    for n, x, y in zip(names, got32, want):
        check(f"{what} f32 {n}", x, y, **F32_GRAD_TOL)

    def lib_epilogue():
        args = [x.detach().requires_grad_(True) for x in (a, w, resid, sc)]
        r = torch.addmm(args[2], args[0], args[1])
        y = F.rms_norm(r, (d,), args[3], 1e-6)
        torch.autograd.backward([r, y], [drout, dy])

    rec.record("matmul_residual_norm_bwd", [N, K, d], err,
               time_ms(lambda: FN.matmul_residual_norm_bwd(*ins), 10),
               time_ms(lambda: FN.plain_matmul_residual_norm_bwd(*ins), 5),
               time_ms(lib_epilogue, 10),
               (2 * N * K + 2 * K * d + 4 * N * d + 2 * d) * 2 + N * 4
               + d * 4,
               4 * N * K * d,
               "ray_tpu_torch/ops/csrc/matmul_residual_norm_bwd.cu",
               "ray_tpu/ops/fused_norm.py:247")
    del a, w, resid, rout, rstd, drout, dy, ins, ins32, got, want, got32
    torch.cuda.empty_cache()

    # flash-CE with the final-norm prologue: x the raw residual stream,
    # w the tied embedding [V, d] at its init scale, one target in seven
    # masked; the backward with the cotangent of the summed loss (1)
    V = TRAIN_V
    x = randn(N, d)
    w = randn(V, d, s=0.02)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
    tgt = torch.randint(0, V, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    tgt[::7] = -1
    srow = (tgt >= 0).float()
    eps = 1e-6
    lse, true, rstd = FC.flash_ce_fwd(x, w, tgt, (sc, eps))
    want = FC.plain_flash_ce_fwd(*_f32(x, w), tgt, (sc.float(), eps))
    got32 = FC.flash_ce_fwd(*_f32(x, w), tgt, (sc.float(), eps))
    torch.cuda.synchronize()
    what = f"flash_ce_fwd norm N={N} V={V}"
    err = max(check(f"{what} lse", lse, want[0], **CE_LSE_TOL),
              check(f"{what} true", true, want[1], **CE_TRUE_TOL),
              check(f"{what} rstd", rstd, want[2], **RSTD_TOL))
    for n, x32, y in zip(("lse", "true", "rstd"), got32, want):
        check(f"{what} f32 {n}", x32, y, **F32_GRAD_TOL)
    del want, got32
    torch.cuda.empty_cache()
    mask = tgt >= 0
    tgt_lib = tgt.long().masked_fill(~mask, -100)

    def lib_ce(backward: bool):
        xx, ww = (t.detach().requires_grad_(backward) for t in (x, w))
        y = F.rms_norm(xx, (d,), sc, eps)
        loss = F.cross_entropy(torch.matmul(y, ww.T).float(), tgt_lib,
                               reduction="sum")
        if backward:
            loss.backward()

    rec.record("flash_ce_fwd", [N, d, V], err,
               time_ms(lambda: FC.flash_ce_fwd(x, w, tgt, (sc, eps)), 5),
               time_ms(lambda: FC.plain_flash_ce_fwd(x, w, tgt, (sc, eps)),
                       3),
               time_ms(lambda: lib_ce(False), 3),
               (N * d + V * d + d) * 2 + N * 4 + 3 * N * 4,
               2 * N * d * V,
               "ray_tpu_torch/ops/csrc/flash_ce_fwd.cu",
               "ray_tpu/ops/flash_ce.py:223")

    norm = (sc, eps, rstd)
    norm32 = (sc.float(), eps, rstd)
    got = FC.flash_ce_bwd(x, w, tgt, lse, srow, norm)
    want = FC.plain_flash_ce_bwd(*_f32(x, w), tgt, lse, srow, norm32)
    got32 = FC.flash_ce_bwd(*_f32(x, w), tgt, lse, srow, norm32)
    torch.cuda.synchronize()
    what = f"flash_ce_bwd norm N={N} V={V}"
    names = ("dx", "dw", "dscale")
    err = max(check(f"{what} {n}", a_, b_, **GRAD_BF16_TOL)
              for n, a_, b_ in zip(names, got, want))
    for n, a_, b_ in zip(names, got32, want):
        check(f"{what} f32 {n}", a_, b_, **F32_GRAD_TOL)
    del got, want, got32
    torch.cuda.empty_cache()
    rec.record("flash_ce_bwd", [N, d, V], err,
               time_ms(lambda: FC.flash_ce_bwd(x, w, tgt, lse, srow, norm),
                       3),
               time_ms(lambda: FC.plain_flash_ce_bwd(x, w, tgt, lse, srow,
                                                     norm), 3),
               time_ms(lambda: lib_ce(True), 3),
               (2 * N * d + 2 * V * d + d) * 2 + 5 * N * 4 + d * 4,
               3 * 2 * N * d * V,
               "ray_tpu_torch/ops/csrc/flash_ce_bwd.cu",
               "ray_tpu/ops/flash_ce.py:352")
    del x, w, tgt, lse, true, rstd, srow
    torch.cuda.empty_cache()


GPT2 = dict(vocab_size=50304, max_seq=1024)
ENGINE = dict(slots=8, page_size=128)
# bf16 engine logits vs the f32 reference.  Random-init logits have an
# rms of ~0.55 (embed 0.02 x sqrt(768)).  Sound runs on an H100 left a
# largest error of 4.3e-2 and a mean error of 6.6e-3 (PERF.md); the
# limits are about twice and one and a half times those.  A fault that
# moves every logit a little (a position dropped from a context) shows
# in the mean first.
ENGINE_TOL = dict(atol=0.09)
ENGINE_MEAN_TOL = 0.01


def engine_phase(params, cfg, dev) -> dict:
    """16 requests (prompts of 40..900 tokens, 32 new tokens each, half
    greedy and half sampled) through the engine; prints the serving
    metrics and returns the launch counts of this run."""
    from ray_tpu_torch import InferenceEngine, SamplingParams
    from ray_tpu_torch.ops import _build

    engine = InferenceEngine(cfg, params, device=dev, **ENGINE)
    engine.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
    rng = np.random.default_rng(0)
    lengths = np.linspace(40, 900, 16).astype(int)
    rng.shuffle(lengths)
    prompts = [rng.integers(0, 50257, n).tolist() for n in lengths]
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    calls0 = dict(engine.call_counts)
    secs0 = dict(engine.seconds)
    _build.reset_launches()
    t0 = time.monotonic()
    rids = [engine.submit(p, max_new_tokens=32,
                          sampling=(None if i % 2 == 0 else
                                    dataclasses.replace(sampled, seed=i)))
            for i, p in enumerate(prompts)]
    submitted = time.monotonic()
    first, out = {}, {r: [] for r in rids}
    while engine.has_work():
        for rid, tok, _done in engine.step():
            first.setdefault(rid, time.monotonic())
            out[rid].append(tok)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _build.launch_counts()
    prefills = engine.call_counts["prefill"] - calls0["prefill"]
    decodes = engine.call_counts["decode"] - calls0["decode"]
    L = cfg.n_layers
    if any(len(out[r]) != 32 for r in rids) or len(first) != len(rids):
        raise AssertionError("not every request finished with 32 tokens")
    if not engine.leak_free():
        raise AssertionError("engine is not leak-free after the run")
    want = {"flash_attention_fwd": L * prefills,
            "matmul_residual_norm_fwd": L * prefills,
            "decode_attention": L * decodes,
            # serving runs no backward and no loss head
            "flash_attention_bwd": 0, "matmul_residual_norm_bwd": 0,
            "flash_ce_fwd": 0, "flash_ce_bwd": 0}
    if prefills != len(rids) or any(launches[k] != n
                                    for k, n in want.items()):
        raise AssertionError(f"launches {launches} != implied {want} "
                             f"({prefills} prefills, {decodes} decodes)")
    dec_s = engine.seconds["decode"] - secs0["decode"]
    pre_s = engine.seconds["prefill"] - secs0["prefill"]
    dec_tokens = sum(len(v) - 1 for v in out.values())
    metrics = {
        "requests": len(rids), "prefills": prefills, "decode_steps": decodes,
        "mean_ttft_ms": 1e3 * float(np.mean([first[r] - submitted
                                             for r in rids])),
        "prefill_ms": 1e3 * pre_s / prefills,
        "decode_step_ms": 1e3 * dec_s / decodes,
        "decode_tokens_per_s": dec_tokens / dec_s,
        "wall_s": wall,
    }
    print("engine phase: all 16 requests finished, leak-free; launches "
          f"{launches} == implied", flush=True)
    print("engine metrics " + json.dumps(metrics), flush=True)
    return launches


def correctness_phase(params, cfg, dev) -> None:
    """Two greedy requests' engine logits (bf16, on the card) against
    the port's teacher-forced forward on the CPU in f32, same weights:
    every logit within ``ENGINE_TOL``, their mean error within
    ``ENGINE_MEAN_TOL``, and greedy tokens equal to the reference argmax
    wherever its top-2 margin is wider than twice the tolerance (at
    least one such token must occur)."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.models.gpt import forward

    engine = InferenceEngine(cfg, params, device=dev, debug_logits=True,
                             **ENGINE)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 50257, n).tolist() for n in (40, 300)]
    outs = engine.generate(prompts, max_new_tokens=16)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def to_cpu32(tree):
        return {k: to_cpu32(v) if isinstance(v, dict) else v.float().cpu()
                for k, v in tree.items()}

    params32 = to_cpu32(params)
    worst, errs, checked, agree, total = 0.0, [], 0, 0, 0
    for rid, (prompt, gen) in enumerate(zip(prompts, outs)):
        full = torch.tensor(prompt + gen[:-1])[None]
        with torch.inference_mode():
            ref = forward(params32, full, cfg32)[0][0, len(prompt) - 1:]
        got = torch.from_numpy(np.stack(engine.logits_trace[rid]))
        worst = max(worst, check(f"engine logits request {rid}", got, ref,
                                 **ENGINE_TOL))
        errs.append((got - ref).abs().flatten())
        top2 = ref.topk(2, -1).values
        # a margin wider than twice the tolerance fixes the argmax
        sure = top2[:, 0] - top2[:, 1] > 2 * ENGINE_TOL["atol"]
        gen_t = torch.tensor(gen)
        if (ref.argmax(-1)[sure] != gen_t[sure]).any():
            raise AssertionError(f"request {rid}: a greedy token differs "
                                 "where the margin is wide")
        checked += int(sure.sum())
        agree += int((ref.argmax(-1) == gen_t).sum())
        total += len(gen)
    mean_err = torch.cat(errs).mean().item()
    if mean_err > ENGINE_MEAN_TOL:
        raise AssertionError(f"engine logits: mean abs error {mean_err:.3e}"
                             f" > {ENGINE_MEAN_TOL}")
    if checked == 0:
        raise AssertionError("no greedy token has a margin wider than "
                             "twice the tolerance: nothing was checked")
    if not engine.leak_free():
        raise AssertionError("correctness engine is not leak-free")
    print(f"correctness: engine logits within atol {ENGINE_TOL['atol']} "
          f"of the f32 CPU reference (max_abs_err={worst:.3e}, mean "
          f"{mean_err:.3e} <= {ENGINE_MEAN_TOL}); {checked} greedy tokens "
          f"with a margin over {2 * ENGINE_TOL['atol']} all agree; "
          f"{agree}/{total} equal the reference argmax", flush=True)


# the training cell "gpt2-train-b24": the JAX package's single-chip
# recipe (bench.py:1932-1935) at full width and depth, bf16, batch 24 x
# 1024, random weights from a seed, on one repeated synthetic batch
TRAIN_CFG = dict(vocab_size=50304, max_seq=1024, remat=False,
                 unroll_layers=True, ce_chunk=-1)
TRAIN_OPT = dict(lr=1e-3, warmup=2, total_steps=100)
WARMUP_STEPS, TIMED_STEPS = 2, 8
# launches of one training step: per layer one attention forward and
# backward and one epilogue forward and backward; one flash-CE pass each
TRAIN_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
                  "matmul_residual_norm_fwd": 12,
                  "matmul_residual_norm_bwd": 12,
                  "flash_ce_fwd": 1, "flash_ce_bwd": 1}


def train_phase(dev) -> dict:
    """GPT-2 124M trains WARMUP_STEPS + TIMED_STEPS steps in bf16 at
    24 x 1024; prints the step metrics and returns the launch counts of
    the timed steps, which must be exactly TRAIN_LAUNCHES per step."""
    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.telemetry import flops

    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), TRAIN_B,
                               TRAIN_S, cfg.vocab_size, device=dev)
    losses, norms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP_STEPS):
        state, m = fns["step_fn"](state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.monotonic()
    timed = []
    for _ in range(TIMED_STEPS):
        state, m = fns["step_fn"](state, batch)
        timed.append(m)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _build.launch_counts()
    losses += [float(m["loss"]) for m in timed]
    norms += [float(m["grad_norm"]) for m in timed]
    want = {k: n * TIMED_STEPS for k, n in TRAIN_LAUNCHES.items()}
    got = {k: launches[k] for k in want}
    if got != want or launches["decode_attention"]:
        raise AssertionError(f"training launches {launches} != {want} "
                             f"for {TIMED_STEPS} steps")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {losses[0]:.4f} is not near "
                             f"ln V = {math.log(cfg.vocab_size):.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    step_ms = 1e3 * wall / TIMED_STEPS
    tok_s = TRAIN_B * TRAIN_S * TIMED_STEPS / wall
    fpt = flops.gpt_train_flops_per_token(cfg, TRAIN_S, ce_recompute=True)
    metrics = {
        "cell": "gpt2-train-b24", "batch": [TRAIN_B, TRAIN_S],
        "step_ms": step_ms, "tokens_per_s": tok_s,
        "mfu": flops.mfu(tok_s, fpt),
        "train_flops_per_token": fpt,
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30,
        "losses": losses, "grad_norms": norms,
    }
    print(f"training phase: {WARMUP_STEPS + TIMED_STEPS} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches per step "
          f"{TRAIN_LAUNCHES} exact", flush=True)
    print("training metrics " + json.dumps(metrics), flush=True)
    return launches


# One step's loss and gradients, kernel path against the port's plain
# path (local attention with RoPE outside, unfused epilogue, dense CE) on
# the same f32 weights and batch, at full width and depth.
# - f32 against f32: summation order only.  The loss within 1e-5 of
#   itself; each gradient leaf within 1e-4 of its own largest value (the
#   JAX suite's grad bound, tests/test_models.py:177, which the CPU tests
#   hold at 2 layers).
# - bf16 kernel path against the f32 plain path: bf16 weights and
#   activations through 12 layers.  Sound runs on an H100 read a loss
#   difference of 9.0e-5 and a worst gradient error of 3.1e-2 of its
#   leaf's largest value (layers/wq; PERF.md section 2); the bounds are
#   about twice those.
TRAIN_F32_TOL = dict(loss_rel=1e-5, grad=1e-4)
TRAIN_BF16_TOL = dict(loss_abs=2e-4, grad=0.06)


def train_correctness_phase(dev) -> None:
    from ray_tpu_torch import GPTConfig, init_params
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.training import (synthetic_lm_batch,
                                               value_and_grad)
    from ray_tpu_torch.ops.attention import make_flash_attention_fn

    cfg32 = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.float32)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    params = init_params(cfg32, torch.Generator().manual_seed(2),
                         device=dev)
    batch = synthetic_lm_batch(torch.Generator().manual_seed(3), 2,
                               TRAIN_S, cfg32.vocab_size, device=dev)
    attn = make_flash_attention_fn(rope_theta=cfg32.rope_theta)

    def kernel_loss(cfg):
        return lambda p, b: gpt.loss_fn(p, b, cfg, attn_fn=attn)

    def plain_loss(p, b):
        return gpt.loss_fn(p, b, cfg32, fuse_norm=False, ce_mode="xla")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v

    ref_loss, ref_grads = value_and_grad(plain_loss, params, batch)
    ref = dict(leaves(ref_grads))
    runs = (("f32", cfg32, params, TRAIN_F32_TOL),
            ("bf16", cfg16, {k: ({kk: vv.to(torch.bfloat16)
                                  for kk, vv in v.items()}
                                 if isinstance(v, dict)
                                 else v.to(torch.bfloat16))
                             for k, v in params.items()}, TRAIN_BF16_TOL))
    for label, cfg, p, tol in runs:
        loss, grads = value_and_grad(kernel_loss(cfg), p, batch)
        torch.cuda.synchronize()
        dl = abs(float(loss) - float(ref_loss))
        lim = (tol["loss_rel"] * abs(float(ref_loss)) if "loss_rel" in tol
               else tol["loss_abs"])
        worst_share, worst = 0.0, ""
        for name, gr in leaves(grads):
            want = ref[name].float()
            err = (gr.float() - want).abs().max().item()
            share = err / (tol["grad"] * want.abs().max().item() + 1e-30)
            if not math.isfinite(share) or share > worst_share:
                worst_share, worst = share, name
        print(f"train correctness {label}: loss {float(loss):.6f} vs plain "
              f"f32 {float(ref_loss):.6f} (|diff| {dl:.3e}, "
              f"share_of_tol={dl / lim:.3f}); worst gradient {worst} "
              f"share_of_tol={worst_share:.3f} (bound {tol['grad']} of "
              "each leaf's largest value)", flush=True)
        if not dl <= lim or not worst_share <= 1:
            raise AssertionError(f"training step {label}: kernel path "
                                 "disagrees with the plain path")
        del grads
        torch.cuda.empty_cache()


def start_up() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    name = card()
    print(name, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ray_tpu_torch.ops import _build
    t0 = time.monotonic()
    lib = _build.build()
    print(f"built {lib.name} in {time.monotonic() - t0:.1f} s", flush=True)
    # one line per compiled kernel: name, registers, spills
    fn, spill = "", ""
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", line)
            if m is None:
                fn = line.split("'")[1][-60:]
                continue
            args = re.sub(r"Li(\d+)E?", r"\1,", m.group(2))
            args = args.replace("13__nv_bfloat16", "bf16,")
            fn = f"{m.group(1)}<{re.sub(r'^f', 'f32,', args).strip(',')}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and fn:
            print(f"  {fn}: {line.split(':', 1)[1].strip()}; {spill}",
                  flush=True)
            fn = ""
    return name


def report(what, prof, wall, steps, top=8):
    """The busiest device-side events of a profile (kernels, copies; an
    operator's device time is its kernels', which would count twice) and
    the device's busy share of the wall time."""
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    print(f"profile {what}: wall {1e3 * wall / steps:.3f} ms/step, "
          f"device busy {busy / steps:.3f} ms/step "
          f"({100 * busy / (1e3 * wall):.1f}% of wall)", flush=True)
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step"
              f"  {e.count // steps:4d} calls/step  {e.key[:90]}",
              flush=True)


def profile_phase(params, cfg, dev) -> None:
    """Where a prefill tick and a decode step spend their time: the
    busiest kernels by device time (torch.profiler), the device's busy
    share of the wall time, and the decode step split into its layer
    stack and its sampling (host clock around synchronised calls)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, **ENGINE)
    engine.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
    rng = np.random.default_rng(2)
    for _ in range(8):
        engine.submit(rng.integers(0, 50257, 512).tolist(),
                      max_new_tokens=24)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        engine.step()              # 8 prefills of 512 tokens + 1 decode
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report("admission tick (8 prefills @512 + 1 decode)", prof, wall, 1)
    for _ in range(2):
        engine.step()
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(8):
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report("decode step (8 slots)", prof, wall, 8)
    # the decode step without the profiler: layers vs sampling
    sched = engine.scheduler
    args = [torch.from_numpy(a).to(dev) for a in (
        np.array([r.generated[-1] for r in sched.active.values()]),
        sched.lengths, sched.page_table)]
    with torch.inference_mode():
        logits = engine._decode_step(*args)
        torch.cuda.synchronize()
        sampling = engine._sampling_inputs(list(sched.active.values()))
        n = 20
        t0 = time.monotonic()
        for _ in range(n):
            engine._decode_step(*args)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for _ in range(n):
            engine._sample(logits, sampling)
        t2 = time.monotonic()
    print(f"profile decode split: layer stack {1e3 * (t1 - t0) / n:.3f} "
          f"ms, sampling {1e3 * (t2 - t1) / n:.3f} ms", flush=True)


def train_profile_phase(dev) -> None:
    """Where one training step of the gpt2-train-b24 cell spends its
    device time (torch.profiler), after two unprofiled steps."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch)

    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), TRAIN_B,
                               TRAIN_S, cfg.vocab_size, device=dev)
    for _ in range(2):
        state, _m = fns["step_fn"](state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, _m = fns["step_fn"](state, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report("training step (gpt2-train-b24)", prof, wall, 1, top=20)


def main() -> None:
    name = start_up()
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--profile", "train"]:
        train_profile_phase(dev)
        return
    if sys.argv[1:] == ["--profile"]:
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        profile_phase(init_params(cfg, torch.Generator().manual_seed(0),
                                  device=dev), cfg, dev)
        return
    if sys.argv[1:]:
        raise SystemExit(f"unknown arguments {sys.argv[1:]}")
    rec = Recorder(name)
    kernel_phase(rec, dev)
    train_kernel_phase(rec, dev)
    from ray_tpu_torch import GPTConfig, init_params
    cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    serve_launches = engine_phase(params, cfg, dev)
    correctness_phase(params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    train_launches = train_phase(dev)
    train_correctness_phase(dev)
    # launches: each path driven with the counts at 0 just before it
    for row in rec.rows.values():
        by_path = {"serve": serve_launches[row["name"]],
                   "train": train_launches[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": list(rec.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
