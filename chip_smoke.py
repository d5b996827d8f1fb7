#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the checks below
    python3 chip_smoke.py --profile        # where the serving time goes
    python3 chip_smoke.py --profile int8   # the same on the int8 cache
    python3 chip_smoke.py --profile train  # where a training step's goes
    python3 chip_smoke.py --profile epilogue  # the epilogue entry points'
                                              # kernels at N = 24576
    python3 chip_smoke.py --profile ce     # the flash-CE entry points'
                                           # kernels at the training shape
    python3 chip_smoke.py --profile spec   # one verify forward and one
                                           # co-batched decode step
    python3 chip_smoke.py --spec           # the speculative-decoding
                                           # phase with every arm
    python3 chip_smoke.py --serve          # the serving-surface phases
                                           # (7b-7d) alone
    python3 chip_smoke.py --decode         # the decode checks and times
    python3 chip_smoke.py --edges          # the wgmma tile checks, the
                                           # decode checks, the
                                           # attention, epilogue and
                                           # flash-CE kernels' ragged
                                           # edges, and the width checks
                                           # (small; for compute-sanitizer)

1. Start-up: prints the card (``nvidia-smi`` name and power limit), the
   torch and CUDA versions, and builds the kernels from
   ``ray_tpu_torch/ops/csrc`` with ``nvcc`` (timed), then checks the
   ``wgmma`` variants the kernels build on alone (n64 with MN-major
   operands, n128 K-major and MN-major), each on one tile against the
   plain product.
2. Kernel phase: every kernel of the serving and training paths against
   its plain PyTorch version (computed in f32 on the same inputs) at the
   main paths' shapes, in bf16 and in f32, with its time, the plain
   version's, one PyTorch library call's as a yardstick, and the least
   time the card could take (``bound_ms``): the ten entry points, the
   int8 decode attention and the RMSNorm forward and backward included;
   the out-proj epilogue forward also at a verify forward's N = 2, 3, 5
   and 9 rows.
   The decode kernels padded and paged (``decode_checks``): bf16, f32 and
   int8 at [8, 1024, 12, 64] with lengths 1 to 1024 (split counts 1 to
   8), through a shuffled page table at pages of 128, 16 and 1, NaN past
   each length and in the garbage page, two calls and the two input
   modes bit-identical, outputs between guard bands; then timed at those
   lengths and with every row full, padded and paged, against the
   masked SDPA and ``gather_pages`` + SDPA.
   The attention kernels also at their ragged edges: the prefill forward
   at S = 1, 65 and 200, the training forward and backward at [2, S, 12,
   64] with and without RoPE for S = 65 and 200, and two bf16 backward
   calls on the same inputs must agree bit for bit.  The out-proj
   epilogue forward and backward likewise at N = 1, 63, 65 and 200 (K =
   768) and K = 384 and 1536 (N = 200), and at d = 1024 and 1280 (the
   widths of gpt2_medium and gpt2_large), bf16 and f32, inputs between
   NaN guard bands, outputs between -7.0 bands, two bf16 backward calls
   bit-identical.  The flash-CE forward and backward likewise at N = 1,
   63, 65 and 200 against V = 1000 and 50257, with and without the norm
   prologue, at d = 768 (bf16 and f32) and at 1024 and 1280 (bf16).
3. Engine phase (gpt2-serve-mixed): GPT-2 124M (random weights from a
   seed, bf16) serves 16 requests through the paged-KV engine with its
   defaults (prefix caching on; the random prompts share no page, so
   nothing hits); every request must finish, the engine must be
   leak-free, and each kernel's launch count must be what the run
   implies; no decode step may gather the paged context
   (``no_gather_in_decode``).
4. Correctness: two greedy requests' logits against the port's
   teacher-forced ``forward`` on the CPU in f32 over the same weights.
5. Engine phase gpt2-serve-int8-prefix: the same model with the int8 KV
   cache serves 16 requests behind 4 shared 512-token system prompts;
   exactly 12 hit the prefix cache, decode runs the int8 kernel only.
6. int8 correctness: a cold and a prefix-hit greedy request on the int8
   engine against the f32 teacher-forced reference, and against each
   other.
7. The RMSNorm kernels (``gpt._PALLAS_NORM``, ``RAY_TPU_PALLAS_NORM=1``)
   in serving: the correctness phase again, with exact norm launches.
7a. Speculative decoding (gpt2-serve-spec, ``spec_phase``): the JAX
   package's spec bench (2 slots, page 16, 4 requests of 512 new tokens
   one at a time, greedy; a templated and a random mix) with spec off
   and spec_k = 4 (``--spec``: 2, 4 and 8), each arm printing decode
   tokens/s, its speedup, the accept rate and histogram, verify calls
   and ms, decode dispatches and inter-token gaps; every stream equal to
   the off arm's but after a near-tie.  Then spec greedy requests'
   logits, verify rows included, against the f32 reference (bf16 and
   int8), and the serving geometry (8 slots, page 128, 8 templated
   requests half sampled) with spec on for all, half and none of them,
   in bf16 and int8.  Every run: all requests finish, leak-free, no
   drafter state left (also after ``drain_requests``), exact launches
   (the epilogue 12 per verify, decode attention 12 per decode
   dispatch), no decode step gathers.
7b. Disaggregated serving (gpt2-serve-disagg, ``disagg_phase``): a
   prefill engine and a decode engine (8 slots, page 128 each) serve
   gpt2-serve-mixed's 16 requests: a first-token-stop submission with
   ``hold_pages``, ``export_request`` as each finishes, ``import_submit``
   of the remaining 31 tokens; bf16 and the int8 cache.  Every stream
   equal to a co-located engine's, token for token; each handoff
   bit-equal to the exporter's pages, each install to its handoff at the
   context's positions; ``nbytes`` the per-page figure times the pages
   (int8 at most 0.55x bf16); exact launches (the exporter 12 prefill
   attentions per request and no decode, the importer 12 decode
   attentions per decode step and nothing else); importer telemetry
   equal to its counters; one sampled request traced across the handoff
   as one gap-free tree; both engines leak-free with nothing held; then
   a warm import of a whole-page context the importer holds by digest
   (nothing moves, same stream).  Prints ``disagg metrics {...}``.
7c. The tiered KV cache (gpt2-serve-tiers, ``tiers_phase``):
   gpt2-serve-int8-prefix's 16 requests in 8 waves of the 2 requests
   behind one system prompt, twice round the 4 prompts, on 10 usable
   pages with a 16-page host pool and a page store, against an engine
   that keeps every page resident; arms bf16 with the model-dtype spill
   and the int8 cache (streams equal the resident engine's, promoted
   requests included) and bf16 with the int8 spill (promoted greedy
   logits within ``INT8_TOL`` of the f32 reference).  16 promoted pages,
   spill bytes the per-page figure times the spills, exact launches,
   telemetry equal to the counters, leak-free, no fetch in flight.
   Prints ``tiers metrics {...}``.
7d. ``serving_obs_phase``: a TTFT and a total deadline on warm kernels
   (budgets at least 10x and 20x a warm step) with the watchdog running;
   ``infer.decode@1`` raising before any launch with the cache
   bit-identical and a clean drain; ``kv.spill@1``, ``kv.spill@4`` and
   ``kv.fetch@1`` each falling back to a cold prefill with the greedy
   stream unchanged (in f32).
8. Training phase: GPT-2 124M in bf16 trains 10 steps at batch 24 x
   1024 through ``build_gpt_train`` (flash attention with in-kernel
   RoPE, the fused epilogue, flash-CE with the norm prologue); prints
   ms/step, tokens/s, MFU and peak memory, checks the loss and the exact
   launch counts of every step.  Then 6 steps with the RMSNorm kernels.
9. Training correctness: one step's loss and every gradient of the
   kernel path against the port's plain path (local attention, unfused
   epilogue, dense CE) at full width and depth, batch 2 x 1024: in f32
   under a summation-order bound, and in bf16 against the f32 plain path;
   then the same at 2 layers with the RMSNorm kernels.
10. Width checks: the kernels at the widths of the repo's other presets
   (attention and decode at tiny's head_dim 16, RMSNorm at d = 64, 1024
   and 1280, the epilogue timed at gpt2_medium's and gpt2_large's
   training shapes), then a 2-layer gpt2_medium, gpt2_large and tiny
   step at two seeds, as in 9, with exact launches: every kernel their
   widths take runs, and none of the card's tensors goes to a plain
   version in a kernel's place.

Any failure raises and the script exits non-zero.  The line before the
last is ``{"kernels": [...]}``; the last is ``{"ok": true, "device":
...}``.  Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
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
               flops, source, replaces, **extra):
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
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **extra)
        # every shape measured, the row's own (the last) included
        row.setdefault("by_shape", []).append(dict(
            shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, **extra))


def _randn(g, dev):
    def randn(*shape, s=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)
    return randn


def _f32(*xs):
    return [x.float() for x in xs]


# decode attention: the smoke's lengths (split counts 1, 8, 1, 1, 2, 4, 7,
# 8 at 128 positions a split: most rows' counts differ from their
# neighbours') and the page sizes the paged entry is checked at
DECODE_LENGTHS = (1, 1024, 37, 128, 129, 500, 777, 1000)
DECODE_PAGE_SIZES = (128, 16, 1)
DECODE_SPLIT = 128   # positions a block owns (decode_attention.cu SPLIT),
                     # for the printed split counts only


def decode_context(g, dev, B, S, H, D, lengths) -> dict:
    """q [B, H, D] bf16 and a padded context [B, S, H, D] that holds
    garbage at every position >= its row's length: K, V in bf16 with
    NaN there; int8 codes and f32 scales [B, S, H] of fresh K/V from
    ``quantize_block``, with random codes and NaN scales there."""
    from ray_tpu_torch.quant import quantize_block

    randn = _randn(g, dev)
    dead = (torch.arange(S, device=dev)[None, :]
            >= lengths[:, None].long())[..., None, None]
    c = dict(q=randn(B, H, D))
    for n in ("k", "v"):
        c[n] = randn(B, S, H, D).masked_fill(dead, float("nan"))
        codes, sc = quantize_block(randn(B, S, H, D, dtype=torch.float32),
                                   block=D)
        noise = torch.randint(-128, 128, codes.shape, generator=g,
                              device=dev, dtype=torch.int8)
        c[n + "8"] = torch.where(dead, noise, codes)
        c[n + "s"] = sc[..., 0].masked_fill(dead[..., 0],
                                            float("nan")).contiguous()
    return c


def decode_pages(c: dict, lengths, page_size: int, g) -> tuple:
    """The padded context ``c`` laid out as the engine's cache holds it:
    pages [P, page_size, ...] with the garbage page 0 and each row's
    pages at shuffled ids, and a table [B, max_pages] int32 whose
    entries from ceil(len / page_size) on name the garbage page.  The
    garbage page and the positions past S hold NaN (codes: 127), and
    the float pages sit between NaN guard bands (``_guarded``).
    Returns (pages by name, table, max_pages)."""
    B, S = c["k"].shape[:2]
    mp = -(-S // page_size)
    ids = (torch.randperm(B * mp, generator=g, device=g.device) + 1)
    pages = {}
    for n in ("k", "v", "k8", "v8", "ks", "vs"):
        x = c[n]
        fill = 127 if x.dtype == torch.int8 else float("nan")
        ctx = torch.full((B, mp * page_size) + x.shape[2:], fill,
                         dtype=x.dtype, device=x.device)
        ctx[:, :S] = x
        pool = torch.full((1 + B * mp, page_size) + x.shape[2:], fill,
                          dtype=x.dtype, device=x.device)
        pool[ids] = ctx.reshape((B * mp, page_size) + x.shape[2:])
        pages[n] = pool if x.dtype == torch.int8 else _guarded(pool)
    used = -(-lengths.long() // page_size)
    table = ids.view(B, mp).masked_fill(
        torch.arange(mp, device=ids.device)[None, :] >= used[:, None], 0)
    return pages, table.to(torch.int32).contiguous(), mp


def _raw_decode(A, q, k, v, scales, lengths, table, ps, mp):
    """The decode kernels launched on outputs the caller gives (o, ws):
    for ``_guarded_writes``."""
    B, H, D = q.shape

    def launch(o, ws):
        common = (lengths.data_ptr(), table.data_ptr(), o.data_ptr(),
                  ws.data_ptr(), B, H, D, ps, mp, D ** -0.5,
                  A._DTYPE_CODES[q.dtype], A._stream(q))
        if scales:
            A.decode_attention_int8_kernel(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *(t.data_ptr() for t in scales.values()), *common)
        else:
            A.decode_attention_kernel(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), *common)
    return launch


def decode_checks(dev, *, B: int, S: int, H: int, D: int,
                  lengths) -> None:
    """Both decode kernels, padded and paged, against their plain
    versions: bf16 and f32 (model dtype) and int8 codes under q in bf16
    and f32, at the main-path tolerances, over a context whose positions
    past each length hold NaN (int8: random codes, NaN scales).  The
    paged entry reads the same context through a shuffled table at page
    sizes 128, 16 and 1, with NaN in the garbage page every table tail
    names and NaN guard bands around the pages.  Two calls must agree
    bit for bit, and the paged call with the padded one (one body, the
    same order of work); the bf16 and int8 launches, made once more on
    outputs between guard bands, must write nothing else."""
    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(11)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    c = decode_context(g, dev, B, S, H, D, lengths)
    scale = D ** -0.5
    q, q32 = c["q"], c["q"].float()
    ref = A.plain_decode_attention(*_f32(q, c["k"], c["v"]), lengths,
                                   scale=scale)
    ref8 = A.plain_decode_attention(q32, c["k8"], c["v8"], lengths,
                                    scale=scale, k_scale=c["ks"],
                                    v_scale=c["vs"])
    # name: (q, k name, v name, int8, reference, tolerance)
    variants = {"bf16": (q, "k", "v", False, ref, BF16_TOL),
                "f32": (q32, "k", "v", False, ref, F32_TOL),
                "int8": (q, "k8", "v8", True, ref8, BF16_TOL),
                "int8 f32": (q32, "k8", "v8", True, ref8, F32_TOL)}
    splits = (-(-lengths.long() // DECODE_SPLIT)).tolist()
    for name, (qq, kn, vn, int8, want, tol) in variants.items():
        what = f"decode [{B},{S},{H},{D}] {name}"
        cast = (lambda x: x) if int8 or qq.dtype == torch.bfloat16 \
            else (lambda x: x.float())
        k, v = cast(c[kn]), cast(c[vn])
        sc = dict(k_scale=c["ks"], v_scale=c["vs"]) if int8 else {}
        o = A.decode_attention(qq, k, v, lengths, **sc)
        again = A.decode_attention(qq, k, v, lengths, **sc)
        torch.cuda.synchronize()
        check(f"{what} padded", o, want, **tol)
        if not torch.equal(o, again):
            raise AssertionError(f"{what}: two padded calls differ")
        for ps in DECODE_PAGE_SIZES:
            pages, table, mp = decode_pages(c, lengths, ps, g)
            kp, vp = cast(pages[kn]), cast(pages[vn])
            if not int8 and qq.dtype == torch.float32:
                kp, vp = _guarded(kp), _guarded(vp)
            psc = (dict(k_scale_pages=pages["ks"], v_scale_pages=pages["vs"])
                   if int8 else {})
            op = A.decode_attention_paged(qq, kp, vp, table, lengths, **psc)
            op2 = A.decode_attention_paged(qq, kp, vp, table, lengths, **psc)
            torch.cuda.synchronize()
            check(f"{what} paged page={ps}", op, want, **tol)
            if not (torch.equal(op, op2) and torch.equal(op, o)):
                raise AssertionError(f"{what} page={ps}: two paged calls, "
                                     "or the paged and the padded, differ")
            if qq.dtype == torch.bfloat16:
                ws = torch.empty(A._decode_workspace_elems(
                    B, H, D, mp * ps), dtype=torch.float32, device=dev)
                _guarded_writes(f"{what} paged page={ps}", _raw_decode(
                    A, qq, kp, vp, {"k": pages["ks"], "v": pages["vs"]}
                    if int8 else {}, lengths, table, ps, mp), (op,),
                    scratch=(ws,))
        print(f"  {what}: padded and paged (pages {DECODE_PAGE_SIZES}) "
              f"bit-identical over two calls and to each other; splits "
              f"per row {splits}; guard bands intact", flush=True)


def _kernel_device_ms(fn, iters: int = 20) -> dict:
    """Device time per call of each kernel ``fn`` launches
    (torch.profiler), by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def _cold_ms(fn, inputs: tuple, copies: int = 6) -> float:
    """``time_ms`` of ``fn(*inputs)`` with each call on the next of
    ``copies`` clones of the inputs, so that a call finds its inputs out
    of the 50 MB L2 (the engine's cache, ~300 MB, is read once a step)."""
    import itertools
    ring = itertools.cycle([tuple(x.clone() for x in inputs)
                            for _ in range(copies)])
    return time_ms(lambda: fn(*next(ring)))


def decode_timings(rec: Recorder, dev, *, B: int, S: int, H: int,
                   D: int) -> None:
    """Both decode kernels timed at the smoke's lengths and with every
    row full, padded and paged (page 128, a shuffled table), beside
    their plain versions and the library's yardsticks: the masked SDPA
    (int8: dequantize, then SDPA) for the padded entry, and
    ``gather_pages`` followed by the same call for the paged one.  Each
    row's headline (recorded last) is the paged kernel at the smoke's
    lengths, the engine's decode step.  Also prints each kernel's time
    with its inputs out of L2, the device time of the split and the
    combine kernels apart, and the achieved bandwidth."""
    import torch.nn.functional as F

    from ray_tpu_torch.inference.kv_cache import gather_pages
    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    scale = D ** -0.5
    src = "ray_tpu_torch/ops/csrc/decode_attention.cu"
    for lens in ((S,) * B, DECODE_LENGTHS):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        c = decode_context(g, dev, B, S, H, D, lengths)
        ps = 128
        pages, table, _mp = decode_pages(c, lengths, ps, g)
        table64 = table.long()
        q, qs = c["q"], c["q"][:, :, None, :]
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        valid = int(lengths.sum())
        n_tab = int((-(-lengths.long() // ps)).sum())
        blocks = H * int((-(-lengths.long() // DECODE_SPLIT)).sum())
        flops = 4 * H * D * valid
        tag = "full" if len(set(lens)) == 1 else "smoke lengths"

        def sdpa(k, v):
            return F.scaled_dot_product_attention(
                qs, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask)

        def deq(codes, sc):
            return (codes.float() * sc[..., None]).to(bf)

        sc = dict(k_scale=c["ks"], v_scale=c["vs"])
        psc = dict(k_scale_pages=pages["ks"], v_scale_pages=pages["vs"])
        for row, int8 in (("decode_attention", False),
                          ("decode_attention_int8", True)):
            k, v = (c["k8"], c["v8"]) if int8 else (c["k"], c["v"])
            kp, vp = ((pages["k8"], pages["v8"]) if int8
                      else (pages["k"], pages["v"]))
            kw, pkw = (sc, psc) if int8 else ({}, {})
            nbytes = (2 * B * H * D * 2 + B * 4
                      + valid * H * ((D + 4) * 2 if int8 else D * 2 * 2))
            want = A.plain_decode_attention(
                q.float(), *((k, v) if int8 else _f32(k, v)), lengths,
                scale=scale, **kw)
            if int8:
                def lib_padded():
                    sdpa(deq(k, c["ks"]), deq(v, c["vs"]))

                def lib_paged():
                    sdpa(deq(gather_pages(kp, table64),
                             gather_pages(pages["ks"], table64)),
                         deq(gather_pages(vp, table64),
                             gather_pages(pages["vs"], table64)))
            else:
                def lib_padded():
                    sdpa(k, v)

                def lib_paged():
                    sdpa(gather_pages(kp, table64), gather_pages(vp, table64))
            replaces = ("ray_tpu/ops/attention.py:1387 (quantized=True, "
                        "body :1319-1344)" if int8
                        else "ray_tpu/ops/attention.py:1387")
            for entry in ("decode_attention", "decode_attention_paged"):
                paged = entry == "decode_attention_paged"
                big = (kp, vp, *pkw.values()) if paged \
                    else (k, v, *kw.values())

                def call(kk, vv, *scs, paged=paged):
                    if paged:
                        return A.decode_attention_paged(
                            q, kk, vv, table, lengths,
                            **dict(zip(pkw, scs)))
                    return A.decode_attention(q, kk, vv, lengths,
                                              **dict(zip(kw, scs)))

                def plain_call(paged=paged):
                    if paged:
                        return A.plain_decode_attention_paged(
                            q, kp, vp, table, lengths, scale=scale, **pkw)
                    return A.plain_decode_attention(q, k, v, lengths,
                                                    scale=scale, **kw)

                o = call(*big)
                torch.cuda.synchronize()
                err = check(f"{row} {entry} {tag}", o, want, **BF16_TOL)
                ms = time_ms(lambda: call(*big))
                cold = _cold_ms(call, big)
                split = _kernel_device_ms(lambda: call(*big))
                nb = nbytes + (n_tab * 4 if paged else 0)
                rec.record(row, [B, S, H, D], err, ms, time_ms(plain_call),
                           time_ms(lib_paged if paged else lib_padded), nb,
                           flops, src, replaces, entry=entry,
                           lengths=list(lens), ms_cold=cold)
                print(f"  {row} {entry} {tag}: cold {cold:.4f} ms; "
                      f"{nb / ms / 1e6:.1f} GB/s warm, "
                      f"{nb / cold / 1e6:.1f} GB/s cold; live split blocks "
                      f"{blocks}; device " + ", ".join(
                          f"{n[:40]} {t:.4f} ms" for n, t in split.items()),
                      flush=True)


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
    for S in (1, 32, 65, 128, 200, 1024):
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

    # decode attention at [8, 1024, 12, 64], padded and paged, model
    # dtype and int8: checks, then times
    decode_checks(dev, B=8, S=1024, H=H, D=D, lengths=DECODE_LENGTHS)
    decode_timings(rec, dev, B=8, S=1024, H=H, D=D)

    # out-proj + residual + rmsnorm, K = d = 768: at a verify forward's
    # N = kb + 1 rows (speculative decoding, kb = 1, 2, 4, 8), a cached
    # prefill's 32 and a prefill's 1024
    for N in (2, 3, 5, 9, 32, 1024):
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


def rmsnorm_checks(rec: Recorder, randn, g, dev) -> None:
    """The RMSNorm kernels (``gpt._PALLAS_NORM``): the forward at the
    decode step's N = 8, a prefill's 1024 and the training step's 24576
    rows, the backward at 24576, d = 768."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import rmsnorm as R

    d, eps, bf = 768, 1e-6, torch.bfloat16
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
    for N in (8, 1024, TRAIN_N):
        x = randn(N, d)
        y, rstd = R.rmsnorm_fwd(x, sc, eps=eps)
        want = R.plain_rmsnorm_fwd(*_f32(x, sc), eps=eps)
        got32 = R.rmsnorm_fwd(*_f32(x, sc), eps=eps)
        torch.cuda.synchronize()
        what = f"rmsnorm_fwd N={N}"
        err = max(check(f"{what} y", y, want[0], **BF16_TOL),
                  check(f"{what} rstd", rstd, want[1], **RSTD_TOL))
        for part, a_, b_ in zip(("y", "rstd"), got32, want):
            check(f"{what} f32 {part}", a_, b_, **F32_TOL)
        rec.record("rmsnorm_fwd", [N, d], err,
                   time_ms(lambda: R.rmsnorm_fwd(x, sc, eps=eps)),
                   time_ms(lambda: R.plain_rmsnorm_fwd(x, sc, eps=eps)),
                   time_ms(lambda: F.rms_norm(x, (d,), sc, eps)),
                   2 * N * d * 2 + d * 2 + N * 4, 4 * N * d,
                   "ray_tpu_torch/ops/csrc/rmsnorm_fwd.cu",
                   "ray_tpu/ops/rmsnorm.py:86")
    # the backward at N = 24576 with the bf16 forward's rstd
    dy = randn(N, d)
    got = R.rmsnorm_bwd(x, sc, rstd, dy)
    want = R.plain_rmsnorm_bwd(*_f32(x, sc), rstd, dy.float())
    got32 = R.rmsnorm_bwd(*_f32(x, sc), rstd, dy.float())
    torch.cuda.synchronize()
    what = f"rmsnorm_bwd N={N}"
    err = max(check(f"{what} dx", got[0], want[0], **GRAD_BF16_TOL),
              check(f"{what} dscale", got[1], want[1], **DS_BF16_TOL))
    check(f"{what} f32 dx", got32[0], want[0], **F32_GRAD_TOL)
    check(f"{what} f32 dscale", got32[1], want[1], **DS_F32_TOL)

    def lib_norm():
        xx, ss = (t.detach().requires_grad_(True) for t in (x, sc))
        F.rms_norm(xx, (d,), ss, eps).backward(dy)

    rec.record("rmsnorm_bwd", [N, d], err,
               time_ms(lambda: R.rmsnorm_bwd(x, sc, rstd, dy)),
               time_ms(lambda: R.plain_rmsnorm_bwd(x, sc, rstd, dy)),
               time_ms(lib_norm),
               3 * N * d * 2 + N * 4 + 2 * d * 2, 8 * N * d,
               "ray_tpu_torch/ops/csrc/rmsnorm_bwd.cu",
               "ray_tpu/ops/rmsnorm.py:117")


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
# RMSNorm's dscale sums dy * xhat over all N = 24576 rows.  The terms are
# products of two unit normals (mean |term| = 2/pi), so |dscale| ~
# sqrt(N) ~ 160, and two errors add: the bf16 rounding of the result, at
# most 2^-9 of the value (rtol 2^-7 leaves headroom, as BF16_TOL does),
# and the f32 summation order, at most N * 2^-24 * mean|term| = 9.4e-4
# for any order (atol 2e-3).  The f32 kernel has the second error only.
DS_BF16_TOL = dict(rtol=2 ** -7, atol=2e-3)
DS_F32_TOL = dict(rtol=1e-5, atol=2e-3)


def bwd_reference(qr, kr, v, o, lse, do, scale, rope32):
    """The bf16 backward's yardstick: the plain version in f64 on the
    rotated q and k (``qr``, ``kr``), with the transposed rotation of dq
    and dk.  In f64 and not f32 because the first row of a sequence
    attends to one key, so its dq is 0 exactly (ds = p (dp - delta) with
    dp = delta, o being that key's v): the kernel gives 0 there, while an
    f32 plain version leaves its own summation noise (up to ~6e-7 on an
    H100), which no bound relative to that row's rms can carry.  In f64
    the 64-term sums of bf16 products are exact, and the row is 0."""
    from ray_tpu_torch.ops import attention as A

    dq, dk, dv = A.plain_flash_attention_bwd(
        *(x.double() for x in (qr, kr, v, o)), lse, do.double(),
        scale=scale)
    return (A._rot_t(dq, *rope32), A._rot_t(dk, *rope32), dv) \
        if rope32 is not None else (dq, dk, dv)


def _guarded(x, pad: int = 4096):
    """x copied into the middle of a NaN-filled buffer with ``pad``
    elements on each side (a multiple of 8, so the view keeps 16-byte
    alignment): a kernel that reads before or past the tensor meets NaN,
    which ``check`` refuses."""
    buf = torch.full((x.numel() + 2 * pad,), float("nan"), dtype=x.dtype,
                     device=x.device)
    view = buf[pad:pad + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def _guarded_writes(what: str, launch, expect, scratch=()) -> None:
    """``launch(*outs)`` with each output a view between guard bands of
    -7.0, shaped as ``expect`` and then ``scratch``; raise if the kernel
    wrote into a band, or if an output differs in any bit from its entry
    of ``expect`` (the wrapper's own call on the same inputs; a scratch
    output is not compared)."""
    pad = 4096
    like = (*expect, *scratch)
    bufs = [torch.full((x.numel() + 2 * pad,), -7.0, dtype=x.dtype,
                       device=x.device) for x in like]
    outs = [b[pad:-pad].view(x.shape) for b, x in zip(bufs, like)]
    launch(*outs)
    torch.cuda.synchronize()
    for b in bufs:
        if not ((b[:pad] == -7.0).all() and (b[-pad:] == -7.0).all()):
            raise AssertionError(f"{what}: a kernel wrote outside an output")
    if not all(torch.equal(x, y) for x, y in zip(outs, expect)):
        raise AssertionError(f"{what}: outputs differ from the wrapper's")


def ragged_attention_checks(dev, *, B: int = 2, H: int = 12,
                            D: int = 64) -> None:
    """The attention kernels at ragged lengths (S = 65 and 200: a partial
    last tile, rows past S masked in-kernel) with and without RoPE:
    forward and backward in bf16 (against the plain version in f32 / f64)
    and in f32 (against the f32 plain version), under the tolerances of
    the main-path checks.  Every input sits between NaN guard bands
    (``_guarded``), so a read past a tensor's last row or before its first
    shows as a non-finite output, and the bf16 kernels are launched once
    more on outputs between guard bands (``_guarded_writes``), which they
    must leave untouched.  Two bf16 backward calls on the same inputs must
    give the same bits (no atomics, a fixed order)."""
    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(5)
    randn = _randn(g, dev)
    bf = torch.bfloat16
    scale = D ** -0.5
    for S in (65, 200):
        for with_rope in (False, True):
            q, k, v, do = (_guarded(randn(B, S, H, D)) for _ in range(4))
            rope = (tuple(map(_guarded, A.rope_tables(
                torch.arange(S, device=dev), D, 10000.0, bf)))
                if with_rope else None)
            rope32 = None if rope is None else _f32(*rope)
            qr, kr = ((A._rot(x, *rope).float() for x in (q, k))
                      if with_rope else _f32(q, k))
            what = f"attention ragged [{B},{S},{H},{D}] rope={with_rope}"
            o, lse = map(_guarded, A.flash_attention_fwd(
                q, k, v, scale=scale, rope=rope))
            o_ref, lse_ref = A.plain_flash_attention_fwd(
                qr, kr, v.float(), scale=scale)
            o32, lse32 = A.flash_attention_fwd(*_f32(q, k, v), scale=scale,
                                               rope=rope32)
            o_ref32, lse_ref32 = A.plain_flash_attention_fwd(
                *_f32(q, k, v), scale=scale, rope=rope32)
            grads = A.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                          rope=rope)
            again = A.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                          rope=rope)
            refs = bwd_reference(qr, kr, v, o, lse, do, scale, rope32)
            args32 = (*_f32(q, k, v, o), lse, do.float())
            grads32 = A.flash_attention_bwd(*args32, scale=scale,
                                            rope=rope32)
            refs32 = A.plain_flash_attention_bwd(*args32, scale=scale,
                                                 rope=rope32)
            torch.cuda.synchronize()
            check(f"{what} o", o, o_ref, **BF16_TOL)
            check(f"{what} lse", lse, lse_ref, **LSE_TOL)
            check(f"{what} f32 o", o32, o_ref32, **F32_TOL)
            check(f"{what} f32 lse", lse32, lse_ref32, **F32_TOL)
            for n, x, y, x32, y32 in zip(("dq", "dk", "dv"), grads, refs,
                                         grads32, refs32):
                check(f"{what} {n}", x, y, **GRAD_BF16_TOL)
                check(f"{what} f32 {n}", x32, y32, **F32_GRAD_TOL)
            if not all(torch.equal(x, y) for x, y in zip(grads, again)):
                raise AssertionError(f"{what}: two bf16 backward calls on "
                                     "the same inputs differ")
            ptr = [None if t is None else t.data_ptr()
                   for t in (q, k, v, o, do, lse, *(rope or (None, None)))]
            args = (B, S, H, D, scale, A._DTYPE_CODES[bf], A._stream(q))
            _guarded_writes(f"{what} forward", lambda o_, lse_:
                            A.flash_attention_kernel(
                                *ptr[:3], *ptr[6:], o_.data_ptr(),
                                lse_.data_ptr(), *args), (o, lse))
            _guarded_writes(f"{what} backward", lambda *outs:
                            A.flash_attention_bwd_kernel(
                                *ptr, *(x.data_ptr() for x in outs), *args),
                            grads, scratch=(lse,))  # delta [B, H, S]
            print(f"  {what}: bf16 backward bit-identical over two calls; "
                  "guard bands intact", flush=True)


def width_kernel_checks(dev) -> None:
    """The kernels at the widths of the repo's other configurations, each
    against its plain version under the main-path tolerances: attention at
    tiny's head_dim 16 (the ragged checks above, and ``decode_checks``:
    the decode kernels padded and paged in bf16, f32 and int8),
    and the RMSNorm kernels at tiny's, gpt2_medium's and gpt2_large's
    d = 64, 1024, 1280 (inputs between NaN guard bands, two bf16 backward
    calls bit-identical).  Then the epilogue at gpt2_medium's and
    gpt2_large's training shapes, timed against its plain version."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import fused_norm as FN
    from ray_tpu_torch.ops import rmsnorm as R

    ragged_attention_checks(dev, H=4, D=16)
    decode_checks(dev, B=4, S=300, H=4, D=16, lengths=(1, 300, 64, 129))
    g = torch.Generator(device=dev).manual_seed(9)
    randn = _randn(g, dev)
    bf = torch.bfloat16
    eps, N = 1e-6, 200
    for d in (64, 1024, 1280):
        what = f"rmsnorm N={N} d={d}"
        sc = _row_guarded(
            (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf))
        x, dy = (_row_guarded(randn(N, d)) for _ in range(2))
        y, rstd = R.rmsnorm_fwd(x, sc, eps=eps)
        want = R.plain_rmsnorm_fwd(*_f32(x, sc), eps=eps)
        got32 = R.rmsnorm_fwd(*_f32(x, sc), eps=eps)
        grads = R.rmsnorm_bwd(x, sc, rstd, dy)
        again = R.rmsnorm_bwd(x, sc, rstd, dy)
        refs = R.plain_rmsnorm_bwd(*_f32(x, sc), rstd, dy.float())
        grads32 = R.rmsnorm_bwd(*_f32(x, sc), rstd, dy.float())
        torch.cuda.synchronize()
        check(f"{what} y", y, want[0], **BF16_TOL)
        check(f"{what} rstd", rstd, want[1], **RSTD_TOL)
        for part, a_, b_ in zip(("y", "rstd"), got32, want):
            check(f"{what} f32 {part}", a_, b_, **F32_TOL)
        check(f"{what} dx", grads[0], refs[0], **GRAD_BF16_TOL)
        check(f"{what} dscale", grads[1], refs[1], **DS_BF16_TOL)
        check(f"{what} f32 dx", grads32[0], refs[0], **F32_GRAD_TOL)
        check(f"{what} f32 dscale", grads32[1], refs[1], **DS_F32_TOL)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(grads, again)):
            raise AssertionError(f"{what}: two bf16 backward calls on the "
                                 "same inputs differ")

    # the epilogue at gpt2_medium's and gpt2_large's training shapes (N =
    # 24576, K = d): bf16 against the f32 plain version, timed
    for d in (1024, 1280):
        N = TRAIN_N
        sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
        a, w, resid, drout, dy = (randn(N, d), randn(d, d, s=d ** -0.5),
                                  randn(N, d), randn(N, d), randn(N, d))
        r, y, rstd = FN.matmul_residual_norm_fwd(a, w, resid, sc, eps=eps)
        want = FN.plain_matmul_residual_norm(*_f32(a, w, resid, sc),
                                             eps=eps)
        grads = FN.matmul_residual_norm_bwd(a, w, r, sc, rstd, drout, dy)
        refs = FN.plain_matmul_residual_norm_bwd(
            *_f32(a, w, r, sc), rstd, *_f32(drout, dy))
        torch.cuda.synchronize()
        what = f"epilogue N={N} K=d={d}"
        for n, x, ref in zip(("r", "y", "rstd"), (r, y, rstd), want):
            check(f"{what} {n}", x, ref,
                  **(RSTD_TOL if n == "rstd" else BF16_TOL))
        for n, x, ref in zip(("da", "dw", "dresid", "dscale"), grads, refs):
            check(f"{what} {n}", x, ref, **GRAD_BF16_TOL)
        del want, refs

        def lib_fwd():
            F.rms_norm(torch.addmm(resid, a, w), (d,), sc, eps)

        def lib_bwd():
            args = [x.detach().requires_grad_(True)
                    for x in (a, w, resid, sc)]
            r_ = torch.addmm(args[2], args[0], args[1])
            y_ = F.rms_norm(r_, (d,), args[3], eps)
            torch.autograd.backward([r_, y_], [drout, dy])

        fwd = (time_ms(lambda: FN.matmul_residual_norm_fwd(
                   a, w, resid, sc, eps=eps)),
               time_ms(lambda: FN.plain_matmul_residual_norm(
                   a, w, resid, sc, eps=eps)), time_ms(lib_fwd))
        bwd = (time_ms(lambda: FN.matmul_residual_norm_bwd(
                   a, w, r, sc, rstd, drout, dy)),
               time_ms(lambda: FN.plain_matmul_residual_norm_bwd(
                   a, w, r, sc, rstd, drout, dy)), time_ms(lib_bwd, 10))
        # the training phase's byte and flop counts at K = d
        bw, peak = peaks(torch.cuda.get_device_name(0))
        fb = bound((2 * N * d + d * d + d) * 2 + 2 * N * d * 2 + N * 4,
                   2 * N * d * d, bw, peak)
        bb = bound((6 * N * d + 2 * d * d + 2 * d) * 2 + N * 4 + d * 4,
                   4 * N * d * d, bw, peak)
        print(f"  {what} bf16: forward {fwd[0]:.4f} ms (plain {fwd[1]:.4f}"
              f", addmm + rms_norm {fwd[2]:.4f}, bound {fb[0]:.4f} "
              f"({fb[1]})); backward {bwd[0]:.4f} ms (plain {bwd[1]:.4f}, "
              f"their forward + backward {bwd[2]:.4f}, bound {bb[0]:.4f} "
              f"({bb[1]}))", flush=True)
        del a, w, resid, drout, dy, r, y, rstd, grads
        torch.cuda.empty_cache()


def wgmma_tile_checks(dev) -> None:
    """The ``wgmma`` variants the kernels build on (``hopper.cuh``), each
    alone on one tile, C = A B over k = 64, against the plain product in
    f32, before the kernels built on them are checked: at n64, ``_tb``
    (A K-major, B MN-major: the epilogue forward's a and w) and ``_tt``
    (both MN-major: the epilogue backward's dw = a^T dresid); at n128,
    both K-major (flash-CE's logits y w^T), ``_tb`` (its dx = dl w, B two
    MN-major atoms) and ``_tt`` (its dw = dl^T y).  A wrong transpose
    bit or descriptor offset moves values by O(1); the bf16 products are
    exact in f32, so only the order of the 64-term sums differs
    (``F32_MATMUL_TOL``)."""
    import ctypes

    from ray_tpu_torch.ops import _build

    fn = _build.load().wgmma_tile_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    A, B, B2 = rand(64, 64), rand(64, 64), rand(64, 128)
    cases = ((0, A, B, A.float() @ B.float(), "n64 tb (A K-major, B MN-major)"),
             (1, A.T.contiguous(), B, A.float() @ B.float(),
              "n64 tt (A and B MN-major)"),
             (2, A, B2.T.contiguous(), A.float() @ B2.float(),
              "n128 (A and B K-major)"),
             (3, A, B2, A.float() @ B2.float(),
              "n128 tb (A K-major, B MN-major)"),
             (4, A.T.contiguous(), B2, A.float() @ B2.float(),
              "n128 tt (A and B MN-major)"))
    for variant, a_in, b_in, want, name in cases:
        c = torch.empty(want.shape, device=dev)
        rc = fn(a_in.data_ptr(), b_in.data_ptr(), c.data_ptr(), variant,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"wgmma_tile_check {variant}: CUDA error {rc}")
        torch.cuda.synchronize()
        check(f"wgmma tile {name}", c, want, **F32_MATMUL_TOL)


# the epilogue kernels' edges (N, K, d): N ragged against their 64-row
# blocks at K = d = 768, the gate's other widths of K around GPT-2's at a
# ragged N, and the widths of gpt2_medium and gpt2_large (the GEMM and
# row-pass design, ragged against its 128-row tiles)
EPILOGUE_EDGES = ((1, 768, 768), (63, 768, 768), (65, 768, 768),
                  (200, 768, 768), (200, 384, 768), (200, 1536, 768),
                  (1, 1024, 1024), (65, 1024, 1024), (200, 1024, 1024),
                  (200, 384, 1024), (63, 1280, 1280), (200, 1280, 1280))


def _row_guarded(x):
    """``_guarded`` with a whole 64-row block of NaN on each side, so a
    kernel block reading rows past the tensor's last meets NaN, not
    memory beyond the buffer."""
    return _guarded(x, pad=64 * x.shape[-1])


def ragged_epilogue_checks(dev) -> None:
    """The out-proj epilogue kernels at ``EPILOGUE_EDGES``: the forward and
    the backward (cotangents into both outputs) in bf16 against the plain
    versions in f32, and in f32 against the same, under the main-path
    tolerances.  Every input sits between NaN guard bands of a 64-row
    block each; both bf16 kernels run once more on outputs between
    guard bands of -7.0 (``_guarded_writes``), and two bf16 backward calls
    must give the same bits (no atomics, ordered partial sums)."""
    from ray_tpu_torch.ops import fused_norm as FN

    g = torch.Generator(device=dev).manual_seed(7)
    randn = _randn(g, dev)
    bf, eps = torch.bfloat16, 1e-6
    code = FN._DTYPE_CODES[bf]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for N, K, d in EPILOGUE_EDGES:
        what = f"epilogue ragged N={N} K={K} d={d}"
        sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
        a, w, resid, sc, drout, dy = map(_row_guarded, (
            randn(N, K), randn(K, d, s=K ** -0.5), randn(N, d), sc,
            randn(N, d), randn(N, d)))
        r, y, rstd = FN.matmul_residual_norm_fwd(a, w, resid, sc, eps=eps)
        want = FN.plain_matmul_residual_norm(*_f32(a, w, resid, sc),
                                             eps=eps)
        got32 = FN.matmul_residual_norm_fwd(*_f32(a, w, resid, sc), eps=eps)
        r, rstd = _row_guarded(r), _row_guarded(rstd)
        ins = (a, w, r, sc, rstd, drout, dy)
        grads = FN.matmul_residual_norm_bwd(*ins)
        again = FN.matmul_residual_norm_bwd(*ins)
        ins32 = (*_f32(a, w, r, sc), rstd, *_f32(drout, dy))
        refs = FN.plain_matmul_residual_norm_bwd(*ins32)
        grads32 = FN.matmul_residual_norm_bwd(*ins32)
        torch.cuda.synchronize()
        for n, x, x32, ref in zip(("r", "y", "rstd"), (r, y, rstd), got32,
                                  want):
            check(f"{what} {n}", x, ref,
                  **(RSTD_TOL if n == "rstd" else BF16_TOL))
            check(f"{what} f32 {n}", x32, ref, **F32_MATMUL_TOL)
        for n, x, x32, ref in zip(("da", "dw", "dresid", "dscale"), grads,
                                  grads32, refs):
            check(f"{what} {n}", x, ref, **GRAD_BF16_TOL)
            check(f"{what} f32 {n}", x32, ref, **F32_GRAD_TOL)
        if not all(torch.equal(x, z) for x, z in zip(grads, again)):
            raise AssertionError(f"{what}: two bf16 backward calls on the "
                                 "same inputs differ")
        _guarded_writes(f"{what} forward", lambda r_, y_, s_:
                        FN.matmul_residual_norm_kernel(
                            a.data_ptr(), w.data_ptr(), resid.data_ptr(),
                            sc.data_ptr(), r_.data_ptr(), y_.data_ptr(),
                            s_.data_ptr(), N, K, d, eps, code, stream),
                        (r, y, rstd))

        def bwd(*outs):
            FN.matmul_residual_norm_bwd_kernel(
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                N, K, d, code, stream)

        # the entry point's own outputs: dscale in f32 and the scratch
        outs = (*(torch.empty_like(x) for x in grads[:3]),
                torch.empty(d, device=dev),
                torch.empty(-(-N // FN._BWD_ROWS), d, device=dev),
                torch.empty(FN._BWD_SPLITS, K, d, device=dev))
        bwd(*outs)
        if not (all(torch.equal(x, z) for x, z in zip(outs, grads[:3]))
                and torch.equal(outs[3].to(bf), grads[3])):
            raise AssertionError(f"{what}: the entry point's outputs differ "
                                 "from the wrapper's")
        _guarded_writes(f"{what} backward", bwd, outs[:4],
                        scratch=outs[4:])
        print(f"  {what}: bf16 backward bit-identical over two calls; "
              "guard bands intact", flush=True)


# the flash-CE kernels' edges: N ragged against the 128-row tiles, V ragged
# against the 128-column vocab tiles (1000, and GPT-2's real vocab 50257),
# and the model widths of gpt2_medium and gpt2_large, which the bf16
# kernels take as a runtime K (flash_ce._KERNEL_WIDTHS lists exactly the
# widths checked here and at the main path)
FLASH_CE_EDGES = tuple((N, 768, V) for N in (1, 63, 65, 200)
                       for V in (1000, 50257)) + (
    (200, 1024, 1000), (65, 1024, 50257), (200, 1280, 1000),
    (65, 1280, 50257))


def ragged_flash_ce_checks(dev) -> None:
    """The flash-CE kernels at ``FLASH_CE_EDGES``, with and without the
    norm prologue: the forward and backward in bf16 against the plain
    versions in f32, and (d = 768, the f32 kernels' width) in f32 against
    the same, under the main-path tolerances.  One target in seven is
    masked, the first row's target is column 0 and the last row's
    V - 1.  Every input sits between NaN guard bands of a 64-row block;
    both bf16 entry points run once more on outputs between -7.0 guard
    bands (``_guarded_writes``), and two bf16 backward calls must give
    the same bits (no atomics, ordered sums)."""
    from ray_tpu_torch.ops import flash_ce as FC

    g = torch.Generator(device=dev).manual_seed(8)
    randn = _randn(g, dev)
    bf, eps = torch.bfloat16, 1e-6
    stream = torch.cuda.current_stream(dev).cuda_stream
    for N, d, V in FLASH_CE_EDGES:
        for with_norm in (False, True):
            what = f"flash_ce ragged N={N} d={d} V={V} norm={with_norm}"
            sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
            x, w, sc = map(_row_guarded, (randn(N, d), randn(V, d, s=0.02),
                                          sc))
            tgt = torch.randint(0, V, (N,), generator=g, device=dev,
                                dtype=torch.int32)
            tgt[::7] = -1
            tgt[0], tgt[-1] = (0, V - 1) if N > 1 else (0, 0)
            srow = (tgt >= 0).float()
            fnorm = (sc, eps) if with_norm else None
            out = FC.flash_ce_fwd(x, w, tgt, fnorm)
            want = FC.plain_flash_ce_fwd(*_f32(x, w), tgt,
                                         (sc.float(), eps) if with_norm
                                         else None)
            lse = _guarded(out[0], pad=64)
            rstd = _guarded(out[2], pad=64) if with_norm else None
            bnorm = (sc, eps, rstd) if with_norm else None
            bnorm32 = (sc.float(), eps, rstd) if with_norm else None
            grads = FC.flash_ce_bwd(x, w, tgt, lse, srow, bnorm)
            again = FC.flash_ce_bwd(x, w, tgt, lse, srow, bnorm)
            refs = FC.plain_flash_ce_bwd(*_f32(x, w), tgt, lse, srow,
                                         bnorm32)
            torch.cuda.synchronize()
            for n, a_, b_ in zip(("lse", "true", "rstd"), out, want):
                check(f"{what} {n}", a_, b_, **{"lse": CE_LSE_TOL,
                                                "true": CE_TRUE_TOL,
                                                "rstd": RSTD_TOL}[n])
            for n, a_, b_ in zip(("dx", "dw", "dscale"), grads, refs):
                check(f"{what} {n}", a_, b_, **GRAD_BF16_TOL)
            if not all(torch.equal(a_, b_) for a_, b_ in zip(grads, again)):
                raise AssertionError(f"{what}: two bf16 backward calls on "
                                     "the same inputs differ")
            if d in FC._KERNEL_WIDTHS[torch.float32]:
                got32 = FC.flash_ce_fwd(*_f32(x, w), tgt,
                                        (sc.float(), eps) if with_norm
                                        else None)
                grads32 = FC.flash_ce_bwd(*_f32(x, w), tgt, lse, srow,
                                          bnorm32)
                torch.cuda.synchronize()
                for n, a_, b_ in zip(("lse", "true", "rstd"), got32, want):
                    check(f"{what} f32 {n}", a_, b_, **F32_GRAD_TOL)
                for n, a_, b_ in zip(("dx", "dw", "dscale"), grads32, refs):
                    check(f"{what} f32 {n}", a_, b_, **F32_GRAD_TOL)
            code = FC._DTYPE_CODES[bf]
            ptr = (lambda t: None if t is None else t.data_ptr())
            ws = FC._workspace("flash_ce_fwd_workspace", N, d, V, with_norm,
                               bf, dev)

            def fwd(l_, t_, *r_):
                FC.flash_ce_fwd_kernel(
                    x.data_ptr(), w.data_ptr(), tgt.data_ptr(),
                    ptr(sc if with_norm else None), l_.data_ptr(),
                    t_.data_ptr(), r_[0].data_ptr() if r_ else None,
                    ws.data_ptr(), N, d, V, eps, int(with_norm), code,
                    stream)

            _guarded_writes(f"{what} forward", fwd, out)
            wsb = FC._workspace("flash_ce_bwd_workspace", N, d, V,
                                with_norm, bf, dev)
            expect = (grads[0], grads[1],
                      *((grads[2],) if with_norm else ()))

            def bwd(dx_, dw_, *ds_):
                FC.flash_ce_bwd_kernel(
                    x.data_ptr(), w.data_ptr(), tgt.data_ptr(),
                    lse.data_ptr(), srow.data_ptr(),
                    ptr(sc if with_norm else None), ptr(rstd),
                    dx_.data_ptr(), dw_.data_ptr(),
                    ds_[0].data_ptr() if ds_ else None, wsb.data_ptr(), N,
                    d, V, int(with_norm), code, stream)

            _guarded_writes(f"{what} backward", bwd, expect)
            print(f"  {what}: bf16 backward bit-identical over two calls; "
                  "guard bands intact", flush=True)


def train_kernel_phase(rec: Recorder, dev) -> None:
    """The training path's kernels against their plain versions at its
    shapes: the flash forward with its RoPE tables, the attention
    backward, the epilogue forward and backward at N = 24576, flash-CE
    forward and backward with the norm prologue.  bf16 (timed) and f32,
    each against the plain version in f32 on the same inputs."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _build
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

    # what the in-kernel RoPE costs: the same calls without it
    o_nr, lse_nr = A.flash_attention_fwd(q, k, v, scale=scale)
    t_f = time_ms(lambda: A.flash_attention_fwd(q, k, v, scale=scale), 5)
    t_b = time_ms(lambda: A.flash_attention_bwd(q, k, v, o_nr, lse_nr, do,
                                                scale=scale), 5)
    print(f"flash_attention [24,1024,12,64] without RoPE: forward {t_f:.4f} "
          f"ms, backward {t_b:.4f} ms", flush=True)
    del o_nr, lse_nr

    # the backward on the same inputs, with the bf16 forward's o and lse
    grads = A.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                  rope=rope)
    refs = bwd_reference(qr, kr, v, o, lse, do, scale, rope32)
    del qr, kr
    torch.cuda.synchronize()
    what = "flash_attention_bwd rope [24,1024,12,64]"
    err = max(check(f"{what} {n}", x, y, **GRAD_BF16_TOL)
              for n, x, y in zip(("dq", "dk", "dv"), grads, refs))
    del grads, refs
    torch.cuda.empty_cache()
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
    rmsnorm_checks(rec, randn, g, dev)

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
    again = FC.flash_ce_bwd(x, w, tgt, lse, srow, norm)
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
        raise AssertionError("flash_ce_bwd: two bf16 calls on the same "
                             "inputs differ")
    rows = _build.query("flash_ce_bwd_chunk_rows", N, d, V, 1, 1)
    print(f"  flash_ce_bwd norm N={N} V={V}: bf16 backward bit-identical "
          f"over two calls ({rows}-row chunks, as the library sets them)",
          flush=True)
    del again
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
# int8-cache engine logits vs the same f32 reference: K/V read back as
# int8 codes add up to half a step of each (position, head) vector's
# amax / 127 to every cached value.  The first sound run on an H100 read
# a largest error of 5.25e-2 and a mean error of 7.9e-3 (PERF.md); the
# limits are about twice and one and a half times those, as for
# ENGINE_TOL.
INT8_TOL = dict(atol=0.11)
INT8_MEAN_TOL = 0.012


def expect_launches(what: str, launches: dict, want: dict) -> None:
    """Raise unless every kernel launched exactly as ``want`` says, and
    every kernel ``want`` leaves out not at all."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        raise AssertionError(f"{what}: launches {launches} != implied "
                             f"{full}")


def serve_launches(L: int, calls: dict, kv_dtype: str) -> dict:
    """The launches a serving run implies: per layer one prefill
    attention per cold prefill, one epilogue per prefill of either kind
    and per verify forward, one decode attention per decode dispatch."""
    decode = ("decode_attention_int8" if kv_dtype == "int8"
              else "decode_attention")
    return {"flash_attention_fwd": L * calls["prefill"],
            "matmul_residual_norm_fwd": L * (calls["prefill"]
                                             + calls["prefill_cached"]
                                             + calls["verify"]),
            decode: L * calls["decode"]}


def no_gather_in_decode(engine) -> None:
    """Make every decode step of ``engine`` raise if it gathers the paged
    context (``kv_cache.gather_pages``): the decode kernel reads the
    pages in place.  The cached prefill still gathers, outside the
    step."""
    from ray_tpu_torch.inference import kv_cache as kvc

    step, gather = engine._decode_step, kvc.gather_pages

    def refuse(*_args, **_kw):
        raise AssertionError("a decode step gathered the paged context")

    def decode_step(*args):
        kvc.gather_pages = refuse
        try:
            return step(*args)
        finally:
            kvc.gather_pages = gather

    engine._decode_step = decode_step


def serve(engine, prompts, sampling, max_new_tokens: int = 32) -> dict:
    """Submit every prompt at once (``max_new_tokens`` each), run the
    engine dry, and return what the run took: the launches, first-token
    times, outputs and the engine's call counts and seconds over the
    run."""
    from ray_tpu_torch.ops import _build

    calls0, secs0 = dict(engine.call_counts), dict(engine.seconds)
    _build.reset_launches()
    t0 = time.monotonic()
    rids = [engine.submit(p, max_new_tokens=max_new_tokens, sampling=sp)
            for p, sp in zip(prompts, sampling)]
    submitted = time.monotonic()
    first, out = {}, {r: [] for r in rids}
    while engine.has_work():
        for rid, tok, _done in engine.step():
            first.setdefault(rid, time.monotonic())
            out[rid].append(tok)
    torch.cuda.synchronize()
    run = dict(
        launches=_build.launch_counts(), rids=rids, out=out,
        wall=time.monotonic() - t0,
        ttft={r: first[r] - submitted for r in first},
        calls={k: v - calls0[k] for k, v in engine.call_counts.items()},
        secs={k: v - secs0[k] for k, v in engine.seconds.items()})
    if any(len(out[r]) != max_new_tokens for r in rids) or \
            len(first) != len(rids):
        raise AssertionError("not every request finished with "
                             f"{max_new_tokens} tokens")
    if not engine.leak_free():
        raise AssertionError("engine is not leak-free after the run")
    return run


def half_sampled(n: int):
    from ray_tpu_torch import SamplingParams
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    return [None if i % 2 == 0 else dataclasses.replace(sampled, seed=i)
            for i in range(n)]


def mixed_prompts():
    """gpt2-serve-mixed's 16 prompts of 40..900 tokens, from its seed."""
    rng = np.random.default_rng(0)
    lengths = np.linspace(40, 900, 16).astype(int)
    rng.shuffle(lengths)
    return [rng.integers(0, 50257, n).tolist() for n in lengths]


def engine_phase(params, cfg, dev) -> dict:
    """16 requests (prompts of 40..900 tokens, 32 new tokens each, half
    greedy and half sampled) through the engine with its defaults
    (prefix caching on, nothing to hit); prints the serving metrics and
    returns the launch counts of this run."""
    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, **ENGINE)
    no_gather_in_decode(engine)
    engine.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
    prompts = mixed_prompts()
    run = serve(engine, prompts, half_sampled(len(prompts)))
    prefills, decodes = run["calls"]["prefill"], run["calls"]["decode"]
    L = cfg.n_layers
    hits = engine.stats()["prefix"]
    if not engine.prefix or hits["requests_hit"] or prefills != 16:
        raise AssertionError(f"expected 16 cold prefills with prefix "
                             f"caching on and no hit: {hits}, {prefills} "
                             "prefills")
    expect_launches("gpt2-serve-mixed", run["launches"],
                    serve_launches(L, run["calls"], "model"))
    dec_s, pre_s = run["secs"]["decode"], run["secs"]["prefill"]
    dec_tokens = sum(len(v) - 1 for v in run["out"].values())
    metrics = {
        "cell": "gpt2-serve-mixed", "requests": len(prompts),
        "prefills": prefills, "decode_steps": decodes,
        "prefix_requests_hit": hits["requests_hit"],
        "mean_ttft_ms": 1e3 * float(np.mean(list(run["ttft"].values()))),
        "prefill_ms": 1e3 * pre_s / prefills,
        "decode_step_ms": 1e3 * dec_s / decodes,
        "decode_tokens_per_s": dec_tokens / dec_s,
        "wall_s": run["wall"],
    }
    print("engine phase: all 16 requests finished, leak-free, prefix cache "
          f"on with 0 hits; launches {run['launches']} == implied; no "
          "decode step gathered the paged context", flush=True)
    print("engine metrics " + json.dumps(metrics), flush=True)
    return run["launches"]


# gpt2-serve-int8-prefix: 4 system prompts of 512 tokens (4 full pages),
# each behind 4 of the 16 requests, with a unique suffix of 40..300 tokens
N_SYSTEM, SYSTEM_LEN = 4, 512


def prefix_traffic():
    """gpt2-serve-int8-prefix's traffic from its seed: a 200-token warm-up
    prompt, then 16 prompts, request i behind system prompt i % 4."""
    rng = np.random.default_rng(3)
    warm = rng.integers(0, 50257, 200).tolist()
    systems = [rng.integers(0, 50257, SYSTEM_LEN).tolist()
               for _ in range(N_SYSTEM)]
    suffixes = rng.integers(40, 301, 16)
    prompts = [systems[i % N_SYSTEM] + rng.integers(0, 50257, n).tolist()
               for i, n in enumerate(suffixes)]
    return warm, prompts


def int8_prefix_phase(params, cfg, dev) -> dict:
    """16 requests behind 4 shared system prompts through the int8-cache
    engine with prefix caching on, all submitted at once: the first
    request of each prompt prefills cold and registers its pages, the
    other 12 hit them and prefill only their suffix.  Checks the hits,
    the exact launches (decode runs the int8 kernel only; cached
    prefills attend in plain PyTorch) and the cache's size; prints TTFT
    for hit and cold requests apart, prefill and decode times."""
    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype="int8",
                             **ENGINE)
    no_gather_in_decode(engine)
    warm, prompts = prefix_traffic()
    engine.generate([warm, warm], max_new_tokens=2)   # warm-up, one hit
    hits0 = dict(engine.stats()["prefix"])
    run = serve(engine, prompts, half_sampled(len(prompts)))
    st = engine.stats()
    hit_reqs = st["prefix"]["requests_hit"] - hits0["requests_hit"]
    hit_tokens = st["prefix"]["hit_tokens"] - hits0["hit_tokens"]
    calls = run["calls"]
    L = cfg.n_layers
    if (hit_reqs, hit_tokens) != (12, 12 * SYSTEM_LEN) or \
            (calls["prefill"], calls["prefill_cached"]) != (4, 12):
        raise AssertionError(f"expected 12 hits of {SYSTEM_LEN} tokens and "
                             f"4 cold prefills: {hit_reqs} hits, "
                             f"{hit_tokens} tokens, calls {calls}")
    expect_launches("gpt2-serve-int8-prefix", run["launches"],
                    serve_launches(L, calls, "int8"))
    k = engine.cache.k
    bf16_bytes = 2 * k.numel() * 2
    if not st["cache_bytes"] < 0.55 * bf16_bytes:
        raise AssertionError(f"int8 cache {st['cache_bytes']} bytes is not "
                             f"under 0.55 x the bf16 cache's {bf16_bytes}")
    cold = [r for i, r in enumerate(run["rids"]) if i < N_SYSTEM]
    hit = [r for r in run["rids"] if r not in cold]
    metrics = {
        "cell": "gpt2-serve-int8-prefix", "requests": len(prompts),
        "prefix_requests_hit": hit_reqs, "hit_tokens": hit_tokens,
        "mean_ttft_ms_cold": 1e3 * float(np.mean([run["ttft"][r]
                                                  for r in cold])),
        "mean_ttft_ms_hit": 1e3 * float(np.mean([run["ttft"][r]
                                                 for r in hit])),
        "prefill_ms_cold": 1e3 * run["secs"]["prefill"] / calls["prefill"],
        "prefill_ms_cached": (1e3 * run["secs"]["prefill_cached"]
                              / calls["prefill_cached"]),
        "decode_steps": calls["decode"],
        "decode_step_ms": 1e3 * run["secs"]["decode"] / calls["decode"],
        "cache_bytes": st["cache_bytes"], "cache_bytes_bf16": bf16_bytes,
        "wall_s": run["wall"],
    }
    print("int8-prefix phase: all 16 requests finished, leak-free; 12 hits"
          f" of {SYSTEM_LEN} tokens; launches {run['launches']} == implied;"
          " no decode step gathered the paged context", flush=True)
    print("int8-prefix metrics " + json.dumps(metrics), flush=True)
    return run["launches"]


def to_cpu32(tree):
    return {k: to_cpu32(v) if isinstance(v, dict) else v.float().cpu()
            for k, v in tree.items()}


def against_reference(label, engine, params32, cfg32, prompts, outs,
                      tol, mean_tol) -> dict:
    """Each request's engine logits against the teacher-forced f32 CPU
    ``forward`` over its own trajectory: every logit within ``tol``, the
    mean error within ``mean_tol``, and greedy tokens equal to the
    reference argmax wherever its top-2 margin is wider than twice the
    tolerance (at least one such token must occur)."""
    from ray_tpu_torch.models.gpt import forward

    worst, errs, checked, agree, total = 0.0, [], 0, 0, 0
    for rid, (prompt, gen) in enumerate(zip(prompts, outs)):
        full = torch.tensor(prompt + gen[:-1])[None]
        with torch.inference_mode():
            ref = forward(params32, full, cfg32)[0][0, len(prompt) - 1:]
        got = torch.from_numpy(np.stack(engine.logits_trace[rid]))
        worst = max(worst, check(f"{label} logits request {rid}", got, ref,
                                 **tol))
        errs.append((got - ref).abs().flatten())
        top2 = ref.topk(2, -1).values
        sure = top2[:, 0] - top2[:, 1] > 2 * tol["atol"]
        gen_t = torch.tensor(gen)
        if (ref.argmax(-1)[sure] != gen_t[sure]).any():
            raise AssertionError(f"{label} request {rid}: a greedy token "
                                 "differs where the margin is wide")
        checked += int(sure.sum())
        agree += int((ref.argmax(-1) == gen_t).sum())
        total += len(gen)
    mean_err = torch.cat(errs).mean().item()
    if mean_err > mean_tol:
        raise AssertionError(f"{label} logits: mean abs error "
                             f"{mean_err:.3e} > {mean_tol}")
    if checked == 0:
        raise AssertionError("no greedy token has a margin wider than "
                             "twice the tolerance: nothing was checked")
    if not engine.leak_free():
        raise AssertionError(f"{label} engine is not leak-free")
    print(f"{label}: engine logits within atol {tol['atol']} of the f32 CPU "
          f"reference (max_abs_err={worst:.3e}, mean {mean_err:.3e} <= "
          f"{mean_tol}); {checked} greedy tokens with a margin over "
          f"{2 * tol['atol']} all agree; {agree}/{total} equal the "
          "reference argmax", flush=True)
    return dict(max_abs_err=worst, mean_abs_err=mean_err)


def correctness_phase(params, cfg, dev, *, norm_kernel: bool = False
                      ) -> dict:
    """Two greedy requests' engine logits (bf16, on the card) against
    the port's teacher-forced forward on the CPU in f32, same weights,
    under ``ENGINE_TOL`` and ``ENGINE_MEAN_TOL``.  With ``norm_kernel``
    the engine runs the model's RMSNorms through the RMSNorm kernel
    (``gpt._PALLAS_NORM``): once per layer (``ln1``) and for ``ln_f`` in
    a prefill, whose ``ln2`` the fused epilogue takes, and twice per
    layer plus ``ln_f`` in a decode step, where the epilogue declines
    S = 1.  Returns the run's launches."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _build

    engine = InferenceEngine(cfg, params, device=dev, debug_logits=True,
                             **ENGINE)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 50257, n).tolist() for n in (40, 300)]
    _build.reset_launches()
    gpt._PALLAS_NORM = norm_kernel
    try:
        outs = engine.generate(prompts, max_new_tokens=16)
    finally:
        gpt._PALLAS_NORM = False
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    L, calls = cfg.n_layers, engine.call_counts
    norms = ((L + 1) * (calls["prefill"] + calls["prefill_cached"])
             + (2 * L + 1) * calls["decode"]) if norm_kernel else 0
    if launches["rmsnorm_fwd"] != norms or launches["rmsnorm_bwd"]:
        raise AssertionError(f"rmsnorm launches {launches} != {norms} "
                             f"implied by {calls}")
    label = "correctness norm kernel" if norm_kernel else "correctness"
    against_reference(label, engine, to_cpu32(params),
                      dataclasses.replace(cfg, dtype=torch.float32), prompts,
                      outs, ENGINE_TOL, ENGINE_MEAN_TOL)
    if norm_kernel:
        print(f"correctness norm kernel: rmsnorm_fwd launched {norms} times "
              f"({L + 1} per prefill, {2 * L + 1} per decode step; "
              f"{calls}), exact", flush=True)
    return launches


def int8_correctness_phase(params, cfg, dev) -> None:
    """A greedy request on the int8-cache engine, then the same prompt
    again as a prefix hit (two of its pages): both against the f32
    teacher-forced reference under ``INT8_TOL``, and the hit's logits
    against its cold run's, under the same bound, up to and including
    the first step where their tokens part (after it their contexts
    differ)."""
    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype="int8",
                             debug_logits=True, **ENGINE)
    prompt = np.random.default_rng(4).integers(0, 50257, 300).tolist()
    outs = [engine.generate([prompt], max_new_tokens=16)[0]
            for _ in range(2)]
    prefix = engine.stats()["prefix"]
    if (prefix["requests_hit"], prefix["hit_tokens"]) != (1, 256):
        raise AssertionError(f"the second request did not hit: {prefix}")
    against_reference("int8 correctness", engine, to_cpu32(params),
                      dataclasses.replace(cfg, dtype=torch.float32),
                      [prompt, prompt], outs, INT8_TOL, INT8_MEAN_TOL)
    parted = [i for i, (a, b) in enumerate(zip(*outs)) if a != b]
    n = parted[0] + 1 if parted else len(outs[0])
    cold, hit = (np.stack(engine.logits_trace[r][:n]) for r in (0, 1))
    check(f"int8 hit vs cold logits ({n} steps)", torch.from_numpy(hit),
          torch.from_numpy(cold), **INT8_TOL)


# the cell "gpt2-serve-spec": the JAX package's speculative-decoding
# bench (bench.py:1240-1380, bench_infer_spec) on GPT-2 124M at full
# width and depth: 2 slots, page 16, 4 requests of 512 new tokens each
# submitted one at a time (the latency-bound regime), greedy; two mixes
# from its seed, "templated" (a 48-token shared prefix + a per-request
# 6-token motif repeated 4 times; from the second request on the prefix
# hits) and "random" (72 i.i.d. tokens); arms spec off and k = 2, 4, 8
SPEC = dict(slots=2, page_size=16)
SPEC_REQUESTS, SPEC_NEW = 4, 512
SPEC_ARMS, SPEC_ARMS_FULL = (0, 4), (0, 2, 4, 8)
# then the serving geometry: 8 templated requests in flight, half greedy
# and half sampled, spec_k = 4 for all, half or none of them
SPEC_SERVE_REQUESTS, SPEC_SERVE_NEW = 8, 128


def spec_mixes(vocab: int) -> dict:
    """The reference bench's prompts, from its seed."""
    rng = np.random.RandomState(1)
    shared = rng.randint(0, vocab, 48).tolist()
    return {
        "templated": [shared + rng.randint(0, vocab, 6).tolist() * 4
                      for _ in range(SPEC_REQUESTS)],
        "random": [rng.randint(0, vocab, 72).tolist()
                   for _ in range(SPEC_REQUESTS)]}


def spec_sampling(sp, k: int):
    """``sp`` (None = greedy) with speculation on at ``k``, or pinned off
    (k = 0)."""
    from ray_tpu_torch import SamplingParams
    return dataclasses.replace(sp or SamplingParams(), spec=k > 0,
                               spec_k=k or None)


def spec_audit(what: str, engine) -> None:
    """Leak-free, and no drafter state left after the run and after
    ``drain_requests``."""
    st = engine.stats()
    engine.drain_requests()
    if not engine.leak_free() or st["spec"]["drafts"] or \
            engine.stats()["spec"]["drafts"] or st["active"]:
        raise AssertionError(f"{what}: not clean after the run: {st}")


def serve_one_at_a_time(engine, prompts, sp, max_new: int) -> dict:
    """Each prompt submitted alone and run dry before the next (the
    sequential regime of the reference bench).  Returns the outputs, the
    inter-token gaps (host clock between consecutive token events of a
    request; the tokens of one verify land together), each request's
    time from its first token to its last, the launches and the engine's
    call counts and seconds over the run."""
    from ray_tpu_torch.ops import _build

    calls0, secs0 = dict(engine.call_counts), dict(engine.seconds)
    _build.reset_launches()
    t0 = time.monotonic()
    outs, gaps, after_first = [], [], []
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new, sampling=sp)
        toks, stamps = [], []
        while engine.has_work():
            for _rid, tok, _done in engine.step():
                stamps.append(time.monotonic())
                toks.append(tok)
        gaps += [b - a for a, b in zip(stamps, stamps[1:])]
        after_first.append(stamps[-1] - stamps[0])
        outs.append(toks)
    torch.cuda.synchronize()
    if any(len(o) != max_new for o in outs):
        raise AssertionError(f"not every request finished with {max_new} "
                             "tokens")
    return dict(
        outs=outs, gaps=gaps, after_first=after_first,
        wall=time.monotonic() - t0, launches=_build.launch_counts(),
        calls={k: v - calls0[k] for k, v in engine.call_counts.items()},
        secs={k: v - secs0[k] for k, v in engine.seconds.items()})


def spec_run_metrics(run: dict, spec: dict) -> dict:
    calls, secs = run["calls"], run["secs"]
    gaps = sorted(run["gaps"])
    return {
        "decode_tokens_per_s": (sum(len(o) - 1 for o in run["outs"])
                                / sum(run["after_first"])),
        "accept_rate": spec["accept_rate"], "k_hist": spec["k_hist"],
        "proposed": spec["proposed"], "accepted": spec["accepted"],
        "verify_calls": calls["verify"],
        "verify_ms": (1e3 * secs["verify"] / calls["verify"]
                      if calls["verify"] else None),
        "decode_dispatches": calls["decode"],
        "decode_step_ms": (1e3 * secs["decode"] / calls["decode"]
                           if calls["decode"] else None),
        "inter_token_p50_ms": 1e3 * gaps[len(gaps) // 2],
        "inter_token_p99_ms": 1e3 * gaps[int(0.99 * (len(gaps) - 1))],
        "wall_s": run["wall"]}


def spec_parity(what: str, off_engine, off_outs, outs) -> int:
    """Each greedy stream of a spec arm against the off arm's: equal up to
    their first difference, where the off arm's own top-2 logit margin
    must be under twice ``ENGINE_TOL``'s atol (verify and decode round
    differently in bf16: plain attention against the kernel, so a
    near-tie may flip; nothing else may).  Returns how many streams are
    identical end to end."""
    same = 0
    for rid, (want, got) in enumerate(zip(off_outs, outs)):
        parted = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
        if not parted:
            same += 1
            continue
        i = parted[0]
        top2 = np.sort(off_engine.logits_trace[rid][i])[-2:]
        margin = float(top2[1] - top2[0])
        print(f"  {what} request {rid}: parts from the off arm at token "
              f"{i}, where the off arm's top-2 margin is {margin:.4f}",
              flush=True)
        if margin >= 2 * ENGINE_TOL["atol"]:
            raise AssertionError(f"{what} request {rid}: the stream parts "
                                 f"from the off arm at token {i} with a "
                                 f"top-2 margin of {margin:.4f}")
    return same


def spec_sequential_phase(params, cfg, dev, arms) -> dict:
    """The reference bench's regime: per mix, the off arm, then each k
    arm, each on a fresh engine (2 slots, page 16, debug logits: the
    off arm's margins decide a parted stream), requests one at a time.
    Gates: every request finishes, leak-free, no drafter state, exact
    launches, proposals and acceptances on the templated mix, streams
    equal to the off arm's but after a near-tie.  Prints one line per
    arm; returns the launches of every arm."""
    from ray_tpu_torch import InferenceEngine

    L = cfg.n_layers
    mixes = spec_mixes(cfg.vocab_size)
    warm = InferenceEngine(cfg, params, device=dev, **SPEC)
    for k in SPEC_ARMS_FULL:                      # warm-up, every shape
        warm.generate(mixes["templated"][:2], max_new_tokens=24,
                      sampling=spec_sampling(None, k))
    del warm
    total = collections.Counter()
    for mix, prompts in mixes.items():
        base = None
        for k in arms:
            engine = InferenceEngine(cfg, params, device=dev,
                                     debug_logits=True, **SPEC)
            no_gather_in_decode(engine)
            run = serve_one_at_a_time(engine, prompts,
                                      spec_sampling(None, k), SPEC_NEW)
            what = f"gpt2-serve-spec {mix} k={k or 'off'}"
            spec = engine.stats()["spec"]
            spec_audit(what, engine)
            expect_launches(what, run["launches"],
                            serve_launches(L, run["calls"], "model"))
            total.update(run["launches"])
            if k and mix == "templated" and not (spec["proposed"]
                                                 and spec["accepted"]):
                raise AssertionError(f"{what}: nothing drafted or "
                                     f"accepted: {spec}")
            metrics = spec_run_metrics(run, spec)
            if base is None:
                base = dict(engine=engine, outs=run["outs"],
                            tps=metrics["decode_tokens_per_s"])
            else:
                metrics["streams_identical"] = spec_parity(
                    what, base["engine"], base["outs"], run["outs"])
            metrics["speedup_vs_off"] = (metrics["decode_tokens_per_s"]
                                         / base["tps"])
            print("spec arm " + json.dumps(dict(
                cell="gpt2-serve-spec", mix=mix, k=k or "off",
                requests=len(prompts), max_new_tokens=SPEC_NEW,
                **metrics)), flush=True)
        del base
    print(f"spec sequential arms {list(arms)}: every request finished, "
          "leak-free, no drafter state left, launches == implied, greedy "
          "streams equal to the off arm's but after a near-tie", flush=True)
    return total


def spec_correctness_phase(params, cfg, dev, kv_dtype: str) -> None:
    """Two templated greedy requests at once (the second hits the first's
    prefix), 64 new tokens, spec_k = 4, on a debug-logits engine: every
    logits row, verify rows included, against the f32 CPU teacher-forced
    reference under ``ENGINE_TOL`` (bf16) or ``INT8_TOL`` (int8)."""
    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                             debug_logits=True, **SPEC)
    prompts = spec_mixes(cfg.vocab_size)["templated"][:2]
    outs = engine.generate(prompts, max_new_tokens=64,
                           sampling=spec_sampling(None, 4))
    st = engine.stats()
    if not (st["calls"]["verify"] and st["spec"]["accepted"]
            and st["prefix"]["requests_hit"] == 1):
        raise AssertionError(f"spec correctness {kv_dtype}: no verify, "
                             f"no accepted draft or no hit: {st}")
    tol, mean_tol = ((INT8_TOL, INT8_MEAN_TOL) if kv_dtype == "int8"
                     else (ENGINE_TOL, ENGINE_MEAN_TOL))
    against_reference(f"spec correctness {kv_dtype}", engine,
                      to_cpu32(params),
                      dataclasses.replace(cfg, dtype=torch.float32),
                      prompts, outs, tol, mean_tol)
    print(f"spec correctness {kv_dtype}: {st['calls']['verify']} verifies, "
          f"spec {st['spec']}", flush=True)


def spec_serving_prompts(vocab: int):
    rng = np.random.RandomState(2)
    shared = rng.randint(0, vocab, 48).tolist()
    return [shared + rng.randint(0, vocab, 6).tolist() * 4
            for _ in range(SPEC_SERVE_REQUESTS)]


def spec_serving_phase(params, cfg, dev, kv_dtype: str) -> dict:
    """The serving geometry (8 slots, page 128), 8 templated requests in
    flight, half greedy and half sampled: spec_k = 4 for every request,
    for half of them (the other half co-batched through the decode kernel
    beside the speculating slots' dead rows), and for none.  Gates as in
    the sequential arms; prints each run's wall clock and how many
    streams, greedy and sampled, equal the off run's.  Returns the
    launches."""
    from ray_tpu_torch import InferenceEngine

    L = cfg.n_layers
    prompts = spec_serving_prompts(cfg.vocab_size)
    base = half_sampled(len(prompts))
    runs = {"all": [spec_sampling(sp, 4) for sp in base],
            "half": [spec_sampling(sp, 4 if i % 4 < 2 else 0)
                     for i, sp in enumerate(base)],
            "off": [spec_sampling(sp, 0) for sp in base]}
    total, outs, lines = collections.Counter(), {}, {}
    for name, sampling in runs.items():
        engine = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                                 **ENGINE)
        no_gather_in_decode(engine)
        engine.generate([[1, 2, 3]], max_new_tokens=2)       # warm-up
        run = serve(engine, prompts, sampling, SPEC_SERVE_NEW)
        what = f"gpt2-serve-spec 8 slots {kv_dtype} spec={name}"
        spec = engine.stats()["spec"]
        spec_audit(what, engine)
        expect_launches(what, run["launches"],
                        serve_launches(L, run["calls"], kv_dtype))
        total.update(run["launches"])
        if name != "off" and not (spec["proposed"] and spec["accepted"]):
            raise AssertionError(f"{what}: nothing drafted or accepted: "
                                 f"{spec}")
        outs[name] = [run["out"][r] for r in run["rids"]]
        calls, secs = run["calls"], run["secs"]
        lines[name] = dict(
            cell="gpt2-serve-spec-8", kv_dtype=kv_dtype, spec=name,
            wall_s=run["wall"],
            tokens_per_s=len(prompts) * SPEC_SERVE_NEW / run["wall"],
            decode_dispatches=calls["decode"],
            decode_step_ms=(1e3 * secs["decode"] / calls["decode"]
                            if calls["decode"] else None),
            verify_calls=calls["verify"],
            verify_ms=(1e3 * secs["verify"] / calls["verify"]
                       if calls["verify"] else None),
            accept_rate=spec["accept_rate"], k_hist=spec["k_hist"])
    for name, line in lines.items():
        same = [a == b for a, b in zip(outs[name], outs["off"])]
        line["identical_greedy"] = sum(same[0::2])
        line["identical_sampled"] = sum(same[1::2])
        line["wall_vs_off"] = line["wall_s"] / lines["off"]["wall_s"]
        print("spec serving " + json.dumps(line), flush=True)
    print(f"spec serving {kv_dtype}: 3 runs of {len(prompts)} requests "
          "finished, leak-free, no drafter state left, launches == implied;"
          " no decode step gathered the paged context", flush=True)
    return total


def spec_phase(params, cfg, dev, arms=SPEC_ARMS) -> dict:
    """gpt2-serve-spec: the sequential arms, the correctness of spec
    greedy requests against the f32 reference (bf16 and int8), then the
    serving geometry in bf16 and int8.  Returns the launches of the
    timed runs (each with the counts at 0 just before it)."""
    launches = spec_sequential_phase(params, cfg, dev, arms)
    for kv_dtype in ("model", "int8"):
        spec_correctness_phase(params, cfg, dev, kv_dtype)
    for kv_dtype in ("model", "int8"):
        launches.update(spec_serving_phase(params, cfg, dev, kv_dtype))
    return launches


# ------------------------------------------------- the serving surface
def add_launches(total: dict, run: dict) -> dict:
    """Two runs' launch counts, kernel by kernel."""
    return {k: total.get(k, 0) + run.get(k, 0)
            for k in set(total) | set(run)}


def on_device(a, dev):
    """A handoff's or spill entry's host array (numpy, or a CPU tensor for
    bf16) on the card, for a bit-for-bit comparison there."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    return t.to(dev)


def page_bytes(cfg, int8: bool) -> int:
    """One page's K/V bytes over all layers: the model dtype, or int8
    codes and f32 scales."""
    from ray_tpu_torch.inference import kv_cache as kvc
    return kvc.handoff_page_bytes(
        n_layers=cfg.n_layers, page_size=ENGINE["page_size"],
        n_heads=cfg.n_heads, head_dim=cfg.head_dim,
        itemsize=1 if int8 else cfg.dtype.itemsize, quantized=int8)


def check_installed(what, engine, req, handoff) -> None:
    """The importer's cache pages of ``req`` against the handoff, bit for
    bit, at the context's positions (a page's positions past the context
    hold the exporter's garbage, or decode writes since)."""
    if not handoff.page_list:
        return
    ps, n_ctx = engine.page_size, len(handoff.context)
    names = ("k", "v") + (("k_scale", "v_scale") if engine.cache.quantized
                          else ())
    for name in names:
        cache = getattr(engine.cache, name)
        sent = on_device(getattr(handoff, name), cache.device)
        for i, src in enumerate(handoff.page_list):
            n = min(ps, n_ctx - src * ps)
            if not torch.equal(cache[:, req.pages[src], :n],
                               sent[:, i, :n]):
                raise AssertionError(f"{what}: installed page {src} "
                                     f"({name}) differs from the handoff")


def gap_free_trace(what, trace_mod, trace_id, want_names) -> None:
    """One trace: one root (``request``), every parent present, the span
    names ``want_names``."""
    spans = trace_mod.spans_for(trace_id)
    ids = {s["span_id"] for s in spans}
    roots = [s["name"] for s in spans if s["parent_id"] is None]
    dangling = [s["name"] for s in spans
                if s["parent_id"] is not None and s["parent_id"] not in ids]
    names = sorted(s["name"] for s in spans)
    if roots != ["request"] or dangling or names != sorted(want_names):
        raise AssertionError(f"{what}: trace is not one gap-free tree: "
                             f"roots {roots}, dangling {dangling}, names "
                             f"{names}")


DISAGG_NEW = 32
DISAGG_TRACED = 1        # a sampled request, traced across the handoff


def disagg_pair(what, pre, dec, prompts, sampling, trace_ctx=None,
                ship=None) -> dict:
    """Every request through the pair: a first-token-stop submission on
    ``pre`` (all at once, run dry), each exported (its arrays checked
    against the exporter's pages), then imported into ``dec`` for the
    remaining tokens and run dry, each install checked against its
    handoff.  ``ship`` maps a handoff to the form sent (a strip).
    Returns the streams, the launches of each side (counts at
    0 just before each), TTFTs, export and install times, the
    handoffs."""
    from ray_tpu_torch.inference import kv_cache as kvc
    from ray_tpu_torch.ops import _build

    _build.reset_launches()
    rids = [pre.submit(p, max_new_tokens=1, sampling=sp, hold_pages=True,
                       trace_ctx=trace_ctx if i == DISAGG_TRACED else None)
            for i, (p, sp) in enumerate(zip(prompts, sampling))]
    submitted = time.monotonic()
    first, handoffs, export_s = {}, {}, []
    while pre.has_work():
        for ev in pre.step():
            rid = ev[0]
            first[rid] = (int(ev[1]), time.monotonic() - submitted)
            # export at once: a held request keeps its pages until then
            pages = list(pre._held[rid].pages)
            t0 = time.monotonic()
            h = pre.export_request(rid)
            export_s.append(time.monotonic() - t0)
            # released, but nothing has overwritten them yet
            for name, arr in kvc.page_contents(
                    pre.cache, pages[:h.n_pages]).items():
                if not torch.equal(arr, on_device(getattr(h, name),
                                                  arr.device)):
                    raise AssertionError(f"{what}: handoff {name} of "
                                         f"request {rid} differs from the "
                                         "exporter's pages")
            handoffs[rid] = ship(h) if ship else h
    torch.cuda.synchronize()
    pre_launches = _build.launch_counts()
    handoffs = [handoffs[r] for r in rids]
    install_s = []
    inner = dec._install_import

    def timed_install(req, events):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        inner(req, events)
        torch.cuda.synchronize()
        install_s.append(time.monotonic() - t0)

    dec._install_import = timed_install
    secs0, calls0 = dict(dec.seconds), dict(dec.call_counts)
    _build.reset_launches()
    by_import = {dec.import_submit(h, max_new_tokens=DISAGG_NEW - 1,
                                   sampling=sp): i
                 for i, (h, sp) in enumerate(zip(handoffs, sampling))}
    out = {i: [first[r][0]] for i, r in enumerate(rids)}
    checked = set()
    while dec.has_work():
        for ev in dec.step():
            if ev.error is not None:
                raise AssertionError(f"{what}: import failed: {ev.error!r}")
            out[by_import[ev[0]]].append(int(ev[1]))
        for req in dec.scheduler.active.values():
            if req.rid not in checked:
                checked.add(req.rid)
                check_installed(what, dec, req,
                                handoffs[by_import[req.rid]])
    torch.cuda.synchronize()
    dec._install_import = inner
    return dict(out=[out[i] for i in range(len(prompts))],
                pre_launches=pre_launches,
                dec_launches=_build.launch_counts(),
                ttft=[first[r][1] for r in rids], export_s=export_s,
                install_s=install_s, handoffs=handoffs,
                decode_s=dec.seconds["decode"] - secs0["decode"],
                decode_calls=dec.call_counts["decode"] - calls0["decode"])


def disagg_phase(params, cfg, dev) -> dict:
    """gpt2-serve-disagg: a prefill engine and a decode engine (8 slots,
    page 128 each) on one card serve gpt2-serve-mixed's 16 requests, in
    bf16 and with the int8 cache (codes and scales move as they are),
    against a co-located engine on the same requests: every stream
    equal token for token, the handoff bit-equal to the exporter's pages
    and the installs to the handoff, exact byte figures and launches,
    both engines leak-free with nothing held.  Then one warm import of a
    whole-page context the importer holds by digest: no page moves, same
    stream.  One sampled request is traced across the handoff.  Returns
    the pair's launches (each side's counts at 0 just before it)."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.telemetry import trace as trace_mod

    prompts = mixed_prompts()
    sampling = half_sampled(len(prompts))
    L, n = cfg.n_layers, len(prompts)
    path: dict = {}
    for kv_dtype in ("model", "int8"):
        what = f"gpt2-serve-disagg {kv_dtype}"
        colo = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                               **ENGINE)
        colo.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
        ref = serve(colo, prompts, sampling, DISAGG_NEW)
        want = [ref["out"][r] for r in ref["rids"]]
        pre = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                              **ENGINE)
        dec = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                              telemetry=True, **ENGINE)
        no_gather_in_decode(dec)
        trace_mod.reset()
        ctx = trace_mod.mint(sampled=True)
        root = trace_mod.record_span("request", ctx, start=time.time(),
                                     dur=0.0)
        run = disagg_pair(what, pre, dec, prompts, sampling,
                          trace_ctx=ctx.child(root))
        if run["out"] != want:
            parted = [i for i, (a, b) in enumerate(zip(run["out"], want))
                      if a != b]
            raise AssertionError(f"{what}: requests {parted} part from the "
                                 "co-located streams")
        decode = ("decode_attention_int8" if kv_dtype == "int8"
                  else "decode_attention")
        expect_launches(f"{what} exporter", run["pre_launches"],
                        {"flash_attention_fwd": L * n,
                         "matmul_residual_norm_fwd": L * n})
        expect_launches(f"{what} importer", run["dec_launches"],
                        {decode: L * run["decode_calls"]})
        path = add_launches(add_launches(path, run["pre_launches"]),
                            run["dec_launches"])
        per_page = page_bytes(cfg, kv_dtype == "int8")
        for h in run["handoffs"]:
            if h.nbytes != per_page * h.n_pages:
                raise AssertionError(f"{what}: handoff of {h.n_pages} pages "
                                     f"is {h.nbytes} bytes, not "
                                     f"{per_page} a page")
        if kv_dtype == "int8" and \
                per_page > 0.55 * page_bytes(cfg, False):
            raise AssertionError(f"{what}: an int8 page ({per_page} bytes) "
                                 "is over 0.55x a bf16 page")
        tel = dec.telemetry.summary()
        if (tel["requests_done"], tel["prefills"], tel["decode_steps"],
                tel["decode_tokens"]) != (n, 0, run["decode_calls"],
                                          n * (DISAGG_NEW - 1)):
            raise AssertionError(f"{what}: importer telemetry {tel} does not "
                                 f"count the run ({dec.call_counts})")
        gap_free_trace(what, trace_mod, ctx.trace_id,
                       ["request", "prefix_walk", "queue", "prefill",
                        "first_token", "prefix_walk", "handoff.install"])
        ticks = sum(ctx.trace_id in r["attributes"]["trace_ids"]
                    for r in trace_mod.recorder().spans()
                    if r["name"] == "decode_tick")
        if ticks != DISAGG_NEW - 1:
            raise AssertionError(f"{what}: {ticks} decode ticks name the "
                                 "traced request")
        # a warm import: a whole-page context the importer already holds
        warm = np.random.default_rng(5).integers(0, 50257, 512).tolist()
        greedy = [None]
        cold = disagg_pair(f"{what} warm-up", pre, dec, [warm], greedy)
        pre.scheduler.flush_prefix()        # the exporter prefills cold
        resident = dec.prefix_digest()
        hits0 = dec.scheduler.prefix_hit_pages
        # the sender strips the pages the target holds by digest: all 4
        w = disagg_pair(f"{what} warm", pre, dec, [warm], greedy,
                        ship=lambda h: h.strip_to(
                            [i for i in range(h.n_pages)
                             if i >= len(h.chain_hashes)
                             or h.chain_hashes[i] not in resident]))
        if w["handoffs"][0].nbytes or w["handoffs"][0].page_list:
            raise AssertionError(f"{what}: a warm handoff moves "
                                 f"{w['handoffs'][0].nbytes} bytes")
        if w["out"] != cold["out"] or dec.scheduler.prefix_hit_pages != \
                hits0 + 4:
            raise AssertionError(f"{what}: the warm import's stream "
                                 f"{w['out']} != the cold one's "
                                 f"{cold['out']}, or it did not take the "
                                 "4 resident pages as hits")
        for eng in (pre, dec):
            if not eng.leak_free() or eng.stats()["held"]:
                raise AssertionError(f"{what}: not leak-free after the run")
        dec_tokens = n * (DISAGG_NEW - 1)
        metrics = {
            "cell": "gpt2-serve-disagg", "kv_dtype": kv_dtype,
            "requests": n,
            "export_ms_per_request": 1e3 * float(np.mean(run["export_s"])),
            "install_ms_per_request": 1e3 * float(np.mean(run["install_s"])),
            "handoff_mb_per_request": float(np.mean(
                [h.nbytes for h in run["handoffs"]])) / 1e6,
            "export_gb_per_s": (sum(h.nbytes for h in run["handoffs"])
                                / sum(run["export_s"]) / 1e9),
            "install_gb_per_s": (sum(h.nbytes for h in run["handoffs"])
                                 / sum(run["install_s"]) / 1e9),
            "mean_ttft_ms_pair": 1e3 * float(np.mean(run["ttft"])),
            "mean_ttft_ms_colocated": 1e3 * float(np.mean(
                list(ref["ttft"].values()))),
            "decode_tokens_per_s_pair": dec_tokens / run["decode_s"],
            "decode_tokens_per_s_colocated": dec_tokens
            / ref["secs"]["decode"],
            "decode_steps_pair": run["decode_calls"],
            "decode_steps_colocated": ref["calls"]["decode"],
        }
        print(f"{what}: 16 streams equal the co-located engine's; handoffs "
              "bit-equal to the exporter's pages and installs to the "
              f"handoffs; {per_page} bytes a page; launches exact (exporter "
              f"{launches_line(run['pre_launches'])}, importer "
              f"{launches_line(run['dec_launches'])}); one gap-free trace; "
              "leak-free, nothing held", flush=True)
        print("disagg metrics " + json.dumps(metrics), flush=True)
        del colo, pre, dec
        gc.collect()
        torch.cuda.empty_cache()
    return path


# gpt2-serve-tiers: gpt2-serve-int8-prefix's 16 requests in 8 waves of
# the 2 requests behind one system prompt, each wave run dry before the
# next: round 1 serves systems 0..3 (requests s, s + 4), round 2 the same
# systems again (s + 8, s + 12).  10 usable pages hold about one wave, so
# each wave reclaims the previous waves' idle pages, and every system's 4
# pages are demoted before round 2 comes back to them: 16 promoted pages
# (the host logic decides it; a CPU rehearsal of the same lengths gives 7
# from the host pool and 9 from the store with 16 host pages)
TIER_ENGINE = dict(num_pages=11, host_pages=16, store=True)
TIER_WAVES = [[s, s + 4] for s in range(N_SYSTEM)] + \
    [[s + 8, s + 12] for s in range(N_SYSTEM)]
TIER_PROMOTED = 16
TIER_ARMS = (("bf16-model-spill", dict(kv_dtype="model",
                                       spill_dtype="model")),
             ("int8-cache", dict(kv_dtype="int8")),
             ("bf16-int8-spill", dict(kv_dtype="model",
                                      spill_dtype="int8")))


def serve_waves(engine, prompts, sampling, waves, max_new=32) -> dict:
    """Each wave's requests submitted together and run dry before the
    next; returns the streams by request index, TTFTs, the launches (the
    counts at 0 just before), the call counts and seconds over it."""
    from ray_tpu_torch.ops import _build

    calls0, secs0 = dict(engine.call_counts), dict(engine.seconds)
    _build.reset_launches()
    out, ttft, rid_of = {}, {}, {}
    for wave in waves:
        t0 = time.monotonic()
        for i in wave:
            rid_of[engine.submit(prompts[i], max_new_tokens=max_new,
                                 sampling=sampling[i])] = i
        while engine.has_work():
            for ev in engine.step():
                i = rid_of[ev[0]]
                if i not in out:
                    ttft[i] = time.monotonic() - t0
                out.setdefault(i, []).append(int(ev[1]))
    torch.cuda.synchronize()
    if any(len(out[i]) != max_new for i in range(len(prompts))):
        raise AssertionError("not every request finished")
    return dict(out=out, ttft=ttft, launches=_build.launch_counts(),
                rid_of={i: r for r, i in rid_of.items()},
                calls={k: v - calls0[k] for k, v in
                       engine.call_counts.items()},
                secs={k: v - secs0[k] for k, v in engine.seconds.items()})


def tiers_phase(params, cfg, dev) -> dict:
    """gpt2-serve-tiers: per arm, the waves through an engine whose idle
    prefix pages are demoted to a 16-page host pool and on to a page
    store, against the same waves on an engine that keeps every page
    resident.  In the exact arms (bf16 with the model-dtype spill, the
    int8 cache's own codes) every stream equals the resident engine's,
    the promoted requests' included; with the int8 spill of a bf16
    cache the promoted greedy requests' logits are held to the f32
    reference under ``INT8_TOL``.  Every arm: the 16 promotions, spill
    bytes equal to the per-page figure times the spills, exact
    launches, telemetry equal to the engine's counters, leak-free with
    the host partition, no store fetch in flight.  Returns the tiered
    runs' launches."""
    from ray_tpu_torch import InferenceEngine

    _warm, prompts = prefix_traffic()
    sampling = half_sampled(len(prompts))
    L = cfg.n_layers
    path: dict = {}
    cfg32, params32 = None, None
    for arm, kw in TIER_ARMS:
        what = f"gpt2-serve-tiers {arm}"
        exact = kw.get("spill_dtype") != "int8"
        resident = InferenceEngine(cfg, params, device=dev, prefix=True,
                                   **kw, **ENGINE)
        ref = serve_waves(resident, prompts, sampling, TIER_WAVES)
        engine = InferenceEngine(cfg, params, device=dev, telemetry=True,
                                 debug_logits=not exact, **kw,
                                 **TIER_ENGINE, **ENGINE)
        no_gather_in_decode(engine)
        run = serve_waves(engine, prompts, sampling, TIER_WAVES)
        expect_launches(what, run["launches"],
                        serve_launches(L, run["calls"], engine.kv_dtype))
        path = add_launches(path, run["launches"])
        st = engine.stats()["tiers"]
        promoted = st["hits"]["dram"] + st["hits"]["store"]
        if promoted < TIER_PROMOTED or st["fetches"] != promoted:
            raise AssertionError(f"{what}: {promoted} promoted pages, "
                                 f"{TIER_PROMOTED} implied: {st}")
        per_page = page_bytes(cfg, not (exact
                                        and engine.kv_dtype == "model"))
        spills = st["host"]["spills"]
        if st["spill_bytes"] != per_page * spills or not spills:
            raise AssertionError(f"{what}: spill bytes {st['spill_bytes']} "
                                 f"!= {per_page} x {spills} spills")
        if not engine.leak_free() or engine.store.in_flight:
            raise AssertionError(f"{what}: not leak-free after the run")
        tel = engine.telemetry.summary()["tiers"]
        if (tel["spill_bytes"], tel["fetches"],
                {k: v for k, v in st["hits"].items() if v}) != \
                (st["spill_bytes"], st["fetches"], tel["hits"]):
            raise AssertionError(f"{what}: telemetry {tel} != the engine's "
                                 f"counters {st}")
        promoted_reqs = [s + 8 for s in range(N_SYSTEM)]
        if exact:
            parted = [i for i in range(len(prompts))
                      if run["out"][i] != ref["out"][i]]
            if parted:
                raise AssertionError(f"{what}: requests {parted} part from "
                                     "the resident engine's streams")
            checked = "16 streams equal the resident engine's"
        else:
            if params32 is None:
                params32 = to_cpu32(params)
                cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
            greedy = [i for i in promoted_reqs if sampling[i] is None]
            engine.logits_trace = {
                k: engine.logits_trace[run["rid_of"][i]]
                for k, i in enumerate(greedy)}
            against_reference(f"{what} promoted", engine, params32, cfg32,
                              [prompts[i] for i in greedy],
                              [run["out"][i] for i in greedy], INT8_TOL,
                              INT8_MEAN_TOL)
            checked = (f"promoted greedy requests {greedy} within "
                       f"atol {INT8_TOL['atol']} of the f32 reference")
        cold = [s for s in range(N_SYSTEM)]
        hbm = [s + 4 for s in range(N_SYSTEM)] + \
            [s + 12 for s in range(N_SYSTEM)]
        metrics = {
            "cell": "gpt2-serve-tiers", "arm": arm,
            "spills": spills, "spill_bytes": st["spill_bytes"],
            "promoted_dram": st["hits"]["dram"],
            "promoted_store": st["hits"]["store"],
            "hbm_hits": st["hits"]["hbm"],
            "fetch_ms_per_page": 1e3 * st["fetch_seconds"] / st["fetches"],
            "mean_ttft_ms_cold": 1e3 * float(np.mean(
                [run["ttft"][i] for i in cold])),
            "mean_ttft_ms_hbm_hit": 1e3 * float(np.mean(
                [run["ttft"][i] for i in hbm])),
            "mean_ttft_ms_promoted": 1e3 * float(np.mean(
                [run["ttft"][i] for i in promoted_reqs])),
            "mean_ttft_ms_promoted_resident_engine": 1e3 * float(np.mean(
                [ref["ttft"][i] for i in promoted_reqs])),
            "store": {k: engine.store.stats()[k]
                      for k in ("puts", "gets", "evictions")},
        }
        print(f"{what}: {checked}; {promoted} pages promoted "
              f"({st['hits']['dram']} host, {st['hits']['store']} store), "
              f"{spills} spills of {per_page} bytes; launches "
              f"{launches_line(run['launches'])} == implied; leak-free",
              flush=True)
        print("tiers metrics " + json.dumps(metrics), flush=True)
        del resident, engine
        gc.collect()
        torch.cuda.empty_cache()
    return path


# the chaos legs of the tier cell run the model in f32: a fault turns a
# promoted (cached) prefill into a cold one, and in bf16 the two round
# differently (plain attention against the flash kernel), which moves a
# greedy token at a bf16 tie; in f32 a stream must not move
CHAOS_NEW = 16


def serving_obs_phase(params, cfg, dev) -> None:
    """Deadlines, chaos, telemetry and the watchdog on the card, on warm
    kernels, with every budget well above a warm step."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.inference import DeadlineExceededError
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.resilience import EngineWatchdog
    from ray_tpu_torch.util import chaos

    rng = np.random.default_rng(11)
    engine = InferenceEngine(cfg, params, device=dev, slots=1,
                             page_size=128)
    engine.generate([rng.integers(0, 50257, 100).tolist()],
                    max_new_tokens=8)                      # warm-up
    t0 = time.monotonic()
    engine.generate([rng.integers(0, 50257, 100).tolist()],
                    max_new_tokens=9)
    step_s = (time.monotonic() - t0) / 9
    ttft_budget, total_budget = max(0.25, 10 * step_s), max(0.5, 20 * step_s)
    # a queued request's TTFT budget runs out behind a long one
    r1 = engine.submit(rng.integers(0, 50257, 200).tolist(),
                       max_new_tokens=int(3 * ttft_budget / step_s) + 8)
    r2 = engine.submit(rng.integers(0, 50257, 100).tolist(),
                       max_new_tokens=4, ttft_deadline_s=ttft_budget)
    errs, toks = {}, {}
    wd = EngineWatchdog(engine, timeout_s=total_budget)
    with wd:
        while engine.has_work():
            for ev in engine.step():
                if ev.error is not None:
                    errs[ev[0]] = ev.error
                else:
                    toks[ev[0]] = toks.get(ev[0], 0) + 1
    if set(errs) != {r2} or errs[r2].kind != "ttft" or r2 in toks or \
            not isinstance(errs[r2], DeadlineExceededError):
        raise AssertionError(f"ttft deadline: errors {errs}, tokens {toks}")
    # a total budget retires a request mid-decode
    r3 = engine.submit(rng.integers(0, 50257, 100).tolist(),
                       max_new_tokens=int(3 * total_budget / step_s) + 8,
                       deadline_s=total_budget)
    n3, err3 = 0, None
    while engine.has_work():
        for ev in engine.step():
            if ev.error is not None:
                err3 = ev.error
            else:
                n3 += 1
    if not isinstance(err3, DeadlineExceededError) or err3.kind != "total" \
            or err3.rid != r3 or not 1 <= n3:
        raise AssertionError(f"total deadline: {err3!r} after {n3} tokens")
    if not engine.leak_free() or engine.deadline_exceeded != 2 or \
            wd.wedges:
        raise AssertionError("deadlines: not leak-free, or miscounted, or "
                             "the watchdog fired on a live engine")
    print(f"deadlines: a queued request's {ttft_budget:.3f} s TTFT budget "
          f"expired, a {total_budget:.3f} s total budget retired a request "
          f"after {n3} tokens (warm step {1e3 * step_s:.2f} ms); "
          "leak-free; the watchdog saw no wedge", flush=True)
    # infer.decode fires before the decode step launches anything
    engine = InferenceEngine(cfg, params, device=dev, slots=2,
                             page_size=128)
    for n in (300, 40):
        engine.submit(rng.integers(0, 50257, n).tolist(), max_new_tokens=16)
    engine.step()
    engine.step()
    torch.cuda.synchronize()
    before = [engine.cache.k.clone(), engine.cache.v.clone(),
              engine.scheduler.lengths.copy()]
    plan = chaos.install_faults("infer.decode@1")
    _build.reset_launches()
    try:
        engine.step()
        raise AssertionError("infer.decode@1 did not fire")
    except chaos.InjectedFault:
        pass
    finally:
        chaos.clear_faults()
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.launch_counts().items() if v}
    if launched or plan.fired != [("infer.decode", 1)] or \
            not torch.equal(engine.cache.k, before[0]) or \
            not torch.equal(engine.cache.v, before[1]) or \
            (engine.scheduler.lengths != before[2]).any():
        raise AssertionError(f"infer.decode: launched {launched} or changed "
                             "the cache before raising")
    if engine.drain_requests() != 2 or not engine.leak_free():
        raise AssertionError("infer.decode: the engine did not drain clean")
    print("chaos infer.decode@1: raised before any launch, cache "
          "bit-identical, drained leak-free", flush=True)
    del engine, before
    # the tier legs' faults, in f32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: (v.float() if isinstance(v, torch.Tensor) else
                    {kk: vv.float() for kk, vv in v.items()})
                for k, v in params.items()}
    _warm, prompts = prefix_traffic()
    system = prompts[0][:SYSTEM_LEN]
    a = system + rng.integers(0, 50257, 40).tolist()
    revisit = system + rng.integers(0, 50257, 40).tolist()
    pressure = rng.integers(0, 50257, 600).tolist()
    cold = InferenceEngine(cfg32, params32, device=dev, slots=1,
                           page_size=128).generate(
        [revisit], max_new_tokens=CHAOS_NEW)[0]
    legs = {}
    for spec in (None, "kv.spill@1", "kv.spill@4", "kv.fetch@1"):
        eng = InferenceEngine(cfg32, params32, device=dev, slots=1,
                              page_size=128, num_pages=6, host_pages=2,
                              store=True, spill_dtype="model")
        eng.generate([a], max_new_tokens=8)
        plan = chaos.install_faults(spec) if spec else None
        try:
            eng.generate([pressure], max_new_tokens=8)
            out = eng.generate([revisit], max_new_tokens=CHAOS_NEW)[0]
        finally:
            chaos.clear_faults()
        st = eng.stats()["tiers"]
        faults = (st["spill_faults"] + st["host"]["dropped"]
                  + st["fetch_faults"])
        if out != cold or not eng.leak_free() or eng.store.in_flight or \
                (spec and (not plan.fired or not faults)) or \
                (not spec and st["fetches"] != 4):
            raise AssertionError(f"chaos {spec}: stream {out} vs cold "
                                 f"{cold}, tiers {st}")
        legs[spec or "none"] = {"promoted": st["fetches"],
                                "faults": faults}
    print(f"chaos tier legs (f32): {json.dumps(legs)}; every revisit's "
          "greedy stream equals the cold run's; leak-free", flush=True)


# the training cell "gpt2-train-b24": the JAX package's single-chip
# recipe (bench.py:1932-1935) at full width and depth, bf16, batch 24 x
# 1024, random weights from a seed, on one repeated synthetic batch
TRAIN_CFG = dict(vocab_size=50304, max_seq=1024, remat=False,
                 unroll_layers=True, ce_chunk=-1)
TRAIN_OPT = dict(lr=1e-3, warmup=2, total_steps=100)
WARMUP_STEPS, TIMED_STEPS = 2, 8
# the run with the RMSNorm kernels: 2 warm-up and 4 timed steps
NORM_TIMED_STEPS = 4
# launches of one training step: per layer one attention forward and
# backward and one epilogue forward and backward; one flash-CE pass each
TRAIN_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
                  "matmul_residual_norm_fwd": 12,
                  "matmul_residual_norm_bwd": 12,
                  "flash_ce_fwd": 1, "flash_ce_bwd": 1}
# with gpt._PALLAS_NORM, one RMSNorm forward and backward per layer
# besides: ln1 (ln2 is the epilogue's, ln_f the flash-CE prologue's)
NORM_LAUNCHES = {"rmsnorm_fwd": 12, "rmsnorm_bwd": 12}


def train_phase(dev, *, norm_kernel: bool = False,
                timed_steps: int = TIMED_STEPS) -> dict:
    """GPT-2 124M trains WARMUP_STEPS + ``timed_steps`` steps in bf16 at
    24 x 1024; prints the step metrics and returns them with the launch
    counts of the timed steps, which must be exactly TRAIN_LAUNCHES per
    step (and NORM_LAUNCHES with ``norm_kernel``, the RMSNorm kernels
    through ``gpt._PALLAS_NORM``)."""
    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.telemetry import flops

    # what earlier phases left in reference cycles (the serving engines:
    # no_gather_in_decode's closure) is collected first, so the peak
    # reads this phase's memory alone
    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), TRAIN_B,
                               TRAIN_S, cfg.vocab_size, device=dev)
    losses, norms = [], []
    torch.cuda.reset_peak_memory_stats()
    gpt._PALLAS_NORM = norm_kernel
    try:
        for _ in range(WARMUP_STEPS):
            state, m = fns["step_fn"](state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.monotonic()
        timed = []
        for _ in range(timed_steps):
            state, m = fns["step_fn"](state, batch)
            timed.append(m)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        gpt._PALLAS_NORM = False
    launches = _build.launch_counts()
    losses += [float(m["loss"]) for m in timed]
    norms += [float(m["grad_norm"]) for m in timed]
    per_step = dict(TRAIN_LAUNCHES, **(NORM_LAUNCHES if norm_kernel else {}))
    expect_launches(f"training ({timed_steps} steps)", launches,
                    {k: n * timed_steps for k, n in per_step.items()})
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {losses[0]:.4f} is not near "
                             f"ln V = {math.log(cfg.vocab_size):.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    step_ms = 1e3 * wall / timed_steps
    tok_s = TRAIN_B * TRAIN_S * timed_steps / wall
    fpt = flops.gpt_train_flops_per_token(cfg, TRAIN_S, ce_recompute=True)
    metrics = {
        "cell": "gpt2-train-b24", "norm_kernel": norm_kernel,
        "batch": [TRAIN_B, TRAIN_S],
        "step_ms": step_ms, "tokens_per_s": tok_s,
        "mfu": flops.mfu(tok_s, fpt),
        "train_flops_per_token": fpt,
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30,
        "losses": losses, "grad_norms": norms,
    }
    label = "training phase" + (" norm kernel" if norm_kernel else "")
    print(f"{label}: {WARMUP_STEPS + timed_steps} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches per step "
          f"{per_step} exact", flush=True)
    print(f"{label} metrics " + json.dumps(metrics), flush=True)
    return dict(metrics, launches=launches)


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
# The width checks (``width_checks``: gpt2_medium, gpt2_large and tiny at
# 2 layers, two seeds) hold the f32 step and every gradient to the bounds
# above.  Their bf16 loss is held to TRAIN_BF16_TOL's 2e-4 over and above
# the distance from the f32 plain path of the same configuration's plain
# path in bf16, which runs no kernel, measured beside it: at 2 layers the
# bf16 rounding of weights and activations alone moves the loss by more
# than 2e-4.  Over these 6 configurations and gpt2's at seed 7 (PERF.md
# section 2) the plain path in bf16 read up to 3.5e-4 from f32, the plain
# path in f32 on the bf16-rounded weights up to 3.0e-4, the kernel path
# with attention in f32 (rounded once) up to 3.9e-4; the kernel path
# itself up to 2.2e-4.  Each run prints those readings ("bf16
# readings").  gpt2 keeps the plain 2e-4.
def step_launches(cfg, *, norm_kernel: bool, ce_mode) -> dict:
    """The launches of one loss-and-gradient step of ``cfg`` on the
    kernel path, from the gates' verdicts at its width: per layer the
    attention pair and, where d is lane-aligned, the epilogue pair; one
    flash-CE pair where it takes the loss; with ``norm_kernel`` one
    RMSNorm pair for each norm neither fuses (ln1; ln2 where the epilogue
    declines; ln_f where flash-CE does)."""
    L, d = cfg.n_layers, cfg.d_model
    epi = d % 128 == 0                   # fused_norm.supports, K = d
    ce = d % 128 == 0 and ce_mode is None
    n = {"flash_attention_fwd": L, "flash_attention_bwd": L}
    if epi:
        n.update(matmul_residual_norm_fwd=L, matmul_residual_norm_bwd=L)
    if ce:
        n.update(flash_ce_fwd=1, flash_ce_bwd=1)
    if norm_kernel:
        norms = L + (0 if epi else L) + (0 if ce else 1)
        n.update(rmsnorm_fwd=norms, rmsnorm_bwd=norms)
    return n


def train_correctness_phase(dev, *, n_layers: int = 12,
                            norm_kernel: bool = False,
                            preset: str = "gpt2", seed: int = 2) -> None:
    """The step parity above at ``n_layers``; with ``norm_kernel`` the
    kernel path's RMSNorms go through the RMSNorm kernels while the plain
    path keeps its plain norms.  ``preset`` names the ``GPTConfig``
    preset: ``gpt2_medium`` and ``gpt2_large`` (d = 1024, 1280) and
    ``tiny`` (d = 64, head_dim 16; at its own vocab and 128 positions)
    run the kernels built for their widths.  Each kernel run launches
    exactly ``step_launches``.  The f32 flash-CE kernels are built for
    d = 768 only, so a wider f32 model asks for the dense CE itself
    (``ce_mode="xla"``; its gate would raise, ROADMAP Queue 2 item A)."""
    from ray_tpu_torch import GPTConfig, init_params
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.training import (synthetic_lm_batch,
                                               value_and_grad)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_ce as FC
    from ray_tpu_torch.ops.attention import make_flash_attention_fn
    from ray_tpu_torch.parallel.ring_attention import local_attention

    kw = dict(TRAIN_CFG, dtype=torch.float32)
    if preset == "tiny":
        kw.update(vocab_size=512, max_seq=128)
    cfg32 = dataclasses.replace(getattr(GPTConfig, preset)(**kw),
                                n_layers=n_layers)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    params = init_params(cfg32, torch.Generator().manual_seed(seed),
                         device=dev)
    batch = synthetic_lm_batch(torch.Generator().manual_seed(seed + 1), 2,
                               cfg32.max_seq, cfg32.vocab_size, device=dev)
    attn = make_flash_attention_fn(rope_theta=cfg32.rope_theta)

    def ce_mode(cfg):
        d = cfg.d_model
        built = FC._KERNEL_WIDTHS[cfg.dtype]
        return "xla" if d % 128 == 0 and d not in built else None

    def plain_loss(cfg):
        return lambda p, b: gpt.loss_fn(p, b, cfg, fuse_norm=False,
                                        ce_mode="xla")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v

    def to(tree, dtype):
        return {k: to(v, dtype) if isinstance(v, dict) else v.to(dtype)
                for k, v in tree.items()}

    ref_loss, ref_grads = value_and_grad(plain_loss(cfg32), params, batch)
    ref = dict(leaves(ref_grads))
    runs = (("f32", cfg32, params, TRAIN_F32_TOL),
            ("bf16", cfg16, to(params, torch.bfloat16), TRAIN_BF16_TOL))
    for label, cfg, p, tol in runs:
        ce = ce_mode(cfg)
        want_n = step_launches(cfg, norm_kernel=norm_kernel, ce_mode=ce)
        gpt._PALLAS_NORM = norm_kernel
        try:
            _build.reset_launches()
            loss, grads = value_and_grad(
                lambda p_, b_: gpt.loss_fn(p_, b_, cfg, attn_fn=attn,
                                           ce_mode=ce), p, batch)
            torch.cuda.synchronize()
            launches = _build.launch_counts()
            if label == "bf16" and n_layers == 2:
                with torch.no_grad():
                    # the kernel path with the plain attention in bf16,
                    # and with attention in f32 rounded once, in place
                    # of the attention kernels
                    no_attn = float(gpt.loss_fn(p, batch, cfg, ce_mode=ce))
                    f32_attn = float(gpt.loss_fn(
                        p, batch, cfg, ce_mode=ce,
                        attn_fn=lambda q, k, v: local_attention(
                            q.float(), k.float(), v.float(),
                            causal=True).to(q.dtype)))
        finally:
            gpt._PALLAS_NORM = False
        if norm_kernel:
            label = f"{label} norm kernel, {n_layers} layers"
        if preset != "gpt2":
            label = f"{label}, {preset}"
        expect_launches(f"train correctness {label}", launches, want_n)
        dl = abs(float(loss) - float(ref_loss))
        lim = (tol["loss_rel"] * abs(float(ref_loss)) if "loss_rel" in tol
               else tol["loss_abs"])
        if "loss_abs" in tol and n_layers == 2:
            with torch.no_grad():
                plain16 = float(plain_loss(cfg)(p, batch))
                plain32w = float(plain_loss(cfg32)(to(p, torch.float32),
                                                   batch))
            ref_f = float(ref_loss)
            if preset != "gpt2":
                lim += abs(plain16 - ref_f)   # see the width checks above
            print(f"  bf16 readings {preset}, loss minus the f32 plain "
                  f"path's: kernel path {float(loss) - ref_f:+.3e}, with "
                  f"plain attention {no_attn - ref_f:+.3e}, with f32 "
                  f"attention {f32_attn - ref_f:+.3e}, plain path in "
                  f"bf16 {plain16 - ref_f:+.3e}, plain path in f32 on the "
                  f"bf16 weights {plain32w - ref_f:+.3e}", flush=True)
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
              f"each leaf's largest value); launches {launches_line(launches)}"
              + ("" if ce is None else "; f32 dense CE (ce_mode='xla')"),
              flush=True)
        if not dl <= lim or not worst_share <= 1:
            raise AssertionError(f"training step {label}: kernel path "
                                 "disagrees with the plain path")
        del grads
        torch.cuda.empty_cache()


def launches_line(launches: dict) -> str:
    return json.dumps({k: n for k, n in launches.items() if n})


def width_checks(dev) -> None:
    """The kernels at the widths of the other configurations the repo
    supports (``width_kernel_checks``), then a 2-layer ``gpt2_medium``,
    ``gpt2_large`` and ``GPTConfig.tiny()`` on the card at two seeds,
    every gate reached with the RMSNorm kernels on: one step's loss and
    gradients against the plain path at the step-parity tolerances (the
    bf16 loss as the note above the width checks sets out), each kernel the
    width is built for launched exactly as ``step_launches`` says, no
    tensor of the card sent to a plain version in a kernel's place.
    tiny's d = 64 is declined by the epilogue and flash-CE gates as by the
    JAX package's (not lane-aligned): its ln2 and ln_f take the RMSNorm
    kernels instead."""
    width_kernel_checks(dev)
    for seed in (2, 7):
        for preset in ("gpt2_medium", "gpt2_large", "tiny"):
            train_correctness_phase(dev, n_layers=2, norm_kernel=True,
                                    preset=preset, seed=seed)
    # gpt2's 2-layer step at the second seed (the main run holds seed 2)
    train_correctness_phase(dev, n_layers=2, norm_kernel=True, seed=7)


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
            args = re.sub(r"^f", "f32,", m.group(2))
            args = re.sub(r"Li(\d+)E?", r"\1,", args)
            args = re.sub(r"Lb([01])E?", lambda b: ("false", "true")[
                int(b.group(1))] + ",", args)
            args = args.replace("13__nv_bfloat16", "bf16,")
            fn = f"{m.group(1)}<{args.strip(',')}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and fn:
            print(f"  {fn}: {line.split(':', 1)[1].strip()}; {spill}",
                  flush=True)
            fn = ""
    return name


def report(what, prof, wall, steps, top=8, groups=None):
    """The busiest device-side events of a profile (kernels, copies; an
    operator's device time is its kernels', which would count twice) and
    the device's busy share of the wall time.  ``groups`` (label: name
    substrings) adds each group's device time per step, its kernels
    listed, and the rest's."""
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0
           and not e.key.startswith("spec/")]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    print(f"profile {what}: wall {1e3 * wall / steps:.3f} ms/step, "
          f"device busy {busy / steps:.3f} ms/step "
          f"({100 * busy / (1e3 * wall):.1f}% of wall)", flush=True)
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step"
              f"  {e.count // steps:4d} calls/step  {e.key[:90]}",
              flush=True)
    rest = busy
    for label, keys in (groups or {}).items():
        members = [e for e in evs if any(k in e.key for k in keys)]
        ms = sum(e.self_device_time_total for e in members) / 1e3
        rest -= ms
        calls = sum(e.count for e in members) // steps
        print(f"  group {label}: {ms / steps:.4f} ms/step in {calls} "
              "calls/step", flush=True)
        for e in members:
            print(f"    {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
                  f"{e.count // steps:4d} calls/step  {e.key[:80]}",
                  flush=True)
    if groups:
        print(f"  group rest: {rest / steps:.4f} ms/step", flush=True)


# the decode step's device time split for the decode kernel's PRs: the
# attention kernels, and the index kernels (the context gather of the
# padded layout, write_decode's scatter, the embedding's lookup)
DECODE_GROUPS = {"decode attention": ("decode_",),
                 "index kernels": ("index", "gather", "scatter")}


def profile_phase(params, cfg, dev, *, kv_dtype: str = "model") -> None:
    """Where a prefill tick and a decode step spend their time: the
    busiest kernels by device time (torch.profiler), the device's busy
    share of the wall time, and the decode step split into its layer
    stack and its sampling (host clock around synchronised calls).  The
    tick admits 8 prompts of 512 tokens; on the int8 cache they share a
    512-token system prompt and add 64 tokens each, so one prefills cold
    and 7 prefill their suffix over the cached prefix."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                             **ENGINE)
    engine.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
    rng = np.random.default_rng(2)
    system = rng.integers(0, 50257, SYSTEM_LEN).tolist()
    for _ in range(8):
        engine.submit(system + rng.integers(0, 50257, 64).tolist()
                      if kv_dtype == "int8"
                      else rng.integers(0, 50257, 512).tolist(),
                      max_new_tokens=24)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        engine.step()              # 8 prefills + 1 decode
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report(f"admission tick ({kv_dtype} cache: 8 prefills + 1 decode)",
           prof, wall, 1)
    for _ in range(2):
        engine.step()
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(8):
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report("decode step (8 slots)", prof, wall, 8, top=12,
           groups=DECODE_GROUPS)
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


# the verify forward's device time split: ranges around the engine's
# methods (record_function, named "spec/..."; not kernels) and the
# epilogue kernels by name
SPEC_RANGES = {"_verify_step": "spec/verify forward",
               "_cached_layers": "spec/verify layers",
               "_cached_prefill_attention": "spec/verify attention",
               "_sample": "spec/sampling"}
VERIFY_GROUPS = {"epilogue": ("mrn_",),
                 "GEMMs": ("gemm", "xmma", "cutlass", "nvjet"),
                 "index kernels": ("index", "gather", "scatter")}


def _range_methods(engine) -> None:
    """Wrap ``engine``'s methods named in ``SPEC_RANGES`` in a profiler
    range each (on the instance; the class is untouched)."""
    for name, label in SPEC_RANGES.items():
        def ranged(*args, _fn=getattr(engine, name), _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kw)
        setattr(engine, name, ranged)


def spec_profile_phase(params, cfg, dev, *, kv_dtype: str = "model"
                       ) -> None:
    """One co-batched decode step and one verify forward of the serving
    geometry (8 slots, page 128; 8 templated requests, spec_k = 4 for
    half of them) under torch.profiler, at a tick where both run: the
    busy share of wall time of each, the decode step split as
    ``--profile`` splits it, and the verify's device time split into the
    epilogue kernels, the verify attention (suffix write, gather,
    dequantize, einsums), the lm-head GEMM (the forward's range minus
    its layer stack's), sampling and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                             **ENGINE)
    engine.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
    for i, p in enumerate(spec_serving_prompts(cfg.vocab_size)):
        engine.submit(p, max_new_tokens=64,
                      sampling=spec_sampling(None, 4 if i % 2 else 0))
    for _ in range(64):
        plan = engine._plan_speculation()
        if plan and len(plan) < len(engine.scheduler.active) and \
                engine.ticks > 4:
            break
        engine.step()
    else:
        raise AssertionError("no tick had both a verify and a decode")
    _range_methods(engine)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    events = []
    torch.cuda.synchronize()
    with torch.inference_mode():
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            engine._decode(events, skip=set(plan))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        report(f"spec co-batched decode step ({kv_dtype} cache, "
               f"{len(engine.scheduler.active) - len(plan)} live rows, "
               f"{len(plan)} dead)", prof, wall, 1, top=6,
               groups=DECODE_GROUPS)
        (slot, drafts), *rest = plan.items()
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            engine._verify(slot, drafts, events)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        n = engine._verify_bucket(len(drafts)) + 1
        report(f"spec verify forward ({kv_dtype} cache, {len(drafts)} "
               f"drafts, N = {n} rows)", prof, wall, 1, top=8,
               groups=VERIFY_GROUPS)
        for s, d in rest:                      # the rest of the tick
            engine._verify(s, d, events)
    ranges = {label: 0.0 for label in SPEC_RANGES.values()}
    for e in prof.events():
        if e.key in ranges and e.device_type == torch.autograd.DeviceType.CPU:
            ranges[e.key] += e.device_time_total / 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("spec/")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    epilogue = sum(e.self_device_time_total for e in kernels
                   if "mrn_" in e.key) / 1e3
    attention = ranges["spec/verify attention"]
    lm_head = ranges["spec/verify forward"] - ranges["spec/verify layers"]
    sampling = ranges["spec/sampling"]
    if not all(ranges.values()):
        print(f"profile spec verify split: not measured (a range read no "
              f"device time: {ranges})", flush=True)
        return
    print(f"profile spec verify split ({kv_dtype}): device busy "
          f"{busy:.4f} ms; epilogue {epilogue:.4f}, verify attention "
          f"{attention:.4f}, lm-head GEMM {lm_head:.4f}, sampling "
          f"{sampling:.4f}, rest "
          f"{busy - epilogue - attention - lm_head - sampling:.4f} ms",
          flush=True)


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


def epilogue_profile_phase(dev) -> None:
    """The out-proj epilogue's two entry points at the training shape (N =
    24576, K = d = 768, bf16): the CUDA kernels each launches, by device
    time per call (torch.profiler over 10 calls)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import fused_norm as FN

    g = torch.Generator(device=dev).manual_seed(1)
    randn = _randn(g, dev)
    N, d = TRAIN_N, 768
    a, resid = randn(N, d), randn(N, d)
    w = randn(d, d, s=d ** -0.5)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16)
    rout, _y, rstd = FN.matmul_residual_norm_fwd(a, w, resid, sc)
    ins = (a, w, rout, sc, rstd, randn(N, d), randn(N, d))
    for what, fn in (
            ("matmul_residual_norm_fwd",
             lambda: FN.matmul_residual_norm_fwd(a, w, resid, sc)),
            ("matmul_residual_norm_bwd",
             lambda: FN.matmul_residual_norm_bwd(*ins))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        report(f"{what} [{N}, {d}, {d}] (per call)", prof, wall, 10)


def ce_profile_phase(dev) -> None:
    """The flash-CE entry points at the training shape (N = 24576, d =
    768, V = 50304, bf16, the norm prologue, one target in seven masked):
    the CUDA kernels each launches, by device time per call
    (torch.profiler over 3 calls)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import flash_ce as FC

    g = torch.Generator(device=dev).manual_seed(1)
    randn = _randn(g, dev)
    N, d, V, eps = TRAIN_N, 768, TRAIN_V, 1e-6
    x, w = randn(N, d), randn(V, d, s=0.02)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16)
    tgt = torch.randint(0, V, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    tgt[::7] = -1
    srow = (tgt >= 0).float()
    lse, _true, rstd = FC.flash_ce_fwd(x, w, tgt, (sc, eps))
    for what, fn in (
            ("flash_ce_fwd", lambda: FC.flash_ce_fwd(x, w, tgt, (sc, eps))),
            ("flash_ce_bwd", lambda: FC.flash_ce_bwd(
                x, w, tgt, lse, srow, (sc, eps, rstd)))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        report(f"{what} [{N}, {d}, {V}] (per call)", prof, wall, 3)


def main() -> None:
    name = start_up()
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--profile", "train"]:
        train_profile_phase(dev)
        return
    if sys.argv[1:] == ["--profile", "epilogue"]:
        epilogue_profile_phase(dev)
        return
    if sys.argv[1:] == ["--profile", "ce"]:
        ce_profile_phase(dev)
        return
    if sys.argv[1:] == ["--decode"]:
        rec = Recorder(name)
        decode_checks(dev, B=8, S=1024, H=12, D=64, lengths=DECODE_LENGTHS)
        decode_checks(dev, B=4, S=300, H=4, D=16, lengths=(1, 300, 64, 129))
        decode_timings(rec, dev, B=8, S=1024, H=12, D=64)
        print(json.dumps({"kernels": list(rec.rows.values())}))
        return
    if sys.argv[1:] == ["--edges"]:
        wgmma_tile_checks(dev)
        decode_checks(dev, B=8, S=1024, H=12, D=64, lengths=DECODE_LENGTHS)
        ragged_attention_checks(dev)
        ragged_epilogue_checks(dev)
        ragged_flash_ce_checks(dev)
        ragged_attention_checks(dev, H=16)
        width_checks(dev)
        print("edges: every check passed", flush=True)
        return
    if sys.argv[1:] in (["--spec"], ["--profile", "spec"]):
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
        if sys.argv[1] == "--spec":
            spec_phase(params, cfg, dev, arms=SPEC_ARMS_FULL)
            print("spec: every check passed", flush=True)
        else:
            for kv_dtype in ("model", "int8"):
                spec_profile_phase(params, cfg, dev, kv_dtype=kv_dtype)
        return
    if sys.argv[1:] == ["--serve"]:
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
        paths = {"serve_disagg": disagg_phase(params, cfg, dev),
                 "serve_tiers": tiers_phase(params, cfg, dev)}
        serving_obs_phase(params, cfg, dev)
        print("serve: every check passed; launches "
              + json.dumps({p: {k: v for k, v in n.items() if v}
                            for p, n in paths.items()}), flush=True)
        return
    if sys.argv[1:] in (["--profile"], ["--profile", "int8"]):
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        profile_phase(init_params(cfg, torch.Generator().manual_seed(0),
                                  device=dev), cfg, dev,
                      kv_dtype="int8" if "int8" in sys.argv else "model")
        return
    if sys.argv[1:]:
        raise SystemExit(f"unknown arguments {sys.argv[1:]}")
    rec = Recorder(name)
    wgmma_tile_checks(dev)
    kernel_phase(rec, dev)
    ragged_attention_checks(dev)
    ragged_epilogue_checks(dev)
    ragged_flash_ce_checks(dev)
    train_kernel_phase(rec, dev)
    from ray_tpu_torch import GPTConfig, init_params
    cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    # launches: each path driven with the counts at 0 just before it
    paths = {"serve": engine_phase(params, cfg, dev)}
    correctness_phase(params, cfg, dev)
    paths["serve_int8_prefix"] = int8_prefix_phase(params, cfg, dev)
    int8_correctness_phase(params, cfg, dev)
    paths["serve_norm"] = correctness_phase(params, cfg, dev,
                                            norm_kernel=True)
    paths["serve_spec"] = spec_phase(params, cfg, dev)
    paths["serve_disagg"] = disagg_phase(params, cfg, dev)
    paths["serve_tiers"] = tiers_phase(params, cfg, dev)
    serving_obs_phase(params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    train = train_phase(dev)
    paths["train"] = train.pop("launches")
    train_norm = train_phase(dev, norm_kernel=True,
                             timed_steps=NORM_TIMED_STEPS)
    paths["train_norm"] = train_norm.pop("launches")
    print(f"training ms/step: {train['step_ms']:.2f} default, "
          f"{train_norm['step_ms']:.2f} with the RMSNorm kernels", flush=True)
    train_correctness_phase(dev)
    train_correctness_phase(dev, n_layers=2, norm_kernel=True)
    width_checks(dev)
    for row in rec.rows.values():
        by_path = {p: n[row["name"]] for p, n in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never launched on a path")
    if set(rec.rows) != set(paths["serve"]):
        raise AssertionError(f"kernels checked {sorted(rec.rows)} != "
                             f"entry points {sorted(paths['serve'])}")
    print(json.dumps({"kernels": list(rec.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
