#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # the checks below
    python3 chip_smoke.py --profile    # where the serving time goes

1. Start-up: prints the card (``nvidia-smi`` name and power limit), the
   torch and CUDA versions, and builds the kernels from
   ``ray_tpu_torch/ops/csrc`` with ``nvcc`` (timed).
2. Kernel phase: every kernel of the serving path against its plain
   PyTorch version (computed in f32 on the same bf16 inputs) at the
   main path's shapes, with its time, the plain version's, one PyTorch
   library call's as a yardstick, and the least time the card could
   take (``bound_ms``).
3. Engine phase: GPT-2 124M (random weights from a seed, bf16) serves
   16 requests through the paged-KV engine; every request must finish,
   the engine must be leak-free, and each kernel's launch count must be
   what the run implies.
4. Correctness: two greedy requests' logits against the port's
   teacher-forced ``forward`` on the CPU in f32 over the same weights.

Any failure raises and the script exits non-zero.  The line before the
last is ``{"kernels": [...]}``; the last is ``{"ok": true, "device":
...}``.  Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
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
    share = (err / tol).max().item()
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


def kernel_phase(name: str, dev) -> list:
    """Each kernel against its plain version at the main path's shapes:
    the bf16 instantiation (timed) and, on the same inputs, the f32 one
    held to the summation-order bound."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import fused_norm as FN

    bw, peak = peaks(name)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(bf)

    def f32(*xs):
        return [x.float() for x in xs]

    rows = {}

    def record(kernel, shape, err, ms, plain_ms, lib_ms, nbytes, flops,
               source, replaces):
        b_ms, b_by = bound(nbytes, flops, bw, peak)
        print(f"kernel {kernel} {shape}: max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
              flush=True)
        row = rows.setdefault(kernel, {
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        # the line reports the largest main-path shape (measured last)
        row.update(shape=shape, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    print(f"tolerances: bf16 {BF16_TOL}, lse {LSE_TOL}, rstd {RSTD_TOL}, "
          f"f32 {F32_TOL}, f32 matmul {F32_MATMUL_TOL}", flush=True)

    # prefill attention at [1, S, 12, 64]
    H, D = 12, 64
    scale = D ** -0.5
    for S in (32, 128, 1024):
        q, k, v = (randn(1, S, H, D) for _ in range(3))
        o, lse = A.flash_attention_fwd(q, k, v, scale=scale)
        o_ref, lse_ref = A.plain_flash_attention_fwd(*f32(q, k, v),
                                                     scale=scale)
        o32, lse32 = A.flash_attention_fwd(*f32(q, k, v), scale=scale)
        torch.cuda.synchronize()
        what = f"flash_attention_fwd S={S}"
        err = max(check(f"{what} o", o, o_ref, **BF16_TOL),
                  check(f"{what} lse", lse, lse_ref, **LSE_TOL))
        check(f"{what} f32 o", o32, o_ref, **F32_TOL)
        check(f"{what} f32 lse", lse32, lse_ref, **F32_TOL)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        record("flash_attention_fwd", [1, S, H, D], err,
               time_ms(lambda: A.flash_attention_fwd(q, k, v, scale=scale)),
               time_ms(lambda: A.plain_flash_attention_fwd(q, k, v,
                                                           scale=scale)),
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
    o_ref = A.plain_decode_attention(*f32(q, k, v), lengths, scale=scale)
    o32 = A.decode_attention(*f32(q, k, v), lengths)
    torch.cuda.synchronize()
    err = check("decode_attention", o, o_ref, **BF16_TOL)
    check("decode_attention f32", o32, o_ref, **F32_TOL)
    mask = ~dead[:, :, 0, 0][:, None, None, :]          # [B, 1, 1, S]
    qs = q[:, :, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    valid = int(lengths.sum())
    record("decode_attention", [B, S, H, D], err,
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
    K = d = 768
    eps = 1e-6
    for N in (32, 1024):
        a = randn(N, K)
        w = randn(K, d, s=K ** -0.5)
        resid = randn(N, d)
        sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
        got = FN.matmul_residual_norm_fwd(a, w, resid, sc, eps=eps)
        want = FN.plain_matmul_residual_norm(*f32(a, w, resid, sc),
                                             eps=eps)
        got32 = FN.matmul_residual_norm_fwd(*f32(a, w, resid, sc), eps=eps)
        torch.cuda.synchronize()
        what = f"matmul_residual_norm N={N}"
        err = max(check(f"{what} r", got[0], want[0], **BF16_TOL),
                  check(f"{what} y", got[1], want[1], **BF16_TOL),
                  check(f"{what} rstd", got[2], want[2], **RSTD_TOL))
        for part, x, y in zip("r y rstd".split(), got32, want):
            check(f"{what} f32 {part}", x, y, **F32_MATMUL_TOL)
        record("matmul_residual_norm_fwd", [N, K, d], err,
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
    return list(rows.values())


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
            "decode_attention": L * decodes}
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

    def report(what, prof, wall, steps):
        # device-side events only (kernels, copies): an operator's
        # device time is its kernels', which would count twice
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in evs) / 1e3
        print(f"profile {what}: wall {1e3 * wall / steps:.3f} ms/step, "
              f"device busy {busy / steps:.3f} ms/step "
              f"({100 * busy / (1e3 * wall):.1f}% of wall)", flush=True)
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step"
                  f"  {e.count // steps:4d} calls/step  {e.key[:90]}",
                  flush=True)

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


def main() -> None:
    name = start_up()
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--profile"]:
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        profile_phase(init_params(cfg, torch.Generator().manual_seed(0),
                                  device=dev), cfg, dev)
        return
    kernels = kernel_phase(name, dev)
    from ray_tpu_torch import GPTConfig, init_params
    cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    launches = engine_phase(params, cfg, dev)
    correctness_phase(params, cfg, dev)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
