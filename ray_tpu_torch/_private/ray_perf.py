"""Microbenchmark driver: the port's copy of ``ray_tpu/_private/ray_perf.py``.

Parity: reference ``python/ray/_private/ray_perf.py`` — same metric names
so numbers are comparable line-for-line (`ray microbenchmark`), and the
same names, signatures and printed result names as the JAX package's
copy, so a port number sits beside the reference's.

``attention_perf`` (``python -m ray_tpu_torch._private.ray_perf --attn``)
is the kernel-level entry: isolated flash-attention fwd+bwd throughput
through the port's Hopper kernels (``ops/csrc/flash_attention_*.cu``).
``ce_perf`` (``--ce``) is the same for the loss head: flash-CE (the
streamed-logits kernels) vs the no-remat dense control.
``fused_norm_perf`` (``--fuse-norm``): the out-proj + residual + norm
epilogue kernels vs the unfused formulation.  ``collective_perf``
(``--collective``): ring all-gather-matmul (``parallel/overlap.py``) vs
the barrier all-gather-then-matmul.  ``decode_perf`` (``--decode``):
single-token decode attention, the port's decode kernel vs its plain
masked version.  ``train_step_perf`` (``--train``) runs the full train
step through the telemetry recorder and prints its JSON block.

The kernel probes run on the card unless ``device="cpu"`` is passed (as
the tests do): bf16 on the card, f32 on the CPU, as the reference picks
by backend.  On the CPU the kernels' plain versions run, so the numbers
exercise the code, not the hardware.  Each probe makes its inputs from
a seeded ``torch.Generator``, runs one warm-up evaluation and then
``steps`` timed ones, synchronising the device before it reads the
clock.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch


def timeit(name: str, fn: Callable, multiplier: int = 1,
           duration: float = 2.0) -> Dict[str, float]:
    # warmup
    fn()
    count = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < duration:
        fn()
        count += 1
    dt = time.perf_counter() - t0
    rate = count * multiplier / dt
    print(f"{name} per second {rate:.2f}")
    return {"name": name, "rate": rate}


def _setup(device):
    """(device, dtype, sync): the card unless ``device`` names another;
    bf16 on the card, f32 elsewhere; ``sync`` waits for the device."""
    import torch

    from ray_tpu_torch.ops.substrate import resolve_device

    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    dtype = torch.bfloat16 if on_cuda else torch.float32

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)
    return dev, dtype, sync


def _time_steps(fn: Callable, steps: int, sync: Callable) -> float:
    """Seconds per call of ``fn`` over ``steps`` calls after one warm-up
    call, the device synchronised before each clock read."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    sync()
    return (time.perf_counter() - t0) / steps


def attention_perf(batch: int = 8, seq: int = 1024, heads: int = 12,
                   head_dim: int = 64, steps: int = 30,
                   causal: bool = True,
                   pack2: Optional[bool] = None,
                   rope: bool = True, device=None) -> Dict[str, float]:
    """Isolated flash-attention fwd+bwd microbenchmark.

    Times ``steps`` gradient evaluations of ``flash_attention`` (its
    forward and backward kernels) at the bench shape and reports
    tokens/s plus *effective* TFLOPs — real attention matmul FLOPs (2 fwd
    + 5 bwd score-shaped matmuls, halved under the causal mask) over
    wall-clock.  ``rope`` feeds ``positions``, so the kernels rotate q
    and k themselves (the training path).

    ``pack2`` names the reference's TPU lane layout (two heads packed
    along the 128-lane matrix unit at head_dim 64).  Hopper has no such
    layout: the port's kernels serve both schedules, so every value of
    ``pack2`` launches the same kernels and only names the result, and
    ``--attn``'s two arms time the same kernels twice.
    """
    import torch

    from ray_tpu_torch.ops.attention import flash_attention

    dev, dtype, sync = _setup(device)
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (batch, seq, heads, head_dim)
    q, k, v, w = (torch.randn(shape, generator=g, device=dev, dtype=dtype)
                  for _ in range(4))     # w: a fixed cotangent
    positions = torch.arange(seq, device=dev) if rope else None

    def grad_fn():
        args = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = flash_attention(*args, causal=causal, positions=positions)
        loss = torch.sum(o.float() * w.float())
        return torch.autograd.grad(loss, args)

    dt = _time_steps(grad_fn, steps, sync)

    # 2 score-shaped matmuls fwd (s, o) + 5 bwd (s recompute, dp, dq,
    # dk, dv), each 2*B*H*S^2*D flops; causal halves the live blocks
    flops = 7 * 2 * batch * heads * seq * seq * head_dim
    if causal:
        flops /= 2
    tok_s = batch * seq / dt
    result = {
        "name": f"attention fwd+bwd pack2={pack2}",
        "ms_per_step": dt * 1e3,
        "tokens_per_sec": tok_s,
        "effective_tflops": flops / dt / 1e12,
    }
    print(f"{result['name']}: {result['ms_per_step']:.2f} ms  "
          f"{tok_s:,.0f} tok/s  "
          f"{result['effective_tflops']:.1f} eff TFLOPs")
    return result


def ce_perf(n_tokens: int = 24576, d_model: int = 768,
            vocab: int = 50304, steps: int = 20,
            mode: str = "flash", device=None) -> Dict[str, float]:
    """Isolated cross-entropy loss-head fwd+bwd microbenchmark.

    Times ``steps`` gradient evaluations of ``(sum_nll / n)`` w.r.t.
    (x, head) at the bench shape and reports ms plus *effective* TFLOPs —
    each arm's real vocab-matmul count (flash: 4 = fwd + recompute + dX +
    dHead; no-remat: 3 = fwd + dX + dHead) over wall-clock.  The no-remat
    arm also pays its passes over the [N, V] logits, which the FLOP
    figure does not credit, so compare ``ms_per_step``, not TFLOPs.

    ``mode``: "flash" (``ops/flash_ce.py:flash_ce_sum``, the flash-CE
    kernels) or "noremat" (the model's own CE glue, ``gpt._chunked_ce``
    pinned to ``mode="xla"``, ``chunk=-1``: the dense formulation with
    the logits resident between the passes).
    """
    import torch

    from ray_tpu_torch.ops.flash_ce import flash_ce_sum

    dev, dtype, sync = _setup(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n_tokens, d_model, generator=g, device=dev,
                    dtype=dtype)
    head = (torch.randn(d_model, vocab, generator=g, device=dev)
            * 0.02).to(dtype)
    targets = torch.randint(0, vocab, (n_tokens,), generator=g, device=dev,
                            dtype=torch.int32)

    # the control arm goes through the model's own CE glue, so the
    # microbench control is the literal no-remat path the dispatch
    # would run, not a lookalike that could drift
    if mode == "flash":
        def ce(x, head):
            return flash_ce_sum(x, head, targets)
    else:
        from ray_tpu_torch.models.gpt import _chunked_ce

        def ce(x, head):
            return _chunked_ce(x, head, targets, chunk=-1, mode="xla")

    def grad_fn():
        args = [t.detach().requires_grad_(True) for t in (x, head)]
        s, n = ce(*args)
        loss = s / n
        return (loss, *torch.autograd.grad(loss, args))

    dt = _time_steps(grad_fn, steps, sync)

    matmuls = 4 if mode == "flash" else 3
    flops = matmuls * 2 * n_tokens * d_model * vocab
    result = {
        "name": f"ce fwd+bwd mode={mode}",
        "ms_per_step": dt * 1e3,
        "tokens_per_sec": n_tokens / dt,
        "effective_tflops": flops / dt / 1e12,
    }
    print(f"{result['name']}: {result['ms_per_step']:.2f} ms  "
          f"{result['tokens_per_sec']:,.0f} tok/s  "
          f"{result['effective_tflops']:.1f} eff TFLOPs "
          f"({matmuls} vocab matmuls)")
    return result


def fused_norm_perf(n_tokens: int = 24576, heads: int = 12,
                    head_dim: int = 64, d_model: int = 768,
                    steps: int = 30,
                    fused: bool = True, device=None) -> Dict[str, float]:
    """Isolated out-proj + residual + norm epilogue microbenchmark
    (``--fuse-norm``).

    Times ``steps`` gradient evaluations of the attention-block epilogue
    — out-proj matmul, residual add, pre-FFN rmsnorm — through the
    epilogue kernels (``ops/fused_norm.matmul_residual_norm``) vs the
    unfused formulation (``plain_matmul_residual_norm``, differentiated
    by autograd), with cotangents flowing into *both* outputs (residual
    stream + normed hidden) like the real block.
    """
    import torch

    from ray_tpu_torch.ops.fused_norm import (matmul_residual_norm,
                                              plain_matmul_residual_norm)

    dev, dtype, sync = _setup(device)
    g = torch.Generator(device=dev).manual_seed(0)
    K = heads * head_dim

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

    a = randn(n_tokens, K)
    w = randn(K, d_model) * K ** -0.5
    resid = randn(n_tokens, d_model)
    scale = torch.ones((d_model,), dtype=dtype, device=dev)
    wr, wy = randn(n_tokens, d_model), randn(n_tokens, d_model)

    def op(a, w, resid, scale):
        if fused:
            return matmul_residual_norm(a, w, resid, scale)
        return plain_matmul_residual_norm(a, w, resid, scale)[:2]

    def grad_fn():
        args = [t.detach().requires_grad_(True)
                for t in (a, w, resid, scale)]
        r, y = op(*args)
        loss = (torch.sum(r.float() * wr.float())
                + torch.sum(y.float() * wy.float()))
        return torch.autograd.grad(loss, args)

    dt = _time_steps(grad_fn, steps, sync)

    # 1 fwd matmul + 2 bwd (da, dw); the norm itself is memory-bound work
    flops = 3 * 2 * n_tokens * K * d_model
    result = {
        "name": f"out-proj+norm epilogue fused={fused}",
        "ms_per_step": dt * 1e3,
        "tokens_per_sec": n_tokens / dt,
        "effective_tflops": flops / dt / 1e12,
    }
    print(f"{result['name']}: {result['ms_per_step']:.2f} ms  "
          f"{result['tokens_per_sec']:,.0f} tok/s  "
          f"{result['effective_tflops']:.1f} eff TFLOPs")
    return result


def decode_perf(batch: int = 8, ctx: int = 1024, heads: int = 12,
                head_dim: int = 64, steps: int = 50,
                impl: str = "auto", device=None) -> Dict[str, float]:
    """Isolated decode-attention microbenchmark (``--decode``).

    Times ``steps`` evaluations of the single-token attention
    (``ops/attention.py:decode_attention``) at a padded context of
    ``ctx`` with mixed valid lengths — the per-layer attention cost of
    one engine decode tick.  ``impl`` is the reference's A/B switch:
    "pallas" names the port's decode kernel (``csrc/decode_attention.cu``),
    "xla" its plain masked version (``plain_decode_attention``: the
    reference's masked-einsum arm, here PyTorch ops), and "auto" takes
    what the engine takes, the kernel.
    """
    import torch

    from ray_tpu_torch.ops.attention import (decode_attention,
                                             plain_decode_attention)

    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', "
                         f"got {impl!r}")
    dev, dtype, sync = _setup(device)
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(batch, heads, head_dim, generator=g, device=dev,
                    dtype=dtype)
    k, v = (torch.randn(batch, ctx, heads, head_dim, generator=g,
                        device=dev, dtype=dtype) for _ in range(2))
    lengths = (torch.arange(1, batch + 1, dtype=torch.int32, device=dev)
               * (ctx // batch))

    if impl == "xla":
        def fn():
            return plain_decode_attention(q, k, v, lengths,
                                          scale=head_dim ** -0.5)
    else:
        def fn():
            return decode_attention(q, k, v, lengths)

    dt = _time_steps(fn, steps, sync)

    # 2 context-shaped matmuls (scores, p@V), each 2*B*H*ctx*D flops
    # on the padded context (masking does not skip compute)
    flops = 2 * 2 * batch * heads * ctx * head_dim
    result = {
        "name": f"decode attention impl={impl}",
        "us_per_step": dt * 1e6,
        "tokens_per_sec": batch / dt,
        "effective_gflops": flops / dt / 1e9,
    }
    print(f"{result['name']}: {result['us_per_step']:.1f} us  "
          f"{result['tokens_per_sec']:,.0f} tok/s  "
          f"{result['effective_gflops']:.1f} eff GFLOPs")
    return result


def train_step_perf(steps: int = 8, batch: Optional[int] = None,
                    seq: Optional[int] = None,
                    device=None) -> Dict[str, float]:
    """Instrumented GPT train-step microbench: one telemetry block.

    Runs ``steps`` steps of the single-device GPT train step through a
    :class:`ray_tpu_torch.telemetry.StepTelemetry` recorder and prints
    its summary as one JSON line — first-step split, synchronised steady
    step time, tokens/s, analytic-FLOPs MFU and the device memory.  On
    the card: GPT-2 124M in bf16 at 24 x 1024; on the CPU the shapes
    shrink to a smoke configuration (numbers exercise the recorder, not
    the hardware).
    """
    import json

    import torch

    from ray_tpu_torch.models import training
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.telemetry import StepTelemetry

    dev, _dtype, _sync = _setup(device)
    if dev.type == "cuda":
        cfg = GPTConfig.gpt2(vocab_size=50304, max_seq=1024,
                             dtype=torch.bfloat16, remat=False,
                             unroll_layers=True, ce_chunk=-1)
        batch, seq = batch or 24, seq or 1024
    else:
        cfg = GPTConfig(vocab_size=2048, d_model=128, n_layers=2,
                        n_heads=4, max_seq=256, dtype=torch.float32)
        batch, seq = batch or 4, seq or 128
    mesh = make_mesh(dp=1, devices=dev)
    fns = training.build_gpt_train(cfg, mesh, device=dev, telemetry=False)
    tel = StepTelemetry(cfg, mesh, comm_mode=fns["comm_mode"],
                        label="ray_perf", aot=True)
    step = tel.wrap(fns["step_fn"])
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    data = training.synthetic_lm_batch(torch.Generator().manual_seed(1),
                                       batch, seq, cfg.vocab_size,
                                       device=dev)
    for _ in range(steps):
        state, _ = step(state, data)
    tel.stop()
    summary = tel.summary()
    summary["metric"] = "train_step_telemetry"
    print(json.dumps(summary))
    return summary


def collective_perf(tokens: int = 4096, d_model: int = 512,
                    d_out: int = 2048, steps: int = 20,
                    n_devices: Optional[int] = None,
                    device=None) -> List[Dict[str, float]]:
    """Isolated TP-collective microbenchmark: ring all-gather-matmul
    (``parallel/overlap.py``) vs the barrier schedule (all_gather, then
    matmul) on a tp ring over the ranks of the default
    ``torch.distributed`` group, each rank on its own device (no group:
    a world of 1).

    The ring version pays the same bytes but hides each hop behind one
    matmul chunk, so the delta bounds what the full-step schedule can
    recover.  A world of 1, as on one card, has no hop: both arms are one
    matmul and the figure measures no NVLink traffic (only a world of
    several cards, one rank each, does).  Over a gloo world on the CPU
    the ring runs but measures nothing of a card.
    """
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel.overlap import ring_allgather_matmul

    dev, dtype, sync = _setup(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(f"collective_perf runs over the default group's "
                         f"{world} rank(s), not {n}")
    rank = dist.get_rank() if n > 1 else 0
    group = dist.group.WORLD if n > 1 else None
    g = torch.Generator(device=dev).manual_seed(0)
    x_full = torch.randn(tokens, d_model, generator=g, device=dev,
                         dtype=dtype)
    w_full = (torch.randn(d_model, d_out, generator=g, device=dev,
                          dtype=dtype) * 0.02)
    # tokens sharded over the ring, output columns per rank
    x = x_full.chunk(n, 0)[rank].contiguous()
    w = w_full.chunk(n, 1)[rank].contiguous()

    def ring():
        return ring_allgather_matmul(x, w, group)

    def barrier():
        full = x
        if n > 1:
            full = torch.empty((x.shape[0] * n, d_model), dtype=dtype,
                               device=dev)
            dist.all_gather_into_tensor(full, x, group=group)
        return torch.matmul(full, w)

    results = []
    for name, body in (("ring all-gather-matmul", ring),
                       ("all-gather then matmul", barrier)):
        dt = _time_steps(body, steps, sync)
        flops = 2 * tokens * d_model * (d_out // max(n, 1)) * n
        gathered = tokens * d_model * x.element_size() * (n - 1) / max(n, 1)
        r = {"name": name, "ms_per_step": dt * 1e3,
             "effective_tflops": flops / dt / 1e12,
             "gathered_bytes_per_device": gathered}
        print(f"{r['name']}: {r['ms_per_step']:.3f} ms  "
              f"{r['effective_tflops']:.2f} eff TFLOPs  "
              f"({gathered/2**20:.2f} MiB gathered/device)")
        results.append(r)
    return results


def main(duration: float = 2.0) -> List[Dict[str, float]]:
    results = []
    value = np.zeros(16 * 1024, dtype=np.uint8)  # small object
    big = np.zeros(100 * 1024 * 1024, dtype=np.uint8)  # 100MB

    # --- object store ---
    ref = ray_tpu_torch.put(value)
    results.append(timeit(
        "single client get calls (shm store)",
        lambda: ray_tpu_torch.get(ref), duration=duration))
    results.append(timeit(
        "single client put calls (shm store)",
        lambda: ray_tpu_torch.put(value), duration=duration))

    def put_gb():
        ray_tpu_torch.get(ray_tpu_torch.put(big))
    results.append(timeit("single client put gigabytes",
                          put_gb, multiplier=big.nbytes // 2**30 or 1,
                          duration=duration))

    # --- tasks ---
    @ray_tpu_torch.remote
    def tiny(x):
        return x

    results.append(timeit(
        "single client tasks sync",
        lambda: ray_tpu_torch.get(tiny.remote(0)), duration=duration))

    def batch_tasks():
        ray_tpu_torch.get([tiny.remote(i) for i in range(100)])
    results.append(timeit("single client tasks and get batch",
                          batch_tasks, multiplier=100,
                          duration=duration))

    # --- wait ---
    refs_1k = [ray_tpu_torch.put(i) for i in range(1000)]
    results.append(timeit(
        "single client wait 1k refs",
        lambda: ray_tpu_torch.wait(refs_1k, num_returns=1000, timeout=10),
        duration=duration))

    # --- actors ---
    @ray_tpu_torch.remote
    class Echo:
        def ping(self, x=None):
            return x

    actor = Echo.remote()
    ray_tpu_torch.get(actor.ping.remote())
    results.append(timeit(
        "1:1 actor calls sync",
        lambda: ray_tpu_torch.get(actor.ping.remote()), duration=duration))

    def async_batch():
        ray_tpu_torch.get([actor.ping.remote(i) for i in range(100)])
    results.append(timeit("1:1 actor calls async", async_batch,
                          multiplier=100, duration=duration))

    actors = [Echo.remote() for _ in range(4)]
    for a in actors:
        ray_tpu_torch.get(a.ping.remote())

    def nn_batch():
        ray_tpu_torch.get([a.ping.remote(i) for a in actors
                           for i in range(25)])
    results.append(timeit("n:n actor calls async", nn_batch,
                          multiplier=100, duration=duration))

    # --- compiled DAG (mutable channels) vs chained actor tasks ---
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class Stage:
        def step(self, x):
            return x + 1

    s1, s2, s3 = Stage.remote(), Stage.remote(), Stage.remote()
    ray_tpu_torch.get([s.step.remote(0) for s in (s1, s2, s3)])

    def chained():
        ray_tpu_torch.get(s3.step.remote(s2.step.remote(s1.step.remote(0))))
    results.append(timeit("3-stage actor pipeline calls (tasks)",
                          chained, duration=duration))

    a, b, c = Stage.bind(), Stage.bind(), Stage.bind()
    with InputNode() as inp:
        dag = c.step.bind(b.step.bind(a.step.bind(inp)))
    compiled = dag.experimental_compile()
    compiled.execute(0).get()
    state = {"futs": []}

    def channel_call():
        state["futs"].append(compiled.execute(0))
        if len(state["futs"]) >= 3:
            state["futs"].pop(0).get()
    results.append(timeit(
        "3-stage actor pipeline calls (compiled dag channels)",
        channel_call, duration=duration))
    for f in state["futs"]:
        f.get()
    compiled.teardown()
    return results


if __name__ == "__main__":
    if "--attn" in sys.argv:
        # both arms launch the same kernels (pack2 is a TPU layout)
        attention_perf(pack2=True)
        attention_perf(pack2=False)
    elif "--ce" in sys.argv:
        # loss-head A/B: the flash-CE kernels vs the no-remat dense CE
        ce_perf(mode="flash")
        ce_perf(mode="noremat")
    elif "--fuse-norm" in sys.argv:
        # norm-epilogue A/B: the epilogue kernels vs the unfused ops
        fused_norm_perf(fused=True)
        fused_norm_perf(fused=False)
    elif "--collective" in sys.argv:
        # TP-schedule A/B: ring all-gather-matmul vs barrier gather
        collective_perf()
    elif "--decode" in sys.argv:
        # decode attention A/B: the decode kernel vs its plain version
        decode_perf(impl="pallas")
        decode_perf(impl="xla")
    elif "--train" in sys.argv:
        # instrumented train step: the telemetry block in isolation
        train_step_perf()
    else:
        ray_tpu_torch.init()
        try:
            main()
        finally:
            ray_tpu_torch.shutdown()
