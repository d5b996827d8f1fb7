"""Time the port's flash-attention kernels at the training shape in one
source tree, so that two trees (a parent and a change) can be compared
in one session on one card.

    python3 tools/attention_ab.py <tree root> <label>

imports ``ray_tpu_torch`` from ``<tree root>`` (builds its kernels there),
then prints ``<label> {...}``: the forward and backward device times in
ms (CUDA events over 20 calls after 3, behind a spin kernel, the best of
3) of the bf16 pair at [24, 1024, 12, 64] (gpt2-train-b24's), causal,
with and without the RoPE tables.  Compare two trees by running them in
turns in one command: parent, change, change, parent.
"""

import sys


def time_ms(fn, iters: int = 20) -> float:
    import torch
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


def main(root: str, label: str) -> None:
    sys.path.insert(0, root)
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A
    if not A.__file__.startswith(root):
        raise SystemExit(f"ray_tpu_torch came from {A.__file__}, not {root}")
    _build.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    B, S, H, D = 24, 1024, 12, 64
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device=dev)
                   .bfloat16() for _ in range(4))
    rope = A.rope_tables(torch.arange(S, device=dev), D, 10000.0,
                         torch.bfloat16)
    scale = D ** -0.5
    out = {}
    for name, r in (("rope", rope), ("norope", None)):
        o, lse = A.flash_attention_fwd(q, k, v, scale=scale, rope=r)
        out[f"fwd_{name}"] = min(time_ms(lambda: A.flash_attention_fwd(
            q, k, v, scale=scale, rope=r)) for _ in range(3))
        out[f"bwd_{name}"] = min(time_ms(lambda: A.flash_attention_bwd(
            q, k, v, o, lse, do, scale=scale, rope=r)) for _ in range(3))
    print(label, {n: round(t, 4) for n, t in out.items()}, flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
