"""Analytic FLOPs and the MFU figure for the port.

Counterpart of ``ray_tpu/telemetry/flops.py`` (the per-matmul count from
``GPTConfig``, attention included, recompute charged).  The only peak
here is the card the port targets: one NVIDIA H100 SXM, dense bf16 on the
tensor cores (NVIDIA's data sheet).  The TPU peak table does not apply.
"""

from __future__ import annotations

from typing import Optional

# NVIDIA H100 SXM, dense bf16 tensor-core peak at the full 700 W limit
H100_PEAK_TFLOPS = 989.0


def gpt_fwd_flops_per_token(cfg, seq: int, *, causal: bool = True) -> float:
    """Matmul FLOPs per token of ONE forward pass of ``cfg`` at ``seq``.

    Per token of a length-``seq`` sequence (2 FLOPs per MAC): the qkv
    projections ``3 * 2*d*H*hd``; the score and value matmuls
    ``2 * 2*seq*H*hd``, halved under a causal mask; the output
    projection ``2*H*hd*d``; the FFN ``2*d*f`` per matmul (3 for swiglu,
    2 for gelu; MoE charges the gate plus ``top_k`` experts); the lm
    head ``2*d*V``.  Embedding gathers, norms and activations are not
    counted, as published MFU figures count."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    f, L, V = cfg.ff_dim, cfg.n_layers, cfg.vocab_size
    qkv = 3 * 2 * d * H * hd
    attn = 2 * 2 * seq * H * hd
    if causal:
        attn /= 2
    out = 2 * H * hd * d
    ffn_matmuls = 3 if cfg.act == "swiglu" else 2
    ffn = ffn_matmuls * 2 * d * f
    if cfg.n_experts > 0:
        ffn = 2 * d * cfg.n_experts + cfg.moe_top_k * ffn
    layer = qkv + attn + out + ffn
    return L * layer + 2 * d * V


def gpt_train_flops_per_token(cfg, seq: int, *, causal: bool = True,
                              ce_recompute: Optional[bool] = None) -> float:
    """Matmul FLOPs per token of ONE training step of ``cfg`` at ``seq``.

    ``3x`` the forward (forward + 2x backward), plus the recompute the
    schedule pays: ``cfg.remat`` re-runs the layer stack, and a
    recomputing CE (``ce_chunk >= 0``, and the flash-CE kernels) runs
    the head matmul once more (``+2*d*V``).  ``ce_recompute=None`` infers
    from ``cfg.ce_chunk`` alone; callers that know the CE path pass it."""
    fwd = gpt_fwd_flops_per_token(cfg, seq, causal=causal)
    head = 2 * cfg.d_model * cfg.vocab_size
    total = 3 * fwd
    if cfg.remat:
        total += fwd - head
    if ce_recompute is None:
        ce_recompute = getattr(cfg, "ce_chunk", 0) >= 0
    if ce_recompute:
        total += head
    return total


def mfu(tokens_per_sec_per_device: float, flops_per_token: float,
        peak_tflops: float = H100_PEAK_TFLOPS) -> float:
    """Model FLOPs utilization: useful FLOP/s over the card's peak."""
    return tokens_per_sec_per_device * flops_per_token / (peak_tflops * 1e12)
