"""Decoder-only transformer (GPT family) in PyTorch.

Counterpart of ``ray_tpu/models/gpt.py`` with the same config fields and
presets and the same parameter tree: a dict of tensors with the layer
weights stacked ``[L, ...]`` (``wq [L, d, H, hd]``, ``wo [L, H, hd,
d]``), a tied ``embed`` and no biases.  A tree made by the JAX package
(``convert.params_from_jax``) therefore drives this module unchanged.

The port runs the main configuration: RMSNorm, SwiGLU, RoPE, dense
FFNs, tied embeddings, no biases.  Other modes, and ``remat``, raise
``NotImplementedError``.  The layer loop is a Python loop (PyTorch runs
eagerly; ``lax.scan`` has no counterpart to port).

The out-proj + residual + pre-FFN norm of each layer goes through
``ops.fused_norm.matmul_residual_norm`` whenever its gate
(``out_proj_norm_plan``) passes, as in the JAX package; on a CUDA
tensor that is the hand-written kernel, forward and backward.  The
training loss (:func:`loss_fn`) goes through ``ops.flash_ce``, with the
final norm fused into its prologue when ``fuse_norm`` allows.

Each gate takes the operands' device: on a CUDA device a shape the JAX
package's gate declines takes the plain branch, as there, and a shape
it takes but no kernel of the port is built for raises, naming ROADMAP
Queue 2 item A or B.

With ``_PALLAS_NORM`` on (``RAY_TPU_PALLAS_NORM=1``, read once at
import as in the JAX package; default off) every RMSNorm that
:func:`_norm` runs goes through ``ops.rmsnorm.rmsnorm``, the hand-written
forward and backward kernels: ``ln1`` in every layer, and ``ln2`` and
``ln_f`` wherever the fused epilogue or the flash-CE prologue does not
take them (the decode step's ``ln2``, the serving path's ``ln_f``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ray_tpu_torch.ops import flash_ce
from ray_tpu_torch.ops import fused_norm as fnorm
from ray_tpu_torch.ops import rmsnorm as rms
from ray_tpu_torch.ops.attention import rope_rotate
from ray_tpu_torch.ops.substrate import resolve_device
from ray_tpu_torch.parallel.ring_attention import local_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # GPT-2 vocab padded to 128 multiple
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_head: Optional[int] = None
    d_ff: Optional[int] = None       # default 4*d_model (8/3 for swiglu)
    max_seq: int = 1024
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    pos: str = "rope"                # rope | learned
    rope_theta: float = 10000.0
    n_experts: int = 0               # >0: every FFN is MoE
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.5
    dtype: Any = torch.bfloat16
    remat: bool = False
    tie_embeddings: bool = True
    use_bias: bool = False
    unroll_layers: bool = False
    ce_chunk: int = 4096

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff:
            return self.d_ff
        return (int(8 * self.d_model / 3 / 128) * 128 or 128) \
            if self.act == "swiglu" else 4 * self.d_model

    @classmethod
    def gpt2(cls, **kw):
        return cls(d_model=768, n_layers=12, n_heads=12, **kw)

    @classmethod
    def gpt2_medium(cls, **kw):
        return cls(d_model=1024, n_layers=24, n_heads=16, **kw)

    @classmethod
    def gpt2_large(cls, **kw):
        return cls(d_model=1280, n_layers=36, n_heads=20, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq", 128)
        return cls(d_model=64, n_layers=2, n_heads=4, **kw)


def check_supported(cfg: GPTConfig) -> None:
    """Raise for the model modes this slice of the port does not run."""
    unported = [
        (cfg.norm != "rmsnorm", f"norm={cfg.norm!r}"),
        (cfg.act != "swiglu", f"act={cfg.act!r}"),
        (cfg.pos != "rope", f"pos={cfg.pos!r}"),
        (cfg.n_experts > 0, "MoE FFNs"),
        (cfg.use_bias, "biases (GPT-2 exact-architecture mode)"),
        (not cfg.tie_embeddings, "an untied lm_head"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP Queue 1: the "
                "layernorm/bias/learned-position/MoE modes come after "
                "the main configuration)")


def init_params(cfg: GPTConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> Params:
    """Random parameters in the JAX package's tree layout and scales.

    Drawn from ``generator`` (default: a CPU generator seeded 0) on its
    device, then moved to ``device``: the card unless the caller passes
    ``device="cpu"`` (without a card and without that, this raises)."""
    check_supported(cfg)
    dev = resolve_device(device)
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    d, H, hd, f, L = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.ff_dim,
                      cfg.n_layers)
    dt = cfg.dtype

    def norm_init(shape, scale):
        x = torch.randn(shape, generator=g, device=g.device) * scale
        return x.to(dt).to(dev)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    embed = norm_init((cfg.vocab_size, d), 0.02)
    layers = {
        "ln1": ones((L, d)),
        "wq": norm_init((L, d, H, hd), d ** -0.5),
        "wk": norm_init((L, d, H, hd), d ** -0.5),
        "wv": norm_init((L, d, H, hd), d ** -0.5),
        "wo": norm_init((L, H, hd, d), (H * hd) ** -0.5 / (2 * L) ** 0.5),
        "ln2": ones((L, d)),
    }
    layers["w1"] = norm_init((L, d, f), d ** -0.5)
    layers["w3"] = norm_init((L, d, f), d ** -0.5)
    layers["w2"] = norm_init((L, f, d), f ** -0.5 / (2 * L) ** 0.5)
    return {"embed": embed, "layers": layers, "ln_f": ones((d,))}


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s weights: views into the stacked ``[L, ...]`` tree."""
    return {k: v[i] for k, v in params["layers"].items()}


def norm_eps(cfg: GPTConfig) -> float:
    """Norm epsilon: HF GPT-2 (exact-architecture mode) uses 1e-5."""
    return 1e-5 if cfg.use_bias else 1e-6


# the RMSNorm kernel path (ops/rmsnorm.py), as at ray_tpu/models/gpt.py:208;
# _norm reads it at each call, so a caller may set it without the env
_PALLAS_NORM = os.environ.get("RAY_TPU_PALLAS_NORM", "0") == "1"


def _norm(x, scale, kind: str, eps: float = 1e-6):
    """RMSNorm with f32 statistics, result in x's dtype."""
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm={kind!r} is not ported yet")
    if _PALLAS_NORM:
        return rms.rmsnorm(x, scale, eps)
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * scale.float()).to(x.dtype)


def _rope(x, positions, theta: float):
    """x: [B, S, H, D]; angles in f32, rotation in x's dtype."""
    return rope_rotate(x, positions, theta)


def _proj_heads(h, w):
    """h [B, S, d] @ w [d, H, hd] -> [B, S, H, hd]."""
    B, S, d = h.shape
    return torch.matmul(h, w.reshape(d, -1)).view(B, S, *w.shape[1:])


def _dense_ffn(lp, x, cfg: GPTConfig):
    h = torch.matmul(x, lp["w1"])
    g = torch.matmul(x, lp["w3"])
    return torch.matmul(F.silu(h) * g, lp["w2"])


def layer_apply(lp, x, cfg: GPTConfig, *, positions, attn_fn: Callable,
                cache=None, fuse_norm: Optional[bool] = None):
    """One transformer block: ``(layer params, hidden [B, S, d]) ->
    (hidden, aux)``.

    ``positions`` is [S] (shared across the batch) or [B, S] (per
    sequence: the decode path).  With ``cache`` not None, ``attn_fn`` is
    called as ``attn_fn(q, k, v, cache=cache)`` with the *rotated* k and
    returns ``(attn_out, new_cache)``; the block then returns
    ``(hidden, aux, new_cache)``.  An ``attn_fn`` marked ``fused_rope``
    (``ops.attention.make_flash_attention_fn``) takes q and k unrotated
    and is called as ``attn_fn(q, k, v, positions=positions)``.

    The out-proj epilogue is fused whenever ``out_proj_norm_plan``
    passes (``fuse_norm=False`` declines it; None means on); it declines
    the S=1 decode step, which keeps the plain matmul + add + norm as
    the JAX package does."""
    eps = norm_eps(cfg)
    B, S, d = x.shape
    h = _norm(x, lp["ln1"], cfg.norm, eps=eps)
    q = _proj_heads(h, lp["wq"])
    k = _proj_heads(h, lp["wk"])
    v = _proj_heads(h, lp["wv"])
    fused_rope = cfg.pos == "rope" and getattr(attn_fn, "fused_rope", False)
    if not fused_rope:
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
    if cache is not None:
        if fused_rope:
            raise ValueError(
                "cache= requires an attn_fn without fused RoPE: cache "
                "entries must store post-RoPE keys, but a fused_rope "
                "attn_fn receives them un-rotated")
        attn, cache = attn_fn(q, k, v, cache=cache)
    elif fused_rope:
        attn = attn_fn(q, k, v, positions=positions)
    else:
        attn = attn_fn(q, k, v)
    Hn, hd = attn.shape[2], attn.shape[3]
    plan = fnorm.out_proj_norm_plan(B * S, Hn * hd, d, norm=cfg.norm,
                                    has_bias=False, seq=S,
                                    enabled=fuse_norm is not False,
                                    device=x.device)
    if plan:
        # out-proj + residual add + pre-FFN norm in one kernel
        r2, y2 = fnorm.matmul_residual_norm(
            attn.reshape(B * S, Hn * hd), lp["wo"].reshape(Hn * hd, d),
            x.reshape(B * S, d), lp["ln2"], eps=eps)
        x = r2.view(B, S, d)
        h2 = y2.view(B, S, d)
    else:
        x = x + torch.matmul(attn.reshape(B, S, Hn * hd),
                             lp["wo"].reshape(Hn * hd, d))
        h2 = _norm(x, lp["ln2"], cfg.norm, eps=eps)
    x = x + _dense_ffn(lp, h2, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is not None:
        return x, aux, cache
    return x, aux


def embed_tokens(params: Params, tokens, cfg: GPTConfig):
    """tokens [B, S] -> hidden [B, S, d] in the model dtype."""
    return params["embed"].to(cfg.dtype)[tokens]


def forward_hidden(params: Params, tokens, cfg: GPTConfig, *,
                   attn_fn: Optional[Callable] = None,
                   fuse_norm: Optional[bool] = None,
                   final_norm: bool = True, positions=None):
    """tokens [B, S] int -> (final hidden [B, S, d], aux).

    ``attn_fn(q, k, v) -> out`` defaults to causal ``local_attention``
    (as in the JAX package); the engine passes ``flash_attention`` and
    the trainer ``make_flash_attention_fn``.  ``fuse_norm`` pins the
    out-proj epilogue; ``final_norm=False`` skips the closing ``ln_f``
    and returns the raw residual stream (for the fused-norm CE)."""
    check_supported(cfg)
    if cfg.remat:
        raise NotImplementedError(
            "remat=True is not ported yet (ROADMAP Queue 1 item 7: "
            "activation recompute comes after the single-device step)")
    S = tokens.shape[1]
    if attn_fn is None:
        attn_fn = functools.partial(local_attention, causal=True)
    x = embed_tokens(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux = layer_apply(layer_params(params, i), x, cfg,
                             positions=positions, attn_fn=attn_fn,
                             fuse_norm=fuse_norm)
        aux_total = aux_total + aux
    if final_norm:
        x = _norm(x, params["ln_f"], cfg.norm, eps=norm_eps(cfg))
    return x, aux_total


def lm_head(params: Params, cfg: GPTConfig):
    """The tied output projection [d, V]."""
    return params["embed"].to(cfg.dtype).T


def forward(params: Params, tokens, cfg: GPTConfig, *,
            attn_fn: Optional[Callable] = None,
            fuse_norm: Optional[bool] = None, positions=None):
    """tokens [B, S] int -> (logits [B, S, V] f32, aux)."""
    x, aux = forward_hidden(params, tokens, cfg, attn_fn=attn_fn,
                            fuse_norm=fuse_norm, positions=positions)
    logits = torch.matmul(x, lm_head(params, cfg))
    return logits.float(), aux


def loss_from_hidden(params: Params, x, targets, cfg: GPTConfig, *,
                     ce_mode: Optional[str] = None, norm_scale=None):
    """(final hidden [B, S, d], targets [B, S]) -> mean NLL over the live
    (non ``-1``) targets.

    ``norm_scale``: when given, ``x`` is the raw residual stream (before
    ``ln_f``) and the norm fuses into the flash-CE prologue
    (``flash_ce.flash_ce_norm_sum``); if that gate declines, the norm
    runs here and the regular CE dispatch follows."""
    B, S, d = x.shape
    if norm_scale is not None:
        if flash_ce.uses_flash_ce_norm(
                B * S, d, cfg.vocab_size, mode=ce_mode or "flash",
                norm=cfg.norm, has_bias=cfg.use_bias, enabled=True,
                device=x.device, dtype=x.dtype):
            s, n = flash_ce.flash_ce_norm_sum(
                x.reshape(B * S, d), lm_head(params, cfg),
                targets.reshape(B * S), norm_scale, eps=norm_eps(cfg))
            return s / n.clamp_min(1.0)
        x = _norm(x, norm_scale, cfg.norm, eps=norm_eps(cfg))
    s, n = _chunked_ce(x.reshape(B * S, d), lm_head(params, cfg),
                       targets.reshape(B * S), chunk=cfg.ce_chunk,
                       mode=ce_mode)
    return s / n.clamp_min(1.0)


def _chunked_ce(x, head, targets, *, chunk: int = 4096,
                mode: Optional[str] = None):
    """x [N, d], head [d, V], targets [N] -> (sum_nll, n_valid).

    ``mode`` (default ``flash``): ``flash`` takes the streamed kernels
    for the shapes ``flash_ce.supports`` on x's device and dtype; ``xla``
    (or a declined shape)
    the dense formulation, over row chunks of ``chunk`` (``chunk < 0``:
    one chunk, logits kept for the backward; ``chunk >= 0``: each chunk
    recomputed in the backward, as ``jax.checkpoint`` does).  ``fused``
    (``ops/fused_ce.py``, no-remat only) is not ported and raises."""
    N, d = x.shape
    mode = mode or "flash"
    if mode == "flash" and flash_ce.supports(N, d, head.shape[1],
                                             device=x.device, dtype=x.dtype):
        return flash_ce.flash_ce_sum(x, head.to(x.dtype), targets)
    remat = chunk >= 0
    if not remat and mode == "fused":
        raise NotImplementedError(
            "ce_mode='fused' (the bf16-resident-logits CE of "
            "ops/fused_ce.py) is not ported yet (ROADMAP Queue 1 item 7)")
    if chunk <= 0:
        chunk = N

    def chunk_loss(xc, tc):
        logits = torch.matmul(xc.float(), head.float())
        lse = torch.logsumexp(logits, -1)
        true = logits.gather(1, tc.clamp_min(0).long()[:, None])[:, 0]
        mask = (tc >= 0).float()
        return ((lse - true) * mask).sum(), mask.sum()

    def run(xc, tc):
        if remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(chunk_loss, xc, tc,
                                                     use_reentrant=False)
        return chunk_loss(xc, tc)

    if N <= chunk:
        return run(x, targets)
    s = n = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, N, chunk):
        cs, cn = run(x[i:i + chunk], targets[i:i + chunk])
        s, n = s + cs, n + cn
    return s, n


def loss_fn(params: Params, batch, cfg: GPTConfig, *,
            attn_fn: Optional[Callable] = None, aux_weight: float = 0.01,
            ce_mode: Optional[str] = None,
            fuse_norm: Optional[bool] = None):
    """batch: dict(tokens [B, S], targets [B, S]) -> scalar loss.

    ``fuse_norm`` (None means on) pins the fused norm epilogues: the
    per-layer out-proj epilogue, and, when the flash-CE-with-norm gate
    passes, ``ln_f`` folded into the vocab-matmul kernel's prologue
    instead of running here."""
    if batch.get("segment_ids") is not None:
        raise NotImplementedError(
            "sample-packed batches (segment_ids) are not ported yet "
            "(ROADMAP Queue 1 item 10: the data-plane slice)")
    B, S = batch["tokens"].shape
    ce_norm = flash_ce.uses_flash_ce_norm(
        B * S, cfg.d_model, cfg.vocab_size, mode=ce_mode or "flash",
        norm=cfg.norm, has_bias=cfg.use_bias, enabled=fuse_norm is not False,
        device=batch["tokens"].device, dtype=cfg.dtype)
    x, aux = forward_hidden(params, batch["tokens"], cfg, attn_fn=attn_fn,
                            fuse_norm=fuse_norm, final_norm=not ce_norm,
                            positions=batch.get("positions"))
    loss = loss_from_hidden(params, x, batch["targets"], cfg,
                            ce_mode=ce_mode,
                            norm_scale=params["ln_f"] if ce_norm else None)
    return loss + aux_weight * aux


def num_params(params: Params) -> int:
    n = 0
    for v in params.values():
        n += num_params(v) if isinstance(v, dict) else v.numel()
    return n
