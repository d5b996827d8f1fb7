"""Decoder-only transformer (GPT family) in PyTorch.

Counterpart of ``ray_tpu/models/gpt.py`` with the same config fields and
presets and the same parameter tree: a dict of tensors with the layer
weights stacked ``[L, ...]`` (``wq [L, d, H, hd]``, ``wo [L, H, hd,
d]``).  A tree made by the JAX package (``convert.params_from_jax``)
therefore drives this module unchanged.

Every mode of the JAX package runs: RMSNorm or LayerNorm, SwiGLU or
gelu (the tanh approximation, ``jax.nn.gelu``'s default and HF's
``gelu_new``), RoPE or learned positions (``pos_embed``, indexed by
absolute position), tied or untied (``lm_head [d, V]``) output head,
biases on every projection and norm (``use_bias``: the GPT-2
exact-architecture mode of ``train/huggingface``), with dense FFNs or
(``n_experts > 0``) MoE FFNs (:func:`_moe_ffn`, ``parallel/moe.py``).
The layer loop is a Python loop (PyTorch runs eagerly; ``lax.scan``
has no counterpart to port); ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``).

The out-proj + residual + pre-FFN norm of each layer goes through
``ops.fused_norm.matmul_residual_norm`` whenever its gate
(``out_proj_norm_plan``) passes, as in the JAX package; on a CUDA
tensor that is the hand-written kernel, forward and backward.  The
training loss (:func:`loss_fn`) goes through ``ops.flash_ce``, with the
final norm fused into its prologue when ``fuse_norm`` allows.  Both
gates decline LayerNorm and biases, as the JAX package's do.

Each gate takes the operands' device: on a CUDA device a shape the JAX
package's gate declines takes the plain branch, as there, and a shape
it takes but no kernel of the port is built for raises, naming ROADMAP
Queue 2 item A or B.

With ``_PALLAS_NORM`` on (``RAY_TPU_PALLAS_NORM=1``, read once at
import as in the JAX package; default off) every RMSNorm without a bias
that :func:`_norm` runs goes through ``ops.rmsnorm.rmsnorm``, the
hand-written forward and backward kernels: ``ln1`` in every layer, and
``ln2`` and ``ln_f`` wherever the fused epilogue or the flash-CE
prologue does not take them (the decode step's ``ln2``, the serving
path's ``ln_f``).
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
from ray_tpu_torch.ops import fused_ce
from ray_tpu_torch.ops import fused_norm as fnorm
from ray_tpu_torch.ops import rmsnorm as rms
from ray_tpu_torch.ops.attention import rope_rotate
from ray_tpu_torch.ops.substrate import resolve_device
from ray_tpu_torch.parallel import comm, moe
from ray_tpu_torch.parallel.mesh import mesh_groups
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


def init_params(cfg: GPTConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> Params:
    """Random parameters in the JAX package's tree layout and scales
    (``ray_tpu/models/gpt.py:94-149``), for every mode of ``cfg``.

    Drawn from ``generator`` (default: a CPU generator seeded 0) on its
    device, then moved to ``device``: the card unless the caller passes
    ``device="cpu"`` (without a card and without that, this raises)."""
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

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    params: Params = {"embed": norm_init((cfg.vocab_size, d), 0.02)}
    if cfg.pos == "learned":
        params["pos_embed"] = norm_init((cfg.max_seq, d), 0.02)
    layers = {
        "ln1": ones((L, d)),
        "wq": norm_init((L, d, H, hd), d ** -0.5),
        "wk": norm_init((L, d, H, hd), d ** -0.5),
        "wv": norm_init((L, d, H, hd), d ** -0.5),
        "wo": norm_init((L, H, hd, d), (H * hd) ** -0.5 / (2 * L) ** 0.5),
        "ln2": ones((L, d)),
    }
    swiglu = cfg.act == "swiglu"
    if cfg.n_experts > 0:
        E = cfg.n_experts
        layers["moe_wg"] = norm_init((L, d, E), d ** -0.5)
        layers["moe_w1"] = norm_init((L, E, d, f), d ** -0.5)
        if swiglu:
            layers["moe_w3"] = norm_init((L, E, d, f), d ** -0.5)
        layers["moe_w2"] = norm_init((L, E, f, d), f ** -0.5 / (2 * L) ** 0.5)
    else:
        layers["w1"] = norm_init((L, d, f), d ** -0.5)
        if swiglu:
            layers["w3"] = norm_init((L, d, f), d ** -0.5)
        layers["w2"] = norm_init((L, f, d), f ** -0.5 / (2 * L) ** 0.5)
    if cfg.use_bias:
        for k, shape in _bias_shapes(cfg).items():
            layers[k] = zeros(shape)
    params["layers"] = layers
    params["ln_f"] = ones((d,))
    if cfg.use_bias:
        params["ln_f_b"] = zeros((d,))
    if not cfg.tie_embeddings:
        params["lm_head"] = norm_init((d, cfg.vocab_size), 0.02)
    return params


def _bias_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    """The layer biases of the exact-architecture mode and their full
    shapes: the norms', q/k/v's per head, the out-proj's and (dense FFNs
    only, as in the reference) the FFN's."""
    d, H, hd, f, L = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.ff_dim,
                      cfg.n_layers)
    out = {"ln1_b": (L, d), "ln2_b": (L, d), "bq": (L, H, hd),
           "bk": (L, H, hd), "bv": (L, H, hd), "bo": (L, d)}
    if cfg.n_experts == 0:
        out["b1"] = (L, f)
        if cfg.act == "swiglu":
            out["b3"] = (L, f)
        out["b2"] = (L, d)
    return out


def param_logical_axes(cfg: GPTConfig) -> Dict[str, Any]:
    """The logical axes of each leaf of :func:`init_params`' tree (the
    leading L of a layer stack unnamed), as
    ``ray_tpu/models/gpt.py:152-196`` names them."""
    swiglu = cfg.act == "swiglu"
    layer = {
        "ln1": (None, None),
        "wq": (None, "embed_fsdp", "heads", None),
        "wk": (None, "embed_fsdp", "heads", None),
        "wv": (None, "embed_fsdp", "heads", None),
        "wo": (None, "heads", None, "embed_fsdp"),
        "ln2": (None, None),
    }
    if cfg.n_experts > 0:
        layer["moe_wg"] = (None, None, None)
        layer["moe_w1"] = (None, "experts", "embed_fsdp", "expert_mlp")
        if swiglu:
            layer["moe_w3"] = (None, "experts", "embed_fsdp", "expert_mlp")
        layer["moe_w2"] = (None, "experts", "expert_mlp", "embed_fsdp")
    else:
        layer["w1"] = (None, "embed_fsdp", "mlp")
        if swiglu:
            layer["w3"] = (None, "embed_fsdp", "mlp")
        layer["w2"] = (None, "mlp", "embed_fsdp")
    if cfg.use_bias:
        bias_axes = {"ln1_b": (None, None), "ln2_b": (None, None),
                     "bq": (None, "heads", None), "bk": (None, "heads", None),
                     "bv": (None, "heads", None), "bo": (None, None),
                     "b1": (None, "mlp"), "b3": (None, "mlp"),
                     "b2": (None, None)}
        layer.update({k: bias_axes[k] for k in _bias_shapes(cfg)})
    axes: Dict[str, Any] = {"embed": ("vocab", "embed_fsdp")}
    if cfg.pos == "learned":
        axes["pos_embed"] = (None, "embed_fsdp")
    axes["layers"] = layer
    axes["ln_f"] = (None,)
    if cfg.use_bias:
        axes["ln_f_b"] = (None,)
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed_fsdp", "vocab")
    return axes


def param_shapes(cfg: GPTConfig) -> Dict[str, Any]:
    """The full shape of each leaf of :func:`init_params`' tree."""
    d, H, hd, f, L = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.ff_dim,
                      cfg.n_layers)
    layers = {"ln1": (L, d), "wq": (L, d, H, hd), "wk": (L, d, H, hd),
              "wv": (L, d, H, hd), "wo": (L, H, hd, d), "ln2": (L, d)}
    swiglu = cfg.act == "swiglu"
    if cfg.n_experts > 0:
        E = cfg.n_experts
        layers.update(moe_wg=(L, d, E), moe_w1=(L, E, d, f),
                      moe_w2=(L, E, f, d))
        if swiglu:
            layers["moe_w3"] = (L, E, d, f)
    else:
        layers.update(w1=(L, d, f), w2=(L, f, d))
        if swiglu:
            layers["w3"] = (L, d, f)
    if cfg.use_bias:
        layers.update(_bias_shapes(cfg))
    out: Dict[str, Any] = {"embed": (cfg.vocab_size, d), "ln_f": (d,),
                           "layers": layers}
    if cfg.pos == "learned":
        out["pos_embed"] = (cfg.max_seq, d)
    if cfg.use_bias:
        out["ln_f_b"] = (d,)
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_size)
    return out


@dataclasses.dataclass(frozen=True)
class _Shards:
    """How a mesh shards the model: the fsdp and tp groups (None when
    the axis is 1) and this rank's tp coordinate."""
    fsdp: Any
    tp: Any
    tp_size: int
    tp_rank: int


def _shards(mesh) -> Optional[_Shards]:
    """The model's sharding on ``mesh``, or None where the mesh shards
    no parameter (no mesh, or fsdp and tp both 1): then the model runs
    exactly as on one card."""
    if mesh is None:
        return None
    g = mesh_groups(mesh)
    if g.size("fsdp") == 1 and g.size("tp") == 1:
        return None
    return _Shards(g.fsdp if g.size("fsdp") > 1 else None,
                   g.tp if g.size("tp") > 1 else None,
                   g.size("tp"), g.coord("tp"))


def _tp_group(sh: Optional[_Shards]):
    return None if sh is None else sh.tp


def _gather_layer(lp: Params, sh: _Shards) -> Params:
    """ZeRO-3: each of a layer's weights all-gathered over fsdp along its
    d_model dimension where it is used; the gradient reduce-scatters
    back (``comm.all_gather_dim``)."""
    if sh.fsdp is None:
        return lp
    out = {}
    for k, w in lp.items():
        axes = _LAYER_AXES[k]
        out[k] = (comm.all_gather_dim(w, axes.index("embed_fsdp") - 1,
                                      sh.fsdp)
                  if "embed_fsdp" in axes else w)
    return out


# every layer leaf's logical axes, the dense and the MoE FFN's and the
# biases together
_LAYER_AXES = dict(
    param_logical_axes(GPTConfig(use_bias=True))["layers"],
    **param_logical_axes(GPTConfig(n_experts=1))["layers"])


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s weights: views into the stacked ``[L, ...]`` tree."""
    return {k: v[i] for k, v in params["layers"].items()}


def norm_eps(cfg: GPTConfig) -> float:
    """Norm epsilon: HF GPT-2 (exact-architecture mode) uses 1e-5."""
    return 1e-5 if cfg.use_bias else 1e-6


# the RMSNorm kernel path (ops/rmsnorm.py), as at ray_tpu/models/gpt.py:208;
# _norm reads it at each call, so a caller may set it without the env
_PALLAS_NORM = os.environ.get("RAY_TPU_PALLAS_NORM", "0") == "1"


def _norm(x, scale, kind: str, bias=None, eps: float = 1e-6):
    """RMSNorm (``kind="rmsnorm"``) or LayerNorm (any other kind, as in
    the reference) with f32 statistics, then the scale and the optional
    ``bias``, result in x's dtype.  The RMSNorm kernel takes only the
    bias-free RMSNorm (``ray_tpu/models/gpt.py:217``)."""
    if kind == "rmsnorm" and bias is None and _PALLAS_NORM:
        return rms.rmsnorm(x, scale, eps)
    x32 = x.float()
    if kind == "rmsnorm":
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    else:
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        x32 = (x32 - mu) * torch.rsqrt(var + eps)
    x32 = x32 * scale.float()
    if bias is not None:
        x32 = x32 + bias.float()
    return x32.to(x.dtype)


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (HF GPT-2's
    ``gelu_new``); ``F.gelu``'s default erf form differs by ~1e-3."""
    return F.gelu(x, approximate="tanh")


def _rope(x, positions, theta: float):
    """x: [B, S, H, D]; angles in f32, rotation in x's dtype."""
    return rope_rotate(x, positions, theta)


def _proj_heads(h, w):
    """h [B, S, d] @ w [d, H, hd] -> [B, S, H, hd]."""
    B, S, d = h.shape
    return torch.matmul(h, w.reshape(d, -1)).view(B, S, *w.shape[1:])


def lora_delta(lora, name: str, x):
    """Low-rank delta ``scale * (x @ A) @ B`` for one target matmul, or
    None when the adapter carries no factors for ``name``
    (``ray_tpu/models/gpt.py:lora_delta``).

    Two modes, told apart by ``ids``:

    - **single adapter** (training): ``<name>_a`` [in, r] and
      ``<name>_b`` [r, out] shared across the batch, a scalar
      ``scale``;
    - **banked** (serving): the factors carry a leading bank axis
      ([N, in, r] / [N, r, out], ``scale`` [N]) and ``ids`` [B] picks
      one bank slot per batch row, so co-batched tenants share one
      step.  Slot 0 is all zeros: base rows land on the base output.

    The rank-space products run in the activation dtype, as the base
    matmuls do; the f32 scale is applied last."""
    a = lora.get(name + "_a")
    if a is None:
        return None
    b = lora[name + "_b"]
    scale = lora["scale"]
    ids = lora.get("ids")
    if ids is None:
        t = torch.matmul(x, a.to(x.dtype))
        d = torch.matmul(t, b.to(x.dtype))
        scale = torch.as_tensor(scale, dtype=torch.float32,
                                device=x.device)
        return (d.float() * scale).to(x.dtype)
    av = a.index_select(0, ids).to(x.dtype)
    bv = b.index_select(0, ids).to(x.dtype)
    s = scale.index_select(0, ids).float()
    d = torch.bmm(torch.bmm(x, av), bv)
    return (d.float() * s[:, None, None]).to(x.dtype)


def _plus(y, delta):
    return y if delta is None else y + delta.reshape(y.shape)


def _col_delta(lora, name: str, x, sh: Optional["_Shards"]):
    """A column-parallel target's delta under tp: this rank's output
    columns of ``scale * (x @ A) @ B``, from the whole (replicated) A
    and its column slice of B.  Both factors enter through
    ``copy_to_group`` over tp: each rank's gradient is its columns'
    part (A's a partial sum, B's its slice), summed over tp into the
    whole, equal on every rank, as the reference's GSPMD step computes
    it for a replicated factor."""
    if lora is None or lora.get(name + "_a") is None:
        return None
    if sh is None or sh.tp is None:
        return lora_delta(lora, name, x)
    a = comm.copy_to_group(lora[name + "_a"], sh.tp)
    b = comm.copy_to_group(lora[name + "_b"], sh.tp)
    n = b.shape[-1] // sh.tp_size
    return lora_delta({name + "_a": a,
                       name + "_b": b[..., sh.tp_rank * n:
                                      (sh.tp_rank + 1) * n],
                       "scale": lora["scale"]}, name, x)


def _row_delta(lora, name: str, x, sh: Optional["_Shards"]):
    """A row-parallel target's delta under tp, whole on every rank: the
    input ``x`` holds this rank's rows (heads or ``mlp`` columns), so
    ``x @ A[rows]`` is this rank's partial of ``x @ A``, summed over tp
    (``reduce_from_group``: its gradient is the whole rank-space
    gradient on every rank) before ``@ B``.  A enters through
    ``copy_to_group`` (each rank's gradient is its rows', summed into
    the whole); B's gradient is whole on every rank as it is.  The
    caller adds the delta after the base output's tp sum."""
    if lora is None or lora.get(name + "_a") is None:
        return None
    if sh is None or sh.tp is None:
        return lora_delta(lora, name, x)
    a = comm.copy_to_group(lora[name + "_a"], sh.tp)
    n = a.shape[0] // sh.tp_size
    t = comm.reduce_from_group(
        torch.matmul(x, a[sh.tp_rank * n:(sh.tp_rank + 1) * n].to(x.dtype)),
        sh.tp)
    d = torch.matmul(t, lora[name + "_b"].to(x.dtype))
    scale = torch.as_tensor(lora["scale"], dtype=torch.float32,
                            device=x.device)
    return (d.float() * scale).to(x.dtype)


def _after_sum(y, delta, bias):
    """A row-parallel output's tail, added once after its tp sum: the
    adapter's delta, then the bias (the reference's order)."""
    y = _plus(y, delta)
    return y if bias is None else y + bias


def _dense_ffn(lp, x, cfg: GPTConfig, lora=None, sh=None):
    """The SwiGLU or gelu FFN -> (output, the w2 delta or None): under
    tp the output is this rank's partial, and the caller adds the delta
    and ``b2`` after the sum (:func:`_after_sum`); unsharded they are
    already in it.  The column-parallel biases ``b1``/``b3`` hold this
    rank's ``mlp`` columns."""
    h = torch.matmul(x, lp["w1"])
    if lora is not None:
        h = _plus(h, _col_delta(lora, "w1", x, sh))
    if "b1" in lp:
        h = h + lp["b1"]
    if cfg.act == "swiglu":
        g = torch.matmul(x, lp["w3"])
        if lora is not None:
            g = _plus(g, _col_delta(lora, "w3", x, sh))
        if "b3" in lp:
            g = g + lp["b3"]
        a = F.silu(h) * g
    else:
        a = _gelu(h)
    out = torch.matmul(a, lp["w2"])
    delta = None if lora is None else _row_delta(lora, "w2", a, sh)
    if _tp_group(sh) is None:
        return _after_sum(out, delta, lp.get("b2")), None
    return out, delta


def _swiglu_experts(w1w3, w2, tokens):
    """The reference's silu-gated expert FFN (``gpt.py:_moe_ffn``): w3
    folded into w1 by concatenation, tokens [E, C, d] -> [E, C, d]."""
    h = torch.einsum("ecd,edh->ech", tokens, w1w3)
    a, b = h.chunk(2, dim=-1)
    return torch.einsum("ech,ehd->ecd", F.silu(a) * b, w2)


def _gelu_experts(w1, w2, tokens):
    """The reference's default expert FFN (``parallel/moe.py:
    _expert_ffn``), for ``act="gelu"``."""
    h = torch.einsum("ecd,edh->ech", tokens, w1)
    return torch.einsum("ech,ehd->ecd", _gelu(h), w2)


def _moe_ffn(lp, x, cfg: GPTConfig, *, mesh=None):
    """The MoE FFN (``ray_tpu/models/gpt.py:_moe_ffn``): x [B, S, d] ->
    (out [B, S, d] in x's dtype, aux).

    Routing is the reference's GSPMD step's: over the global batch, in
    batch order (``moe.ShardedTokenOrder`` over the mesh's data axes and
    sp, whose ranks hold distinct tokens; capacity, priority and the
    aux loss's means global).  Every rank computes the router on its
    tokens.  Under ``ep`` each rank runs its shard of the experts and
    the outputs are summed over ep; under ``tp`` each expert's hidden
    dimension is split (Megatron within the expert).  Gradient
    convention: the expert path's input enters through
    ``copy_to_group`` over tp and ep (its gradient is partial there);
    the router's gate values through ``copy_to_group`` over ep (each ep
    rank combines only its experts' outputs), while its aux-loss path
    is whole on every rank and is not summed; the router weight's
    gradient is then whole on every ep and tp rank."""
    B, S, d = x.shape
    g = mesh_groups(mesh)
    tp = g.tp if g.size("tp") > 1 else None
    ep = g.ep if g.size("ep") > 1 else None
    n_tok = comm.group_size(g.count)
    if n_tok > 1:
        order = moe.ShardedTokenOrder(g.count, rows=B, width=S,
                                      seq_shards=g.size("sp"),
                                      num_tokens=B * S * n_tok)
    else:
        order = moe.TokenOrder(B * S)
    E, k = cfg.n_experts, cfg.moe_top_k
    cap = moe.capacity(order.num_tokens, E, k, cfg.moe_capacity_factor)
    flat = x.reshape(B * S, d)
    dispatch, combine, aux = moe.route(flat, lp["moe_wg"], k, cap, order,
                                       gate_group=ep)
    E_local = lp["moe_w1"].shape[0]
    lo = g.coord("ep") * E_local
    tokens = comm.copy_to_group(comm.copy_to_group(flat, tp), ep)
    expert_in = torch.einsum("tec,td->ecd", dispatch[:, lo:lo + E_local],
                             tokens.float())
    if cfg.act == "swiglu":
        w1w3 = torch.cat([lp["moe_w1"], lp["moe_w3"]], dim=-1).float()
        local = _swiglu_experts(w1w3, lp["moe_w2"].float(), expert_in)
    else:
        local = _gelu_experts(lp["moe_w1"].float(), lp["moe_w2"].float(),
                              expert_in)
    expert_out = comm.reduce_from_group(local, tp)
    out = torch.einsum("tec,ecd->td", combine[:, lo:lo + E_local],
                       expert_out)
    out = comm.reduce_from_group(out, ep)
    return out.to(x.dtype).reshape(B, S, d), aux


def layer_apply(lp, x, cfg: GPTConfig, *, positions, attn_fn: Callable,
                cache=None, fuse_norm: Optional[bool] = None, mesh=None,
                lora=None):
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
    the JAX package does.

    On a ``mesh`` that shards the model, ``lp`` holds this rank's shards:
    fsdp-sharded weights are all-gathered here (``_gather_layer``), and
    under tp the block is Megatron's: q/k/v and w1/w3 column-parallel
    over the rank's heads and ``mlp`` columns (their input's gradient
    summed over tp), wo and w2 row-parallel with their outputs summed
    over tp before each residual add, where GSPMD puts the reference's
    collectives.  The fused epilogue declines under tp, as the
    reference's gate declines a sharded mesh: the tp sum sits between
    the matmul and the residual add.  With biases (``use_bias``) the
    column-parallel ``bq``/``bk``/``bv``/``b1``/``b3`` hold this rank's
    heads and columns, and the row-parallel ``bo``/``b2`` are added once,
    after the tp sum, as GSPMD places them; the epilogue declines a
    layer with biases or LayerNorm.

    ``lora``: this layer's low-rank adapter factors (:func:`lora_delta`'s
    layout, single or banked) added to the q/k/v, out-proj and MLP
    matmul outputs before RoPE, so the block equals the base block over
    the merged weights ``W + scale * A @ B``.  An active ``lora``
    declines the fused out-proj epilogue (the kernel folds the wo
    matmul, which would skip the wo delta), as the reference's does; a
    ``lora`` on an MoE config raises as the reference's does.  On a mesh
    that shards the model the factors are whole on every rank (the
    reference replicates them): fsdp gathers only the base weights, and
    under tp the column-parallel targets add this rank's columns of the
    delta (:func:`_col_delta`) and the row-parallel ones their delta
    after the tp sum (:func:`_row_delta`); a banked adapter there
    raises."""
    eps = norm_eps(cfg)
    B, S, d = x.shape
    sh = _shards(mesh)
    if lora is not None:
        if cfg.n_experts > 0:
            raise ValueError("LoRA adapters are dense-FFN only "
                             "(see adapters.lora.effective_targets)")
        if sh is not None and lora.get("ids") is not None:
            raise ValueError("a banked adapter (ids=) runs on an unsharded "
                             "model; a sharded mesh takes one adapter")
    if sh is not None:
        lp = _gather_layer(lp, sh)
    tp = _tp_group(sh)
    h = comm.copy_to_group(
        _norm(x, lp["ln1"], cfg.norm, bias=lp.get("ln1_b"), eps=eps), tp)
    q = _proj_heads(h, lp["wq"])
    k = _proj_heads(h, lp["wk"])
    v = _proj_heads(h, lp["wv"])
    if lora is not None:
        q = _plus(q, _col_delta(lora, "wq", h, sh))
        k = _plus(k, _col_delta(lora, "wk", h, sh))
        v = _plus(v, _col_delta(lora, "wv", h, sh))
    if "bq" in lp:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    fused_rope = cfg.pos == "rope" and getattr(attn_fn, "fused_rope", False)
    if cfg.pos == "rope" and not fused_rope:
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
    plan = lora is None and fnorm.out_proj_norm_plan(
        B * S, Hn * hd, d, norm=cfg.norm,
        has_bias="bo" in lp or "ln2_b" in lp, seq=S,
        enabled=fuse_norm is not False,
        tp_size=1 if sh is None else sh.tp_size, device=x.device)
    if plan:
        # out-proj + residual add + pre-FFN norm in one kernel
        r2, y2 = fnorm.matmul_residual_norm(
            attn.reshape(B * S, Hn * hd), lp["wo"].reshape(Hn * hd, d),
            x.reshape(B * S, d), lp["ln2"], eps=eps)
        x = r2.view(B, S, d)
        h2 = y2.view(B, S, d)
    else:
        a2 = attn.reshape(B, S, Hn * hd)
        proj = torch.matmul(a2, lp["wo"].reshape(Hn * hd, d))
        # the row-parallel tail (delta, bo) once, after the tp sum
        x = x + _after_sum(comm.reduce_from_group(proj, tp),
                           _row_delta(lora, "wo", a2, sh), lp.get("bo"))
        h2 = _norm(x, lp["ln2"], cfg.norm, bias=lp.get("ln2_b"), eps=eps)
    if cfg.n_experts > 0:
        ffn_out, aux = _moe_ffn(lp, h2, cfg, mesh=mesh)
        x = x + ffn_out
    else:
        ffn_out, delta = _dense_ffn(lp, comm.copy_to_group(h2, tp), cfg,
                                    lora=lora, sh=sh)
        if tp is not None:
            ffn_out = _after_sum(comm.reduce_from_group(ffn_out, tp), delta,
                                 lp.get("b2"))
        x = x + ffn_out
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is not None:
        return x, aux, cache
    return x, aux


def embed_tokens(params: Params, tokens, cfg: GPTConfig, *, mesh=None,
                 positions=None):
    """tokens [B, S] -> hidden [B, S, d] in the model dtype.

    On a mesh the table's d_model is all-gathered over fsdp, and under
    tp the lookup is vocab-parallel: each rank looks up the tokens its
    vocabulary rows hold, zeros elsewhere, summed over tp.  With learned
    positions the ``pos_embed`` rows of ``positions`` ([S] shared by the
    rows or [B, S] per row, absolute; default ``arange(S)``) are added
    after that sum, the table gathered over fsdp; a position past
    ``max_seq`` takes the last row, as JAX's clamped gather does."""
    sh = _shards(mesh)
    if sh is None:
        x = params["embed"].to(cfg.dtype)[tokens]
    else:
        table = comm.all_gather_dim(params["embed"], 1, sh.fsdp).to(cfg.dtype)
        if sh.tp is None:
            x = table[tokens]
        else:
            V = table.shape[0]
            local = tokens - sh.tp_rank * V
            hit = (local >= 0) & (local < V)
            x = torch.where(hit[..., None], table[local.clamp(0, V - 1)], 0.0)
            x = comm.reduce_from_group(x, sh.tp)
    if cfg.pos != "learned":
        return x
    pos = params["pos_embed"]
    if sh is not None:
        pos = comm.all_gather_dim(pos, 1, sh.fsdp)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    return x + pos.to(cfg.dtype)[positions.clamp(0, cfg.max_seq - 1)]


def _with_segments(attn_fn: Callable, segment_ids) -> Callable:
    """``attn_fn`` with ``segment_ids`` closed over, keeping the
    ``fused_rope`` mark ``layer_apply`` dispatches on
    (``gpt.py:_with_segments``).  Every attention hook of the port
    (``local_attention``, ``flash_attention`` and the
    ``make_flash_attention_fn`` wrappers) takes the keyword and runs
    ``ops.attention.segment_attention`` for it."""
    fn = functools.partial(attn_fn, segment_ids=segment_ids)
    fn.fused_rope = getattr(attn_fn, "fused_rope", False)
    return fn


def forward_hidden(params: Params, tokens, cfg: GPTConfig, *,
                   attn_fn: Optional[Callable] = None,
                   fuse_norm: Optional[bool] = None,
                   final_norm: bool = True, positions=None, mesh=None,
                   segment_ids=None, lora=None):
    """tokens [B, S] int -> (final hidden [B, S, d], aux).

    ``attn_fn(q, k, v) -> out`` defaults to causal ``local_attention``
    (as in the JAX package); the engine passes ``flash_attention`` and
    the trainer ``make_flash_attention_fn``.  ``fuse_norm`` pins the
    out-proj epilogue; ``final_norm=False`` skips the closing ``ln_f``
    and returns the raw residual stream (for the fused-norm CE).
    ``mesh``: ``params`` are this rank's shards on it (``layer_apply``);
    ``tokens`` and ``positions`` are this rank's rows and, under sp, its
    sequence shard with that shard's global positions.

    ``segment_ids``/``positions`` [B, S] carry a sample-packed batch
    (``data.SamplePacker``): attention masks block-diagonally per
    segment and RoPE or the learned positions restart at every document
    start, so the packed forward equals the per-document unpacked one.

    ``lora``: one adapter's stacked factors ([L, in, r] / [L, r, out]
    per target, and a scalar ``scale``) applied to every adapted matmul,
    the trainable-adapter forward of ``models/training.py`` over a
    frozen base."""
    S = tokens.shape[1]
    if attn_fn is None:
        attn_fn = functools.partial(local_attention, causal=True)
    if segment_ids is not None:
        if positions is None:
            # arange positions across packed documents would break the
            # packed == per-document parity: RoPE restarts per document
            raise ValueError(
                "segment_ids without positions: a packed batch needs "
                "its per-document positions (SamplePacker emits both)")
        attn_fn = _with_segments(attn_fn, segment_ids)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(params, tokens, cfg, mesh=mesh, positions=positions)
    x, aux_total = run_layers(params["layers"], x, cfg, positions=positions,
                              attn_fn=attn_fn, fuse_norm=fuse_norm,
                              mesh=mesh, lora=lora)
    if final_norm:
        x = _norm(x, params["ln_f"], cfg.norm, bias=params.get("ln_f_b"),
                  eps=norm_eps(cfg))
    return x, aux_total


def run_layers(layers: Params, x, cfg: GPTConfig, *, positions,
               attn_fn: Callable, fuse_norm: Optional[bool] = None,
               mesh=None, lora=None):
    """The blocks of a stacked layer tree (leaves ``[n, ...]``, any n:
    the whole model, or a pipeline stage's slice) over the hidden ``x``
    in order -> (hidden, summed aux); each block is recomputed in the
    backward under ``cfg.remat``.  ``lora``'s stacked factors (leading
    ``n``) go layer by layer beside the weights; its scale is shared."""
    def block(lp, la, x):
        layer_lora = None if la is None else {**la, "scale": lora["scale"]}
        return layer_apply(lp, x, cfg, positions=positions,
                           attn_fn=attn_fn, fuse_norm=fuse_norm, mesh=mesh,
                           lora=layer_lora)

    if cfg.remat and torch.is_grad_enabled():
        block = _remat(block)
    factors = None if lora is None else {
        k: v for k, v in lora.items() if k != "scale"}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(next(iter(layers.values())).shape[0]):
        la = None if factors is None else {k: v[i]
                                           for k, v in factors.items()}
        x, aux = block({k: v[i] for k, v in layers.items()}, la, x)
        aux_total = aux_total + aux
    return x, aux_total


def _remat(block: Callable) -> Callable:
    """``block`` under ``torch.utils.checkpoint`` (non-reentrant), the
    counterpart of the reference's ``jax.checkpoint(layer_body)``
    (``ray_tpu/models/gpt.py:595-596``): the block keeps only its
    inputs, and the backward runs its forward again, kernels included,
    rebuilding what the kernels' Functions save (attention's o and lse,
    the epilogue's statistics).  The recompute takes the forward's
    kernel path: the attention hook and ``fuse_norm`` are the same
    objects, and ``_PALLAS_NORM`` is pinned to its value at the
    forward."""
    pallas = _PALLAS_NORM

    def pinned(*args):
        global _PALLAS_NORM
        saved, _PALLAS_NORM = _PALLAS_NORM, pallas
        try:
            return block(*args)
        finally:
            _PALLAS_NORM = saved

    def run(*args):
        return torch.utils.checkpoint.checkpoint(pinned, *args,
                                                 use_reentrant=False)

    return run


def lm_head(params: Params, cfg: GPTConfig, *, mesh=None):
    """The output projection [d, V]: the tied embedding's transpose, or
    the untied ``lm_head`` leaf (on a mesh: d gathered over fsdp, this
    rank's vocabulary columns under tp)."""
    sh = _shards(mesh)
    if not cfg.tie_embeddings:
        head = params["lm_head"]
        if sh is not None:
            head = comm.all_gather_dim(head, 0, sh.fsdp)
        return head.to(cfg.dtype)
    if sh is None:
        return params["embed"].to(cfg.dtype).T
    return comm.all_gather_dim(params["embed"], 1, sh.fsdp).to(cfg.dtype).T


def forward(params: Params, tokens, cfg: GPTConfig, *,
            attn_fn: Optional[Callable] = None,
            fuse_norm: Optional[bool] = None, positions=None, mesh=None,
            segment_ids=None, lora=None):
    """tokens [B, S] int -> (logits [B, S, V] f32, aux); under tp each
    rank's vocabulary columns are all-gathered into the full V."""
    x, aux = forward_hidden(params, tokens, cfg, attn_fn=attn_fn,
                            fuse_norm=fuse_norm, positions=positions,
                            mesh=mesh, segment_ids=segment_ids, lora=lora)
    tp = _tp_group(_shards(mesh))
    logits = torch.matmul(comm.copy_to_group(x, tp),
                          lm_head(params, cfg, mesh=mesh))
    return comm.all_gather_dim(logits.float(), 2, tp), aux


def loss_from_hidden(params: Params, x, targets, cfg: GPTConfig, *,
                     ce_mode: Optional[str] = None, norm_scale=None,
                     mesh=None):
    """(final hidden [B, S, d], targets [B, S]) -> mean NLL over the live
    (non ``-1``) targets.

    ``norm_scale``: when given, ``x`` is the raw residual stream (before
    ``ln_f``) and the norm fuses into the flash-CE prologue
    (``flash_ce.flash_ce_norm_sum``); if that gate declines, the norm
    runs here and the regular CE dispatch follows.  Under tp the head
    is vocab-sharded and the CE vocab-parallel (:func:`_vocab_parallel_ce`),
    as the reference's flash-CE declines a sharded head
    (``ray_tpu/models/gpt.py:667``)."""
    B, S, d = x.shape
    sh = _shards(mesh)
    if sh is not None and sh.tp is not None:
        if norm_scale is not None:
            x = _norm(x, norm_scale, cfg.norm, bias=params.get("ln_f_b"),
                      eps=norm_eps(cfg))
        s, n = _vocab_parallel_ce(x.reshape(B * S, d),
                                  lm_head(params, cfg, mesh=mesh),
                                  targets.reshape(B * S), sh,
                                  chunk=cfg.ce_chunk)
        return s / n.clamp_min(1.0)
    if norm_scale is not None:
        if flash_ce.uses_flash_ce_norm(
                B * S, d, cfg.vocab_size, mode=ce_mode or "flash",
                norm=cfg.norm, has_bias=cfg.use_bias, enabled=True,
                device=x.device, dtype=x.dtype):
            s, n = flash_ce.flash_ce_norm_sum(
                x.reshape(B * S, d), lm_head(params, cfg, mesh=mesh),
                targets.reshape(B * S), norm_scale, eps=norm_eps(cfg))
            return s / n.clamp_min(1.0)
        x = _norm(x, norm_scale, cfg.norm, bias=params.get("ln_f_b"),
                  eps=norm_eps(cfg))
    s, n = _chunked_ce(x.reshape(B * S, d), lm_head(params, cfg, mesh=mesh),
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
    (no-remat, ``chunk < 0``, only; else the ``xla`` paths) keeps the
    logits in bf16 between the passes (``ops/fused_ce.py``)."""
    N, d = x.shape
    mode = mode or "flash"
    if mode == "flash" and flash_ce.supports(N, d, head.shape[1],
                                             device=x.device, dtype=x.dtype):
        return flash_ce.flash_ce_sum(x, head.to(x.dtype), targets)
    if chunk < 0 and mode == "fused":
        return fused_ce.ce_sum_bf16(x, head.to(x.dtype), targets)

    def chunk_loss(xc, tc):
        logits = torch.matmul(xc.float(), head.float())
        lse = torch.logsumexp(logits, -1)
        true = logits.gather(1, tc.clamp_min(0).long()[:, None])[:, 0]
        mask = (tc >= 0).float()
        return ((lse - true) * mask).sum(), mask.sum()

    return _rows_remat(chunk_loss, x, targets, chunk)


def _rows_remat(chunk_loss: Callable, x, targets, chunk: int):
    """(sum, count) of ``chunk_loss`` over row chunks of ``chunk``
    (``chunk < 0``: one chunk, kept for the backward; ``chunk >= 0``:
    each chunk recomputed in the backward)."""
    remat = chunk >= 0
    N = x.shape[0]
    if chunk <= 0:
        chunk = N

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


def _vocab_parallel_ce(x, head, targets, sh: _Shards, *, chunk: int):
    """x [N, d] (the same on every tp rank), head [d, V/tp] (this rank's
    vocabulary columns), targets [N] -> (sum_nll, n_valid), the same on
    every tp rank: the row max, the sum of exponentials and the target
    logit are each reduced over tp, and the gradient of x is summed over
    tp (``comm.copy_to_group``)."""
    Vl = head.shape[1]
    lo = sh.tp_rank * Vl
    x = comm.copy_to_group(x, sh.tp)

    def chunk_loss(xc, tc):
        logits = torch.matmul(xc.float(), head.float())
        m = comm.all_reduce_max(logits.detach().amax(-1), sh.tp)
        se = comm.reduce_from_group(
            torch.exp(logits - m[:, None]).sum(-1), sh.tp)
        local = tc.long() - lo
        hit = (tc >= 0) & (local >= 0) & (local < Vl)
        picked = logits.gather(1, local.clamp(0, Vl - 1)[:, None])[:, 0]
        true = comm.reduce_from_group(torch.where(hit, picked, 0.0), sh.tp)
        mask = (tc >= 0).float()
        return ((torch.log(se) + m - true) * mask).sum(), mask.sum()

    return _rows_remat(chunk_loss, x, targets, chunk)


def uses_ce_norm(cfg: GPTConfig, n_rows: int, device, *,
                 ce_mode: Optional[str] = None,
                 fuse_norm: Optional[bool] = None, mesh=None) -> bool:
    """Whether the loss over ``n_rows`` hidden rows folds ``ln_f`` into
    the flash-CE prologue (no tp split of the head, and the gate takes
    the shape)."""
    return _tp_group(_shards(mesh)) is None and \
        flash_ce.uses_flash_ce_norm(
            n_rows, cfg.d_model, cfg.vocab_size, mode=ce_mode or "flash",
            norm=cfg.norm, has_bias=cfg.use_bias,
            enabled=fuse_norm is not False, device=device, dtype=cfg.dtype)


def loss_fn(params: Params, batch, cfg: GPTConfig, *,
            attn_fn: Optional[Callable] = None, aux_weight: float = 0.01,
            ce_mode: Optional[str] = None,
            fuse_norm: Optional[bool] = None, mesh=None, lora=None):
    """batch: dict(tokens [B, S], targets [B, S]) -> scalar loss.

    ``fuse_norm`` (None means on) pins the fused norm epilogues: the
    per-layer out-proj epilogue, and, when the flash-CE-with-norm gate
    passes, ``ln_f`` folded into the vocab-matmul kernel's prologue
    instead of running here.

    A sample-packed batch also carries ``segment_ids`` and ``positions``
    [B, S] (``ray_tpu_torch.data``): attention masks block-diagonally
    and positions restart per document; the packer's ``targets``
    already mask document ends and padding with ``-1``.  ``lora``: a
    single adapter's factors over these (frozen) ``params``
    (:func:`forward_hidden`)."""
    B, S = batch["tokens"].shape
    ce_norm = uses_ce_norm(cfg, B * S, batch["tokens"].device,
                           ce_mode=ce_mode, fuse_norm=fuse_norm, mesh=mesh)
    x, aux = forward_hidden(params, batch["tokens"], cfg, attn_fn=attn_fn,
                            fuse_norm=fuse_norm, final_norm=not ce_norm,
                            positions=batch.get("positions"), mesh=mesh,
                            segment_ids=batch.get("segment_ids"), lora=lora)
    loss = loss_from_hidden(params, x, batch["targets"], cfg,
                            ce_mode=ce_mode,
                            norm_scale=params["ln_f"] if ce_norm else None,
                            mesh=mesh)
    return loss + aux_weight * aux


def num_params(params: Params) -> int:
    n = 0
    for v in params.values():
        n += num_params(v) if isinstance(v, dict) else v.numel()
    return n
