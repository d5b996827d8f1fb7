"""HF Transformers GPT-2 <-> the port's GPT parameter tree.

Counterpart of ``ray_tpu/train/huggingface/weights.py``.  ``port_gpt2``
maps ``GPT2LMHeadModel`` state (HF's ``Conv1D`` stores weights as ``[in,
out]``) onto the stacked ``[L, ...]`` tree of ``GPTConfig(use_bias=True,
norm="layernorm", act="gelu", pos="learned")``, an exact-architecture
match (``tests/test_torch_hf.py`` holds the logits against HF's).  The
leaves come back as numpy arrays, cheap to ship through the object
store; the trainer places them on the card in the model dtype.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.gpt import GPTConfig


def gpt2_config(hf_config, dtype=None, **overrides) -> GPTConfig:
    """The ``GPTConfig`` that matches an HF ``GPT2Config`` exactly (bf16
    unless ``dtype`` says otherwise)."""
    kw: Dict[str, Any] = dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.n_embd,
        n_layers=hf_config.n_layer,
        n_heads=hf_config.n_head,
        max_seq=hf_config.n_positions,
        norm="layernorm",
        act="gelu",
        pos="learned",
        use_bias=True,
        tie_embeddings=True,
        dtype=dtype or torch.bfloat16,
    )
    kw.update(overrides)
    return GPTConfig(**kw)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def port_gpt2(model_or_state, hf_config=None, dtype=None,
              **config_overrides) -> Tuple[GPTConfig, Dict[str, Any]]:
    """(``GPT2LMHeadModel`` or its state_dict, config) -> (``GPTConfig``,
    params with numpy leaves): ``c_attn`` split into the stacked
    ``wq``/``wk``/``wv`` ``[L, d, H, hd]`` and their biases ``[L, H,
    hd]``, ``c_proj`` into ``wo [L, H, hd, d]``."""
    if hf_config is None:
        hf_config = model_or_state.config
    state = (model_or_state if isinstance(model_or_state, dict)
             else model_or_state.state_dict())
    sd = {k.replace("transformer.", ""): _np(v) for k, v in state.items()}
    cfg = gpt2_config(hf_config, dtype=dtype, **config_overrides)
    d, H, hd, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_layers

    def stack(fmt: str, post=lambda a: a) -> np.ndarray:
        return np.stack([post(sd[fmt.format(i=i)]) for i in range(L)])

    qkv_w = stack("h.{i}.attn.c_attn.weight")          # [L, d, 3d]
    qkv_b = stack("h.{i}.attn.c_attn.bias")            # [L, 3d]
    wq, wk, wv = np.split(qkv_w, 3, axis=2)
    bq, bk, bv = np.split(qkv_b, 3, axis=1)
    layers = {
        "ln1": stack("h.{i}.ln_1.weight"),
        "ln1_b": stack("h.{i}.ln_1.bias"),
        "wq": wq.reshape(L, d, H, hd),
        "wk": wk.reshape(L, d, H, hd),
        "wv": wv.reshape(L, d, H, hd),
        "bq": bq.reshape(L, H, hd),
        "bk": bk.reshape(L, H, hd),
        "bv": bv.reshape(L, H, hd),
        "wo": stack("h.{i}.attn.c_proj.weight",
                    lambda a: a.reshape(H, hd, d)),
        "bo": stack("h.{i}.attn.c_proj.bias"),
        "ln2": stack("h.{i}.ln_2.weight"),
        "ln2_b": stack("h.{i}.ln_2.bias"),
        "w1": stack("h.{i}.mlp.c_fc.weight"),
        "b1": stack("h.{i}.mlp.c_fc.bias"),
        "w2": stack("h.{i}.mlp.c_proj.weight"),
        "b2": stack("h.{i}.mlp.c_proj.bias"),
    }
    params = {
        "embed": sd["wte.weight"],
        "pos_embed": sd["wpe.weight"],
        "layers": layers,
        "ln_f": sd["ln_f.weight"],
        "ln_f_b": sd["ln_f.bias"],
    }
    return cfg, params


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def export_gpt2(params: Dict[str, Any], hf_model) -> None:
    """Write the port's params (tensors or numpy leaves) back into an HF
    ``GPT2LMHeadModel`` in place: fine-tune on the card, hand back an HF
    checkpoint."""
    cfg = hf_model.config
    d, H = cfg.n_embd, cfg.n_head
    L = cfg.n_layer
    p = {k: _np(v).astype(np.float32) for k, v in _flatten(params).items()}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    sd = hf_model.state_dict()
    sd["transformer.wte.weight"].copy_(t(p["embed"]))
    sd["transformer.wpe.weight"].copy_(t(p["pos_embed"]))
    sd["transformer.ln_f.weight"].copy_(t(p["ln_f"]))
    sd["transformer.ln_f.bias"].copy_(t(p["ln_f_b"]))
    if "lm_head.weight" in sd:
        sd["lm_head.weight"].copy_(t(p["embed"]))
    for i in range(L):
        pre = f"transformer.h.{i}."
        qkv_w = np.concatenate([p[f"layers.{w}"][i].reshape(d, d)
                                for w in ("wq", "wk", "wv")], axis=1)
        qkv_b = np.concatenate([p[f"layers.{b}"][i].reshape(d)
                                for b in ("bq", "bk", "bv")])
        sd[pre + "attn.c_attn.weight"].copy_(t(qkv_w))
        sd[pre + "attn.c_attn.bias"].copy_(t(qkv_b))
        sd[pre + "attn.c_proj.weight"].copy_(
            t(p["layers.wo"][i].reshape(d, d)))
        for hf_name, ours in (("attn.c_proj.bias", "bo"),
                              ("ln_1.weight", "ln1"), ("ln_1.bias", "ln1_b"),
                              ("ln_2.weight", "ln2"), ("ln_2.bias", "ln2_b"),
                              ("mlp.c_fc.weight", "w1"),
                              ("mlp.c_fc.bias", "b1"),
                              ("mlp.c_proj.weight", "w2"),
                              ("mlp.c_proj.bias", "b2")):
            sd[pre + hf_name].copy_(t(p[f"layers.{ours}"][i]))


def load_model(model, dtype=None, **overrides
               ) -> Tuple[GPTConfig, Dict[str, Any]]:
    """An HF model instance, or a local checkpoint directory, ported by
    :func:`port_gpt2`.  A string that is not a directory resolves only
    from the local HF cache (``local_files_only``): nothing is
    downloaded."""
    if isinstance(model, (str, os.PathLike)):
        from transformers import GPT2LMHeadModel
        model = GPT2LMHeadModel.from_pretrained(
            os.fspath(model), local_files_only=True)
    return port_gpt2(model, dtype=dtype, **overrides)
