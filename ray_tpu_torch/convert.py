"""State from the JAX package into the port and back.

The JAX package's parameter tree (``ray_tpu.models.gpt.init_params``),
handed over as numpy arrays, becomes the port's tree of tensors with the
same keys and shapes; a KV handoff or a spill entry of its KV cache
becomes the port's (host data: numpy, or CPU tensors for bf16), and the
port's go back as numpy.  bf16 arrays arrive as ``ml_dtypes`` bfloat16
numpy arrays; they cross through a 16-bit integer view, bit for bit, so
neither ``jax`` nor ``ml_dtypes`` is imported here: the way back returns
that view, or the caller's bf16 dtype (``bf16_dtype=``) over it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.inference import kv_cache as kvc

from ray_tpu_torch.models.gpt import GPTConfig, check_supported
from ray_tpu_torch.ops.substrate import resolve_device


def array_to_tensor(arr, device) -> torch.Tensor:
    """One numpy (or array-like) leaf -> tensor, bf16 bit-exact."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree: Dict[str, Any], cfg: GPTConfig,
                    device=None) -> Dict[str, Any]:
    """The JAX package's GPT parameter tree (numpy leaves) -> the port's.

    Checks the tree against ``cfg``: every leaf must carry the model
    dtype, and the embedding and stacked attention weights must have the
    shapes ``cfg`` implies."""
    check_supported(cfg)
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = array_to_tensor(node, dev)
        if t.dtype != cfg.dtype:
            raise ValueError(f"parameter of dtype {t.dtype} in a tree "
                             f"for a {cfg.dtype} model")
        return t

    out = convert(tree)
    d, H, hd, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_layers
    want = {("embed",): (cfg.vocab_size, d),
            ("layers", "wq"): (L, d, H, hd),
            ("layers", "wo"): (L, H, hd, d),
            ("ln_f",): (d,)}
    for path, shape in want.items():
        node = out
        for key in path:
            node = node[key]
        if tuple(node.shape) != shape:
            raise ValueError(f"{'/'.join(path)} has shape "
                             f"{tuple(node.shape)}, expected {shape}")
    return out


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse direction of :func:`params_from_jax`: the port's tree
    of tensors -> the same tree of numpy arrays on the host, so a test can
    hold post-step parameters against the JAX package's leaf by leaf.
    bf16 leaves come back as f32 (exact: every bf16 value is an f32
    value), since numpy has no bf16."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {k: params_to_numpy(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def _host_from_jax(a):
    """One host array of the JAX package -> the port's host form: numpy,
    or a CPU bf16 tensor (bit for bit) for an ``ml_dtypes`` bf16
    array."""
    return None if a is None else kvc._to_host(array_to_tensor(a, "cpu"))


def _host_to_numpy(a, bf16_dtype):
    """The inverse of :func:`_host_from_jax`: a bf16 tensor comes back
    as its int16 view, viewed as ``bf16_dtype`` when one is given."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.bfloat16:
            return a.detach().cpu().numpy().copy()
        bits = a.detach().cpu().contiguous().view(torch.int16).numpy()
        return bits.view(bf16_dtype) if bf16_dtype is not None \
            else bits.copy()
    return np.array(a, copy=True)


_HANDOFF_ARRAYS = ("k", "v", "k_scale", "v_scale")


def handoff_from_jax(h) -> kvc.KVHandoff:
    """The JAX package's ``KVHandoff`` (numpy leaves) -> the port's, with
    every field carried over; its ``dtype`` name already is the one the
    port writes."""
    fields = {f.name: getattr(h, f.name)
              for f in dataclasses.fields(kvc.KVHandoff)}
    for name in _HANDOFF_ARRAYS:
        fields[name] = _host_from_jax(fields[name])
    fields["context"] = [int(t) for t in fields["context"]]
    fields["chain_hashes"] = list(fields["chain_hashes"])
    if fields["present"] is not None:
        fields["present"] = list(fields["present"])
    return kvc.KVHandoff(**fields)


def handoff_to_numpy(h: kvc.KVHandoff,
                     bf16_dtype: Optional[np.dtype] = None
                     ) -> Dict[str, Any]:
    """The port's ``KVHandoff`` -> its fields with numpy arrays, the
    keyword arguments of the JAX package's ``KVHandoff``.  bf16 contents
    come back as their int16 bits, or as ``bf16_dtype`` (e.g. the JAX
    package's ``jnp.bfloat16``) viewed over them."""
    fields = {f.name: getattr(h, f.name)
              for f in dataclasses.fields(kvc.KVHandoff)}
    for name in _HANDOFF_ARRAYS:
        fields[name] = _host_to_numpy(fields[name], bf16_dtype)
    return fields


def spill_entry_from_jax(entry: Dict[str, Any]) -> Dict[str, Any]:
    """One spill entry of the JAX package's tiered cache -> the port's."""
    return {k: v if k == "fmt" else _host_from_jax(v)
            for k, v in entry.items()}


def spill_entry_to_numpy(entry: Dict[str, Any],
                         bf16_dtype: Optional[np.dtype] = None
                         ) -> Dict[str, Any]:
    """One spill entry of the port's -> numpy arrays, as
    :func:`handoff_to_numpy` converts them."""
    return {k: v if k == "fmt" else _host_to_numpy(v, bf16_dtype)
            for k, v in entry.items()}
