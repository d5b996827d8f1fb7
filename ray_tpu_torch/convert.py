"""Parameters from the JAX package into the port.

The JAX package's parameter tree (``ray_tpu.models.gpt.init_params``),
handed over as numpy arrays, becomes the port's tree of tensors with the
same keys and shapes.  bf16 leaves arrive as ``ml_dtypes`` bfloat16
numpy arrays; they cross through a 16-bit integer view, bit for bit, so
neither ``jax`` nor ``ml_dtypes`` is imported here.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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
