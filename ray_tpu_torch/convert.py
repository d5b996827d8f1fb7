"""State from the JAX package into the port and back.

The JAX package's parameter tree (``ray_tpu.models.gpt.init_params``),
handed over as numpy arrays, becomes the port's tree of tensors with the
same keys and shapes (flax's ResNet and MLP trees too, in the port's
layouts: ``resnet_params_from_flax``, ``mlp_params_from_flax``); a KV
handoff or a spill entry of its KV cache becomes the port's (host data:
numpy, or CPU tensors for bf16), and the port's go back as numpy.  bf16
arrays arrive as ``ml_dtypes`` bfloat16 numpy arrays; they cross
through a 16-bit integer view, bit for bit, so neither ``jax`` nor
``ml_dtypes`` is imported here: the way back returns that view, or the
caller's bf16 dtype (``bf16_dtype=``) over it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.inference import kv_cache as kvc

from ray_tpu_torch.models.gpt import GPTConfig, param_logical_axes
from ray_tpu_torch.ops.substrate import resolve_device
from ray_tpu_torch.parallel.sharding import (pp_rules, shard_params,
                                             stage_stacked_axes)


def array_to_tensor(arr, device) -> torch.Tensor:
    """One numpy (or array-like) leaf -> tensor, bf16 bit-exact."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree: Dict[str, Any], cfg: GPTConfig,
                    device=None, *, mesh=None,
                    stage_axis: Optional[str] = None) -> Dict[str, Any]:
    """The JAX package's GPT parameter tree (numpy leaves) -> the port's.

    Checks the tree against ``cfg``: every leaf must carry the model
    dtype, and the embedding and stacked attention weights must have the
    shapes ``cfg`` implies (the MoE leaves ride along as they are).  With
    ``mesh``, returns this rank's shards (``parallel.sharding.
    shard_params`` by the model's logical axes): the part of each leaf
    that JAX device r holds on the same mesh shape lands on rank r.

    A stage-stacked tree (``build_gpt_train_pp``'s ``init_fn``: layer
    leaves ``[stages, L / stages, ...]``) is taken as well; with ``mesh``
    each rank gets its stage's slice (``[1, L / stages, ...]``) and its
    shards of it, the stage over ``stage_axis`` (default ``pp`` when the
    mesh has it, else ``dcn``), as ``build_gpt_train_pp`` holds them."""
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
    stacked = out["layers"]["wq"].dim() == 5
    lead = tuple(out["layers"]["wq"].shape[:2]) if stacked else (L,)
    if stacked and lead[0] * lead[1] != L:
        raise ValueError(f"stage-stacked layers {lead} do not hold "
                         f"n_layers={L}")
    want = {("embed",): (cfg.vocab_size, d),
            ("layers", "wq"): lead + (d, H, hd),
            ("layers", "wo"): lead + (H, hd, d),
            ("ln_f",): (d,)}
    for path, shape in want.items():
        node = out
        for key in path:
            node = node[key]
        if tuple(node.shape) != shape:
            raise ValueError(f"{'/'.join(path)} has shape "
                             f"{tuple(node.shape)}, expected {shape}")
    if mesh is None:
        return out
    if not stacked:
        return shard_params(out, mesh, param_logical_axes(cfg))
    if stage_axis is None:
        stage_axis = "pp" if "pp" in dict(mesh.shape.items()) else "dcn"
    return shard_params(out, mesh,
                        stage_stacked_axes(param_logical_axes(cfg)),
                        pp_rules(stage_axis))


def resnet_params_from_flax(variables: Dict[str, Any], device=None
                            ) -> Dict[str, Any]:
    """A flax ``ResNet``'s ``{"params", "batch_stats"}`` (numpy leaves,
    ``ray_tpu/models/resnet.py``) -> ``models.resnet.ResNet``'s, the
    same names: each conv kernel from flax's HWIO to ``[out, in, kh,
    kw]``, the head's Dense ``[in, out]`` and every BatchNorm scale,
    bias, mean and variance as they are."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        a = np.asarray(node)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return array_to_tensor(a, dev)

    return {"params": convert(variables["params"]),
            "batch_stats": convert(variables.get("batch_stats", {}))}


def mlp_params_from_flax(params: Dict[str, Any], device=None
                         ) -> Dict[str, torch.Tensor]:
    """A flax ``MLP``'s params (``{"Dense_<i>": {"kernel" [in, out],
    "bias"}}``, numpy leaves) -> ``models.mlp.MLP``'s ``nn.Linear``
    state (``Dense_<i>.weight`` [out, in], ``Dense_<i>.bias``)."""
    dev = resolve_device(device)
    out = {}
    for name, layer in params.items():
        out[f"{name}.weight"] = array_to_tensor(
            np.asarray(layer["kernel"]).T, dev)
        out[f"{name}.bias"] = array_to_tensor(layer["bias"], dev)
    return out


def adapter_from_jax(tree: Dict[str, Any], cfg: GPTConfig, lcfg,
                     device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's adapter tree (``adapters.lora.init_adapter``'s
    ``{"<t>_a": [L, in, r], "<t>_b": [L, r, out]}``, numpy leaves, a
    ``scale`` leaf allowed) -> the port's, bf16 bit-exact.  Every factor
    must be one the port's bank for ``(cfg, lcfg)`` carries, with its
    shape."""
    from ray_tpu_torch.adapters import lora as lora_mod
    dev = resolve_device(device)
    dims = lora_mod.target_dims(cfg)
    want = {}
    for t in lora_mod.effective_targets(cfg, lcfg):
        i, o = dims[t]
        want[f"{t}_a"] = (cfg.n_layers, i, lcfg.rank)
        want[f"{t}_b"] = (cfg.n_layers, lcfg.rank, o)
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        t = array_to_tensor(v, dev)
        if k != "scale" and tuple(t.shape) != want.get(k):
            raise ValueError(f"adapter factor {k!r} of shape "
                             f"{tuple(t.shape)} where the bank holds "
                             f"{want.get(k)}")
        out[k] = t
    return out


def bank_from_jax(bank: Dict[str, Any], device=None
                  ) -> Dict[str, torch.Tensor]:
    """The JAX package's adapter bank (``bank_zeros``/``bank_install``:
    ``[N, L, in, r]``/``[N, L, r, out]`` factors and an f32 ``scale``
    [N], numpy leaves) -> the port's bank, bf16 bit-exact."""
    dev = resolve_device(device)
    return {k: array_to_tensor(v, dev) for k, v in bank.items()}


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse direction of :func:`params_from_jax`: the port's tree
    of tensors -> the same tree of numpy arrays on the host, so a test can
    hold post-step parameters against the JAX package's leaf by leaf.
    bf16 leaves come back as f32 (exact: every bf16 value is an f32
    value), since numpy has no bf16.  A pipeline's shards are put back
    together first by ``build_gpt_train_pp``'s ``gather_params`` (the
    stage-stacked tree); :func:`fold_stages` then gives the layer
    leaves ``[L, ...]``."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {k: params_to_numpy(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def rl_state_from_jax(host_state, cfg: GPTConfig, device=None):
    """The JAX package's RL learner state (``InProcessLearner.
    state_host()``: ``TrainState(params, opt_state, step)`` with numpy
    leaves, ``opt_state`` optax's ``clip_by_global_norm -> adam`` chain,
    whose one ``ScaleByAdamState(count, mu, nu)`` holds the moments) ->
    the port learner's ``TrainState(params, AdamWState(count, mu, nu),
    step)``, bf16 bit-exact, for ``InProcessLearner.load_state``: the
    port then takes the step the reference would take next.  A full
    model's params are checked against ``cfg`` (:func:`params_from_jax`);
    an adapter-only learner's factor tree is taken as it is."""
    from ray_tpu_torch.models.training import AdamWState, TrainState
    params, opt_state, step = host_state

    def find_adam(node):
        if all(hasattr(node, a) for a in ("count", "mu", "nu")):
            return node
        if isinstance(node, (list, tuple)):
            for child in node:
                got = find_adam(child)
                if got is not None:
                    return got
        return None

    adam = find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer "
                         "state: expected optax's clip_by_global_norm -> "
                         "adam chain")
    dev = resolve_device(device)

    def tree(t):
        if "embed" in t:
            return params_from_jax(t, cfg, dev)
        return {k: array_to_tensor(v, dev) for k, v in t.items()}

    return TrainState(tree(params),
                      AdamWState(int(np.asarray(adam.count)),
                                 tree(adam.mu), tree(adam.nu)),
                      int(np.asarray(step)))


def rl_module_params_from_jax(tree, device=None):
    """An rllib module's parameter tree from the JAX package
    (``ray_tpu.rllib.core.rl_module``'s ``init_params``: dicts and the
    trunk's list of ``{"w", "b"}`` layers, numpy leaves) -> the port
    module's, the same structure with tensor leaves, bit-exact.  A tuple
    (SAC's ``(actor, critic)`` pair) comes back as a tuple."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        return array_to_tensor(node, dev)

    return convert(tree)


def fold_stages(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A stage-stacked tree (layer leaves ``[stages, L / stages, ...]``,
    tensors or numpy arrays) -> layer leaves ``[L, ...]``."""
    out = dict(tree)
    out["layers"] = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                     for k, v in tree["layers"].items()}
    return out


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
