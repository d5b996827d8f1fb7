"""LoRA factor math: init, the merged-weights oracle, and the bank.

Counterpart of ``ray_tpu/adapters/lora.py``.  One adapter's layout
(host or device):

    {"<t>_a": [L, in_t, r], "<t>_b": [L, r, out_t]}   for t in targets

with every target a flattened 2-D matmul:

    target   in       out      stacked base weight
    wq/wk/wv d        H*hd     [L, d, H, hd]
    wo       H*hd     d        [L, H, hd, d]
    w1/w3    d        f        [L, d, f]
    w2       f        d        [L, f, d]

The engine's **bank** stacks ``N = cache_slots + 1`` adapters on a new
leading axis (``[N, L, in, r]`` / ``[N, L, r, out]``) beside a per-slot
f32 ``scale`` vector.  Slot 0 is all zeros with scale 0: the exact
identity every adapter-free request rides.  The bank is a dict of
tensors allocated once; :func:`bank_install` and :func:`bank_clear`
write one slot in place, so a hot load, an eviction or a republish
allocates nothing and the step functions read the same tensors.

``init_adapter`` draws from a ``torch.Generator``: the reference draws
from ``jax.random``, which torch cannot reproduce, so parity tests feed
the reference's factors through ``convert.adapter_from_jax``.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.adapters.config import LoraConfig
from ray_tpu_torch.ops.substrate import resolve_device


def effective_targets(cfg, lcfg: LoraConfig) -> Tuple[str, ...]:
    """``lcfg.targets`` minus targets the architecture doesn't have."""
    drop = set()
    if cfg.act != "swiglu":
        drop.add("w3")
    if cfg.n_experts > 0:
        raise ValueError("LoRA adapters are dense-FFN only (MoE layers "
                         "route tokens per-expert; a per-slot delta on "
                         "the expert matmuls is not yet supported)")
    return tuple(t for t in lcfg.targets if t not in drop)


def target_dims(cfg) -> Dict[str, Tuple[int, int]]:
    """``{target: (in_dim, out_dim)}`` in the flattened 2-D view."""
    d, hk, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.ff_dim
    dims = {"wq": (d, hk), "wk": (d, hk), "wv": (d, hk), "wo": (hk, d),
            "w1": (d, f), "w2": (f, d)}
    if cfg.act == "swiglu":
        dims["w3"] = (d, f)
    return dims


def init_adapter(cfg, lcfg: LoraConfig,
                 generator: Optional[torch.Generator] = None, *,
                 random_b: bool = False, dtype=None,
                 device=None) -> Dict[str, torch.Tensor]:
    """One adapter's factors, drawn from ``generator`` (target by
    target, A then B).  Standard LoRA init (A gaussian scaled by
    ``in ** -0.5``, B zeros: the fresh adapter is an exact no-op);
    ``random_b=True`` draws B too (``r ** -0.5``), a non-identity
    adapter for parity checks and benchmarks.  Drawn on the generator's
    device (the CPU for the default), then moved to ``device``: the card
    unless the caller passes another."""
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    L, r = cfg.n_layers, lcfg.rank
    gen_dev = generator.device if generator is not None else "cpu"
    out: Dict[str, torch.Tensor] = {}
    for t in effective_targets(cfg, lcfg):
        i, o = target_dims(cfg)[t]
        a = torch.randn((L, i, r), generator=generator, device=gen_dev)
        out[f"{t}_a"] = (a * i ** -0.5).to(dt)
        if random_b:
            b = torch.randn((L, r, o), generator=generator,
                            device=gen_dev) * r ** -0.5
        else:
            b = torch.zeros((L, r, o), device=gen_dev)
        out[f"{t}_b"] = b.to(dt)
    return {k: v.to(dev) for k, v in out.items()}


def merge_adapter(params: Dict[str, Any], adapter: Dict[str, Any],
                  cfg, *, scale: float = 1.0) -> Dict[str, Any]:
    """The parity oracle: new params with ``W += scale * A @ B`` folded
    into every adapted matmul (f32 accumulation, cast back to the
    param dtype).  An engine serving ``adapter`` must match an engine
    serving these merged weights."""
    layers = dict(params["layers"])
    for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
        a = adapter.get(f"{name}_a")
        if a is None or name not in layers:
            continue
        w = layers[name]
        a = torch.as_tensor(a).to(device=w.device, dtype=torch.float32)
        b = torch.as_tensor(adapter[f"{name}_b"]).to(
            device=w.device, dtype=torch.float32)
        delta = scale * torch.einsum("lir,lro->lio", a, b)
        layers[name] = (w.float() + delta.reshape(w.shape)).to(w.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


def bank_zeros(cfg, lcfg: LoraConfig, *, dtype=None,
               device=None) -> Dict[str, torch.Tensor]:
    """Fresh all-identity bank: every slot zeroed, scale 0, on the card
    unless the caller passes another device."""
    device = resolve_device(device)
    dt = dtype or cfg.dtype
    N, L, r = lcfg.bank_slots, cfg.n_layers, lcfg.rank
    bank = {"scale": torch.zeros((N,), dtype=torch.float32, device=device)}
    for t in effective_targets(cfg, lcfg):
        i, o = target_dims(cfg)[t]
        bank[f"{t}_a"] = torch.zeros((N, L, i, r), dtype=dt, device=device)
        bank[f"{t}_b"] = torch.zeros((N, L, r, o), dtype=dt, device=device)
    return bank


@torch.no_grad()
def bank_install(bank: Dict[str, torch.Tensor], slot: int,
                 adapter: Dict[str, Any], *,
                 scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Overwrite one bank slot with an adapter's factors, in place, and
    return the bank.  Targets absent from ``adapter`` are zeroed (the
    slot must not leak a previous tenant's factors)."""
    if slot <= 0:
        raise ValueError(f"bank slot {slot} is not writable (slot 0 is "
                         "the reserved identity)")
    for k, v in bank.items():
        if k == "scale":
            v[slot] = float(np.float32(scale))
            continue
        src = adapter.get(k)
        if src is None:
            v[slot].zero_()
        else:
            v[slot].copy_(torch.as_tensor(src).to(device=v.device,
                                                  dtype=v.dtype))
    return bank


def bank_mismatch(bank: Dict[str, Any], adapter: Any) -> Optional[str]:
    """Reason ``adapter``'s factors cannot install into ``bank`` (wrong
    rank, target set or layer dims), else None.

    The serving engine gates every store fetch through this before
    :func:`bank_install`: a tenant publishing factors of another
    geometry surfaces as a typed per-request ``AdapterUnavailableError``,
    not as a shape error escaping the replica's step loop.  Targets
    *absent* from the adapter are fine (the install zeroes them);
    targets the bank does not carry are a mismatch, since dropping them
    would part from the merged oracle."""
    if not isinstance(adapter, dict):
        return (f"payload is {type(adapter).__name__}, "
                "expected a factor dict")
    targets = tuple(k for k in bank if k != "scale")
    for k, v in adapter.items():
        if k == "scale":
            continue
        ref = bank.get(k)
        if ref is None:
            return (f"factor {k!r} has no matching bank target "
                    f"(bank carries {targets})")
        shape = tuple(getattr(v, "shape", None) or np.asarray(v).shape)
        row = tuple(ref.shape[1:])
        if shape != row:
            return (f"factor {k!r} shape {shape} != bank row "
                    f"shape {row}")
    return None


@torch.no_grad()
def bank_clear(bank: Dict[str, torch.Tensor],
               slot: int) -> Dict[str, torch.Tensor]:
    """Zero a slot back to identity (evict without replacement), in
    place."""
    for v in bank.values():
        v[slot] = 0
    return bank


def adapter_nbytes(adapter: Dict[str, Any]) -> int:
    """Publish payload size: the rank·(in+out)·L·itemsize sum."""
    total = 0
    for leaf in adapter.values():
        if isinstance(leaf, dict):
            total += adapter_nbytes(leaf)
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total


def salt_bytes(model_id: Optional[str], version: int) -> bytes:
    """Prefix-cache chain-root salt for an (adapter, version) pair,
    byte-equal to the reference's.

    Adapter K/V differs from base K/V for identical token prefixes, so
    salted chains keep the prefix index and the tiered store from ever
    aliasing tenants; a version republish changes the salt, so stale
    entries miss and age out of the LRU, with no flush."""
    if not model_id:
        return b""
    return hashlib.blake2b(f"{model_id}@{version}".encode(),
                           digest_size=16).digest()
