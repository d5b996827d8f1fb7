"""What the rllib learners share: their device, the batch's move onto
it, gradients with the loss's metrics, the optimizers and the metrics'
host form.

The reference's learners are jitted ``jax.value_and_grad`` steps over
``optax`` chains; here each step is autograd over the same loss, and
the optimizers are the port's hand-written ``optax`` counterparts, which
update the parameter tensors in place (``models.training``): Adam is
``rl_optimizer`` (the clip divides by the norm exactly, never
``clip_grad_norm_``'s ``norm + 1e-6``), with no clip where the reference
chains none.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


def learner_device(device, config) -> torch.device:
    """``device``, else the config's ``device``; None is the card
    (``resolve_device`` raises where there is none)."""
    from ray_tpu_torch.ops.substrate import resolve_device
    if device is None:
        device = getattr(config, "device", None)
    return resolve_device(device)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Numpy (or tensor) columns -> tensors on ``device``: integer
    columns as int64 (gather indices), the rest as they are."""
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v):
            v = np.asarray(v)
            if not v.flags.writeable:   # an object-store batch's buffer
                v = v.copy()
        t = torch.as_tensor(v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def value_and_grad_aux(loss_fn: Callable, params, *args
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                  Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: (loss, metrics,
    grads) of ``loss_fn(params, *args) -> (loss, metrics)``; a leaf the
    loss does not reach gets a zero gradient."""
    from ray_tpu_torch.models.training import _leaves, _rebuild
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    loss, metrics = loss_fn(_rebuild(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _rebuild(params, grads))


def adam(lr: float):
    """``optax.adam(lr)``: the RL optimizer with no clip."""
    from ray_tpu_torch.models.training import rl_optimizer
    return rl_optimizer(lr, grad_clip=math.inf)


def host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def host_params(params):
    """A host copy of ``params`` (CPU tensors), what the env runners are
    handed through the object store."""
    from ray_tpu_torch.rl.learner import host_copy
    return host_copy(params)


def stop_actors(actors) -> None:
    """Kill each actor, ignoring the ones already gone."""
    import ray_tpu_torch
    for a in actors:
        try:
            ray_tpu_torch.kill(a)
        except Exception:  # noqa: BLE001
            pass
