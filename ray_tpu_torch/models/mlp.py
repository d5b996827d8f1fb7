"""MLP classifier: the Fashion-MNIST baseline model (BASELINE config 1).

Counterpart of ``ray_tpu/models/mlp.py`` (flax linen): ``nn.Linear``
layers ``Dense_0 .. Dense_<n>`` (flax's names), ReLU between them, the
hidden layers in ``dtype`` and the head in f32, as flax's ``Dense(dtype=
...)`` computes them.  A flax tree converts through
``convert.mlp_params_from_flax`` (its ``[in, out]`` kernels transposed
to ``nn.Linear``'s ``[out, in]``).  The matmuls have no Pallas kernel in
the reference, so they are plain PyTorch here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch.models.resnet import (data_group, reduce_step,
                                         shard_rows, softmax_ce_and_accuracy)
from ray_tpu_torch.ops.substrate import resolve_device


class MLP(nn.Module):
    """``hidden`` ReLU layers then a ``num_classes`` head over inputs
    flattened to ``in_features`` (Fashion-MNIST's 784 by default: flax
    infers it from the example, ``nn.Linear`` needs it up front)."""

    def __init__(self, hidden: Sequence[int] = (128, 128),
                 num_classes: int = 10, dtype: Any = torch.float32, *,
                 in_features: int = 784):
        super().__init__()
        self.hidden, self.num_classes, self.dtype = (tuple(hidden),
                                                     num_classes, dtype)
        widths = [in_features, *self.hidden, num_classes]
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))

    def layers(self):
        return [getattr(self, f"Dense_{i}")
                for i in range(len(self.hidden) + 1)]

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        *body, head = self.layers()
        for layer in body:
            x = F.relu(F.linear(x, layer.weight.to(self.dtype),
                                layer.bias.to(self.dtype)))
        return F.linear(x.float(), head.weight.float(), head.bias.float())

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None) -> Dict[str, torch.Tensor]:
        """A fresh parameter dict (``state_dict`` names) with flax's
        initialisers (kernels lecun-normal, biases 0), drawn from
        ``generator`` (default: a CPU generator seeded 0)."""
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        out = {}
        for i, layer in enumerate(self.layers()):
            fan_in = layer.in_features
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            w = torch.empty(layer.weight.shape, device=g.device)
            torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                        generator=g)
            out[f"Dense_{i}.weight"] = w.to(device)
            out[f"Dense_{i}.bias"] = torch.zeros(layer.out_features,
                                                 device=device)
        return out


def build_mlp_train(model: MLP, mesh=None, *, lr: float = 1e-3,
                    device=None) -> Dict[str, Any]:
    """The training step (``ray_tpu/models/mlp.py:build_mlp_train``):
    ``optax.adam(lr)`` (the port's Adam, ``models.training.
    rl_optimizer`` with no clip: b1 0.9, b2 0.999, eps 1e-8), the mean
    softmax cross-entropy and the accuracy.

    Returns dict(init_fn, step_fn, shard_batch).  ``init_fn(generator=
    None, example=None, *, params=None)`` -> ``{"params", "opt_state"}``,
    the same on every rank; ``step_fn(state, (images, labels))`` ->
    (state, {"loss", "accuracy"}) with this rank's rows of the global
    batch (``shard_batch``): the batch over the mesh's data axes, the
    gradients summed over them.  Runs on the card unless
    ``device="cpu"``."""
    from ray_tpu_torch.models.training import (_broadcast_from_first,
                                               rl_optimizer)
    dev = resolve_device(device)
    model = model.to(dev)
    group, idx, n_data = data_group(mesh)
    tx = rl_optimizer(lr, grad_clip=math.inf)

    def init(generator: Optional[torch.Generator] = None, example=None, *,
             params: Optional[Dict[str, torch.Tensor]] = None):
        params = model.init_params(generator, dev) if params is None else \
            {k: v.detach().to(dev).clone() for k, v in params.items()}
        if group is not None:
            _broadcast_from_first(params, group)
        return {"params": params, "opt_state": tx.init(params)}

    def step(state, batch):
        images, labels = batch
        count = torch.tensor(float(labels.shape[0] * n_data),
                             device=images.device)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        logits = torch.func.functional_call(model, params, (images,))
        loss, acc = softmax_ce_and_accuracy(logits, labels, count)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        metrics = [loss.detach().clone(), acc.clone()]
        reduce_step(grads, metrics, group)
        opt = tx.update(grads, state["opt_state"], state["params"],
                        g_norm=torch.zeros((), device=images.device))
        return ({"params": state["params"], "opt_state": opt},
                {"loss": metrics[0], "accuracy": metrics[1]})

    def shard_batch(batch):
        return shard_rows(batch, idx, n_data) if group is not None \
            else batch

    return {"init_fn": init, "step_fn": step, "shard_batch": shard_batch}
