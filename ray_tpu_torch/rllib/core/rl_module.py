"""RLModule — the neural policy/value abstraction.

Counterpart of ``ray_tpu/rllib/core/rl_module.py`` (parity: the
reference new stack's ``rllib/core/rl_module/rl_module.py``): one object
owning the forward passes for exploration, inference and training.
Functional, as the reference's: the params are a tree of tensors (dicts
and the trunk's list of layers) and the forward functions take it.

Init follows the reference's scheme (He-normal hidden weights,
``(2 / fan_in) ** 0.5``, zero biases, the output heads at
``out_scale``), its draws from an explicit ``torch.Generator``; they are
not ``jax.random``'s, so parity starts from the reference's params
(``convert.rl_module_params_from_jax``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops.substrate import resolve_device


def _normal(generator: Optional[torch.Generator], shape, scale: float,
            dtype, device) -> torch.Tensor:
    """``scale`` times standard normal draws, taken on the generator's
    device (the CPU for ``torch.Generator()``), then moved."""
    gen_dev = generator.device if generator is not None else "cpu"
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=gen_dev) * scale
    return w.to(device=device, dtype=dtype)


def _dense(generator, fan_in: int, fan_out: int, scale: float, dtype,
           device) -> Dict[str, torch.Tensor]:
    """One layer's ``w``/``b`` on ``device`` (None: the card, through
    ``resolve_device``)."""
    device = resolve_device(device)
    return {"w": _normal(generator, (fan_in, fan_out), scale, dtype, device),
            "b": torch.zeros(fan_out, dtype=dtype, device=device)}


@dataclass
class MLPModuleConfig:
    obs_dim: int = 4
    num_actions: int = 2
    hidden: Tuple[int, ...] = (64, 64)
    dtype: Any = torch.float32


class DiscreteMLPModule:
    """Categorical policy + value MLP (CartPole-class tasks)."""

    def __init__(self, config: MLPModuleConfig):
        self.config = config

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None) -> Dict[str, Any]:
        cfg = self.config
        sizes = (cfg.obs_dim,) + tuple(cfg.hidden)
        layers = [_dense(generator, sizes[i], sizes[i + 1],
                         (2.0 / sizes[i]) ** 0.5, cfg.dtype, device)
                  for i in range(len(sizes) - 1)]
        return {"layers": layers,
                "pi": _dense(generator, sizes[-1], cfg.num_actions, 0.01,
                             cfg.dtype, device),
                "vf": _dense(generator, sizes[-1], 1, 1.0, cfg.dtype,
                             device)}

    def _trunk(self, params, obs):
        x = obs
        for layer in params["layers"]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
        return x

    def forward(self, params, obs):
        """obs [B, obs_dim] -> (logits [B, A], value [B])."""
        x = self._trunk(params, obs)
        logits = x @ params["pi"]["w"] + params["pi"]["b"]
        value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
        return logits, value

    def action_dist(self, logits):
        return torch.log_softmax(logits, dim=-1)

    @torch.no_grad()
    def sample_actions(self, params, obs, generator: torch.Generator):
        """-> (actions [B], logp [B], value [B]), the actions drawn from
        the categorical policy on ``generator`` (a CPU generator: env
        runners sample on the host)."""
        logits, value = self.forward(params, obs)
        probs = torch.softmax(logits.float(), -1).cpu()
        actions = torch.multinomial(probs, 1, generator=generator)[:, 0]
        actions = actions.to(logits.device)
        logp = torch.log_softmax(logits, -1).gather(
            -1, actions[:, None])[:, 0]
        return actions, logp, value


@dataclass
class ContinuousModuleConfig:
    obs_dim: int = 3
    act_dim: int = 1
    act_low: Tuple[float, ...] = (-1.0,)
    act_high: Tuple[float, ...] = (1.0,)
    hidden: Tuple[int, ...] = (256, 256)
    log_std_bounds: Tuple[float, float] = (-10.0, 2.0)
    dtype: Any = torch.float32


def _mlp_init(generator, sizes, dtype, out_scale=0.01, out_dim=None,
              device=None) -> List[Dict[str, torch.Tensor]]:
    layers = [_dense(generator, sizes[i], sizes[i + 1],
                     (2.0 / sizes[i]) ** 0.5, dtype, device)
              for i in range(len(sizes) - 1)]
    if out_dim is not None:
        layers.append(_dense(generator, sizes[-1], out_dim, out_scale,
                             dtype, device))
    return layers


def _mlp_apply(layers, x, final_linear: bool):
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1 or not final_linear:
            x = torch.relu(x)
    return x


class SquashedGaussianModule:
    """Tanh-squashed Gaussian actor (the SAC policy; reference:
    ``rllib/algorithms/sac/sac_rl_module.py``'s action distribution)."""

    def __init__(self, config: ContinuousModuleConfig):
        self.config = config
        self._low = np.asarray(config.act_low, np.float32)
        self._high = np.asarray(config.act_high, np.float32)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None):
        cfg = self.config
        sizes = (cfg.obs_dim,) + tuple(cfg.hidden)
        return {"trunk": _mlp_init(generator, sizes, cfg.dtype,
                                   out_scale=0.01, out_dim=2 * cfg.act_dim,
                                   device=device)}

    def dist_params(self, params, obs):
        out = _mlp_apply(params["trunk"], obs, final_linear=True)
        mean, log_std = out.chunk(2, dim=-1)
        lo, hi = self.config.log_std_bounds
        log_std = lo + 0.5 * (hi - lo) * (torch.tanh(log_std) + 1.0)
        return mean, log_std

    def _bounds(self, like):
        low = torch.as_tensor(self._low, device=like.device)
        high = torch.as_tensor(self._high, device=like.device)
        return low, (high - low) / 2.0

    def sample(self, params, obs, generator: Optional[torch.Generator] = None,
               *, eps=None):
        """-> (action in env bounds, log_prob).  The reparameterised
        noise is ``eps`` when given (a parity test feeds the
        reference's), else standard normal draws from ``generator``."""
        mean, log_std = self.dist_params(params, obs)
        std = torch.exp(log_std)
        if eps is None:
            eps = _normal(generator, tuple(mean.shape), 1.0, mean.dtype,
                          mean.device)
        pre = mean + std * eps
        logp = (-0.5 * (eps ** 2 + 2 * log_std
                        + math.log(2 * math.pi))).sum(-1)
        a = torch.tanh(pre)
        # tanh change of variables
        logp = logp - torch.log(torch.clamp(1 - a ** 2, min=1e-6)).sum(-1)
        low, scale = self._bounds(a)
        act = low + (a + 1.0) * scale
        logp = logp - torch.log(scale).sum()
        return act, logp

    def deterministic(self, params, obs):
        mean, _ = self.dist_params(params, obs)
        low, scale = self._bounds(mean)
        return low + (torch.tanh(mean) + 1.0) * scale


class TwinQModule:
    """Clipped double-Q critics (reference: SAC's twin Q)."""

    def __init__(self, config: ContinuousModuleConfig):
        self.config = config

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None):
        cfg = self.config
        sizes = (cfg.obs_dim + cfg.act_dim,) + tuple(cfg.hidden)
        return {"q1": _mlp_init(generator, sizes, cfg.dtype, out_scale=1.0,
                                out_dim=1, device=device),
                "q2": _mlp_init(generator, sizes, cfg.dtype, out_scale=1.0,
                                out_dim=1, device=device)}

    def forward(self, params, obs, act):
        x = torch.cat([obs, act], dim=-1)
        q1 = _mlp_apply(params["q1"], x, final_linear=True)[..., 0]
        q2 = _mlp_apply(params["q2"], x, final_linear=True)[..., 0]
        return q1, q2
