"""ResNet (v1.5) in PyTorch: the reference's Train benchmark model
(``release/train_tests`` ResNet-50/ImageNet; BASELINE config 3).

Counterpart of ``ray_tpu/models/resnet.py`` (flax linen).  The modules
are functional, as flax's are: ``ResNet.init`` returns ``{"params",
"batch_stats"}`` trees named as flax names them (``conv_init``,
``bn_init``, ``ResNetBlock_<i>`` / ``BottleneckBlock_<i>`` with
``Conv_<j>``, ``BatchNorm_<j>``, ``conv_proj``, ``norm_proj``, and
``Dense_0``), and ``ResNet.apply`` runs them.  A conv kernel is stored
``[out, in, kh, kw]`` (PyTorch's layout; flax's HWIO converts through
``convert.resnet_params_from_flax``), the head's ``[in, out]``.

The traps against flax, each handled here:
- the interface is NHWC (``[B, H, W, 3]``); inside, the images are the
  NCHW view of the same memory (channels-last strides, which cuDNN
  takes as they are);
- ``padding="SAME"`` pads ``(total // 2, total - total // 2)``: (0, 1) on
  a 3x3 stride-2 conv and on the 3x3/2 max pool, so those pad
  explicitly; the stem's 7x7 pads (3, 3) as written;
- BatchNorm is flax's: f32 statistics whatever ``dtype`` is, the
  biased variance ``E[x^2] - E[x]^2`` (clipped at 0), and running values
  kept at ``momentum`` 0.9 of the old (torch's ``momentum=0.1``);
- in a data-parallel world the batch statistics are the global batch's,
  as the reference's GSPMD step computes them: each BatchNorm sums its
  local ``sum x`` and ``sum x^2`` over the data group with ``comm.psum``
  (whose gradient is summed too), SyncBN semantics;
- the last BatchNorm of every block starts with scale 0.

Convolutions, BatchNorm and pooling have no Pallas kernel in the
reference (XLA computes them), so they are plain PyTorch here (cuDNN on
the card).  :func:`build_resnet_train` is the SGD (nesterov, momentum
0.9) training step with the ``batch_stats`` carried in its state.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.substrate import resolve_device
from ray_tpu_torch.parallel import comm

Tree = Dict[str, Any]
BN_MOMENTUM, BN_EPS = 0.9, 1e-5


# ---------------------------------------------------------------------------
# layers (functional)
# ---------------------------------------------------------------------------

def _lecun_normal(shape, fan_in: int, g: torch.Generator, dev):
    """flax's default kernel init: a normal truncated at 2 sigma, scaled
    to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    t = torch.empty(shape, dtype=torch.float32, device=g.device)
    torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                generator=g)
    return t.to(dev)


def _conv_init(cin: int, cout: int, k: int, g, dev) -> Tree:
    return {"kernel": _lecun_normal((cout, cin, k, k), cin * k * k, g, dev)}


def _bn_init(c: int, dev, *, zero_scale: bool = False) -> Tuple[Tree, Tree]:
    f32 = dict(dtype=torch.float32, device=dev)
    scale = torch.zeros(c, **f32) if zero_scale else torch.ones(c, **f32)
    return ({"scale": scale, "bias": torch.zeros(c, **f32)},
            {"mean": torch.zeros(c, **f32), "var": torch.ones(c, **f32)})


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dimension: (low, high),
    the odd element on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, p: Tree, stride: int, dtype, padding="SAME"):
    """x [B, C, H, W] -> the convolution in ``dtype`` (flax's ``Conv(dtype=
    ...)``: input and kernel cast, output in ``dtype``).  ``padding``:
    ``"SAME"`` or explicit ``((lo, hi), (lo, hi))``."""
    w = p["kernel"].to(dtype)
    kh, kw = w.shape[-2:]
    if padding == "SAME":
        padding = (same_pads(x.shape[2], kh, stride),
                   same_pads(x.shape[3], kw, stride))
    (hl, hh), (wl, wh) = padding
    x = x.to(dtype)
    if hl == hh and wl == wh:
        return F.conv2d(x, w, stride=stride, padding=(hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, stride=stride)


def batch_norm(x, p: Tree, stats: Tree, *, train: bool, group=None
               ) -> Tuple[torch.Tensor, Tree]:
    """flax's ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype=f32)`` over
    [B, C, H, W] -> (f32 output, new running statistics).  In training
    the statistics are the batch's (summed over ``group``'s ranks: the
    global batch's), the running ones updated; in eval the running
    ones are used and returned as they are."""
    x32 = x.float()
    if train:
        sums = torch.stack([x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3))])
        n = torch.tensor(float(x32.numel() // x32.shape[1]),
                         device=x32.device)
        if group is not None:
            sums = comm.psum(sums, group)
            n = comm.psum(n, group)
        mean = sums[0] / n
        var = (sums[1] / n - mean.square()).clamp_min(0.0)
        new = {"mean": BN_MOMENTUM * stats["mean"]
               + (1 - BN_MOMENTUM) * mean.detach(),
               "var": BN_MOMENTUM * stats["var"]
               + (1 - BN_MOMENTUM) * var.detach()}
    else:
        mean, var, new = stats["mean"], stats["var"], stats
    mul = torch.rsqrt(var + BN_EPS) * p["scale"]
    y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None]
    return y + p["bias"][None, :, None, None], new


def max_pool_same(x, k: int = 3, stride: int = 2):
    """``nn.max_pool(x, (k, k), (stride, stride), padding="SAME")``: -inf
    padding on the (low, high) sides XLA pads."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], k, stride),
                          same_pads(x.shape[3], k, stride))
    x = F.pad(x, (wl, wh, hl, hh), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResNetBlock:
    """Two 3x3 convolutions (the first strided), the projection where
    the shape changes."""
    filters: int
    strides: Tuple[int, int] = (1, 1)
    dtype: Any = torch.float32
    expansion = 1

    def convs(self):
        """(name, kernel size, stride, output channels) of the main path."""
        s = self.strides[0]
        return [("0", 3, s, self.filters), ("1", 3, 1, self.filters)]

    def __call__(self, p: Tree, s: Tree, x, *, train: bool, group=None
                 ) -> Tuple[torch.Tensor, Tree]:
        new: Tree = {}
        y = x
        convs = self.convs()
        for i, (j, _k, stride, _c) in enumerate(convs):
            y = conv(y, p[f"Conv_{j}"], stride, self.dtype)
            y, new[f"BatchNorm_{j}"] = batch_norm(
                y, p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"], train=train,
                group=group)
            if i < len(convs) - 1:
                y = F.relu(y)
        residual = x
        if "conv_proj" in p:
            residual = conv(x, p["conv_proj"], self.strides[0], self.dtype)
            residual, new["norm_proj"] = batch_norm(
                residual, p["norm_proj"], s["norm_proj"], train=train,
                group=group)
        return F.relu(residual + y), new


@dataclasses.dataclass(frozen=True)
class BottleneckBlock(ResNetBlock):
    """1x1, 3x3 (strided), 1x1 to ``4 * filters``."""
    expansion = 4

    def convs(self):
        s = self.strides[0]
        return [("0", 1, 1, self.filters), ("1", 3, s, self.filters),
                ("2", 1, 1, self.filters * 4)]


def _block_init(block: ResNetBlock, cin: int, g, dev) -> Tuple[Tree, Tree]:
    """A block's params and statistics for ``cin`` input channels."""
    params, stats = {}, {}
    convs = block.convs()
    c = cin
    for i, (j, k, _s, cout) in enumerate(convs):
        params[f"Conv_{j}"] = _conv_init(c, cout, k, g, dev)
        params[f"BatchNorm_{j}"], stats[f"BatchNorm_{j}"] = _bn_init(
            cout, dev, zero_scale=i == len(convs) - 1)
        c = cout
    out = block.filters * block.expansion
    if cin != out or block.strides != (1, 1):
        params["conv_proj"] = _conv_init(cin, out, 1, g, dev)
        params["norm_proj"], stats["norm_proj"] = _bn_init(out, dev)
    return params, stats


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResNet:
    stage_sizes: Sequence[int]
    block_cls: Any
    num_classes: int = 1000
    num_filters: int = 64
    dtype: Any = torch.float32

    def blocks(self):
        """(name, block) of every block in order, named as flax names
        them."""
        out = []
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                out.append((f"{self.block_cls.__name__}_{len(out)}",
                            self.block_cls(self.num_filters * 2 ** i,
                                           strides=strides,
                                           dtype=self.dtype)))
        return out

    def init(self, generator: Optional[torch.Generator] = None, *,
             device=None) -> Tree:
        """``{"params", "batch_stats"}`` with flax's initialisers (kernels
        lecun-normal, BatchNorm scale 1 (0 for each block's last), biases
        and means 0, variances 1), drawn from ``generator`` (default: a
        CPU generator seeded 0), on ``device`` (the card unless
        ``device="cpu"``)."""
        dev = resolve_device(device)
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        params: Tree = {"conv_init": _conv_init(3, self.num_filters, 7, g,
                                                dev)}
        stats: Tree = {}
        params["bn_init"], stats["bn_init"] = _bn_init(self.num_filters, dev)
        c = self.num_filters
        for name, block in self.blocks():
            params[name], stats[name] = _block_init(block, c, g, dev)
            c = block.filters * block.expansion
        params["Dense_0"] = {
            "kernel": _lecun_normal((self.num_classes, c), c, g, dev).T
            .contiguous(),
            "bias": torch.zeros(self.num_classes, dtype=torch.float32,
                                device=dev)}
        return {"params": params, "batch_stats": stats}

    def apply(self, variables: Tree, images, train: bool = True, *,
              group=None):
        """images [B, H, W, 3] -> logits [B, num_classes] f32; with
        ``train`` also the new ``batch_stats`` (flax's ``mutable=
        ["batch_stats"]``).  ``group``: the data-parallel process group
        the batch statistics are summed over (None: this rank's batch)."""
        p, s = variables["params"], variables["batch_stats"]
        x = images.permute(0, 3, 1, 2)          # NCHW view, NHWC memory
        new: Tree = {}
        x = conv(x, p["conv_init"], 2, self.dtype,
                 padding=((3, 3), (3, 3)))
        x, new["bn_init"] = batch_norm(x, p["bn_init"], s["bn_init"],
                                       train=train, group=group)
        x = max_pool_same(F.relu(x))
        for name, block in self.blocks():
            x, new[name] = block(p[name], s[name], x, train=train,
                                 group=group)
        x = x.float().mean((2, 3))
        logits = torch.matmul(x, p["Dense_0"]["kernel"]) + \
            p["Dense_0"]["bias"]
        return (logits, new) if train else logits


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def softmax_ce_and_accuracy(logits, labels, count):
    """(sum of the softmax cross-entropy of this rank's rows / ``count``,
    the number of correct rows / ``count``): the global batch's mean
    loss and accuracy once summed over the ranks."""
    labels = labels.long()
    nll = torch.logsumexp(logits, -1) - logits.gather(
        1, labels[:, None])[:, 0]
    acc = (logits.argmax(-1) == labels).float().sum()
    return nll.sum() / count, acc.detach() / count


def data_group(mesh):
    """(the process group of the mesh's data axes or None, this rank's
    index in it, its size)."""
    from ray_tpu_torch.parallel.mesh import mesh_groups
    groups = mesh_groups(mesh)
    n = groups.size("dcn") * groups.size("dp") * groups.size("fsdp")
    if n == 1:
        return None, 0, 1
    idx = (groups.coord("dcn") * groups.size("dp")
           + groups.coord("dp")) * groups.size("fsdp") + groups.coord("fsdp")
    return groups.count, idx, n


def reduce_step(grads: Tree, metrics, group) -> None:
    """Sum the gradients and the metrics over ``group``'s ranks, in place
    (one flat buffer)."""
    if group is None:
        return
    import torch.distributed as dist

    from ray_tpu_torch.models.training import _flat_collective, _leaves
    leaves = _leaves(grads) + list(metrics)
    got = _flat_collective(leaves, lambda f: dist.all_reduce(f, group=group))
    for t, g in zip(leaves, got):
        t.copy_(g)


def shard_rows(batch, idx: int, n: int):
    """This rank's rows of a global ``(images, labels)`` batch."""
    return tuple(t.chunk(n)[idx] for t in batch)


def build_resnet_train(model: ResNet, mesh=None, *, lr: float = 0.1,
                       momentum: float = 0.9, image_size: int = 224,
                       device=None) -> Dict[str, Any]:
    """The training step (``ray_tpu/models/resnet.py:build_resnet_train``):
    ``optax.sgd(lr, momentum, nesterov=True)`` on the params, the
    ``batch_stats`` carried in the state.

    Returns dict(init_fn, step_fn, shard_batch).  ``init_fn(generator=
    None)`` -> ``{"params", "batch_stats", "opt_state"}`` (the momentum
    trace, zeros), the same on every rank (the first rank's, broadcast);
    ``step_fn(state, (images, labels))`` -> (state, {"loss",
    "accuracy"}), with this rank's rows of the global batch
    (``shard_batch(global_batch)``): the batch over the mesh's data axes
    (dcn, dp, fsdp), the parameters replicated, the gradients, loss and
    accuracy summed over the ranks and the BatchNorm statistics taken
    over the global batch.  ``image_size`` is the reference's (its init
    traces an example; this one needs none).  Runs on the card unless
    ``device="cpu"``."""
    from ray_tpu_torch.models.training import (_broadcast_from_first,
                                               _leaves, _rebuild)
    dev = resolve_device(device)
    group, idx, n_data = data_group(mesh)

    def init(generator: Optional[torch.Generator] = None, *,
             variables: Optional[Tree] = None) -> Tree:
        v = model.init(generator, device=dev) if variables is None else \
            variables
        if group is not None:
            _broadcast_from_first(v, group)
        trace = _rebuild(v["params"], [torch.zeros_like(t) for t in
                                       _leaves(v["params"])])
        return {"params": v["params"], "batch_stats": v["batch_stats"],
                "opt_state": trace}

    def step(state: Tree, batch):
        images, labels = batch
        count = torch.tensor(float(labels.shape[0] * n_data),
                             device=images.device)
        leaves = [p.detach().requires_grad_(True)
                  for p in _leaves(state["params"])]
        params = _rebuild(state["params"], leaves)
        logits, stats = model.apply(
            {"params": params, "batch_stats": state["batch_stats"]},
            images, train=True, group=group)
        loss, acc = softmax_ce_and_accuracy(logits, labels, count)
        grads = list(torch.autograd.grad(loss, leaves))
        metrics = [loss.detach().clone(), acc.clone()]
        reduce_step(grads, metrics, group)
        with torch.no_grad():
            for p, g, f in zip(_leaves(state["params"]), grads,
                               _leaves(state["opt_state"])):
                f.copy_(g + momentum * f)
                p.add_(g + momentum * f, alpha=-lr)
        return ({"params": state["params"], "batch_stats": stats,
                 "opt_state": state["opt_state"]},
                {"loss": metrics[0], "accuracy": metrics[1]})

    def shard_batch(batch):
        return shard_rows(batch, idx, n_data) if group is not None \
            else batch

    return {"init_fn": init, "step_fn": step, "shard_batch": shard_batch}
