"""Port parity: ``ray_tpu_torch.models.mlp`` and ``models.resnet`` against
the JAX package's flax models (counterparts of
``tests/test_misc_libs.py::test_mlp_trains`` and ``::test_resnet18_step``).

Both sides start from the reference's own initial variables, converted
by ``convert.mlp_params_from_flax`` / ``resnet_params_from_flax``, and
take the same numpy batches.

- ``MLP``: 30 Adam steps on ``make_mesh(dp=1)``, each loss within 1e-5
  (f32, summation order only).
- A small ``ResNet`` (``stage_sizes=[1, 1]``, ``num_filters=8``) with
  each block class at 16 x 16, f32: one step's loss, gradients (the SGD
  momentum trace after one step is the gradient, on both sides) and new
  ``batch_stats`` within 1e-5 of each leaf's largest value, and the
  eval-mode logits within 1e-5.  A bias followed by a BatchNorm has a
  zero gradient in exact arithmetic (the norm removes any shift), so
  those leaves hold rounding noise of ~1e-7: the bound has a floor of
  1e-6.
- ``ResNet50``'s converted tree covers every flax leaf (shapes from
  ``jax.eval_shape``, nothing compiled).
- dp = 2: one 2-rank gloo world spawned by this file runs the port's
  step on each rank's half of the batch; the BatchNorm statistics are
  the global batch's (SyncBN), as the reference's ``make_mesh(dp=2)``
  GSPMD step computes them, including a batch whose halves have
  different means, where per-rank statistics would part.
"""

import os
import time

import numpy as np
import pytest
import torch

SMALL = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)
IMAGE, ROWS, LR = 16, 8, 0.1
BLOCKS = ["ResNetBlock", "BottleneckBlock"]


def _walk(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _walk(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _assert_tree_close(got, want, what):
    """Each leaf of the port's tree ``got`` within 1e-5 of the largest
    value of ``want``'s (the reference's, converted), floor 1e-6."""
    g = {k: np.asarray(v.detach() if torch.is_tensor(v) else v)
         for k, v in _walk(got)}
    w = {k: np.asarray(v.detach() if torch.is_tensor(v) else v)
         for k, v in _walk(want)}
    assert g.keys() == w.keys(), what
    for k, ref in w.items():
        err = np.abs(g[k] - ref).max()
        assert err <= max(1e-5 * np.abs(ref).max(), 1e-6), (what, k, err)


def _batch(seed, offset=0.0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((ROWS, IMAGE, IMAGE, 3)).astype(np.float32)
    images[ROWS // 2:] += offset
    labels = rng.integers(0, SMALL["num_classes"], ROWS).astype(np.int32)
    return images, labels


_JAX_BUILDS = {}


def _jax_build(block: str, n_devices: int):
    """(model, train fns, initial variables on the host) of the
    reference, built once per block and mesh size; the variables are
    the one-device init's (``PRNGKey(0)``: the same on any mesh)."""
    import jax

    from ray_tpu.models import resnet as jr
    from ray_tpu.parallel.mesh import make_mesh
    key = (block, n_devices)
    if key not in _JAX_BUILDS:
        model = jr.ResNet(block_cls=getattr(jr, block), **SMALL)
        fns = jr.build_resnet_train(
            model, make_mesh(dp=n_devices,
                             devices=jax.devices()[:n_devices]),
            lr=LR, image_size=IMAGE)
        if n_devices == 1:
            state = fns["init_fn"](jax.random.PRNGKey(0))
            host = jax.tree.map(np.asarray, jax.device_get(
                {"params": state["params"],
                 "batch_stats": state["batch_stats"]}))
        else:
            host = _jax_build(block, 1)[2]
        _JAX_BUILDS[key] = (model, fns, host)
    return _JAX_BUILDS[key]


def _jax_step(block: str, images, labels, n_devices: int = 1):
    """The reference's initial variables, its one step's loss, accuracy,
    gradients (its momentum trace) and new batch_stats, and (on one
    device) its eval logits, on ``make_mesh(dp=n_devices)``."""
    import jax
    import jax.numpy as jnp
    import optax
    model, fns, host = _jax_build(block, n_devices)
    params = jax.tree.map(jnp.asarray, host["params"])
    state = {"params": params,
             "batch_stats": jax.tree.map(jnp.asarray, host["batch_stats"]),
             "opt_state": optax.sgd(LR, momentum=0.9,
                                    nesterov=True).init(params)}
    out = {}
    if n_devices == 1:
        out["logits"] = np.asarray(jax.jit(
            lambda v, x: model.apply(v, x, train=False))(
                host, jnp.asarray(images)))
    state, m = fns["step_fn"](state, (jnp.asarray(images),
                                      jnp.asarray(labels)))
    trace = jax.device_get(state["opt_state"][0].trace)
    out.update(loss=float(m["loss"]), accuracy=float(m["accuracy"]),
               grads=jax.tree.map(np.asarray, trace),
               batch_stats=jax.tree.map(np.asarray, jax.device_get(
                   state["batch_stats"])))
    return host, out


def _as_port(tree):
    """A flax-shaped tree of numpy leaves in the port's layouts."""
    from ray_tpu_torch.convert import resnet_params_from_flax
    return resnet_params_from_flax({"params": tree}, device="cpu")["params"]


def test_mlp_trains_as_the_reference():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.mlp import MLP as JMLP
    from ray_tpu.models.mlp import build_mlp_train as jbuild
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu_torch.convert import mlp_params_from_flax
    from ray_tpu_torch.models.mlp import MLP, build_mlp_train
    fns = jbuild(JMLP(hidden=(32,), num_classes=4),
                 make_mesh(dp=1, devices=jax.devices()[:1]), lr=5e-3)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=64)
    jstate = fns["init_fn"](jax.random.PRNGKey(0), jnp.asarray(X[:1]))
    tfns = build_mlp_train(MLP(hidden=(32,), num_classes=4, in_features=8),
                           lr=5e-3, device="cpu")
    tstate = tfns["init_fn"](params=mlp_params_from_flax(
        jax.tree.map(np.asarray, jax.device_get(jstate["params"])),
        device="cpu"))
    jl, tl = [], []
    batch = (torch.from_numpy(X), torch.from_numpy(y))
    for _ in range(30):
        jstate, m = fns["step_fn"](jstate, (jnp.asarray(X), jnp.asarray(y)))
        tstate, tm = tfns["step_fn"](tstate, batch)
        jl.append(float(m["loss"]))
        tl.append(float(tm["loss"]))
        assert float(tm["accuracy"]) == pytest.approx(float(m["accuracy"]))
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert tl[-1] < tl[0]


def test_mlp_default_is_fashion_mnist():
    from ray_tpu_torch.models.mlp import MLP
    m = MLP()
    assert [(layer.in_features, layer.out_features)
            for layer in m.layers()] == [(784, 128), (128, 128), (128, 10)]
    params = m.init_params(device="cpu")
    assert params["Dense_2.bias"].abs().max() == 0


@pytest.mark.parametrize("block", BLOCKS)
def test_resnet_step_matches_flax(block):
    from ray_tpu_torch.convert import resnet_params_from_flax
    from ray_tpu_torch.models import resnet as tr
    images, labels = _batch(0)
    host, want = _jax_step(block, images, labels)
    model = tr.ResNet(block_cls=getattr(tr, block), **SMALL)
    variables = resnet_params_from_flax(host, device="cpu")
    logits = model.apply(variables, torch.from_numpy(images), train=False)
    np.testing.assert_allclose(logits.numpy(), want["logits"], atol=1e-5,
                               rtol=1e-5)
    fns = tr.build_resnet_train(model, lr=LR, device="cpu")
    state = fns["init_fn"](variables=variables)
    state, m = fns["step_fn"](state, (torch.from_numpy(images),
                                      torch.from_numpy(labels)))
    assert float(m["loss"]) == pytest.approx(want["loss"], abs=1e-5)
    assert float(m["accuracy"]) == pytest.approx(want["accuracy"])
    _assert_tree_close(state["opt_state"], _as_port(want["grads"]), "grads")
    stats = resnet_params_from_flax({"params": {}, "batch_stats":
                                     want["batch_stats"]},
                                    device="cpu")["batch_stats"]
    _assert_tree_close(state["batch_stats"], stats, "batch_stats")


def test_same_padding_is_flax_s():
    """``"SAME"`` pads (0, 1) on a 3x3 stride-2 conv over an even size,
    (1, 1) at stride 1; the 1x1 stride-2 projection pads nothing."""
    from ray_tpu_torch.models.resnet import same_pads
    assert same_pads(56, 3, 2) == (0, 1)
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(57, 3, 2) == (1, 1)
    assert same_pads(56, 3, 1) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)


def test_resnet50_tree_covers_every_flax_leaf():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import resnet as jr
    from ray_tpu_torch.convert import resnet_params_from_flax
    from ray_tpu_torch.models import resnet as tr
    shapes = jax.eval_shape(lambda: jr.ResNet50(num_classes=1000).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    flax = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)
    got = resnet_params_from_flax(flax, device="cpu")
    port = tr.ResNet50(num_classes=1000).init(device="cpu")
    for part in ("params", "batch_stats"):
        want = {k: tuple(v.shape) for k, v in _walk(port[part])}
        assert {k: tuple(v.shape) for k, v in _walk(got[part])} == want
    n = sum(v.numel() for _k, v in _walk(port["params"]))
    assert n == sum(int(np.prod(s.shape)) for s in
                    jax.tree.leaves(shapes["params"]))
    assert len(port["batch_stats"]) == 17     # bn_init + 16 blocks


# ---------------------------------------------------------------------------
# dp = 2
# ---------------------------------------------------------------------------

DP = 2
DP_CASES = [("same-means", 0.0), ("halves-apart", 3.0)]


def _dp_world(rank, store, in_path, out_dir):
    """One rank of the 2-rank gloo world: both cases in turn, each its
    half of the batch; rank 0 writes the metrics, the gradients and the
    new statistics."""
    import torch.distributed as dist

    from ray_tpu_torch.convert import resnet_params_from_flax
    from ray_tpu_torch.models import resnet as tr
    from ray_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, DP),
                            rank=rank, world_size=DP)
    data = dict(np.load(in_path, allow_pickle=True))
    host = data["host"].item()
    for name, _offset in DP_CASES:
        model = tr.ResNet(block_cls=tr.ResNetBlock, **SMALL)
        fns = tr.build_resnet_train(model, make_mesh(dp=DP), lr=LR,
                                    device="cpu")
        state = fns["init_fn"](variables=resnet_params_from_flax(
            host, device="cpu"))
        batch = fns["shard_batch"]((torch.from_numpy(data[f"{name}/x"]),
                                    torch.from_numpy(data[f"{name}/y"])))
        state, m = fns["step_fn"](state, batch)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{name}.npz"),
                     loss=float(m["loss"]), accuracy=float(m["accuracy"]),
                     **{"g/" + k: v.numpy() for k, v in
                        _walk(state["opt_state"])},
                     **{"s/" + k: v.numpy() for k, v in
                        _walk(state["batch_stats"])})
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Each case's port results (the world runs while the pytest process
    steps the reference on ``make_mesh(dp=2)``) and reference results."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("resnet_dp")
    host = _jax_build("ResNetBlock", 1)[2]
    batches = {name: _batch(i + 1, offset)
               for i, (name, offset) in enumerate(DP_CASES)}
    inputs = {"host": np.array(host, dtype=object)}
    for name, (images, labels) in batches.items():
        inputs.update({f"{name}/x": images, f"{name}/y": labels})
    in_path = str(tmp / "inputs.npz")
    np.savez(in_path, **inputs)
    t0 = time.monotonic()
    ctx = mp.start_processes(_dp_world, args=(str(tmp / "store"), in_path,
                                              str(tmp)),
                             nprocs=DP, join=False, start_method="spawn")
    want = {name: _jax_step("ResNetBlock", *b, n_devices=DP)[1]
            for name, b in batches.items()}
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=1):
        assert time.monotonic() < deadline, "the dp world did not finish"
    print(f"dp world {time.monotonic() - t0:.1f} s")
    return {name: (dict(np.load(tmp / f"{name}.npz")), want[name])
            for name, _ in DP_CASES}


@pytest.mark.parametrize("name", [c[0] for c in DP_CASES])
def test_resnet_dp2_batch_norm_is_global(dp_runs, name):
    """The port's step on each rank's half equals the reference's
    ``make_mesh(dp=2)`` step on the global batch: loss, accuracy, every
    gradient and every new running statistic (bounds above)."""
    from ray_tpu_torch.convert import resnet_params_from_flax
    got, want = dp_runs[name]
    assert float(got["loss"]) == pytest.approx(want["loss"], abs=1e-5)
    assert float(got["accuracy"]) == pytest.approx(want["accuracy"])
    _assert_tree_close({k[2:]: v for k, v in got.items()
                        if k.startswith("g/")},
                       dict(_walk(_as_port(want["grads"]))), "grads")
    stats = resnet_params_from_flax({"params": {}, "batch_stats":
                                     want["batch_stats"]},
                                    device="cpu")["batch_stats"]
    _assert_tree_close({k[2:]: v for k, v in got.items()
                        if k.startswith("s/")}, dict(_walk(stats)),
                       "batch_stats")
