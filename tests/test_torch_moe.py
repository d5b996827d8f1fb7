"""Port parity: experts (``ray_tpu_torch.parallel.moe`` and the MoE FFN of
``models/gpt.py``) against the JAX package's (``ray_tpu.parallel.moe``,
``ray_tpu.models.gpt``).

In-process cases: ``_route``'s dispatch, combine and aux loss at a
capacity that drops tokens (random router, and a router whose two
columns tie, where ``lax.top_k`` takes the lower index); ``moe_layer``
with the GELU experts and with the model's SwiGLU experts, values and
gradients; the counterparts of ``tests/test_parallel.py::
test_moe_capacity_drops_tokens`` and ``tests/test_models.py::
test_gpt_logical_axes_match_params`` at ``n_experts=2``; a MoE
``build_gpt_train`` step on one process; the engine's refusal.

One 4-rank gloo world (spawned as ``tests/test_torch_overlap.py``
does; the ranks import only torch and the port): ``test_moe_ep_matches_
dense`` on {ep 4} through ``make_moe_fn``; and a MoE ``build_gpt_train``
step at ``moe_capacity_factor=0.5`` (half the assignments fit, so tokens
are dropped) on {dp 4}, {dp 2, ep 2}, {ep 2, tp 2} and {fsdp 2, ep 2},
each against the JAX package's GSPMD step on the same mesh.  The {dp 4}
case is the one a per-rank router fails: the reference routes the
global batch.

Bounds: dispatch bit-equal; combine, outputs and aux within 1e-6
(rtol 1e-5); the ep layer within atol 1e-5 (the reference test's); f32
steps: the loss within rtol 2e-5, atol 2e-6, the grad norm within rtol
2e-4, atol 2e-5, every gradient leaf within rtol 1e-4, atol 1e-5.
"""

import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
MOE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, max_seq=32,
           n_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
B, S = 8, 32
MESHES = [dict(dp=4), dict(dp=2, ep=2), dict(ep=2, tp=2), dict(fsdp=2, ep=2)]
MESH_IDS = ["-".join(f"{k}{v}" for k, v in m.items()) for m in MESHES]
EP = dict(T=64, d=8, E=8, h=16, cf=8.0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _np_tree(node):
    if isinstance(node, dict):
        return {k: _np_tree(v) for k, v in node.items()}
    return node.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# in-process cases
# ---------------------------------------------------------------------------

def _router_inputs(tie: bool):
    import jax
    T, d, E = 32, 8, 4
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (T, d)))
    wg = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (d, E)))
    if tie:
        wg = wg.copy()
        wg[:, 2] = wg[:, 1]
    return x, wg


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tied"])
def test_route_matches_reference_with_drops(tie):
    """``_route`` at top_k 2 and capacity 6 (24 places for 64
    assignments): the dispatch bit-equal to the JAX package's, combine
    and aux within 1e-6; with two tied router columns every token's tie
    goes to the lower expert index, as ``lax.top_k``."""
    import jax.numpy as jnp

    from ray_tpu.parallel import moe as jmoe
    from ray_tpu_torch.parallel import moe

    x, wg = _router_inputs(tie)
    jd, jc, ja = jmoe._route(jnp.asarray(x), jnp.asarray(wg), 2, 6)
    d, c, a = moe.route(_t(x), _t(wg), 2, 6)
    assert float(d.sum()) < 64          # tokens were dropped
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(float(a), float(ja), atol=1e-6, rtol=1e-5)
    if tie:
        # no token dispatched to the higher of the tied experts before
        # the lower one is full for it
        assert np.asarray(jd)[:, 1].sum() > 0


def _swiglu_jax_ffn():
    import jax
    import jax.numpy as jnp

    def ffn(w1w3, w2, tokens):
        h = jnp.einsum("ecd,edh->ech", tokens, w1w3)
        a, b = jnp.split(h, 2, axis=-1)
        return jnp.einsum("ech,ehd->ecd", jax.nn.silu(a) * b, w2)
    return ffn


@pytest.mark.parametrize("experts", ["gelu", "swiglu"])
def test_moe_layer_matches_reference(experts):
    """``moe_layer`` with the GELU experts (tanh approximation, as
    ``jax.nn.gelu``) and with the model's SwiGLU experts (w3 folded into
    w1): the output and aux, and the gradients of ``sum(out * r) + aux``
    with respect to x and every weight, against the JAX package's."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import moe as jmoe
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import moe

    T, d, E, h = 48, 8, 4, 16
    ks = jax.random.split(jax.random.PRNGKey(7), 4)
    jp = jmoe.init_moe_params(ks[0], d, h, E)
    if experts == "swiglu":
        jp = jmoe.MoEParams(jp.wg, jnp.concatenate(
            [jp.w1, jax.random.normal(ks[3], (E, d, h)) * d ** -0.5], -1),
            jp.w2)
    x = jax.random.normal(ks[1], (T, d))
    r = jax.random.normal(ks[2], (T, d))
    jffn = _swiglu_jax_ffn() if experts == "swiglu" else None
    tffn = gpt._swiglu_experts if experts == "swiglu" else None

    def jloss(p, x):
        out, aux = jmoe.moe_layer(p, x, top_k=2, capacity_factor=1.0,
                                  expert_ffn=jffn)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, x)
    tp = moe.MoEParams(*(_t(w).requires_grad_(True) for w in jp))
    tx = _t(x).requires_grad_(True)
    out, aux = moe.moe_layer(tp, tx, top_k=2, capacity_factor=1.0,
                             expert_ffn=tffn)
    (torch.sum(out * _t(r)) + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=1e-5, rtol=1e-4)
    for name, t, j in zip(("wg", "w1", "w2"), tp, jg[0]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_moe_capacity_drops_tokens():
    """``test_moe_capacity_drops_tokens``: with a tiny capacity most
    tokens are dropped, so the output has zero rows, and the aux loss is
    positive."""
    from ray_tpu_torch.parallel import moe
    T, d, E, h = 32, 4, 4, 8
    params = moe.init_moe_params(torch.Generator().manual_seed(4), d, h, E)
    x = torch.randn(T, d, generator=torch.Generator().manual_seed(5))
    out, aux = moe.moe_layer(params, x, top_k=1, capacity_factor=0.1)
    assert float(aux) > 0
    assert int((out.abs().sum(-1) == 0).sum()) > 0


def test_gpt_logical_axes_match_params():
    """``tests/test_models.py::test_gpt_logical_axes_match_params`` at
    ``n_experts=2``: every leaf has one logical axis per dimension, and
    the tree's keys and shapes are the JAX package's."""
    import jax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.tiny(n_experts=2)
    params = gpt.init_params(cfg, device="cpu")
    axes = gpt.param_logical_axes(cfg)
    flat_p, flat_a = _flat(_np_tree(params)), {}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat_a[prefix + k] = v
    walk(axes)
    assert flat_p.keys() == flat_a.keys()
    for path, leaf in flat_p.items():
        assert leaf.ndim == len(flat_a[path]), path
    jshapes = {k: v.shape for k, v in _flat(jax.tree.map(
        np.asarray, jgpt.init_params(jgpt.GPTConfig.tiny(n_experts=2),
                                     jax.random.PRNGKey(0)))).items()}
    assert {k: v.shape for k, v in flat_p.items()} == jshapes
    assert _flat_axes(jgpt.param_logical_axes(
        jgpt.GPTConfig.tiny(n_experts=2))) == flat_a


def _flat_axes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_axes(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _keep_grads():
    """An optax transformation that keeps its gradients as its state."""
    import jax
    import jax.numpy as jnp
    import optax
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_step(axes, params, batch):
    """The JAX package's GSPMD ``build_gpt_train`` step on ``axes``:
    loss, grad norm and gradients."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh
    cfg = jgpt.GPTConfig(**dict(MOE, dtype=jnp.float32))
    n = int(np.prod(list(axes.values())))
    tx = _keep_grads()
    fns = jtrain.build_gpt_train(cfg, make_mesh(**axes,
                                                devices=jax.devices()[:n]),
                                 optimizer=tx, telemetry=False)
    p = jax.tree.map(jnp.asarray, params)
    st = jtrain.TrainState(p, tx.init(p), jnp.zeros((), jnp.int32))
    st, m = fns["step_fn"](st, batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": {k: np.asarray(v, np.float32) for k, v in
                      _flat(jax.device_get(st.opt_state)).items()}}


def _assert_step(got_loss, got_norm, got_grads, want, what):
    np.testing.assert_allclose(got_loss, want["loss"], rtol=2e-5, atol=2e-6,
                               err_msg=f"{what}: loss")
    np.testing.assert_allclose(got_norm, want["grad_norm"], rtol=2e-4,
                               atol=2e-5, err_msg=f"{what}: grad norm")
    assert got_grads.keys() == want["grads"].keys()
    for path, w in want["grads"].items():
        np.testing.assert_allclose(got_grads[path], w, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what}: grad {path}")


@pytest.fixture(scope="module")
def moe_inputs():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    cfg = jgpt.GPTConfig(**dict(MOE, dtype=jnp.float32))
    params = jax.tree.map(np.asarray,
                          jgpt.init_params(cfg, jax.random.PRNGKey(0)))
    batch = {k: np.asarray(v) for k, v in jtrain.synthetic_lm_batch(
        jax.random.PRNGKey(1), B, S, cfg.vocab_size).items()}
    return params, batch


def test_moe_train_step_one_process(moe_inputs):
    """A MoE ``build_gpt_train`` step on one process, capacity factor 0.5
    (tokens dropped), against the JAX package's on one device."""
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt, training
    params, batch = moe_inputs
    cfg = gpt.GPTConfig(**dict(MOE, dtype=torch.float32))
    from ray_tpu_torch.parallel import moe
    assert moe.capacity(B * S, 4, 2, 0.5) * 4 < B * S * 2
    fns = training.build_gpt_train(cfg, device="cpu", telemetry=False)
    tparams = params_from_jax(params, cfg, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = fns["value_and_grad_fn"](tparams, tbatch)
    state = fns["init_fn"](params=tparams)
    _, m = fns["step_fn"](state, tbatch)
    _assert_step(float(loss), float(m["grad_norm"]),
                 _flat(_np_tree(grads)), _jax_step(dict(dp=1), params, batch),
                 "one process")


def test_engine_refuses_moe():
    """The serving engine refuses a MoE config with the reference's
    message (its decode cache has no MoE path)."""
    from ray_tpu_torch.inference.engine import InferenceEngine
    from ray_tpu_torch.models import gpt
    cfg = gpt.GPTConfig.tiny(n_experts=2, dtype=torch.float32)
    params = gpt.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="MoE decode cache not supported yet"):
        InferenceEngine(cfg, params, device="cpu")


# ---------------------------------------------------------------------------
# the port's world (rank side: torch and the port only)
# ---------------------------------------------------------------------------

def _ep_case(rank, tmp):
    """make_moe_fn on {ep 4}: each rank its quarter of the tokens (rows
    ``r T/4 ...``, the reference's ``P("ep", None)``) and two of the
    eight experts (``P("ep")``); outputs gathered in rank order."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import moe
    from ray_tpu_torch.parallel.mesh import make_mesh
    data = dict(np.load(os.path.join(tmp, "in-ep.npz")))
    mesh = make_mesh(ep=WORLD)
    e, t = EP["E"] // WORLD, EP["T"] // WORLD
    params = moe.MoEParams(
        torch.from_numpy(data["wg"]),
        torch.from_numpy(data["w1"][rank * e:(rank + 1) * e]),
        torch.from_numpy(data["w2"][rank * e:(rank + 1) * e]))
    x = torch.from_numpy(data["x"][rank * t:(rank + 1) * t])
    out, aux = moe.make_moe_fn(mesh, top_k=2, capacity_factor=EP["cf"])(
        params, x)
    outs = [torch.empty_like(out) for _ in range(WORLD)]
    dist.all_gather(outs, out.contiguous())
    if rank == 0:
        np.savez(os.path.join(tmp, "out-ep.npz"),
                 out=torch.cat(outs).numpy(), aux=float(aux))


def _step_case(rank, tmp, axes, name):
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import make_mesh
    t0 = time.monotonic()
    data = dict(np.load(os.path.join(tmp, "in-step.npz")))
    params = _unflat({k[2:]: v for k, v in data.items()
                      if k.startswith("p/")})
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "targets")}
    cfg = gpt.GPTConfig(**dict(MOE, dtype=torch.float32))
    mesh = make_mesh(**axes)
    fns = training.build_gpt_train(cfg, mesh, device="cpu", telemetry=False)
    local = fns["shard_batch"](batch)
    shards = params_from_jax(params, cfg, device="cpu", mesh=mesh)
    loss, grads = fns["value_and_grad_fn"](shards, local)
    full = _flat(_np_tree(sharding.gather_params(
        grads, mesh, gpt.param_logical_axes(cfg))))
    state = fns["init_fn"](params=shards)
    _, m = fns["step_fn"](state, local)
    if rank == 0:
        np.savez(os.path.join(tmp, f"out-{name}.npz"),
                 secs=time.monotonic() - t0, loss=float(loss),
                 grad_norm=float(m["grad_norm"]),
                 **{f"g/{k}": v for k, v in full.items()})


def _world(rank, store, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    _ep_case(rank, tmp)
    for axes, name in zip(MESHES, MESH_IDS):
        _step_case(rank, tmp, axes, name)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, moe_inputs):
    import jax
    import jax.numpy as jnp
    import torch.multiprocessing as mp

    from ray_tpu.parallel import moe as jmoe

    tmp = str(tmp_path_factory.mktemp("moe"))
    jp = jmoe.init_moe_params(jax.random.PRNGKey(2), EP["d"], EP["h"],
                              EP["E"])
    x = jax.random.normal(jax.random.PRNGKey(3), (EP["T"], EP["d"]))
    np.savez(os.path.join(tmp, "in-ep.npz"), x=np.asarray(x),
             **{k: np.asarray(v) for k, v in jp._asdict().items()})
    params, batch = moe_inputs
    np.savez(os.path.join(tmp, "in-step.npz"), **batch,
             **{"p/" + k: v for k, v in _flat(params).items()})
    t0 = time.monotonic()
    ctx = mp.start_processes(_world, args=(os.path.join(tmp, "store"), tmp),
                             nprocs=WORLD, join=False, start_method="spawn")
    dense_out, dense_aux = jax.jit(lambda p, x: jmoe.moe_layer(
        p, x, top_k=2, capacity_factor=EP["cf"]))(jp, x)
    jax_out = {"ep": (np.asarray(dense_out), float(dense_aux))}
    for axes, name in zip(MESHES, MESH_IDS):
        jax_out[name] = _jax_step(axes, params, batch)
    jax_s = time.monotonic() - t0
    while not ctx.join(timeout=1):
        pass
    port = {name: dict(np.load(os.path.join(tmp, f"out-{name}.npz")))
            for name in MESH_IDS + ["ep"]}
    print(f"JAX side {jax_s:.1f} s; world of {WORLD} "
          f"{time.monotonic() - t0:.1f} s")
    return {"jax": jax_out, "port": port}


def test_moe_ep_matches_dense(runs):
    """``test_moe_ep_matches_dense``: the expert-parallel layer on
    {ep 4} (tokens and experts split, ``comm.all_to_all`` both ways)
    equals the JAX package's dense layer, atol 1e-5."""
    want_out, want_aux = runs["jax"]["ep"]
    got = runs["port"]["ep"]
    np.testing.assert_allclose(got["out"], want_out, atol=1e-5)
    assert np.isfinite(float(got["aux"]))


@pytest.mark.parametrize("name", MESH_IDS)
def test_moe_train_step_matches_gspmd(runs, name):
    """A MoE ``build_gpt_train`` step with tokens dropped, on the mesh,
    against the JAX package's GSPMD step on the same mesh: capacity,
    priority and the aux loss over the global batch."""
    port = runs["port"][name]
    grads = {k[2:]: v for k, v in port.items() if k.startswith("g/")}
    _assert_step(float(port["loss"]), float(port["grad_norm"]), grads,
                 runs["jax"][name], name)
