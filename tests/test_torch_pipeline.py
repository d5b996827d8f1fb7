"""Port parity: the pipeline (``ray_tpu_torch.parallel.pipeline`` and
``models.training.build_gpt_train_pp``) against the JAX package's
(``ray_tpu.parallel.pipeline``, ``ray_tpu.models.training.
build_gpt_train_pp``) on the same mesh shapes.

The port side runs in one 4-rank gloo world (``torch.multiprocessing``,
spawn, a ``FileStore`` under the test's directory) that takes every case
in turn: each rank imports only ``torch`` and the port, holds its stage's
slice of the JAX package's stage-stacked parameters
(``convert.params_from_jax(..., mesh=)``) and its rows of the batch
(``fns["shard_batch"]``), and rank 0 writes the loss, the gradients and
the post-step parameters, gathered back to the stage-stacked tree
(``fns["gather_params"]``), to an ``.npz`` file.  The JAX side runs in
the pytest process on ``jax.devices()[:n]`` while the world runs: one
``step_fn`` of ``build_gpt_train_pp`` whose optimizer keeps the
gradients it is given as its state (``_keep_grads``), so the JAX
package's loss, grad norm and gradients come from its own step.

Cases (``tests/test_parallel.py``'s, cut to 4 ranks):
``test_pipeline_matches_sequential`` ({pp 4}, M = 6); the GPT on
{pp 2, tp 2} with GPipe (``test_gpt_pipeline_parallel_matches_dense``'s
model, M = 4); ``test_1f1b_parity_with_non_pipelined``'s remat model on
{pp 2, dp 2} with 1F1B, against the JAX package's 1F1B on {pp 2, dp 2}
and its non-pipelined trainer (SGD at 1e-2 on both sides: loss,
grad norm and every post-step leaf with the stage dimension folded
back); 1F1B on {pp 2, fsdp 2}; masked targets on {pp 2, dp 2} with one
microbatch holding no valid target; bf16 on {pp 2, tp 2}; 1F1B on
{pp 4} at M = 8 > 2 pp - 1 (the saved inputs wrap); and 1F1B staged over
``dcn`` ({dcn 2, dp 2}, which the reference cannot run on this jax)
against GPipe on {pp 2, dp 2} at the same global batch; GPipe and 1F1B
on {pp 2, sp 2}, each stage's sequence sharded over sp; GPipe on
{pp 2, tp 2} in every GPT mode at once (LayerNorm, gelu, learned
positions, biases, an untied head).

Bounds: f32 losses within rtol 2e-5, atol 2e-6 and grad norms within
rtol 2e-4, atol 2e-5 (the reference test's); every gradient leaf and
every post-step leaf within rtol 1e-4, atol 1e-5 (the reference's
post-step bound); bf16 losses within 3e-2 and gradients within atol
3e-2, rtol 5e-3 (``tests/test_torch_overlap.py``'s bf16 bounds).  The
returned dict's ``schedule``, ``stage_axis``, ``bubble_fraction`` and
``in_flight_microbatches`` equal the JAX package's.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
DENSE = dict(vocab_size=256, d_model=32, n_layers=4, n_heads=4, max_seq=32)
BASE = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4, max_seq=32)
SGD_LR = 1e-2
# (name, port mesh, JAX mesh, config, schedule, M, batch, seq, mask)
CASES = [
    ("gpipe-pp2-tp2", dict(pp=2, tp=2), dict(pp=2, tp=2), dict(DENSE),
     "gpipe", 4, 8, 16, None),
    ("1f1b-pp2-dp2-remat", dict(pp=2, dp=2), dict(pp=2, dp=2),
     dict(BASE, remat=True), "1f1b", 4, 8, 32, None),
    ("1f1b-pp2-fsdp2", dict(pp=2, fsdp=2), dict(pp=2, fsdp=2), dict(BASE),
     "1f1b", 4, 8, 32, None),
    ("1f1b-pp2-dp2-masked", dict(pp=2, dp=2), dict(pp=2, dp=2), dict(BASE),
     "1f1b", 4, 8, 32, "microbatch"),
    ("bf16-1f1b-pp2-tp2", dict(pp=2, tp=2), dict(pp=2, tp=2),
     dict(BASE, dtype="bfloat16"), "1f1b", 4, 8, 32, None),
    ("1f1b-pp4-m8", dict(pp=4), dict(pp=4), dict(BASE), "1f1b", 8, 8, 32,
     None),
    # the reference's dcn test model (2 layers, batch 4 x 32, M = 2);
    # JAX holds GPipe on {pp 2, dp 2}: it cannot stage 1F1B over dcn
    ("1f1b-dcn2-dp2", dict(dcn=2, dp=2), dict(pp=2, dp=2),
     dict(BASE, n_layers=2), "1f1b", 2, 4, 32, None),
    ("gpipe-pp2-dp2-l2", dict(pp=2, dp=2), dict(pp=2, dp=2),
     dict(BASE, n_layers=2), "gpipe", 2, 4, 32, None),
    # each stage's sequence sharded over sp (ring attention), the
    # transfers carrying each rank's shard; the reference's GSPMD shards
    # it through _pp_batch_sharding
    ("gpipe-pp2-sp2", dict(pp=2, sp=2), dict(pp=2, sp=2), dict(BASE),
     "gpipe", 4, 8, 32, None),
    ("1f1b-pp2-sp2", dict(pp=2, sp=2), dict(pp=2, sp=2), dict(BASE),
     "1f1b", 4, 8, 32, None),
    # every GPT mode at once (the first stage adds the learned positions,
    # the last the untied head and the final norm's bias; the
    # row-parallel biases once after each tp sum), biases and norms
    # perturbed off their zeros and ones
    ("gpipe-pp2-tp2-modes", dict(pp=2, tp=2), dict(pp=2, tp=2),
     dict(DENSE, norm="layernorm", act="gelu", pos="learned", use_bias=True,
          tie_embeddings=False), "gpipe", 4, 8, 16, None),
]
IDS = [c[0] for c in CASES]
PARITY = "1f1b-pp2-dp2-remat"
SEQ = dict(d=16, M=6, rows=8)


def _dtype(cfg, lib):
    return getattr(lib, cfg.get("dtype", "float32"))


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


# ---------------------------------------------------------------------------
# the port's world (rank side: torch and the port only)
# ---------------------------------------------------------------------------

class _SGD:
    """``optax.sgd(lr)`` on the port's optimizer interface."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, grads, state, params, g_norm=None):
        from ray_tpu_torch.models.training import _leaves
        for p, g in zip(_leaves(params), _leaves(grads)):
            p.copy_(p + (-self.lr * g.float()).to(p.dtype))
        return state


def _inputs(tmp, name):
    data = dict(np.load(os.path.join(tmp, f"in-{name}.npz")))
    params = _unflat({k[2:]: v for k, v in data.items()
                      if k.startswith("p/")})
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "targets")}
    return params, batch


def _port_params(params, cfg, mesh):
    """This rank's shards of the f32 stage-stacked numpy tree, in
    ``cfg.dtype`` (bf16 rounded from the f32 values, as the JAX side's
    ``astype``)."""
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models.gpt import param_logical_axes
    from ray_tpu_torch.parallel.sharding import (pp_rules, shard_params,
                                                 stage_stacked_axes)
    if cfg.dtype == torch.float32:
        return params_from_jax(params, cfg, device="cpu", mesh=mesh)
    full = {k: (torch.from_numpy(v).to(cfg.dtype) if not isinstance(v, dict)
                else {kk: torch.from_numpy(vv).to(cfg.dtype)
                      for kk, vv in v.items()})
            for k, v in params.items()}
    axis = "pp" if "pp" in dict(mesh.shape.items()) else "dcn"
    return shard_params(full, mesh,
                        stage_stacked_axes(param_logical_axes(cfg)),
                        pp_rules(axis))


def _seq_case(rank, tmp):
    """pipeline_apply over {pp 4}: each rank holds its stage's weight."""
    from ray_tpu_torch.parallel import pipeline
    from ray_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(pp=WORLD)
    data = dict(np.load(os.path.join(tmp, "in-seq.npz")))
    w = torch.from_numpy(data["w"][rank])
    x = torch.from_numpy(data["x"])

    def stage_fn(p, a):
        return torch.relu(a @ p["w"])

    out = pipeline.pipeline_apply(stage_fn, {"w": w}, x, mesh=mesh,
                                  num_microbatches=SEQ["M"])
    outs = [torch.empty_like(out) for _ in range(WORLD)]
    import torch.distributed as dist
    dist.all_gather(outs, out)
    if rank == 0:
        np.savez(os.path.join(tmp, "out-seq.npz"),
                 **{f"r{i}": o.numpy() for i, o in enumerate(outs)})


def _gpt_case(rank, tmp, case):
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel.mesh import make_mesh
    name, axes, _jaxes, cfg_kw, schedule, M = case[:6]
    t0 = time.monotonic()
    cfg = gpt.GPTConfig(**dict(cfg_kw, dtype=_dtype(cfg_kw, torch)))
    mesh = make_mesh(**axes)
    params, batch = _inputs(tmp, name)
    fns = training.build_gpt_train_pp(
        cfg, mesh, num_microbatches=M, schedule=schedule,
        optimizer=_SGD(SGD_LR), device="cpu", telemetry=name == PARITY)
    local = fns["shard_batch"](batch)
    state = fns["init_fn"](params=_port_params(params, cfg, mesh))
    loss, grads = fns["value_and_grad_fn"](state.params, local)
    eval_loss = fns["loss_fn"](state.params, local)
    out = {"loss": float(loss), "eval_loss": float(eval_loss)}
    out.update({f"g/{k}": v for k, v in
                _flat(_np_tree(fns["gather_params"](grads))).items()})
    state, m = fns["step_fn"](state, local)
    out.update(step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    out.update({f"p/{k}": v for k, v in
                _flat(_np_tree(fns["gather_params"](state.params))).items()})
    info = {k: fns[k] for k in ("schedule", "stage_axis", "bubble_fraction",
                                "in_flight_microbatches",
                                "num_microbatches")}
    if "telemetry" in fns:
        summ = fns["telemetry"].summary()
        info["summary"] = {k: v for k, v in summ.items()
                           if k in ("label", "steps", "tokens_per_step")
                           or k.startswith("collective")}
    if rank == 0:
        np.savez(os.path.join(tmp, f"out-{name}.npz"),
                 secs=time.monotonic() - t0, info=json.dumps(info), **out)


def _world(rank, store, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    _seq_case(rank, tmp)
    for case in CASES:
        _gpt_case(rank, tmp, case)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side (pytest process)
# ---------------------------------------------------------------------------

def _keep_grads():
    """An optax transformation that keeps the gradients it is given as
    its state and updates nothing: one step gives the trainer's own
    gradients exactly."""
    import jax
    import jax.numpy as jnp
    import optax
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_case(case, params, batch):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh
    name, _axes, jaxes, cfg_kw, schedule, M = case[:6]
    cfg = jgpt.GPTConfig(**dict(cfg_kw, dtype=_dtype(cfg_kw, jnp)))
    n = int(np.prod(list(jaxes.values())))
    mesh = make_mesh(**jaxes, devices=jax.devices()[:n])
    tx = _keep_grads()
    fns = jtrain.build_gpt_train_pp(cfg, mesh, schedule=schedule,
                                    num_microbatches=M, optimizer=tx,
                                    telemetry=name == PARITY)
    p = jax.tree.map(lambda a: jnp.asarray(a, cfg.dtype), params)
    st = jtrain.TrainState(p, tx.init(p), jnp.zeros((), jnp.int32))
    st, m = fns["step_fn"](st, batch)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "grads": {k: np.asarray(v, np.float32)
                     for k, v in _flat(jax.device_get(st.opt_state)).items()},
           "info": {k: fns[k] for k in (
               "schedule", "stage_axis", "bubble_fraction",
               "in_flight_microbatches", "num_microbatches")}}
    if "telemetry" in fns:
        summ = fns["telemetry"].summary()
        out["summary"] = {k: v for k, v in summ.items()
                          if k in ("label", "steps", "tokens_per_step")
                          or k.startswith("collective")}
    return out


def _jax_non_pipelined(cfg_kw, params, batch):
    """``test_1f1b_parity_with_non_pipelined``'s reference: the JAX
    package's non-pipelined trainer on one device, SGD, one step."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh
    cfg = jgpt.GPTConfig(**dict(cfg_kw, dtype=jnp.float32))
    fns = jtrain.build_gpt_train(cfg, make_mesh(dp=1,
                                                devices=jax.devices()[:1]),
                                 optimizer=optax.sgd(SGD_LR),
                                 telemetry=False)
    flat = dict(params)
    flat["layers"] = {k: v.reshape((-1,) + v.shape[2:])
                      for k, v in params["layers"].items()}
    p = jax.tree.map(jnp.asarray, flat)
    st = jtrain.TrainState(p, optax.sgd(SGD_LR).init(p),
                           jnp.zeros((), jnp.int32))
    st, m = fns["step_fn"](st, batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {k: np.asarray(v, np.float32) for k, v in
                       _flat(jax.device_get(st.params)).items()}}


def _jax_seq(w, x):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import pipeline
    from ray_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(pp=WORLD, devices=jax.devices()[:WORLD])

    def stage_fn(p, a):
        return jax.nn.relu(a @ p["w"])

    out = jax.jit(lambda p, x: pipeline.pipeline_apply(
        stage_fn, p, x, mesh=mesh, num_microbatches=SEQ["M"]))(
        {"w": jnp.asarray(w)}, jnp.asarray(x))
    return np.asarray(out)


def _perturbed(tree, rng):
    """Biases and norm scales moved off their zeros and ones."""
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k.startswith(("ln", "b")):
            out[k] = (np.asarray(v) + 0.1 * rng.standard_normal(
                np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _make_batch(vocab, b, s, mask, M):
    import jax

    from ray_tpu.models import training as jtrain
    batch = {k: np.asarray(v) for k, v in jtrain.synthetic_lm_batch(
        jax.random.PRNGKey(1), b, s, vocab).items()}
    if mask == "microbatch":
        # microbatch 1 holds no valid target; the others some
        batch["targets"] = batch["targets"].copy()
        rows = b // M
        batch["targets"][rows:2 * rows] = -1
        batch["targets"][:, :s // 4] = -1
    return batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import torch.multiprocessing as mp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh

    tmp = str(tmp_path_factory.mktemp("pipeline"))
    ks = jax.random.split(jax.random.PRNGKey(0), WORLD)
    d = SEQ["d"]
    w = np.stack([np.asarray(jax.random.normal(k, (d, d)) * 0.3)
                  for k in ks])
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (SEQ["M"], SEQ["rows"], d)))
    np.savez(os.path.join(tmp, "in-seq.npz"), w=w, x=x)
    inputs = {}
    for name, _a, jaxes, cfg_kw, sched, M, b, s, mask in CASES:
        # the JAX trainer's own stage-stacked initial parameters (f32)
        cfg = jgpt.GPTConfig(**dict(cfg_kw, dtype=jnp.float32))
        n = int(np.prod(list(jaxes.values())))
        fns = jtrain.build_gpt_train_pp(
            cfg, make_mesh(**jaxes, devices=jax.devices()[:n]),
            schedule="gpipe", num_microbatches=M, telemetry=False)
        params = jax.tree.map(np.asarray, jax.device_get(
            fns["init_fn"](jax.random.PRNGKey(0)).params))
        if cfg.use_bias:
            params = _perturbed(params, np.random.default_rng(2))
        batch = _make_batch(cfg.vocab_size, b, s, mask, M)
        inputs[name] = (params, batch)
        np.savez(os.path.join(tmp, f"in-{name}.npz"), **batch,
                 **{"p/" + k: v for k, v in _flat(params).items()})
    t0 = time.monotonic()
    ctx = mp.start_processes(_world, args=(os.path.join(tmp, "store"), tmp),
                             nprocs=WORLD, join=False, start_method="spawn")
    jax_out = {"seq": _jax_seq(w, x)}
    for case in CASES:
        if case[0] == "1f1b-dcn2-dp2":
            continue
        jax_out[case[0]] = _jax_case(case, *inputs[case[0]])
    # the same JAX step: GPipe on {pp 2, dp 2} at the same model and batch
    jax_out["1f1b-dcn2-dp2"] = jax_out["gpipe-pp2-dp2-l2"]
    parity = next(c for c in CASES if c[0] == PARITY)
    jax_out["non-pipelined"] = _jax_non_pipelined(parity[3],
                                                  *inputs[PARITY])
    jax_s = time.monotonic() - t0
    while not ctx.join(timeout=1):
        pass
    port = {name: dict(np.load(os.path.join(tmp, f"out-{name}.npz")))
            for name in IDS}
    port["seq"] = dict(np.load(os.path.join(tmp, "out-seq.npz")))
    print(f"JAX side {jax_s:.1f} s; world of {WORLD} "
          f"{time.monotonic() - t0:.1f} s; per case "
          f"{ {n: round(float(port[n]['secs']), 2) for n in IDS} }")
    return {"jax": jax_out, "port": port, "inputs": inputs,
            "seq_in": (w, x)}


def _tol(name):
    if name.startswith("bf16"):
        return (dict(rtol=3e-2, atol=3e-2), dict(rtol=3e-2, atol=3e-2),
                dict(rtol=5e-3, atol=3e-2))
    return (dict(rtol=2e-5, atol=2e-6), dict(rtol=2e-4, atol=2e-5),
            dict(rtol=1e-4, atol=1e-5))


def _grads(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def test_pipeline_matches_sequential(runs):
    """``test_pipeline_matches_sequential`` on {pp 4}, M = 6: the port's
    GPipe forward on every rank equals the sequential stages and the JAX
    package's ``pipeline_apply`` (atol 1e-5)."""
    w, x = runs["seq_in"]
    ref = x
    for s in range(WORLD):
        ref = np.maximum(ref @ w[s], 0.0)
    for r in range(WORLD):
        got = runs["port"]["seq"][f"r{r}"]
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(got, runs["jax"]["seq"], atol=1e-5)


@pytest.mark.parametrize("name", IDS)
def test_pipeline_step_matches_jax(runs, name):
    """The port's ``build_gpt_train_pp`` against the JAX package's on the
    case's mesh: the loss (``value_and_grad_fn``'s, ``loss_fn``'s and the
    step's), the grad norm and every gradient leaf of the stage-stacked
    tree, and the dict's schedule figures."""
    port, want = runs["port"][name], runs["jax"][name]
    loss_tol, norm_tol, grad_tol = _tol(name)
    for key in ("loss", "eval_loss", "step_loss"):
        np.testing.assert_allclose(float(port[key]), want["loss"],
                                   **loss_tol, err_msg=f"{name}: {key}")
    np.testing.assert_allclose(float(port["grad_norm"]), want["grad_norm"],
                               **norm_tol, err_msg=f"{name}: grad norm")
    got = _grads(port, "g/")
    assert got.keys() == want["grads"].keys()
    for path, w in want["grads"].items():
        np.testing.assert_allclose(got[path], w, **grad_tol,
                                   err_msg=f"{name}: grad {path}")
    info = json.loads(str(port["info"]))
    summary = info.pop("summary", None)
    if name.startswith("1f1b-dcn"):
        # JAX held GPipe here; the figures are the reference's analytic
        # ones for 1F1B over the dcn axis
        from ray_tpu.parallel.pipeline import pipeline_schedule_stats
        stats = pipeline_schedule_stats(2, info["num_microbatches"], "1f1b")
        assert info == {"schedule": "1f1b", "stage_axis": "dcn",
                        "bubble_fraction": stats["bubble_fraction"],
                        "in_flight_microbatches":
                            stats["in_flight_microbatches"],
                        "num_microbatches": 2}
    else:
        assert info == want["info"]
    if summary is not None:
        jsum = want["summary"]
        assert summary["label"] == jsum["label"] == "train_pp"
        assert summary["steps"] == jsum["steps"] == 1
        assert summary["collective_bytes_ici"] == jsum["collective_bytes_ici"]
        assert summary["collective_bytes_dcn"] == jsum["collective_bytes_dcn"]
        g = summary["collective_bytes_per_step"]
        w = jsum["collective_bytes_per_step"]
        for tier in ("ici", "dcn"):
            assert {k: v for k, v in g[tier].items() if k != "seconds"} == \
                {k: v for k, v in w[tier].items() if k != "seconds"}


def test_1f1b_parity_with_non_pipelined(runs):
    """``test_1f1b_parity_with_non_pipelined``: 1F1B with remat against
    the JAX package's non-pipelined trainer at the same global batch,
    SGD at 1e-2: equal loss (rtol 2e-5, atol 2e-6) and grad norm (rtol
    2e-4, atol 2e-5), and every post-step leaf, the stage dimension
    folded back, within rtol 1e-4, atol 1e-5."""
    from ray_tpu_torch.convert import fold_stages
    port, want = runs["port"][PARITY], runs["jax"]["non-pipelined"]
    assert runs["jax"][PARITY]["info"]["in_flight_microbatches"] == 3
    np.testing.assert_allclose(float(port["step_loss"]), want["loss"],
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(port["grad_norm"]), want["grad_norm"],
                               rtol=2e-4, atol=2e-5)
    got = _flat(fold_stages(_unflat(_grads(port, "p/"))))
    assert got.keys() == want["params"].keys()
    for path, w in want["params"].items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=1e-5,
                                   err_msg=f"param drift at {path}")


def test_1f1b_stages_over_dcn_axis(runs):
    """``test_1f1b_stages_over_dcn_axis``: 1F1B staged over ``dcn`` (one
    stage per pod) gives GPipe-on-pp's loss at the same global batch
    (rtol 2e-5, atol 2e-6), here both the port's; the reference raises
    on this mesh (ROADMAP Queue 3)."""
    dcn = runs["port"]["1f1b-dcn2-dp2"]
    pp = runs["port"]["gpipe-pp2-dp2-l2"]
    for key in ("eval_loss", "loss"):
        np.testing.assert_allclose(float(dcn[key]), float(pp[key]),
                                   rtol=2e-5, atol=2e-6)


def test_masked_microbatch_weights(runs):
    """With one microbatch holding no valid target, each microbatch's
    loss is weighted by its share of the global count (``n_u /
    n_total``): the masked-mean loss and its gradients equal the JAX
    package's (checked in ``test_pipeline_step_matches_jax``), and the
    empty microbatch adds nothing."""
    params, batch = runs["inputs"]["1f1b-pp2-dp2-masked"]
    rows = batch["targets"].shape[0] // 4
    assert (batch["targets"][rows:2 * rows] < 0).all()
    assert (batch["targets"] >= 0).sum() > 0
    assert np.isfinite(float(runs["port"]["1f1b-pp2-dp2-masked"]["loss"]))


def test_pipeline_schedule_stats():
    """``test_pipeline_schedule_stats``, and the port's figures equal the
    JAX package's over a grid of stages, microbatches and schedules."""
    from ray_tpu.parallel.pipeline import pipeline_schedule_stats as jstats
    from ray_tpu_torch.parallel.pipeline import pipeline_schedule_stats

    g = pipeline_schedule_stats(4, 8, "gpipe")
    assert g["ticks"] == 8 + 4 - 1
    assert g["bubble_fraction"] == pytest.approx(3 / 11)
    assert g["in_flight_microbatches"] == 8
    f = pipeline_schedule_stats(4, 8, "1f1b")
    assert f["ticks"] == 8 + 2 * 4 - 2
    assert f["bubble_fraction"] == pytest.approx(6 / 14)
    assert f["in_flight_microbatches"] == 7
    assert pipeline_schedule_stats(4, 64, "1f1b")[
        "in_flight_microbatches"] == 7
    s = pipeline_schedule_stats(1, 4, "1f1b")
    assert s["bubble_fraction"] == 0.0 and s["ticks"] == 4
    with pytest.raises(ValueError, match="schedule"):
        pipeline_schedule_stats(2, 4, "zb-h1")
    for pp in (1, 2, 3, 4):
        for M in (1, 2, 4, 7, 8, 64):
            for sched in ("gpipe", "1f1b"):
                assert pipeline_schedule_stats(pp, M, sched) == \
                    jstats(pp, M, sched)


def test_build_gpt_train_pp_raises_as_the_reference():
    """The reference's refusals, with its messages: gpipe without a pp
    axis, 1f1b with neither pp nor dcn above 1, layers that do not split
    over the stages, MoE, a batch the microbatches do not divide, and a
    packed batch."""
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    cfg = gpt.GPTConfig(**dict(BASE, dtype=torch.float32))
    one = make_mesh(pp=1)
    with pytest.raises(ValueError, match="needs a 'pp' mesh axis"):
        training.build_gpt_train_pp(cfg, make_mesh(dp=1), schedule="gpipe",
                                    device="cpu")
    with pytest.raises(ValueError, match="needs a 'pp' axis or a 'dcn'"):
        training.build_gpt_train_pp(cfg, make_mesh(dp=1), schedule="1f1b",
                                    device="cpu")
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        training.build_gpt_train_pp(cfg, one, schedule="zb", device="cpu")
    with pytest.raises(ValueError, match="not divisible by stages=3"):
        training.build_gpt_train_pp(cfg, MeshSpec.create(pp=3),
                                    schedule="gpipe", device="cpu")
    with pytest.raises(ValueError, match="MoE \\+ pipeline"):
        training.build_gpt_train_pp(
            gpt.GPTConfig(**dict(BASE, n_experts=2, dtype=torch.float32)),
            one, schedule="gpipe", device="cpu")
    fns = training.build_gpt_train_pp(cfg, one, num_microbatches=3,
                                      schedule="1f1b", device="cpu",
                                      telemetry=False)
    assert (fns["stage_axis"], fns["bubble_fraction"],
            fns["in_flight_microbatches"]) == ("pp", 0.0, 1)
    batch = training.synthetic_lm_batch(torch.Generator().manual_seed(0), 4,
                                        8, cfg.vocab_size, device="cpu")
    with pytest.raises(ValueError, match="batch=4 not divisible by "
                                         "microbatches=3"):
        fns["shard_batch"](batch)
    fns = training.build_gpt_train_pp(cfg, one, num_microbatches=2,
                                      schedule="gpipe", device="cpu",
                                      telemetry=False)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="segment_ids"):
        fns["loss_fn"](state.params, dict(batch, segment_ids=batch["tokens"]))
