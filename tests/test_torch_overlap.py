"""Port parity: the overlap schedule (``ray_tpu_torch.parallel.overlap``)
against the JAX package's (``ray_tpu.parallel.overlap``) on the same mesh
shapes.

The port side runs in one 4-rank gloo world (``torch.multiprocessing``,
spawn, a ``FileStore`` under the test's directory) that takes every case
in turn; its ranks import only ``torch`` and the port, take their shards
through ``convert.params_from_jax(..., mesh=)`` and their rows through
``sharding.shard_batch``, and rank 0 writes each case's loss and
gradients (gathered to full) to an ``.npz`` file.  The JAX side runs
once, in the pytest process, on ``make_mesh(..., devices=jax.devices()[:4])``
while the world runs: ``build_overlap_step_fns``' ``value_and_grad``
under ``jax.jit``, from the same parameters and batch.

Cases (the reference's ``tests/test_parallel.py:279-437``, cut to 4
ranks): {fsdp 4}; {fsdp 2, tp 2} at 3 layers with masked targets (one
rank's rows and sequence chunk hold none); the
uneven shapes (d_model 48, d_ff 40, vocab 192, batch 6, seq 24) on
{fsdp 2, tp 2}; {dp 2, tp 2} with ``remat``; {dcn 2, fsdp 2}; and bf16
on {fsdp 2, tp 2}.  Bounds, ``_overlap_vs_gspmd``'s: the loss within
rtol 2e-4, atol 2e-5; every gradient leaf within rtol 5e-3, atol 5e-5;
bf16 loss rtol and atol 3e-2, gradients atol 3e-2.  The same bounds hold
each case against the port's own gspmd step on the same mesh.

The int8 wire: its forward rounds to nearest, so its loss equals the JAX
package's int8 loss at the f32 bounds; its gradients (stochastic ring
reduce-scatters, which cannot equal ``jax.random``'s draws) are held to
the reference's budget against the port's own unquantized ones: the loss
within 1%, each leaf's relative error norm at most 5%
(``test_overlap_quantized_wire_grad_budget``) or, on a mesh where the
JAX package's own int8 wire exceeds that (5.57% at most on {fsdp 4} at 3
layers, 5.06% on the masked {fsdp 2, tp 2}; 5.00% on the reference's own
{fsdp 4, tp 2}), at most 5% above the JAX package's error.  The "dcn" wire on {dcn 2,
fsdp 2}: the loss equal to the unquantized one within 1e-6 relative, and
each leaf's largest error under 5% of its largest value
(``test_hierarchical_dcn_quant_grad_budget``).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
BASE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, max_seq=32)
UNEVEN = dict(vocab_size=192, d_model=48, n_layers=3, n_heads=4, d_ff=40,
              max_seq=24)
OPT = dict(lr=1e-3, warmup=1, total_steps=8)
STEPS = 3
# (name, mesh axes, config, batch, seq, masked targets)
CASES = [
    ("fsdp4", dict(fsdp=4), dict(BASE), 8, 32, False),
    ("fsdp2-tp2-l3-masked", dict(fsdp=2, tp=2), dict(BASE, n_layers=3), 8,
     32, True),
    ("uneven-fsdp2-tp2", dict(fsdp=2, tp=2), dict(UNEVEN), 6, 24, False),
    ("dp2-tp2-remat", dict(dp=2, tp=2), dict(BASE, remat=True), 8, 32,
     False),
    ("dcn2-fsdp2", dict(dcn=2, fsdp=2), dict(BASE), 8, 32, False),
    ("bf16-fsdp2-tp2", dict(fsdp=2, tp=2), dict(BASE, dtype="bfloat16"), 8,
     32, False),
    # every GPT mode at once: the schedule's biases (bo and b2 after the
    # reduce-scatter), gelu, the gathered learned positions and the
    # gathered untied head; biases and norms perturbed
    ("fsdp2-tp2-modes", dict(fsdp=2, tp=2),
     dict(BASE, norm="layernorm", act="gelu", pos="learned", use_bias=True,
          tie_embeddings=False), 8, 32, False),
]
IDS = [c[0] for c in CASES]
# the int8 wire: {fsdp 4} at 3 layers (three hops a reduce-scatter) and
# the masked {fsdp 2, tp 2} case
INT8 = [("int8-fsdp4-l3", dict(fsdp=4), dict(BASE, n_layers=3), 8, 32,
         False),
        ("int8-fsdp2-tp2-l3-masked",) + CASES[1][1:]]
INT8_IDS = [c[0] for c in INT8]
ALL = CASES + INT8
STEP_AXES = dict(fsdp=2, tp=2)
RING = dict(T=4, K=8, M=12)
# every entry of the order-of-issue record: profiler ranges of overlap.py
ORDER_CASE = INT8[0]


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

def _inputs(tmp, name):
    data = dict(np.load(os.path.join(tmp, f"in-{name}.npz")))
    params = _unflat({k[2:]: v for k, v in data.items()
                      if k.startswith("p/")})
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "targets")}
    return params, batch


def _port_params(params, cfg, mesh):
    """This rank's shards of the f32 numpy tree, in ``cfg.dtype`` (bf16
    rounded from the f32 values, as the JAX side's ``astype``)."""
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models.gpt import param_logical_axes
    from ray_tpu_torch.parallel.sharding import shard_params
    if cfg.dtype == torch.float32:
        return params_from_jax(params, cfg, device="cpu", mesh=mesh)
    full = {k: (torch.from_numpy(v).to(cfg.dtype) if not isinstance(v, dict)
                else {kk: torch.from_numpy(vv).to(cfg.dtype)
                      for kk, vv in v.items()})
            for k, v in params.items()}
    return shard_params(full, mesh, param_logical_axes(cfg))


def _full_grads(grads, cfg, mesh):
    from ray_tpu_torch.models.gpt import param_logical_axes
    from ray_tpu_torch.parallel import sharding
    return _flat(_np_tree(sharding.gather_params(
        grads, mesh, param_logical_axes(cfg))))


def _ring_case(rank, tmp):
    """ring_allgather_matmul on {tp 4}: x's rows sharded, each rank's
    weights its columns of the full ones; values, and the gradients of x
    and of every weight, gathered to full."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import comm
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.overlap import ring_allgather_matmul
    mesh = make_mesh(tp=WORLD)
    tp = mesh.axes_group(("tp",))
    T, K, M = RING["T"], RING["K"], RING["M"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, WORLD * T, K, generator=g)
    w1 = torch.randn(K, WORLD * M, generator=g)
    w2 = torch.randn(K, 2, WORLD * 3, generator=g)
    r = dist.get_rank()
    xl = x[:, r * T:(r + 1) * T].clone().requires_grad_(True)
    w1l = w1[:, r * M:(r + 1) * M].clone().requires_grad_(True)
    w2l = w2[..., r * 3:(r + 1) * 3].clone().requires_grad_(True)
    a, b = ring_allgather_matmul(xl, [w1l, w2l], tp)
    single = ring_allgather_matmul(xl, w1l, tp)
    ((a ** 2).sum() + (b ** 3).sum()).backward()
    out = {"a": comm.all_gather_dim(a.detach(), 2, tp),
           "b": comm.all_gather_dim(b.detach(), 3, tp),
           "single": comm.all_gather_dim(single.detach(), 2, tp),
           "dx": comm.all_gather_dim(xl.grad, 1, tp),
           "dw1": comm.all_gather_dim(w1l.grad, 1, tp),
           "dw2": comm.all_gather_dim(w2l.grad, 2, tp)}
    # bf16 operands, f32 products (the vocabulary head's form)
    f32 = ring_allgather_matmul(xl.detach().bfloat16(), w1l.detach()
                                .bfloat16(), tp, out_dtype=torch.float32)
    out["f32"] = comm.all_gather_dim(f32, 2, tp)
    if rank == 0:
        np.savez(os.path.join(tmp, "ring.npz"),
                 **{k: v.numpy() for k, v in out.items()})


def _overlap_run(cfg, mesh, params, batch, quant):
    from ray_tpu_torch.parallel import overlap, sharding
    fns = overlap.build_overlap_step_fns(cfg, mesh, quant=quant,
                                         device="cpu")
    local = sharding.shard_batch(batch, mesh)
    loss, grads = fns["value_and_grad"](params, local["tokens"],
                                        local["targets"])
    no_grad_loss = fns["loss"](params, local["tokens"], local["targets"])
    return float(loss), grads, float(no_grad_loss)


def _case(rank, tmp, case, quants):
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import make_mesh
    name, axes, cfg_kw, _b, _s, _m = case
    t0 = time.monotonic()
    cfg = gpt.GPTConfig(**dict(cfg_kw, dtype=_dtype(cfg_kw, torch)))
    mesh = make_mesh(**axes)
    params, batch = _inputs(tmp, name)
    shards = _port_params(params, cfg, mesh)
    out = {}
    for quant in quants:
        loss, grads, no_grad_loss = _overlap_run(cfg, mesh, shards, batch,
                                                 quant)
        out[f"{quant}/loss"] = loss
        out[f"{quant}/no_grad_loss"] = no_grad_loss
        out.update({f"{quant}/g/{k}": v for k, v in
                    _full_grads(grads, cfg, mesh).items()})
    if "none" in quants:
        fns = training.build_gpt_train(cfg, mesh, comm_mode="gspmd",
                                       device="cpu", telemetry=False)
        loss, grads = fns["value_and_grad_fn"](
            shards, sharding.shard_batch(batch, mesh))
        out["gspmd/loss"] = float(loss)
        out.update({f"gspmd/g/{k}": v for k, v in
                    _full_grads(grads, cfg, mesh).items()})
    if rank == 0:
        np.savez(os.path.join(tmp, f"out-{name}.npz"),
                 secs=time.monotonic() - t0, **out)


def _order_case(rank, tmp):
    """One value_and_grad of the {fsdp 4}, 3-layer case under the
    profiler: the names and start times of overlap.py's ranges."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel.mesh import make_mesh
    name, axes, cfg_kw = ORDER_CASE[:3]
    cfg = gpt.GPTConfig(**dict(cfg_kw, dtype=torch.float32))
    mesh = make_mesh(**axes)
    params, batch = _inputs(tmp, name)
    shards = _port_params(params, cfg, mesh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _overlap_run(cfg, mesh, shards, batch, "none")
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name.startswith("overlap/"))
    if rank == 0:
        with open(os.path.join(tmp, "order.json"), "w") as f:
            json.dump([n for _, n in events], f)


def _steps_case(rank, tmp):
    """3 steps of build_gpt_train(comm_mode="overlap") with the step
    recorder on; 6 steps of the int8 wire at a larger learning rate; and
    the dispatch's choices on real meshes."""
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel.mesh import make_mesh
    cfg = gpt.GPTConfig(**dict(BASE, dtype=torch.float32))
    mesh = make_mesh(**STEP_AXES)
    params, batch = _inputs(tmp, "steps")
    out = {}
    fns = training.build_gpt_train(
        cfg, mesh, comm_mode="overlap",
        optimizer=training.default_optimizer(**OPT), device="cpu",
        telemetry=True)
    local = fns["shard_batch"](batch)
    state = fns["init_fn"](params=params_from_jax(params, cfg, device="cpu",
                                                  mesh=mesh))
    steps = []
    for _ in range(STEPS):
        state, m = fns["step_fn"](state, local)
        steps.append((float(m["loss"]), float(m["grad_norm"])))
    out["steps"] = steps
    out["summary"] = {k: v for k, v in fns["telemetry"].summary().items()
                      if k.startswith("collective") or k.startswith("comm")}
    out["modes"] = [fns["comm_mode"], fns["comm_quant"]]
    q = training.build_gpt_train(
        cfg, mesh, comm_mode="overlap", comm_quant="int8",
        optimizer=training.default_optimizer(lr=1e-2, warmup=1,
                                             total_steps=8),
        device="cpu", telemetry=False)
    state = q["init_fn"](params=params_from_jax(params, cfg, device="cpu",
                                                mesh=mesh))
    losses = []
    for _ in range(6):
        state, m = q["step_fn"](state, local)
        losses.append(float(m["loss"]))
    out["int8_losses"] = losses
    out["int8_modes"] = [q["comm_mode"], q["comm_quant"]]
    # the dispatch on real meshes: sp falls back, the wire is dropped
    # under gspmd, accumulation falls back
    picks = {}
    for label, axes, kw in (
            ("sp", dict(dp=2, sp=2), dict(comm_mode="overlap",
                                          comm_quant="int8")),
            ("gspmd-int8", STEP_AXES, dict(comm_mode="gspmd",
                                           comm_quant="int8")),
            ("accum", STEP_AXES, dict(comm_mode="overlap", accum_steps=2))):
        f = training.build_gpt_train(cfg, make_mesh(**axes), device="cpu",
                                     telemetry=False, **kw)
        picks[label] = [f["comm_mode"], f["comm_quant"]]
    out["picks"] = picks
    if rank == 0:
        with open(os.path.join(tmp, "steps.json"), "w") as f:
            json.dump(out, f)


def _world(rank, store, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    _ring_case(rank, tmp)
    for case in CASES:
        _case(rank, tmp, case, ("none", "dcn") if case[0] == "dcn2-fsdp2"
              else ("none",))
    for case in INT8:
        _case(rank, tmp, case, ("none", "int8"))
    _order_case(rank, tmp)
    _steps_case(rank, tmp)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side (pytest process)
# ---------------------------------------------------------------------------

def _jax_case(case, params, batch, quants):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import overlap as jovl
    from ray_tpu.parallel.mesh import make_mesh
    name, axes, cfg_kw = case[:3]
    cfg = jgpt.GPTConfig(**dict(cfg_kw, dtype=_dtype(cfg_kw, jnp)))
    mesh = make_mesh(**axes, devices=jax.devices()[:WORLD])
    p = jax.tree.map(lambda a: jnp.asarray(a, cfg.dtype), params)
    out = {}
    for quant in quants:
        o = jovl.build_overlap_step_fns(cfg, mesh, quant=quant)
        loss, grads = jax.jit(o["value_and_grad"])(p, batch["tokens"],
                                                   batch["targets"])
        out[quant] = (float(loss), {k: np.asarray(v, np.float32)
                                    for k, v in _flat(grads).items()})
    return out


def _jax_steps(params, batch):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel import overlap as jovl
    from ray_tpu.parallel.mesh import make_mesh
    cfg = jgpt.GPTConfig(**dict(BASE, dtype=jnp.float32))
    mesh = make_mesh(**STEP_AXES, devices=jax.devices()[:WORLD])
    fns = jtrain.build_gpt_train(cfg, mesh, comm_mode="overlap",
                                 optimizer=jtrain.default_optimizer(**OPT),
                                 telemetry=False)
    assert fns["comm_mode"] == "overlap"
    st = fns["init_fn"](jax.random.PRNGKey(0))
    assert all(np.array_equal(np.asarray(a), b) for a, b in
               zip(jax.tree.leaves(st.params), jax.tree.leaves(params)))
    steps = []
    for _ in range(STEPS):
        st, m = fns["step_fn"](st, batch)
        steps.append((float(m["loss"]), float(m["grad_norm"])))
    cb = jovl.collective_bytes_per_step(cfg, mesh, batch=8, seq=32,
                                        comm_mode="overlap", quant="none")
    return np.array(steps), cb


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


def _make_batch(vocab, b, s, masked):
    import jax

    from ray_tpu.models import training as jtrain
    batch = {k: np.asarray(v) for k, v in jtrain.synthetic_lm_batch(
        jax.random.PRNGKey(1), b, s, vocab).items()}
    if masked:
        # the reference's mask, and the first half of the first half of
        # the rows: on {fsdp 2, tp 2} rank 0's rows and sequence chunk
        # hold no valid target, and it still divides by the global count
        batch["targets"] = batch["targets"].copy()
        batch["targets"][:, :s // 4] = -1
        batch["targets"][:b // 2, :s // 2] = -1
    return batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import torch.multiprocessing as mp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh

    tmp = str(tmp_path_factory.mktemp("overlap"))
    inputs = {}
    for name, _axes, cfg_kw, b, s, masked in ALL:
        f32 = jgpt.GPTConfig(**dict(cfg_kw, dtype=jnp.float32))
        params = jax.tree.map(np.asarray,
                              jgpt.init_params(f32, jax.random.PRNGKey(0)))
        if f32.use_bias:
            params = _perturbed(params, np.random.default_rng(3))
        batch = _make_batch(f32.vocab_size, b, s, masked)
        inputs[name] = (params, batch)
    # the step case starts from the JAX step's own initial parameters
    cfg = jgpt.GPTConfig(**dict(BASE, dtype=jnp.float32))
    fns = jtrain.build_gpt_train(
        cfg, make_mesh(**STEP_AXES, devices=jax.devices()[:WORLD]),
        comm_mode="overlap", telemetry=False)
    inputs["steps"] = (jax.tree.map(np.asarray, jax.device_get(
        fns["init_fn"](jax.random.PRNGKey(0)).params)),
        _make_batch(256, 8, 32, False))
    for name, (params, batch) in inputs.items():
        np.savez(os.path.join(tmp, f"in-{name}.npz"), **batch,
                 **{"p/" + k: v for k, v in _flat(params).items()})
    t0 = time.monotonic()
    ctx = mp.start_processes(_world, args=(os.path.join(tmp, "store"), tmp),
                             nprocs=WORLD, join=False, start_method="spawn")
    jax_out = {}
    for case in CASES:
        jax_out[case[0]] = _jax_case(case, *inputs[case[0]], ("none",))
    for case in INT8:
        jax_out[case[0]] = _jax_case(case, *inputs[case[0]],
                                     ("none", "int8"))
    jax_steps = _jax_steps(*inputs["steps"])
    jax_s = time.monotonic() - t0
    while not ctx.join(timeout=1):
        pass
    port = {}
    for name, *_ in ALL:
        d = dict(np.load(os.path.join(tmp, f"out-{name}.npz")))
        port[name] = d
    with open(os.path.join(tmp, "steps.json")) as f:
        steps = json.load(f)
    with open(os.path.join(tmp, "order.json")) as f:
        order = json.load(f)
    print(f"JAX side {jax_s:.1f} s; world of {WORLD} "
          f"{time.monotonic() - t0:.1f} s; per case "
          f"{ {n: round(float(p['secs']), 2) for n, p in port.items()} }")
    return {"jax": jax_out, "port": port, "steps": steps,
            "jax_steps": jax_steps, "order": order,
            "ring": dict(np.load(os.path.join(tmp, "ring.npz")))}


def _grads(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _assert_parity(got_loss, got, want_loss, want, bf16, what):
    tol = dict(rtol=3e-2, atol=3e-2) if bf16 else dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_loss, want_loss, **tol,
                               err_msg=f"{what}: loss")
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=5e-3,
                                   atol=3e-2 if bf16 else 5e-5,
                                   err_msg=f"{what}: grad {path}")


@pytest.mark.parametrize("name", IDS)
def test_overlap_matches_jax_overlap(runs, name):
    """The port's ``build_overlap_step_fns`` against the JAX package's on
    the same mesh shape: the loss and every gradient leaf, gathered to
    full; the no-gradient ``loss`` equals ``value_and_grad``'s."""
    port = runs["port"][name]
    want_loss, want = runs["jax"][name]["none"]
    _assert_parity(float(port["none/loss"]), _grads(port, "none/g/"),
                   want_loss, want, "bf16" in name, name)
    np.testing.assert_allclose(float(port["none/no_grad_loss"]),
                               float(port["none/loss"]), rtol=1e-6)


@pytest.mark.parametrize("name", IDS)
def test_overlap_matches_port_gspmd(runs, name):
    """The same overlap run against the port's own gspmd step on the
    same mesh and shards, at the same bounds."""
    port = runs["port"][name]
    _assert_parity(float(port["none/loss"]), _grads(port, "none/g/"),
                   float(port["gspmd/loss"]), _grads(port, "gspmd/g/"),
                   "bf16" in name, name)


@pytest.mark.parametrize("name", INT8_IDS)
def test_int8_wire_loss_matches_jax_and_grads_within_budget(runs, name):
    """The int8 wire.  Its forward rounds to nearest, with codes bit-equal
    to the reference's, so the loss equals the JAX package's int8 loss at
    the f32 bounds, and so do the gradients of the leaves no quantized
    reduce-scatter reaches (the norm scales: their gradients come from the
    activations alone).  Against the port's own unquantized run the loss
    is within 1% and each leaf's relative error norm within the
    reference's budget of 5%, or, where the JAX package's own int8 wire
    exceeds that budget on this mesh (its forward's rounding alone moves
    these tiny random models' gradients by ~5%), within 5% above the JAX
    package's error."""
    port = runs["port"][name]
    want_loss, want = runs["jax"][name]["int8"]
    np.testing.assert_allclose(float(port["int8/loss"]), want_loss,
                               rtol=2e-4, atol=2e-5)
    base_loss = float(port["none/loss"])
    assert abs(float(port["int8/loss"]) - base_loss) <= 0.01 * abs(base_loss)
    base, quant = _grads(port, "none/g/"), _grads(port, "int8/g/")
    jax_base = runs["jax"][name]["none"][1]
    assert base.keys() == quant.keys() == want.keys()
    for path in ("layers/ln1", "layers/ln2", "ln_f"):
        np.testing.assert_allclose(quant[path], want[path], rtol=5e-3,
                                   atol=5e-5, err_msg=f"{name}: {path}")
    for path, a in base.items():
        rel = np.linalg.norm(quant[path] - a) / max(np.linalg.norm(a), 1e-12)
        ref = np.linalg.norm(want[path] - jax_base[path]) / max(
            np.linalg.norm(jax_base[path]), 1e-12)
        assert rel <= max(0.05, 1.05 * ref), (
            f"{name}: grad error {rel:.4f} at {path} (the JAX package's "
            f"int8 wire: {ref:.4f})")
    # the unquantized arm of this mesh holds the JAX parity bounds too
    _assert_parity(base_loss, base, *runs["jax"][name]["none"], False, name)


def test_dcn_wire_within_budget(runs):
    """quant="dcn" on {dcn 2, fsdp 2}: only the gradients' cross-node
    all-reduce is quantized, so the loss equals the unquantized one
    within 1e-6 relative, and each leaf's largest error is under 5% of
    its largest value."""
    port = runs["port"]["dcn2-fsdp2"]
    np.testing.assert_allclose(float(port["dcn/loss"]),
                               float(port["none/loss"]), rtol=1e-6)
    base, quant = _grads(port, "none/g/"), _grads(port, "dcn/g/")
    for path, a in base.items():
        rel = np.abs(quant[path] - a).max() / max(np.abs(a).max(), 1e-8)
        assert rel < 0.05, f"dcn-quant grad error {rel:.4f} at {path}"
        assert not np.array_equal(quant[path], a) or not a.any(), path


def test_overlap_steps_match_jax_overlap_step(runs):
    """3 steps of ``build_gpt_train(comm_mode="overlap")`` on {fsdp 2, tp
    2} from the JAX step's initial parameters: every loss and grad norm
    within 1e-4 relative of the JAX overlap step's."""
    steps = runs["steps"]
    assert steps["modes"] == ["overlap", "none"]
    np.testing.assert_allclose(np.array(steps["steps"]),
                               runs["jax_steps"][0], rtol=1e-4)


def test_int8_overlap_step_trains(runs):
    """6 steps of the int8 wire's step (lr 1e-2): the loss falls by more
    than 0.2 and the last grad norm is finite."""
    steps = runs["steps"]
    assert steps["int8_modes"] == ["overlap", "int8"]
    losses = steps["int8_losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, losses


def test_step_recorder_bytes_on_a_live_mesh(runs):
    """The overlap step's recorder on {fsdp 2, tp 2}: from each rank's
    rows (2 of 8) it reports the reference's bytes for the global batch,
    entry for entry, and the flattened tier totals."""
    s = runs["steps"]["summary"]
    want = runs["jax_steps"][1]
    got = s["collective_bytes_per_step"]
    for tier in ("ici", "dcn"):
        for k, v in want[tier].items():
            if k != "seconds":
                assert got[tier][k] == v, (tier, k)
    assert got["total"] == want["total"]
    assert s["collective_bytes_ici"] == want["ici"]["total"]
    assert s["collective_bytes_dcn"] == 0
    assert s["comm_mode"] == "overlap" and s["comm_quant"] == "none"


def test_dispatch_on_live_meshes(runs):
    """On real meshes: sp falls back to gspmd and drops the wire, the
    wire is dropped under gspmd, and accumulation falls back."""
    assert runs["steps"]["picks"] == {"sp": ["gspmd", "none"],
                                      "gspmd-int8": ["gspmd", "none"],
                                      "accum": ["gspmd", "none"]}


def test_order_of_issue(runs):
    """The schedule's order of issue on {fsdp 4} at 3 layers (one
    value_and_grad under the profiler, rank 0): block i+1's gather is
    issued before block i starts (and after block i-1 starts: a double
    buffer, not all up front); the backward runs one group of reduce-
    scatters per block, 7 leaves each, the last block's first."""
    order = runs["order"]
    L = ORDER_CASE[2]["n_layers"]

    def first(name):
        return order.index(name)

    for i in range(L - 1):
        assert first(f"overlap/gather_block[{i + 1}]") < \
            first(f"overlap/block[{i}]"), order
        if i > 0:
            assert first(f"overlap/block[{i - 1}]") < \
                first(f"overlap/gather_block[{i + 1}]"), order
    rs = [n for n in order if n.startswith("overlap/grad_reduce_scatter")]
    blocks = [int(n[n.index("[") + 1:-1]) for n in rs]
    assert blocks == [b for b in range(L - 1, -1, -1) for _ in range(7)], rs
    assert first(rs[0]) > first(f"overlap/block[{L - 1}]")


def test_ring_allgather_matmul_matches_gather(runs):
    """ring_allgather_matmul on {tp 4} against gather-then-matmul: the
    one-weight and several-weight forms (one output ``[K, 2, 3]``), the
    gradients of x and of each rank's weight columns, and bf16 operands
    with f32 products."""
    r = runs["ring"]
    T, K, M = RING["T"], RING["K"], RING["M"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, WORLD * T, K, generator=g).requires_grad_(True)
    w1 = torch.randn(K, WORLD * M, generator=g).requires_grad_(True)
    w2 = torch.randn(K, 2, WORLD * 3, generator=g).requires_grad_(True)
    a = x @ w1
    b = torch.einsum("btk,kaf->btaf", x, w2)
    ((a ** 2).sum() + (b ** 3).sum()).backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["a"], a.detach().numpy(), **tol)
    np.testing.assert_allclose(r["single"], a.detach().numpy(), **tol)
    np.testing.assert_allclose(r["b"], b.detach().numpy(), **tol)
    np.testing.assert_allclose(r["dx"], x.grad.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(r["dw1"], w1.grad.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(r["dw2"], w2.grad.numpy(), rtol=1e-5,
                               atol=1e-4)
    want = x.detach().bfloat16().float() @ w1.detach().bfloat16().float()
    np.testing.assert_allclose(r["f32"], want.numpy(), rtol=1e-6, atol=1e-5)


def test_ring_allgather_matmul_without_ring():
    """No group: plain matmuls, in both forms."""
    from ray_tpu_torch.parallel.overlap import ring_allgather_matmul
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 8, generator=g)
    w1 = torch.randn(8, 12, generator=g)
    w2 = torch.randn(8, 2, 3, generator=g)
    torch.testing.assert_close(ring_allgather_matmul(x, w1, None), x @ w1)
    a, b = ring_allgather_matmul(x, [w1, w2], None)
    torch.testing.assert_close(a, x @ w1)
    torch.testing.assert_close(b, torch.einsum("tk,kab->tab", x, w2))
