"""Port parity: ``build_gpt_train`` on sharded meshes against the JAX
package's GSPMD step on the same mesh shapes.

The model is ``GPTConfig.tiny`` at d_model 128 in f32 (2 layers, 4
heads, vocab 512), so the port's fused epilogue and flash-CE gates pass
per rank wherever tp is 1, at a global batch of 8 x 32 whose targets
are partly masked (-1) unevenly over rows and sequence halves, so the
shards of every mesh hold different counts of valid targets (one row
holds none).  The parameters come from the JAX package's
``init_params``; each rank takes its shards through
``convert.params_from_jax(..., mesh=)`` and its rows and sequence shard
of the same global batch through ``fns["shard_batch"]``.

The JAX side runs once, in the pytest process, on its 8-device host mesh
(``make_mesh(..., devices=jax.devices()[:4])``): for each mesh shape the
loss and gradients of ``jax.value_and_grad(loss_fn)`` under the step's
own shardings (``state_shardings``, ``batch_sharding``), then 3 AdamW
steps of the step's update (``default_optimizer``) on those gradients.
The port side runs in one 4-rank gloo world (``torch.multiprocessing``,
a ``FileStore`` under the test's directory) that takes every mesh shape
in turn; its ranks import only ``torch`` and the port, and write their
results to ``.npz`` files.  One case also goes end to end through
``TorchTrainer`` with ``ScalingConfig.mesh_axes``, and the same world
runs the RL learner's step (``build_gpt_rl_train``) on {fsdp: 2, tp: 2}
against the reference's on that mesh shape (its own test's mesh axes,
``tests/test_rl.py``), on the batch's tokens and targets with rewards
from a seed, and both steps again in adapter-only mode
(``lora=LoraConfig(rank=4)``, every target, a random B) against the
reference's ``lora=...`` steps from the same adapter.

Bounds (``tests/test_parallel.py::_overlap_vs_gspmd``'s): the loss within
rtol 2e-4, atol 2e-5; every gradient leaf, gathered to full, within rtol
5e-3, atol 5e-5; over the 3 steps each loss and grad norm within 1e-4
relative.  The same bounds hold each sharded run against the port's own
one-process step on the global batch.
"""

import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
# GPTConfig.tiny at d_model 128 (head_dim 32): every rank's rows are
# whole d_model-128 rows on an fsdp mesh, so the port's per-rank fused
# epilogue and flash-CE (with the norm prologue) run there; tp declines
# them.  4 heads split over tp = 2 and then sp = 2 (Ulysses)
MODEL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
             max_seq=128)
B, S = 8, 32
STEPS = 3
OPT = dict(lr=1e-3, warmup=1, total_steps=8)
CASES = [("fsdp4", dict(fsdp=4), "ring"),
         ("dp2-tp2", dict(dp=2, tp=2), "ring"),
         ("fsdp2-tp2", dict(fsdp=2, tp=2), "ring"),
         ("dp2-sp2-ring", dict(dp=2, sp=2), "ring"),
         ("sp2-tp2-ring", dict(sp=2, tp=2), "ring"),
         ("sp2-tp2-ulysses", dict(sp=2, tp=2), "ulysses"),
         ("dcn2-fsdp2", dict(dcn=2, fsdp=2), "ring")]
IDS = [c[0] for c in CASES]
# the port against itself only: 2 microbatches and remat on a sharded
# mesh against the unsharded step with the same options
ACCUM = ("fsdp2-tp2-accum2-remat", dict(fsdp=2, tp=2), "ring")
# the RL learner's policy-gradient step on a sharded mesh
RL = ("rl-fsdp2-tp2", dict(fsdp=2, tp=2))
RL_LR = 1e-3
# adapter-only training on a mesh that shards the frozen base: every
# target, a random B so that every factor has a gradient
LORA = ("fsdp2-tp2-lora", dict(fsdp=2, tp=2))
LORA_RANK = 4
# every GPT mode of the JAX package at once (the GPT-2 exact
# architecture with an untied head) on a mesh with fsdp and tp: the
# learned positions gathered over fsdp, the column-parallel biases
# split over tp and the row-parallel ones (bo, b2) added once after the
# tp sum
MODES = dict(norm="layernorm", act="gelu", pos="learned", use_bias=True,
             tie_embeddings=False)
MODES_CASE = ("fsdp2-tp2-modes", dict(fsdp=2, tp=2), "ring")


def _rewards():
    return np.random.default_rng(4).standard_normal(B).astype(np.float32)


def _global_batch():
    rng = np.random.default_rng(3)
    tok = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    tgt = tok[:, 1:].copy()
    tgt[0, :20] = -1        # rank rows and sequence halves differ
    tgt[3, 5:9] = -1
    tgt[5, -7:] = -1
    tgt[6, :] = -1          # a row with no valid target
    return {"tokens": tok[:, :-1].copy(), "targets": tgt}


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


def _port_run(fns, state, batch):
    """(loss, gradients, [(loss, grad_norm)] over STEPS steps) of one
    port step function from ``state``."""
    loss, grads = fns["value_and_grad_fn"](state.params, batch)
    steps = []
    for _ in range(STEPS):
        state, m = fns["step_fn"](state, batch)
        steps.append((float(m["loss"]), float(m["grad_norm"])))
    return float(loss), grads, steps


def _world(rank, store, in_path, out_dir):
    """One rank of the gloo world: every case in turn; rank 0 writes each
    case's loss, full gradients and step metrics."""
    import torch.distributed as dist

    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    data = dict(np.load(in_path))
    params = _unflat({k[2:]: v for k, v in data.items()
                      if k.startswith("p/")})
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "targets")}
    for name, axes, impl in CASES + [ACCUM]:
        t0 = time.monotonic()
        accum = name == ACCUM[0]
        cfg = gpt.GPTConfig(**MODEL, dtype=torch.float32, remat=accum)
        mesh = make_mesh(**axes)
        fns = training.build_gpt_train(
            cfg, mesh, optimizer=training.default_optimizer(**OPT),
            sp_impl=impl, accum_steps=2 if accum else 1, device="cpu",
            telemetry=False)
        state = fns["init_fn"](params=params_from_jax(
            params, cfg, device="cpu", mesh=mesh))
        local = fns["shard_batch"](batch)
        logits = sharding.gather_tensor(
            fns["forward_fn"](state.params, local),
            sharding.logical_to_spec(("batch", "seq"), mesh=mesh), mesh)
        loss, grads, steps = _port_run(fns, state, local)
        full = sharding.gather_params(grads, mesh,
                                      gpt.param_logical_axes(cfg))
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{name}.npz"), loss=loss,
                     steps=np.array(steps), secs=time.monotonic() - t0,
                     logits=logits.numpy(),
                     **{"g/" + k: v for k, v in
                        _flat(_np_tree(full)).items()})
    _modes_case(rank, _unflat({k[2:]: v for k, v in data.items()
                               if k.startswith("m/")}), batch, out_dir)
    _rl_case(rank, params, batch, out_dir)
    adapter = {k[2:]: v for k, v in data.items() if k.startswith("a/")}
    _lora_case(rank, params, adapter, batch, out_dir)
    dist.destroy_process_group()


def _modes_case(rank, params, batch, out_dir):
    """MODES_CASE: the loss, full gradients and step metrics of
    ``build_gpt_train`` in every mode at once."""
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import make_mesh
    name, axes, impl = MODES_CASE
    t0 = time.monotonic()
    cfg = gpt.GPTConfig(**MODEL, **MODES, dtype=torch.float32)
    mesh = make_mesh(**axes)
    fns = training.build_gpt_train(
        cfg, mesh, optimizer=training.default_optimizer(**OPT),
        sp_impl=impl, device="cpu", telemetry=False)
    state = fns["init_fn"](params=params_from_jax(params, cfg, device="cpu",
                                                  mesh=mesh))
    loss, grads, steps = _port_run(fns, state, fns["shard_batch"](batch))
    full = sharding.gather_params(grads, mesh, gpt.param_logical_axes(cfg))
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{name}.npz"), loss=loss,
                 steps=np.array(steps), secs=time.monotonic() - t0,
                 **{"g/" + k: v for k, v in _flat(_np_tree(full)).items()})


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


def _rank_spread(tree) -> float:
    """The largest difference of ``tree``'s leaves between any rank and
    rank 0 (0.0: equal on every rank)."""
    import torch.distributed as dist

    from ray_tpu_torch.models.training import _leaves, _path_order
    leaves = _leaves(tree)
    flat = torch.cat([leaves[i].detach().reshape(-1).float()
                      for i in _path_order(tree)])
    got = [torch.empty_like(flat) for _ in range(WORLD)]
    dist.all_gather(got, flat)
    return max(float((g - got[0]).abs().max()) for g in got)


def _lora_case(rank, params, adapter, batch, out_dir):
    """Adapter-only training on LORA's mesh: the loss, the adapter's
    gradient and STEPS steps of ``build_gpt_train(lora=...)``, then the
    RL step's ``pg_grad_fn`` and one step with ``lora=``; the gradient's
    and the trained adapter's spread over the ranks."""
    from ray_tpu_torch.adapters import LoraConfig
    from ray_tpu_torch.convert import adapter_from_jax, params_from_jax
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel.mesh import make_mesh
    t0 = time.monotonic()
    cfg = gpt.GPTConfig(**MODEL, dtype=torch.float32)
    mesh = make_mesh(**LORA[1])
    lcfg = LoraConfig(enabled=True, rank=LORA_RANK)
    base = params_from_jax(params, cfg, device="cpu")
    snapshot = {k: v.clone() for k, v in base["layers"].items()}
    start = adapter_from_jax(adapter, cfg, lcfg, device="cpu")
    fns = training.build_gpt_train(
        cfg, mesh, optimizer=training.default_optimizer(**OPT),
        device="cpu", telemetry=False, lora=lcfg, base_params=base)
    state = fns["init_fn"](params=start)
    local = fns["shard_batch"](batch)
    loss, grads, steps = _port_run(fns, state, local)
    spread = [_rank_spread(grads), _rank_spread(state.params)]
    rfns = training.build_gpt_rl_train(
        cfg, mesh, optimizer=training.rl_optimizer(RL_LR), device="cpu",
        lora=lcfg, base_params=base)
    rstate = rfns["init_fn"](params=start)
    rlocal = rfns["shard_batch"](dict(batch, rewards=_rewards()))
    (rloss, rmetrics), rgrads = rfns["pg_grad_fn"](rstate.params, rlocal)
    spread.append(_rank_spread(rgrads))
    rstate, rm = rfns["step_fn"](rstate, rlocal)
    base_moved = max(float((base["layers"][k] - v).abs().max())
                     for k, v in snapshot.items())
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{LORA[0]}.npz"), loss=loss,
                 steps=np.array(steps), secs=time.monotonic() - t0,
                 spread=np.array(spread), base_moved=base_moved,
                 rl_loss=float(rloss),
                 rl_step=np.array([float(rm["pg_loss"]),
                                   float(rm["grad_norm"])]),
                 **{"m/" + k: float(v) for k, v in rmetrics.items()},
                 **{"g/" + k: v.detach().numpy() for k, v in grads.items()},
                 **{"r/" + k: v.detach().numpy() for k, v in rgrads.items()})


def _rl_case(rank, params, batch, out_dir):
    """The RL step on RL's mesh: its loss, metrics and full gradients,
    then STEPS steps' (pg_loss, grad_norm)."""
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import make_mesh
    t0 = time.monotonic()
    cfg = gpt.GPTConfig(**MODEL, dtype=torch.float32)
    mesh = make_mesh(**RL[1])
    fns = training.build_gpt_rl_train(
        cfg, mesh, optimizer=training.rl_optimizer(RL_LR), device="cpu")
    state = fns["init_fn"](params=params_from_jax(params, cfg, device="cpu",
                                                  mesh=mesh))
    local = fns["shard_batch"](dict(batch, rewards=_rewards()))
    (loss, metrics), grads = fns["pg_grad_fn"](state.params, local)
    full = sharding.gather_params(grads, mesh, gpt.param_logical_axes(cfg))
    steps = []
    for _ in range(STEPS):
        state, m = fns["step_fn"](state, local)
        steps.append((float(m["pg_loss"]), float(m["grad_norm"])))
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{RL[0]}.npz"), loss=float(loss),
                 steps=np.array(steps), secs=time.monotonic() - t0,
                 **{"m/" + k: float(v) for k, v in metrics.items()},
                 **{"g/" + k: v for k, v in _flat(_np_tree(full)).items()})


def _np_tree(node):
    if isinstance(node, dict):
        return {k: _np_tree(v) for k, v in node.items()}
    return node.detach().numpy()


def _jax_rl_reference(params0, batch):
    """The reference's ``build_gpt_rl_train`` on RL's mesh: the loss,
    metrics and gradients of its ``pg_grad_fn``, then STEPS steps'
    (pg_loss, grad_norm) of its ``step_fn`` from ``params0``."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh

    cfg = jgpt.GPTConfig(**MODEL, dtype=jnp.float32)
    mesh = make_mesh(**RL[1], devices=jax.devices()[:WORLD])
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(RL_LR))
    fns = jtrain.build_gpt_rl_train(cfg, mesh, optimizer=tx)
    rl_batch = dict(batch, rewards=_rewards())
    (loss, metrics), grads = fns["pg_grad_fn"](params0, rl_batch)
    first = (float(loss), {k: float(v) for k, v in metrics.items()},
             _flat(jax.device_get(grads)))
    state = jax.device_put(
        jtrain.TrainState(params0, tx.init(params0),
                          jnp.zeros((), jnp.int32)), fns["state_shardings"])
    steps = []
    for _ in range(STEPS):
        state, m = fns["step_fn"](state, rl_batch)
        steps.append((float(m["pg_loss"]), float(m["grad_norm"])))
    return first + (np.array(steps),)


def _record_grads():
    """An optax transformation that passes the gradients on and keeps
    them as its state: the first link of the reference step's chain, so
    its own step's gradients can be read back."""
    import jax
    import jax.numpy as jnp
    import optax
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, _s, _p=None: (g, g))


def _jax_lora_reference(params0, adapter0, batch):
    """The reference's adapter-only ``build_gpt_train`` and
    ``build_gpt_rl_train`` on LORA's mesh from ``adapter0``: the first
    step's loss and adapter gradients (read from the step's own
    optimizer chain) and STEPS steps' (loss, grad_norm); the RL
    ``pg_grad_fn``'s loss, metrics and gradients and one RL step's
    (pg_loss, grad_norm)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.adapters import LoraConfig
    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh

    cfg = jgpt.GPTConfig(**MODEL, dtype=jnp.float32)
    mesh = make_mesh(**LORA[1], devices=jax.devices()[:WORLD])
    lcfg = LoraConfig(enabled=True, rank=LORA_RANK)
    tx = optax.chain(_record_grads(), jtrain.default_optimizer(**OPT))
    fns = jtrain.build_gpt_train(cfg, mesh, optimizer=tx, lora=lcfg,
                                 base_params=params0, telemetry=False)
    ad = jax.tree.map(jnp.asarray, adapter0)
    state = jax.device_put(
        jtrain.TrainState(ad, tx.init(ad), jnp.zeros((), jnp.int32)),
        fns["state_shardings"])
    steps = []
    for i in range(STEPS):
        state, m = fns["step_fn"](state, batch)
        steps.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            grads = jax.tree.map(np.asarray,
                                 jax.device_get(state.opt_state[0]))
    rtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(RL_LR))
    rfns = jtrain.build_gpt_rl_train(cfg, mesh, optimizer=rtx, lora=lcfg,
                                     base_params=params0)
    rl_batch = dict(batch, rewards=_rewards())
    # fresh arrays: the steps donate their state
    ad = jax.tree.map(jnp.asarray, adapter0)
    (rloss, rmetrics), rgrads = rfns["pg_grad_fn"](ad, rl_batch)
    ad = jax.tree.map(jnp.asarray, adapter0)
    rstate = jax.device_put(
        jtrain.TrainState(ad, rtx.init(ad), jnp.zeros((), jnp.int32)),
        rfns["state_shardings"])
    rstate, rm = rfns["step_fn"](rstate, rl_batch)
    return {"loss": steps[0][0], "grads": grads, "steps": np.array(steps),
            "rl_loss": float(rloss),
            "rl_metrics": {k: float(v) for k, v in rmetrics.items()},
            "rl_grads": jax.tree.map(np.asarray, jax.device_get(rgrads)),
            "rl_step": np.array([float(rm["pg_loss"]),
                                 float(rm["grad_norm"])])}


def _jax_reference(axes, impl, params0, batch, update, **modes):
    """Loss, gradients and STEPS steps' (loss, grad_norm) of the JAX
    package's GSPMD step on ``axes`` (in ``modes``): its
    ``value_and_grad`` under the step's shardings, its optimizer's update
    (``update``, one jit on the host, shared by every mesh shape)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh

    cfg = jgpt.GPTConfig(**MODEL, **modes, dtype=jnp.float32)
    mesh = make_mesh(**axes, devices=jax.devices()[:WORLD])
    fns = jtrain.build_gpt_train(cfg, mesh, sp_impl=impl,
                                 optimizer=jtrain.default_optimizer(**OPT),
                                 telemetry=False)
    assert fns["comm_mode"] == "gspmd"
    psh = fns["state_shardings"].params

    def loss(p, b):
        return jgpt.loss_fn(p, b, cfg, attn_fn=fns["attn_fn"], mesh=mesh)

    vg = jax.jit(jax.value_and_grad(loss),
                 in_shardings=(psh, fns["batch_sharding"]))
    p, opt = params0, None
    steps = []
    for i in range(STEPS):
        val, g = vg(jax.device_put(p, psh), batch)
        g = jax.device_get(g)
        if i == 0:
            first = (float(val), g)
        steps.append((float(val), float(optax.global_norm(g))))
        p, opt = update(g, opt, p)
    return first[0], _flat(first[1]), np.array(steps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's port and JAX results, and the port's unsharded step
    on the global batch.  The port's world runs while the JAX side
    computes."""
    import jax
    import jax.numpy as jnp
    import torch.multiprocessing as mp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt, training

    from ray_tpu.adapters import LoraConfig
    from ray_tpu.adapters import lora as jlora

    tmp = tmp_path_factory.mktemp("train_sharded")
    jcfg = jgpt.GPTConfig(**MODEL, dtype=jnp.float32)
    params0 = jax.tree.map(np.asarray,
                           jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    adapter0 = jax.tree.map(np.asarray, jlora.init_adapter(
        jcfg, LoraConfig(enabled=True, rank=LORA_RANK),
        jax.random.PRNGKey(7), random_b=True))
    params_modes = _perturbed(jax.tree.map(np.asarray, jgpt.init_params(
        jgpt.GPTConfig(**MODEL, **MODES, dtype=jnp.float32),
        jax.random.PRNGKey(0))), np.random.default_rng(5))
    batch = _global_batch()
    in_path = str(tmp / "inputs.npz")
    np.savez(in_path, **batch,
             **{"p/" + k: v for k, v in _flat(params0).items()},
             **{"m/" + k: v for k, v in _flat(params_modes).items()},
             **{"a/" + k: v for k, v in adapter0.items()})
    t0 = time.monotonic()
    ctx = mp.start_processes(_world, args=(str(tmp / "store"), in_path,
                                           str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")

    tx = jtrain.default_optimizer(**OPT)

    @jax.jit
    def _apply(g, opt, p):
        import optax
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt

    def update(g, opt, p):
        return _apply(g, tx.init(p) if opt is None else opt, p)

    jax_out = {name: _jax_reference(axes, impl, params0, batch, update)
               for name, axes, impl in CASES}
    jax_modes = _jax_reference(MODES_CASE[1], MODES_CASE[2], params_modes,
                               batch, update, **MODES)
    jax_rl = _jax_rl_reference(params0, batch)
    jax_lora = _jax_lora_reference(params0, adapter0, batch)
    jax_s = time.monotonic() - t0

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain = {}
    for accum in (False, True):
        tcfg = gpt.GPTConfig(**MODEL, dtype=torch.float32, remat=accum)
        fns = training.build_gpt_train(
            tcfg, None, optimizer=training.default_optimizer(**OPT),
            accum_steps=2 if accum else 1, device="cpu", telemetry=False)
        state = fns["init_fn"](params=params_from_jax(params0, tcfg,
                                                      device="cpu"))
        logits = fns["forward_fn"](state.params, tb).numpy()
        loss, grads, steps = _port_run(fns, state, tb)
        plain[accum] = (loss, _flat(_np_tree(grads)), np.array(steps),
                        logits)

    while not ctx.join(timeout=1):
        pass
    port = {}
    for name, _axes, _impl in CASES + [ACCUM, MODES_CASE]:
        d = dict(np.load(tmp / f"{name}.npz"))
        port[name] = (float(d["loss"]), {k[2:]: v for k, v in d.items()
                                         if k.startswith("g/")},
                      d["steps"], float(d["secs"]), d.get("logits"))
    d = dict(np.load(tmp / f"{RL[0]}.npz"))
    port_rl = (float(d["loss"]), {k[2:]: float(v) for k, v in d.items()
                                  if k.startswith("m/")},
               {k[2:]: v for k, v in d.items() if k.startswith("g/")},
               d["steps"])
    port_lora = dict(np.load(tmp / f"{LORA[0]}.npz"))
    print(f"JAX side {jax_s:.1f} s; world of {WORLD} "
          f"{time.monotonic() - t0:.1f} s; per case "
          f"{ {n: round(p[3], 2) for n, p in port.items()} }; lora "
          f"{float(port_lora['secs']):.2f}")
    return {"jax": jax_out, "port": port, "plain": plain,
            "jax_modes": jax_modes,
            "params0": params0, "batch": batch,
            "rl": {"jax": jax_rl, "port": port_rl},
            "lora": {"jax": jax_lora, "port": port_lora}}


def _assert_close(got, want, what):
    g_loss, g_grads, g_steps = got[:3]
    w_loss, w_grads, w_steps = want[:3]
    np.testing.assert_allclose(g_loss, w_loss, rtol=2e-4, atol=2e-5,
                               err_msg=f"{what}: loss")
    assert g_grads.keys() == w_grads.keys()
    for path, w in w_grads.items():
        np.testing.assert_allclose(g_grads[path], w, rtol=5e-3, atol=5e-5,
                                   err_msg=f"{what}: grad {path}")
    np.testing.assert_allclose(g_steps, w_steps, rtol=1e-4,
                               err_msg=f"{what}: step losses, grad norms")


@pytest.mark.parametrize("name", IDS)
def test_sharded_step_matches_jax_gspmd(runs, name):
    """The port's sharded step against the JAX package's GSPMD step on
    the same mesh shape: loss, every gradient leaf gathered to full, and
    3 steps' losses and grad norms."""
    _assert_close(runs["port"][name], runs["jax"][name], name)


@pytest.mark.parametrize("name", IDS)
def test_sharded_step_matches_unsharded_port(runs, name):
    """The same sharded step against the port's own one-process step on
    the global batch, at the same bounds."""
    _assert_close(runs["port"][name], runs["plain"][False], name)


@pytest.mark.parametrize("name", IDS)
def test_sharded_forward_logits_match_unsharded_port(runs, name):
    """``fns["forward_fn"]`` on the mesh (each rank's rows and sequence
    shard, the vocabulary all-gathered over tp), gathered over the batch
    axes and sp, against the unsharded forward's logits (f32, summation
    order only: within 2e-4 relative, 2e-5 absolute)."""
    np.testing.assert_allclose(runs["port"][name][4],
                               runs["plain"][False][3], rtol=2e-4,
                               atol=2e-5)


def test_sharded_modes_step_matches_jax_gspmd(runs):
    """Every GPT mode at once (LayerNorm, gelu, learned positions,
    biases, an untied head) on {fsdp: 2, tp: 2} against the JAX
    package's GSPMD step: the loss, every gradient leaf gathered to full
    and 3 steps' losses and grad norms, at the bounds above.  A
    row-parallel bias added on every tp rank would double its
    contribution and part the loss at once."""
    _assert_close(runs["port"][MODES_CASE[0]], runs["jax_modes"],
                  MODES_CASE[0])


def test_sharded_accumulation_and_remat_match_unsharded_port(runs):
    """``accum_steps=2`` with ``cfg.remat`` on {fsdp: 2, tp: 2} (each
    rank's rows those of its shard of each microbatch, the fsdp gathers
    and tp collectives recomputed in the backward) against the
    unsharded step with the same options, at the same bounds."""
    _assert_close(runs["port"][ACCUM[0]], runs["plain"][True], ACCUM[0])


def test_sharded_rl_step_matches_jax_gspmd(runs):
    """``build_gpt_rl_train`` on {fsdp: 2, tp: 2} (each rank's rows with
    their advantages over the global batch, the whole vocabulary's
    logits on every tp rank) against the reference's on that mesh shape:
    the loss and metrics within rtol 2e-4 (atol 2e-5), every gradient
    leaf gathered to full within the bounds above, and 3 steps' losses
    and grad norms within 1e-4 relative."""
    w_loss, w_metrics, w_grads, w_steps = runs["rl"]["jax"]
    g_loss, g_metrics, g_grads, g_steps = runs["rl"]["port"]
    np.testing.assert_allclose(g_loss, w_loss, rtol=2e-4, atol=2e-5)
    assert g_metrics.keys() == w_metrics.keys()
    for k, v in w_metrics.items():
        np.testing.assert_allclose(g_metrics[k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    assert g_grads.keys() == w_grads.keys()
    for path, w in w_grads.items():
        np.testing.assert_allclose(g_grads[path], w, rtol=5e-3, atol=5e-5,
                                   err_msg=f"rl grad {path}")
    np.testing.assert_allclose(g_steps, w_steps, rtol=1e-4, atol=1e-6)


def test_sharded_lora_step_matches_jax_gspmd(runs):
    """``build_gpt_train(lora=...)`` on {fsdp: 2, tp: 2} (the frozen base
    sharded as the model is, the adapter whole on every rank) against
    the reference's on that mesh shape from the same adapter: the loss,
    every factor's gradient and 3 steps' losses and grad norms at the
    bounds above; the gradient and the trained adapter equal on every
    rank, and the base untouched."""
    got, want = runs["lora"]["port"], runs["lora"]["jax"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=2e-4,
                               atol=2e-5)
    grads = {k[2:]: v for k, v in got.items() if k.startswith("g/")}
    assert grads.keys() == want["grads"].keys()
    assert len(grads) == 14
    for k, w in want["grads"].items():
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(grads[k], w, rtol=5e-3, atol=5e-5,
                                   err_msg=f"lora grad {k}")
    np.testing.assert_allclose(got["steps"], want["steps"], rtol=1e-4,
                               err_msg="lora step losses, grad norms")
    assert float(got["base_moved"]) == 0.0
    np.testing.assert_array_equal(got["spread"], 0.0)


def test_sharded_lora_rl_step_matches_jax_gspmd(runs):
    """``build_gpt_rl_train(lora=...)`` on {fsdp: 2, tp: 2} against the
    reference's: ``pg_grad_fn``'s loss and metrics (rtol 2e-4, atol
    2e-5), every factor's gradient (rtol 5e-3, atol 5e-5), and one step's
    pg_loss and grad norm (1e-4 relative)."""
    got, want = runs["lora"]["port"], runs["lora"]["jax"]
    np.testing.assert_allclose(float(got["rl_loss"]), want["rl_loss"],
                               rtol=2e-4, atol=2e-5)
    metrics = {k[2:]: float(v) for k, v in got.items() if k.startswith("m/")}
    assert metrics.keys() == want["rl_metrics"].keys()
    for k, v in want["rl_metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    rgrads = {k[2:]: v for k, v in got.items() if k.startswith("r/")}
    assert rgrads.keys() == want["rl_grads"].keys()
    for k, w in want["rl_grads"].items():
        np.testing.assert_allclose(rgrads[k], w, rtol=5e-3, atol=5e-5,
                                   err_msg=f"rl lora grad {k}")
    np.testing.assert_allclose(got["rl_step"], want["rl_step"], rtol=1e-4,
                               atol=1e-6)


def test_loss_counts_every_valid_target_once(runs):
    """Every mesh shape's reference loss is the one global masked mean,
    and the port's one-process step on the global batch gives it."""
    losses = [v[0] for v in runs["jax"].values()]
    np.testing.assert_allclose(losses, losses[0], rtol=2e-6)
    np.testing.assert_allclose(runs["plain"][False][0], losses[0],
                               rtol=2e-4)


@pytest.fixture
def ray_start_4_cpus():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=WORLD)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_torch_trainer_scaling_config_mesh_axes(runs, ray_start_4_cpus,
                                                tmp_path):
    """End to end: four gloo workers of a ``TorchTrainer`` whose
    ``ScalingConfig(mesh_axes={"fsdp": 2, "tp": 2})`` reaches each
    worker's context (``get_mesh_axes``); each builds the mesh, takes its
    shards and its part of the batch and trains 3 steps, whose losses and
    grad norms equal the JAX package's GSPMD step on that mesh shape
    within 1e-4 relative."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    def loop(config):
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.convert import params_from_jax
        from ray_tpu_torch.models import gpt, training
        from ray_tpu_torch.parallel.mesh import make_mesh
        axes = train.get_context().get_mesh_axes()
        mesh = make_mesh(**axes)
        cfg = gpt.GPTConfig(**MODEL, dtype=torch.float32)
        fns = training.build_gpt_train(
            cfg, mesh, optimizer=training.default_optimizer(**config["opt"]),
            device="cpu", telemetry=False)
        state = fns["init_fn"](params=params_from_jax(
            config["params"], cfg, device="cpu", mesh=mesh))
        batch = fns["shard_batch"]({k: torch.from_numpy(v) for k, v in
                                    config["batch"].items()})
        for _ in range(config["steps"]):
            state, m = fns["step_fn"](state, batch)
            train.report({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "axes": axes, "mesh": dict(mesh.shape.items())})

    axes = {"fsdp": 2, "tp": 2}
    trainer = TorchTrainer(
        loop, torch_config=TorchConfig(host_collective=False),
        train_loop_config={"params": runs["params0"], "batch": runs["batch"],
                           "opt": OPT, "steps": STEPS},
        scaling_config=ScalingConfig(num_workers=WORLD, mesh_axes=axes),
        run_config=RunConfig(name="gpt-sharded", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert len(hist) == STEPS and hist[0]["axes"] == axes
    assert hist[0]["mesh"] == axes
    got = np.array([(h["loss"], h["grad_norm"]) for h in hist])
    np.testing.assert_allclose(got, runs["jax"]["fsdp2-tp2"][2], rtol=1e-4)
