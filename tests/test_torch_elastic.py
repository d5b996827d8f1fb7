"""Elastic training in the port against the JAX package's (counterparts
of ``tests/test_elastic.py``): gradient accumulation's global-batch
invariance and the ``RAY_TPU_ACCUM`` default, ``reshard_state`` with its
typed refusals, and the shrink/expand loop.

The loop runs in one spawned 4-rank gloo world (``torch.
multiprocessing``, a ``FileStore`` under the module's directory) whose
ranks import only ``torch`` and the port: the full mesh is {fsdp 4}, a
``mesh.loss`` shrinks it to the first 2 ranks ({fsdp 2}, ``accum_steps``
2, the global batch unchanged) and ``mesh.restore`` expands it back.
The parameters and every batch are the JAX package's (its ``init_fn``
and ``synthetic_lm_batch`` draws, fed through ``params=`` and
``batch_fn=``); the optimizer is plain SGD at lr 1e-2 on both sides
(optax's ``sgd``), so the losses test the data and state movement, not
the optimizer.  The pytest process runs the reference's loop on its
host devices (``devices[:4]`` -> ``[:2]``) under the same fault plan.

Bounds: batch cursors equal; each loss within the reference test's
``rel=1e-4, abs=1e-5`` of the reference's loss at that step (reduction
order differs between partitions and packages).
"""

import json
import os

import numpy as np
import pytest
import torch

WORLD = 4
TINY = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, max_seq=32)
B, S, STEPS, LR = 16, 16, 10, 1e-2
PLAN = "mesh.loss@3,mesh.restore@6"


class _SGD:
    """``optax.sgd(lr)`` on the port's tensors, in place."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, grads, state, params, g_norm=None):
        from ray_tpu_torch.models.training import _leaves
        for p, g in zip(_leaves(params), _leaves(grads)):
            p.copy_(p + (-self.lr) * g)
        return state


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.from_numpy(np.array(v))
    return out


def _tcfg():
    from ray_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(**TINY, dtype=torch.float32)


# ------------------------------------------------------------ the world
def _rank_main(rank, store, out_dir):
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.resilience import (ElasticError, ReshardError,
                                          StragglerSupervisor,
                                          TrainCheckpointer,
                                          host_state, reshard_state,
                                          run_elastic_train_loop,
                                          state_shardings)
    from ray_tpu_torch.util import chaos
    # one thread a rank: four ranks of a full OpenMP team each on a
    # shared box make a step of this model hundreds of milliseconds,
    # as slow as the straggle window below
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        data = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        params = _unflat({k[2:]: v for k, v in data.items()
                          if k.startswith("p/")})
        batches = data["tokens"], data["targets"]

        def batch_fn(cursor):
            return {"tokens": batches[0][cursor],
                    "targets": batches[1][cursor]}

        cfg, cache, out = _tcfg(), {}, {}
        kw = dict(steps=STEPS, batch_size=B, seq_len=S, params=params,
                  batch_fn=batch_fn, optimizer=_SGD(LR), device="cpu",
                  topologies=cache)

        def run(name, plan=None, **extra):
            if plan:
                fired = chaos.install_faults(plan)
            rec = run_elastic_train_loop(cfg, telemetry=True,
                                         **{**kw, **extra})
            chaos.clear_faults()
            out[name] = {k: rec[k] for k in (
                "losses", "batch_cursors", "transitions",
                "straggler_events", "builds", "final_devices",
                "accum_steps", "final_step")}
            out[name]["elastic"] = rec["elastic"]
            out[name]["fired"] = fired.fired if plan else []
            return rec

        run("base")
        run("plan", PLAN)
        with TrainCheckpointer(os.path.join(out_dir, "ck"), every=2,
                               keep=3) as ck:
            run("hard", "mesh.loss@4", graceful=False, ckpt=ck)
        sup = StragglerSupervisor(factor=2.0, dwell=2, window=8)
        run("straggler", "mesh.step@4..6:delay=0.5,mesh.restore@8",
            straggler=sup)
        # typed refusals
        errors = {}
        chaos.install_faults("mesh.loss@2")
        try:
            run_elastic_train_loop(cfg, graceful=False, **kw)
        except ElasticError as e:
            errors["hard_no_ckpt"] = str(e)
        chaos.clear_faults()
        chaos.install_faults("mesh.loss@1")
        try:
            run_elastic_train_loop(cfg, degraded_devices=3,
                                   **dict(kw, steps=2, topologies={}))
        except ElasticError as e:
            errors["not_dividing"] = str(e)
        chaos.clear_faults()
        try:
            run_elastic_train_loop(cfg, degraded_devices=2, min_devices=4,
                                   **dict(kw, steps=2))
        except ElasticError as e:
            errors["below_floor"] = str(e)
        # reshard: the full state onto {fsdp 2} over ranks 0-1 and back,
        # and a state whose d_model does not split over fsdp 4
        full = cache[WORLD]
        state = full["fns"]["init_fn"](params=params)
        host = host_state(state, full["shardings"])
        half = cache[2]
        if half["mesh"].member:
            moved = reshard_state(host, half["shardings"])
            back = host_state(moved, half["shardings"])
            errors["roundtrip_equal"] = all(
                torch.equal(a, b) for a, b in zip(
                    _flat_tensors(host.params), _flat_tensors(back.params)))
        bad = host._replace(params=dict(
            host.params, embed=host.params["embed"][:, :-2]))
        try:
            reshard_state(bad, state_shardings(cfg, full["mesh"], "cpu"))
        except ReshardError as e:
            errors["reshard"] = str(e)
        errors["member"] = [bool(make_mesh(fsdp=2, ranks=2).member)]
        out["errors"] = errors
        if rank == 0:
            with open(os.path.join(out_dir, "port.json"), "w") as f:
                json.dump(out, f)
        else:
            with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
                json.dump({"member": errors["member"],
                           "plan_losses": out["plan"]["losses"]}, f)
    finally:
        dist.destroy_process_group()


def _flat_tensors(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_flat_tensors(v) if isinstance(v, dict) else [v])
    return out


def _reference_runs(out_dir):
    """The JAX package's elastic loop on the host devices, and the
    inputs the port's world takes from it."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtraining
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.resilience import run_elastic_train_loop
    from ray_tpu.util import chaos
    cfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    devices = jax.devices()[:WORLD]
    mesh = make_mesh(fsdp=WORLD, devices=devices)
    fns = jtraining.build_gpt_train(cfg, mesh, optimizer=optax.sgd(LR),
                                    telemetry=False)
    params = jax.tree.map(np.asarray,
                          fns["init_fn"](jax.random.PRNGKey(0)).params)
    data_key = jax.random.PRNGKey(1)
    batches = [jtraining.synthetic_lm_batch(jax.random.fold_in(data_key, c),
                                            B, S, cfg.vocab_size)
               for c in range(STEPS)]
    np.savez(os.path.join(out_dir, "inputs.npz"),
             tokens=np.stack([np.asarray(b["tokens"]) for b in batches]),
             targets=np.stack([np.asarray(b["targets"]) for b in batches]),
             **{"p/" + k: v for k, v in _flat(params).items()})
    kw = dict(steps=STEPS, batch_size=B, seq_len=S, seed=0,
              devices=devices, optimizer=optax.sgd(LR), telemetry=False,
              topologies={})
    chaos.clear_faults()
    ref = {"base": run_elastic_train_loop(cfg, **kw)}
    chaos.install_faults(PLAN)
    ref["plan"] = run_elastic_train_loop(cfg, **kw)
    chaos.clear_faults()
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp
    out_dir = tmp_path_factory.mktemp("elastic")
    ref = _reference_runs(str(out_dir))
    mp.start_processes(_rank_main, args=(str(out_dir / "store"),
                                         str(out_dir)),
                       nprocs=WORLD, start_method="spawn")
    with open(out_dir / "port.json") as f:
        port = json.load(f)
    others = []
    for r in range(1, WORLD):
        with open(out_dir / f"rank{r}.json") as f:
            others.append(json.load(f))
    return port, ref, others


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert b == pytest.approx(a, rel=1e-4, abs=1e-5)


def test_elastic_4_2_4_matches_reference(world):
    """4 -> 2 -> 4 under ``mesh.loss@3,mesh.restore@6``: the same
    transitions, the global batch kept (accumulation 2 on the degraded
    mesh), the batch cursors the reference's, and every loss within
    the reference test's bound of the reference's loop's at that step
    and of the uninterrupted run's."""
    port, ref, others = world
    plan, base = port["plan"], port["base"]
    assert [f[0] for f in plan["fired"]] == ["mesh.loss", "mesh.restore"]
    assert [(t["kind"], t["from"], t["to"]) for t in plan["transitions"]] \
        == [("shrink", 4, 2), ("expand", 2, 4)] == [
            (t["kind"], t["from"], t["to"])
            for t in ref["plan"]["transitions"]]
    assert plan["batch_cursors"] == ref["plan"]["batch_cursors"] == \
        list(range(STEPS))
    assert plan["final_devices"] == 4 and plan["accum_steps"] == 1
    assert plan["builds"] == [2]            # the full mesh was cached
    _close(base["losses"], ref["base"]["losses"])
    _close(plan["losses"], ref["plan"]["losses"])
    _close(plan["losses"], base["losses"])
    assert plan["elastic"]["transitions"] == {"shrink": 1, "expand": 1}
    assert plan["elastic"]["mesh_devices"] == 4
    # the third step's loss hit shrinks before cursor 2 and the sixth's
    # restore expands before cursor 5: ranks 2 and 3 sat out cursors
    # 2-4 and rejoined; every rank of a mesh reports its loss
    assert [t["step"] for t in plan["transitions"]] == [2, 5]
    for r, o in enumerate(others, start=1):
        losses = o["plan_losses"]
        if r < 2:
            assert losses == plan["losses"]
        else:
            assert losses[2:5] == [None] * 3
            assert losses[:2] + losses[5:] == \
                plan["losses"][:2] + plan["losses"][5:]


def test_hard_loss_restores_from_checkpoint(world):
    """``graceful=False``: the loss at step 3 rolls back to the latest
    retained snapshot (cursor 2, rank 0's checkpoint of the full state):
    batches 2 and 3 replay on the degraded mesh, and the replayed tail
    tracks the uninterrupted run."""
    port, _ref, _o = world
    hard, base = port["hard"], port["base"]
    assert hard["batch_cursors"] == [0, 1, 2] + list(range(2, STEPS))
    assert hard["transitions"][0]["kind"] == "shrink"
    assert hard["transitions"][0]["step"] == 2
    assert hard["final_devices"] == 2 and hard["accum_steps"] == 2
    _close(hard["losses"][3:], base["losses"][2:])


def test_straggler_drives_shrink_then_expand(world):
    """A ``mesh.step`` slowdown window is detected by the supervisor and
    taken as a graceful shrink (agreed over the world); ``mesh.restore``
    expands back; cursors exact and losses within bounds."""
    port, _ref, _o = world
    rec, base = port["straggler"], port["base"]
    assert rec["straggler_events"] == [4]
    assert [(t["kind"], t["from"], t["to"], t["cause"])
            for t in rec["transitions"]] == [
        ("shrink", 4, 2, "straggler"), ("expand", 2, 4, "fault")]
    assert rec["final_devices"] == 4 and rec["accum_steps"] == 1
    assert rec["batch_cursors"] == base["batch_cursors"]
    _close(rec["losses"], base["losses"])
    assert rec["elastic"]["straggler_events"] == 1


def test_reshard_and_the_loop_refuse_typed(world):
    """A hard loss with no checkpointer, a degraded size that does not
    divide the mesh and a target under the floor raise ``ElasticError``;
    a state whose d_model does not split over fsdp raises
    ``ReshardError`` naming the leaf; the full state goes onto {fsdp 2}
    over ranks 0-1 and comes back bit-equal; only ranks 0-1 are members
    of a 2-rank mesh."""
    port, _ref, others = world
    errors = port["errors"]
    assert "TrainCheckpointer" in errors["hard_no_ckpt"]
    assert "does not divide" in errors["not_dividing"]
    assert "fatal" in errors["below_floor"]
    assert "embed" in errors["reshard"] and "fsdp" in errors["reshard"]
    assert errors["roundtrip_equal"] is True
    assert [errors["member"]] + [o["member"] for o in others] == \
        [[True], [True], [False], [False]]


# --------------------------------------------------- accumulation, local
def test_accum_parity_single_device():
    """``accum_steps=2`` reproduces the one-step batch: the loss within
    1e-6 and the SGD-updated parameters (the gradients) within 1e-6 of
    ``accum_steps=1``'s, as the reference's test holds its own."""
    from ray_tpu_torch.models import training
    cfg = _tcfg()
    batch = training.synthetic_lm_batch(torch.Generator().manual_seed(1),
                                        8, 16, cfg.vocab_size, device="cpu")
    out = []
    for k in (1, 2):
        fns = training.build_gpt_train(cfg, optimizer=_SGD(LR),
                                       accum_steps=k, device="cpu",
                                       telemetry=False)
        assert fns["accum_steps"] == k
        st = fns["init_fn"](torch.Generator().manual_seed(0))
        st, m = fns["step_fn"](st, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]), st.params))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-5)
    for a, b in zip(_flat_tensors(out[0][2]), _flat_tensors(out[1][2])):
        assert (a - b).abs().max().item() < 1e-6
    fns = training.build_gpt_train(cfg, optimizer=_SGD(LR), accum_steps=3,
                                   device="cpu", telemetry=False)
    with pytest.raises(ValueError, match="accum_steps"):
        fns["step_fn"](fns["init_fn"](torch.Generator().manual_seed(0)),
                       batch)
    with pytest.raises(ValueError, match=">= 1"):
        training.build_gpt_train(cfg, accum_steps=0, device="cpu")


def test_accum_env_default_matches_reference(monkeypatch):
    """``RAY_TPU_ACCUM`` is ``build_gpt_train``'s default in both
    packages, and both fall back loudly to 1 on garbage."""
    from ray_tpu.models import training as jtraining
    from ray_tpu_torch.models import training
    monkeypatch.setenv("RAY_TPU_ACCUM", "2")
    fns = training.build_gpt_train(_tcfg(), optimizer=_SGD(LR),
                                   device="cpu", telemetry=False)
    assert fns["accum_steps"] == 2 == jtraining.default_accum_steps()
    assert training.build_gpt_train(_tcfg(), accum_steps=1, device="cpu",
                                    telemetry=False)["accum_steps"] == 1
    for raw in ("bogus", "-2", "0", "3"):
        monkeypatch.setenv("RAY_TPU_ACCUM", raw)
        assert training.default_accum_steps() == \
            jtraining.default_accum_steps()
    monkeypatch.delenv("RAY_TPU_ACCUM")
    assert training.default_accum_steps() == 1
