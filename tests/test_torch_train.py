"""Port counterparts of ``tests/test_train.py`` for ``ray_tpu_torch.train``
(DataParallelTrainer, TorchTrainer, checkpoints, failure restart,
restore, remote storage), and the data-parallel GPT step through
``TorchTrainer`` held against the JAX package's dp=2 host mesh.

The JAX package's ``JaxTrainer`` has its counterpart in ``TorchTrainer``
(one ``torch.distributed`` world over the workers; gloo here, the
workers hold no card).  Each test starts its own runtime.
"""

import os
import time
from typing import Any, NamedTuple

import numpy as np
import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_data_parallel_trainer_basic(ray_start_regular, tmp_path):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    def loop(config):
        ctx = train.get_context()
        for step in range(3):
            train.report({"step": step, "rank": ctx.get_world_rank(),
                          "world": ctx.get_world_size()})

    trainer = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="basic", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert result.metrics["world"] == 2
    assert len(result.metrics_history) == 3


def test_trainer_checkpointing(ray_start_regular, tmp_path):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import (Checkpoint, CheckpointConfig,
                                     DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    def loop(config):
        ctx = train.get_context()
        for step in range(4):
            ckpt = None
            if ctx.get_world_rank() == 0:
                ckpt = Checkpoint.from_dict({"step": step,
                                             "weights": [step] * 3})
            train.report({"loss": 10.0 - step}, checkpoint=ckpt)

    trainer = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="ckpt", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="loss",
                checkpoint_score_order="min")))
    result = trainer.fit()
    assert result.error is None
    assert result.checkpoint is not None
    state = result.checkpoint.to_dict()
    assert state["step"] == 3  # best by min loss = last step
    assert len(result.best_checkpoints) <= 2


def test_trainer_failure_restart(ray_start_regular, tmp_path):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import (Checkpoint, DataParallelTrainer,
                                     FailureConfig, RunConfig,
                                     ScalingConfig)

    def loop(config):
        ctx = train.get_context()
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_dict()["step"] + 1
        for step in range(start, 4):
            if step == 2 and ckpt is None:
                raise RuntimeError("simulated failure at step 2")
            c = (Checkpoint.from_dict({"step": step})
                 if ctx.get_world_rank() == 0 else None)
            train.report({"step": step}, checkpoint=c)

    trainer = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="restart", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    attempts = {m.get("_attempt") for m in result.metrics_history}
    assert attempts == {0, 1}


def test_torch_trainer_host_collective_dp_allreduce(ray_start_regular,
                                                    tmp_path):
    """Two workers fit a toy linear regression with gradients averaged
    through the host collective group (the counterpart of the
    reference's JaxTrainer test, ``tests/test_train.py:95``)."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    def loop(config):
        import numpy as np
        import torch

        from ray_tpu_torch.util import collective
        ctx = train.get_context()
        group = config["group_name"]
        w = torch.zeros(4, dtype=torch.float64)
        rng = np.random.default_rng(ctx.get_world_rank())
        X = torch.from_numpy(rng.normal(size=(64, 4)))
        true_w = torch.tensor([1.0, -2.0, 3.0, 0.5], dtype=torch.float64)
        y = X @ true_w
        for step in range(30):
            w.requires_grad_(True)
            loss = ((X @ w - y) ** 2).mean()
            (g,) = torch.autograd.grad(loss, w)
            g_sum = collective.allreduce(g.numpy(), group_name=group)
            w = (w - 0.1 * torch.from_numpy(g_sum)
                 / ctx.get_world_size()).detach()
            train.report({"loss": float(loss), "step": step})
        train.report({"final_err": float((w - true_w).abs().max())})

    cfg = TorchConfig(host_collective=True,
                      collective_group_name="torch_dp_test")
    trainer = TorchTrainer(
        loop, torch_config=cfg,
        train_loop_config={"group_name": "torch_dp_test"},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="torchdp", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["final_err"] < 0.05


def test_torch_trainer_ddp(ray_start_regular, tmp_path):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.train.torch import prepare_model
        assert dist.is_initialized()
        torch.manual_seed(dist.get_rank())
        model = prepare_model(torch.nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        X = torch.randn(32, 4)
        y = X @ torch.tensor([[1.0], [-1.0], [2.0], [0.0]])
        for step in range(10):
            opt.zero_grad()
            loss = torch.nn.functional.mse_loss(model(X), y)
            loss.backward()
            opt.step()
            train.report({"loss": float(loss), "step": step,
                          "world": dist.get_world_size(),
                          "backend": dist.get_backend(),
                          "w": model.module.weight.detach().tolist()})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="torchddp", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["world"] == 2
    assert result.metrics["backend"] == "gloo"
    assert result.metrics["loss"] < 2.0


def test_torch_tree_checkpoint_roundtrip_bf16(tmp_path):
    """A TrainState of torch tensors (bf16 and f32 leaves, the optimizer
    state, the step) round-trips through save_pytree/load_pytree: every
    leaf bit-equal, dtypes and types kept."""
    import torch

    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.train import load_pytree, save_pytree
    cfg = gpt.GPTConfig.tiny(dtype=torch.bfloat16)
    fns = training.build_gpt_train(cfg, device="cpu", telemetry=False)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = training.synthetic_lm_batch(torch.Generator().manual_seed(1), 2,
                                        16, cfg.vocab_size, device="cpu")
    state, _ = fns["step_fn"](state, batch)
    extra = {"f32": torch.linspace(0, 1, 5), "nested": [torch.ones(2, 2)]}
    save_pytree({"state": state, "extra": extra}, str(tmp_path / "ck"))
    out = load_pytree(str(tmp_path / "ck"))
    got = out["state"]
    assert type(got) is type(state) and got.step == state.step == 1
    assert type(got.opt_state) is type(state.opt_state)
    assert got.opt_state.count == 1
    for a, b in zip(training._leaves(got.params),
                    training._leaves(state.params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in zip(training._leaves(got.opt_state.nu),
                    training._leaves(state.opt_state.nu)):
        assert torch.equal(a, b)
    assert torch.equal(out["extra"]["f32"], extra["f32"])
    assert torch.equal(out["extra"]["nested"][0], torch.ones(2, 2))


def test_pytree_checkpoint_roundtrip(tmp_path):
    import torch

    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
    tree = {"w": torch.arange(10.0), "nested": {"b": torch.ones((3, 3))}}
    save_pytree(tree, str(tmp_path / "ck"))
    out = load_pytree(str(tmp_path / "ck"), target=tree)
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(10.0))
    np.testing.assert_array_equal(out["nested"]["b"].numpy(),
                                  np.ones((3, 3)))


def _np_bits(x):
    """A leaf as numpy, bf16 as its 16-bit pattern (bit-equal checks)."""
    import torch
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_package_checkpoint_loads(tmp_path, monkeypatch, dtype):
    """A ``build_gpt_train`` state (``GPTConfig.tiny``, one step taken, a
    0-d step counter; f32, and bf16 leaves) that the JAX package's
    ``save_pytree`` wrote as an orbax directory loads into the port
    bit-equal, leaf for leaf, to the JAX package's ``load_pytree`` of
    the same directory: with no target as the same nested dicts and
    lists (None where orbax restores None), and with the port's
    ``TrainState`` as target as that state, its ``AdamWState`` taking
    the chain's Adam count and moments.  Without ``tensorstore`` the
    orbax directory raises, naming it.  A checkpoint written as npz (the
    writer without orbax) loads too, leaves bit-equal."""
    import sys

    import jax
    import jax.numpy as jnp
    import torch

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.train.checkpoint import load_pytree as jax_load
    from ray_tpu.train.checkpoint import save_pytree as jax_save
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.models.training import AdamWState, TrainState
    from ray_tpu_torch.train.checkpoint import load_pytree

    jcfg = jgpt.GPTConfig.tiny(dtype=getattr(jnp, dtype))
    fns = jtrain.build_gpt_train(
        jcfg, make_mesh(dp=1, devices=jax.devices()[:1]), telemetry=False)
    state = fns["init_fn"](jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    state, _ = fns["step_fn"](state, {"tokens": tok[:, :-1],
                                      "targets": tok[:, 1:]})
    ck = str(tmp_path / "jck")
    jax_save(state, ck)
    assert (tmp_path / "jck" / "state" / "_METADATA").is_file()

    want = jax_load(ck)
    got = load_pytree(ck)
    assert jax.tree.structure(jax.tree.map(_np_bits, got)) == \
        jax.tree.structure(jax.tree.map(_np_bits, want))
    assert got["opt_state"][0] is None and got["opt_state"][1][1] is None
    assert got["step"].dim() == 0
    pairs = list(zip(jax.tree.leaves(jax.tree.map(_np_bits, got)),
                     jax.tree.leaves(jax.tree.map(_np_bits, want))))
    assert len(pairs) > 20
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    tcfg = gpt.GPTConfig.tiny(dtype=getattr(torch, dtype))
    tfns = training.build_gpt_train(tcfg, None, device="cpu",
                                    telemetry=False)
    target = tfns["init_fn"](params=params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(state.params)), tcfg,
        device="cpu"))
    jwant = jax_load(ck, target=state)
    placed = load_pytree(ck, target=target)
    assert isinstance(placed, TrainState)
    assert isinstance(placed.opt_state, AdamWState)
    assert placed.step == int(jwant.step) == 1
    adam = jwant.opt_state[1][0]
    assert placed.opt_state.count == int(adam.count) == 1
    for got_tree, want_tree in ((placed.params, jwant.params),
                                (placed.opt_state.mu, adam.mu),
                                (placed.opt_state.nu, adam.nu)):
        g = jax.tree.leaves(jax.tree.map(_np_bits, got_tree))
        w = jax.tree.leaves(jax.tree.map(_np_bits, want_tree))
        assert len(g) == len(w) > 5
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert placed.params["embed"].dtype == getattr(torch, dtype)

    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(NotImplementedError, match="tensorstore"):
        load_pytree(ck)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jax_save({"w": jnp.arange(4.0), "b": [jnp.ones(2, jnp.bfloat16), None]},
             str(tmp_path / "npz"))
    out = load_pytree(str(tmp_path / "npz"))
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4.0))
    assert out["b"][0].dtype == torch.bfloat16 and out["b"][1] is None
    np.testing.assert_array_equal(out["b"][0].float().numpy(), np.ones(2))
    with pytest.raises(FileNotFoundError):
        load_pytree(str(tmp_path / "empty"))


class _ChainAdam(NamedTuple):
    count: Any
    mu: Any


class _ChainSchedule(NamedTuple):
    count: Any


class _FlatOpt(NamedTuple):
    count: int
    mu: Any


class _FlatOptExtra(NamedTuple):
    count: int
    nu: Any


def test_jax_package_checkpoint_target_mismatch_raises(tmp_path):
    """Into a target it does not match, a JAX-package orbax checkpoint
    raises rather than filling leaves from others: a ``layers`` list
    longer than the checkpoint's, a leaf of another shape, and a flat
    optimizer state whose fields no state of the checkpoint's chain
    holds.  The one bridged mismatch, the chain against a flat state,
    takes the first chain state with every field (Adam's count, not the
    schedule's)."""
    import jax.numpy as jnp
    import torch

    from ray_tpu.train.checkpoint import save_pytree as jax_save
    from ray_tpu_torch.train.checkpoint import load_pytree

    ck = str(tmp_path / "jck")
    jax_save({"layers": [{"w": jnp.ones((2, 3))}, {"w": jnp.zeros((2, 3))}],
              "opt": (None, (_ChainAdam(jnp.int32(1), jnp.full(3, 2.0)),
                             _ChainSchedule(jnp.int32(7))))}, ck)

    def target(n_layers=2, shape=(2, 3), opt=None):
        return {"layers": [{"w": torch.empty(shape)}
                           for _ in range(n_layers)],
                "opt": opt or _FlatOpt(0, torch.empty(3))}

    out = load_pytree(ck, target=target())
    assert isinstance(out["opt"], _FlatOpt) and out["opt"].count == 1
    np.testing.assert_array_equal(out["opt"].mu.numpy(), np.full(3, 2.0))
    np.testing.assert_array_equal(out["layers"][1]["w"].numpy(),
                                  np.zeros((2, 3)))
    with pytest.raises(KeyError, match="no leaf"):
        load_pytree(ck, target=target(n_layers=3))
    with pytest.raises(ValueError, match="shape"):
        load_pytree(ck, target=target(shape=(3, 2)))
    with pytest.raises(KeyError, match="no leaf"):
        load_pytree(ck, target=target(
            opt=_FlatOptExtra(0, torch.empty(3))))


def test_trainer_restore_resumes_from_checkpoint(ray_start_regular,
                                                 tmp_path):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)
    from ray_tpu_torch.train.checkpoint import Checkpoint

    def loop(config):
        ckpt = train.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt else 0
        for step in range(start, start + 2):
            train.report({"step": step}, checkpoint=Checkpoint.from_dict(
                {"step": step + 1}))

    storage = str(tmp_path)
    kwargs = dict(scaling_config=ScalingConfig(num_workers=1),
                  run_config=RunConfig(name="resumable",
                                       storage_path=storage))
    r1 = DataParallelTrainer(loop, **kwargs).fit()
    assert r1.error is None and r1.metrics["step"] == 1

    exp_dir = os.path.join(storage, "resumable")
    assert DataParallelTrainer.can_restore(exp_dir)
    restored = DataParallelTrainer.restore(exp_dir)
    r2 = restored.fit()
    assert r2.error is None
    assert r2.metrics["step"] == 3  # resumed at 2, not from scratch


def test_checkpoint_cloud_storage_roundtrip(tmp_path):
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.storage import delete_uri, list_uri

    delete_uri("memory://ckpts")
    ckpt = Checkpoint.from_dict({"step": 7, "w": [1.0, 2.0]})
    ckpt.set_metadata({"metrics": {"loss": 0.5}})
    remote = ckpt.persist("memory://ckpts", "checkpoint_000001")
    assert remote.path.startswith("memory://")
    assert "checkpoint_000001" in list_uri("memory://ckpts")
    back = Checkpoint(remote.path)
    assert back.to_dict()["step"] == 7
    assert back.get_metadata()["metrics"]["loss"] == 0.5
    with back.as_directory() as d:
        assert os.path.exists(os.path.join(d, "dict_checkpoint.pkl"))


def test_trainer_cloud_storage_and_restore(ray_start_regular):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import (Checkpoint, CheckpointConfig,
                                     DataParallelTrainer, RunConfig,
                                     ScalingConfig)
    from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
    from ray_tpu_torch.train.storage import delete_uri, list_uri

    uri = "memory://exp-cloud"
    delete_uri(uri)

    def loop(config):
        ctx = train.get_context()
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_dict()["step"] + 1
        for step in range(start, 3):
            c = (Checkpoint.from_dict({"step": step})
                 if ctx.get_world_rank() == 0 else None)
            train.report({"step": step}, checkpoint=c)

    trainer = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="cloud", storage_path=uri,
            checkpoint_config=CheckpointConfig(num_to_keep=2)))
    result = trainer.fit()
    assert result.metrics["step"] == 2
    exp_uri = uri + "/cloud"
    names = list_uri(exp_uri + "/checkpoints")
    assert names and len(names) <= 2, names
    assert result.checkpoint.path.startswith("memory://")
    assert result.checkpoint.to_dict()["step"] == 2
    restored = DataParallelTrainer.restore(exp_uri)
    assert restored._restored
    mgr = CheckpointManager(exp_uri + "/checkpoints",
                            CheckpointConfig(num_to_keep=2), resume=True)
    assert mgr.latest is not None
    assert mgr.latest.to_dict()["step"] == 2


def test_run_config_callbacks_raise_item_13():
    """``RunConfig.callbacks`` no longer raises (tune was ported): it
    holds tune's experiment callbacks, and the controller's fan-out
    reaches them and survives one that fails."""
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.tune import callbacks as cb_mod

    seen = []

    class Probe(cb_mod.Callback):
        def on_trial_start(self, trial):
            seen.append(trial)

    class Broken(cb_mod.Callback):
        def on_trial_start(self, trial):
            raise RuntimeError("a failing callback")

    cfg = RunConfig(callbacks=[Broken(), Probe()])
    assert len(cfg.callbacks) == 2
    cb_mod.invoke(cfg.callbacks, "on_trial_start", "trial_00000")
    assert seen == ["trial_00000"]


def test_gpu_worker_without_a_card_raises(tmp_path):
    """``use_gpu=True`` on a node whose card is accounting only (no CUDA
    here): the worker, placed in its bundle, is bound to card ``"0"``
    (ROADMAP Queue 3 fault 6), finds no device and the trainer raises; it
    does not go on over gloo.  The card is back once ``fit()`` has
    raised."""
    import ray_tpu_torch
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    def loop(config):
        raise AssertionError("the loop must not start")

    ray_tpu_torch.init(num_cpus=2, num_gpus=1)
    try:
        trainer = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="nogpu", storage_path=str(tmp_path)))
        with pytest.raises(Exception, match="CUDA_VISIBLE_DEVICES='0'"
                                              r"\) finds no CUDA device"):
            trainer.fit()
        deadline = time.monotonic() + 10.0
        while ray_tpu_torch.available_resources().get("GPU") != 1.0:
            assert time.monotonic() < deadline, \
                ray_tpu_torch.available_resources()
            time.sleep(0.05)
    finally:
        ray_tpu_torch.shutdown()


def test_nccl_world_on_cpu_workers_raises(ray_start_regular, tmp_path):
    """An NCCL world asked for on workers without a card raises; it is
    not turned into gloo."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    def loop(config):
        raise AssertionError("the loop must not start")

    trainer = TorchTrainer(
        loop, torch_config=TorchConfig(backend="nccl",
                                       host_collective=False),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="nonccl", storage_path=str(tmp_path)))
    with pytest.raises(Exception, match="'nccl' needs a card"):
        trainer.fit()


def test_torch_trainer_restart_forms_a_new_world(ray_start_regular,
                                                 tmp_path):
    """A failed attempt's world is torn down with its workers and the
    next attempt forms a fresh one (a rendezvous of its own), of the
    same size, and finishes."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    def loop(config):
        import os

        import torch
        import torch.distributed as dist

        from ray_tpu_torch.train.torch.config import WORLD_GROUP
        from ray_tpu_torch.util import collective
        ctx = train.get_context()
        t = collective.allreduce(torch.ones(2), group_name=WORLD_GROUP)
        marker = config["marker"]
        if ctx.get_world_rank() == 1 and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("simulated failure in the first world")
        train.report({"sum": t.tolist(), "world": dist.get_world_size(),
                      "pid": os.getpid(),
                      "coord": collective.get_group(
                          WORLD_GROUP).coordinator})

    trainer = TorchTrainer(
        loop, torch_config=TorchConfig(host_collective=False),
        train_loop_config={"marker": str(tmp_path / "failed_once")},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="reworld", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.error is None
    hist = result.metrics_history
    assert (tmp_path / "failed_once").exists()
    assert hist[-1]["world"] == 2 and hist[-1]["sum"] == [2.0, 2.0]
    assert hist[-1]["_attempt"] == 1
    first = [m for m in hist if m["_attempt"] == 0]
    if first:          # rank 0 reported before rank 1's failure was seen
        assert first[0]["coord"] != hist[-1]["coord"]
        assert first[0]["pid"] != hist[-1]["pid"]


# ------------------------------------------------- the data-parallel GPT
_DP_STEPS = 2
_DP_B, _DP_S = 4, 32
_DP_OPT = dict(lr=1e-3, warmup=1, total_steps=8)


def _dp_batches():
    """Two global batches; rank 0's half holds more masked (-1) targets
    than rank 1's, so a mean of per-rank means would differ from the
    global mean."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(_DP_STEPS):
        tok = rng.integers(0, 512, (_DP_B, _DP_S + 1)).astype(np.int32)
        tgt = tok[:, 1:].copy()
        tgt[0, :20] = -1
        tgt[1, 5:9] = -1
        tgt[3, -3:] = -1
        out.append({"tokens": tok[:, :-1].copy(), "targets": tgt})
    return out


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_gpt_dp_two_workers_match_jax_dp2_mesh(ray_start_regular,
                                               tmp_path, accum_steps):
    """Two gloo workers through ``TorchTrainer`` train ``GPTConfig.tiny``
    (f32, 2 layers) for 2 steps, each on its half of the global batch,
    the halves holding different numbers of valid targets.  Against the
    JAX package's ``build_gpt_train`` on ``make_mesh(dp=2)`` with the
    whole batch: each loss and grad norm within 1e-5 relative, each
    parameter leaf after the 2 steps within 1e-5 of its largest value.
    With ``accum_steps=2`` on both sides each rank holds, for each
    microbatch of the reference's split, that microbatch's rows on its
    shard of the dp axis (global row ``2 i + rank`` for microbatch i),
    so both sides average the same microbatches.  Each rank's step
    recorder reports the MFU of its own tokens/s."""
    import jax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    def dp_loop(config):
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.convert import params_from_jax, params_to_numpy
        from ray_tpu_torch.models import gpt, training
        from ray_tpu_torch.parallel.mesh import make_mesh
        from ray_tpu_torch.telemetry import flops
        ctx = train.get_context()
        r, W = ctx.get_world_rank(), ctx.get_world_size()
        cfg = gpt.GPTConfig.tiny(dtype=torch.float32)
        mesh = make_mesh(dp=-1)
        k = config["accum_steps"]
        fns = training.build_gpt_train(
            cfg, mesh, optimizer=training.default_optimizer(**config["opt"]),
            accum_steps=k, device="cpu", telemetry=True)
        # rank 0 starts from the JAX package's parameters, rank 1 from its
        # own draw: init_fn broadcasts rank 0's to every rank
        params = (params_from_jax(config["params"], cfg, device="cpu") if r == 0
                  else gpt.init_params(cfg, torch.Generator().manual_seed(9),
                                       device="cpu"))
        state = fns["init_fn"](params=params)
        # microbatch i of the global batch is rows [i B/k, (i+1) B/k);
        # the dp axis gives rank r its r-th share of each
        share = _DP_B // (k * W)
        rows = [i * _DP_B // k + r * share + j for i in range(k)
                for j in range(share)]
        for b in config["batches"]:
            local = {n: torch.from_numpy(np.array(v[rows]))
                     for n, v in b.items()}
            state, m = fns["step_fn"](state, local)
            train.report({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "mesh": [int(mesh.size), mesh.shape["dp"]],
                          "params": (params_to_numpy(state.params)
                                     if r == 0 else None)})
        # each rank's recorder counts its own rows: its MFU is that of
        # its local tokens/s, not divided again by the world size
        tel = fns["telemetry"]
        fpt, local = tel.flops_per_token(), len(rows) * _DP_S
        steady = [(rec["mfu"], rec["wall_s"]) for rec in tel.records[1:]]
        summ = tel.summary()
        steady.append((summ["mfu"], summ["steady_step_s"]))
        for got, wall in steady:
            want = flops.mfu(local / wall, fpt)
            if not abs(got - want) <= 1e-12 * want:
                raise AssertionError(f"rank {r}: recorder's MFU {got} vs "
                                     f"flops.mfu of {local} tokens in "
                                     f"{wall} s, {want}")
        if summ["tokens_per_step"] != local:
            raise AssertionError(f"rank {r}: recorder counts "
                                 f"{summ['tokens_per_step']} tokens a "
                                 f"step, the rank holds {local}")

    batches = _dp_batches()
    jcfg = jgpt.GPTConfig.tiny(dtype=jax.numpy.float32)
    jfns = jtrain.build_gpt_train(
        jcfg, make_mesh(dp=2, devices=jax.devices()[:2]),
        optimizer=jtrain.default_optimizer(**_DP_OPT),
        accum_steps=accum_steps, telemetry=False)
    jstate = jfns["init_fn"](jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, jstate.params)
    want = []
    for b in batches:
        jstate, m = jfns["step_fn"](jstate, b)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    want_params = jax.tree.map(np.asarray, jstate.params)

    trainer = TorchTrainer(
        dp_loop, torch_config=TorchConfig(host_collective=False),
        train_loop_config={"params": params0, "batches": batches,
                           "opt": _DP_OPT, "accum_steps": accum_steps},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="gptdp", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert len(hist) == _DP_STEPS and hist[0]["mesh"] == [2, 2]
    got = np.array([(h["loss"], h["grad_norm"]) for h in hist])
    np.testing.assert_allclose(got, np.array(want), rtol=1e-5)
    tl = hist[-1]["params"]
    for path, w in jax.tree_util.tree_leaves_with_path(want_params):
        g = tl
        for k in path:
            g = g[k.key]
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), path
