"""The port's training resilience against the JAX package's
(counterparts of ``tests/test_resilience.py``): the async checkpoint
write, bit-exact resume (losses float-equal, not allclose), loud
fallbacks from corrupt, drifted and truncated snapshots, the ``ckpt.*``
fault sites, the straggler supervisor and the config knobs (decisions
equal to the reference's on the same inputs), and a checkpoint the JAX
package writes as npz loaded by the port with the same loss.

Tolerances: resumed losses float-equal (the CPU step runs under
``torch.use_deterministic_algorithms``); the loss of the JAX package's
restored parameters in the port within 2e-5 of the reference's (f32).
"""

import glob
import os
import sys
import time

import numpy as np
import pytest
import torch

TINY = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, max_seq=32)


@pytest.fixture(autouse=True)
def _no_faults():
    from ray_tpu_torch.util import chaos
    chaos.clear_faults()
    yield
    chaos.clear_faults()


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.fixture(scope="module")
def tiny():
    from ray_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(**TINY, dtype=torch.float32)


@pytest.fixture(scope="module")
def train_fns(tiny):
    from ray_tpu_torch.models import training
    return training.build_gpt_train(tiny, device="cpu", telemetry=False)


def _loop(cfg, fns, **kw):
    from ray_tpu_torch.resilience import run_train_ckpt_loop
    return run_train_ckpt_loop(cfg, batch_size=2, seq_len=16, seed=0,
                               fns=fns, device="cpu", **kw)


# --------------------------------------------------------- checkpointing
def test_checkpoint_write_is_async(tmp_path, monkeypatch):
    """The step loop pays the host copy, never the disk write: with a
    slow writer ``save`` returns at once and ``flush`` sees the write."""
    import ray_tpu_torch.resilience.checkpoint as rc
    slow, wrote = 0.25, []

    def slow_save(tree, path, *, name="state"):
        time.sleep(slow)
        wrote.append(path)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, f"{name}.marker"), "w") as f:
            f.write("x")

    monkeypatch.setattr(rc, "save_pytree", slow_save)
    ck = rc.TrainCheckpointer(str(tmp_path), every=2, keep=2,
                              telemetry=True)
    state = {"w": torch.zeros(4, 4)}
    t0 = time.monotonic()
    assert ck.maybe_save(state, step=2) is True
    assert ck.maybe_save(state, step=3) is False
    assert time.monotonic() - t0 < slow / 2
    ck.flush()
    assert len(wrote) == 1
    summary = ck.telemetry.summary()
    assert summary["checkpoints"] == 1
    assert summary["last_checkpoint_step"] == 2
    assert summary["write_s"] >= slow
    ck.close()


def test_snapshot_is_a_copy_the_next_step_cannot_touch(tmp_path):
    """The port's step updates tensors in place: the snapshot must hold
    the state at the save, not a later step's (on the CPU ``.cpu()``
    aliases)."""
    from ray_tpu_torch.resilience import TrainCheckpointer
    w = torch.arange(6.0)
    with TrainCheckpointer(str(tmp_path), every=1, keep=1) as ck:
        ck.save({"w": w}, step=1)
        w.add_(100.0)                        # the next step, in place
        got = ck.restore_latest()
    assert torch.equal(got["state"]["w"], torch.arange(6.0))


def test_train_resume_is_bit_exact(tmp_path, tiny, train_fns,
                                   deterministic):
    """A run killed at step 4 and resumed from its checkpoint gives the
    uninterrupted run's losses, float-equal: parameters, optimizer state,
    step, the cursor and the data generator's state all survive."""
    from ray_tpu_torch.resilience import TrainCheckpointer
    full = _loop(tiny, train_fns, steps=6)
    assert len(full["losses"]) == 6
    d = str(tmp_path / "ck")
    with TrainCheckpointer(d, every=2, keep=2, telemetry=True) as ck:
        part = _loop(tiny, train_fns, steps=4, ckpt=ck)
    assert part["losses"] == full["losses"][:4]
    assert part["checkpoint"]["checkpoints"] == 2
    assert part["checkpoint"]["last_checkpoint_step"] == 4
    with TrainCheckpointer(d, every=2, keep=2) as ck2:
        rest = _loop(tiny, train_fns, steps=6, ckpt=ck2, resume=True)
    assert rest["start_step"] == 4
    assert rest["restored_from"].endswith("checkpoint_000001")
    assert rest["losses"] == full["losses"][4:]
    assert rest["final_step"] == 6
    for a, b in zip(full["state"].params.values(),
                    rest["state"].params.values()):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)


def test_corrupt_checkpoint_falls_back_loudly(tmp_path, capfd, tiny,
                                              train_fns):
    from ray_tpu_torch.resilience import TrainCheckpointer
    d = str(tmp_path / "ck")
    with TrainCheckpointer(d, every=2, keep=3) as ck:
        _loop(tiny, train_fns, steps=4, ckpt=ck)
    dirs = sorted(glob.glob(os.path.join(d, "checkpoint_*")))
    assert len(dirs) == 2
    with open(os.path.join(dirs[-1], "train_state.pt"), "r+b") as f:
        f.truncate(100)                       # a torn write
    capfd.readouterr()
    with TrainCheckpointer(d, every=2, keep=3) as ck2:
        rest = _loop(tiny, train_fns, steps=4, ckpt=ck2, resume=True)
    assert rest["start_step"] == 2
    assert rest["restored_from"].endswith("checkpoint_000000")
    assert "falling back to the previous retained snapshot" in \
        capfd.readouterr().err


def test_drifted_checkpoint_fails_validation_and_falls_back(
        tmp_path, capfd, tiny, train_fns):
    """A snapshot that loads cleanly but is not this model's state (the
    embedding lost a row) is rejected by validation, loudly."""
    from ray_tpu_torch.resilience import TrainCheckpointer
    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
    d = str(tmp_path / "ck")
    with TrainCheckpointer(d, every=2, keep=3) as ck:
        _loop(tiny, train_fns, steps=4, ckpt=ck)
    dirs = sorted(glob.glob(os.path.join(d, "checkpoint_*")))
    payload = load_pytree(dirs[-1], name="train_state")
    payload["state"].params["embed"] = payload["state"].params["embed"][:-1]
    save_pytree(payload, dirs[-1], name="train_state")
    capfd.readouterr()
    with TrainCheckpointer(d, every=2, keep=3) as ck2:
        rest = _loop(tiny, train_fns, steps=4, ckpt=ck2, resume=True)
    assert rest["start_step"] == 2
    err = capfd.readouterr().err
    assert "mismatch" in err and "falling back" in err


def test_ckpt_write_and_truncate_faults(tmp_path, capfd, tiny, train_fns):
    """``ckpt.write`` fails a write (counted, the run goes on);
    ``ckpt.truncate`` tears one on disk (restore falls back)."""
    from ray_tpu_torch.resilience import TrainCheckpointer
    from ray_tpu_torch.util import chaos
    d = str(tmp_path / "ck")
    plan = chaos.install_faults("ckpt.write@1,ckpt.truncate@2")
    with TrainCheckpointer(d, every=1, keep=4, telemetry=True) as ck:
        _loop(tiny, train_fns, steps=3, ckpt=ck)
        ck.flush()
        summary = ck.telemetry.summary()
    assert summary["failed"] == 1 and summary["checkpoints"] == 2
    assert ("ckpt.write", 1) in plan.fired
    assert ("ckpt.truncate", 2) in plan.fired
    chaos.clear_faults()
    capfd.readouterr()
    with TrainCheckpointer(d, every=1, keep=4) as ck2:
        rest = _loop(tiny, train_fns, steps=3, ckpt=ck2, resume=True)
    assert rest["start_step"] == 2
    assert "falling back" in capfd.readouterr().err


def test_sidecar_mismatch_refusal(tmp_path):
    """A snapshot written on one mesh refuses to restore onto another
    unless ``reshard=True`` (typed); one with no sidecar restores."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.resilience import (MeshMismatchError,
                                          TrainCheckpointer)
    with TrainCheckpointer(str(tmp_path / "a"), every=1,
                           mesh=MeshSpec.create(fsdp=4),
                           accum_steps=1) as ck:
        ck.save({"w": torch.ones(2)}, step=1)
        with pytest.raises(MeshMismatchError, match="fsdp"):
            ck.restore_latest(mesh=MeshSpec.create(fsdp=2))
        got = ck.restore_latest(mesh=MeshSpec.create(fsdp=2), reshard=True)
        assert got["mesh"] == MeshSpec.create(fsdp=4)
        assert got["accum_steps"] == 1
    with TrainCheckpointer(str(tmp_path / "b"), every=1) as ck:
        ck.save({"w": torch.ones(2)}, step=1)
        got = ck.restore_latest(mesh=MeshSpec.create(fsdp=2))
        assert got["mesh"] is None and got["accum_steps"] is None


def test_jax_package_npz_checkpoint_loads_with_the_same_loss(
        tmp_path, monkeypatch, tiny):
    """A checkpoint the JAX package's own checkpointed loop writes as npz
    (orbax made unimportable, its writer's fallback) is found by the
    port's checkpointer; its parameters, in the port, give the loss the
    JAX package computes with them (within 2e-5, f32), and its step and
    optimizer count are the reference's."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtraining
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.resilience import TrainCheckpointer as JCheckpointer
    from ray_tpu.resilience import run_train_ckpt_loop as jloop
    from ray_tpu.train.checkpoint import load_pytree as jload
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.resilience import TrainCheckpointer
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    fns = jtraining.build_gpt_train(
        jcfg, make_mesh(dp=1, devices=jax.devices()[:1]), telemetry=False)
    d = str(tmp_path / "jck")
    with JCheckpointer(d, every=2, keep=2) as ck:
        jloop(jcfg, steps=2, batch_size=2, seq_len=16, seed=0, fns=fns,
              ckpt=ck)
    (newest,) = glob.glob(os.path.join(d, "checkpoint_*"))
    assert os.path.exists(os.path.join(newest, "train_state.npz"))
    with TrainCheckpointer(d, every=2, keep=2) as port_ck:
        got = port_ck.restore_latest()
    assert got["step"] == 2 and got["path"] == newest
    state = got["state"]
    assert type(state).__name__ == "TrainState" and int(state.step) == 2
    adam = state.opt_state[1][0]
    assert type(adam).__name__ == "ScaleByAdamState"
    assert int(adam.count) == 2
    want = jload(newest, name="train_state")
    assert int(got["extras"]["data_cursor"]) == \
        int(want["extras"]["data_cursor"]) == 2
    params = params_from_jax(
        {k: ({kk: vv.numpy() for kk, vv in v.items()}
             if isinstance(v, dict) else v.numpy())
         for k, v in state.params.items()}, tiny, device="cpu")
    batch = jtraining.synthetic_lm_batch(jax.random.PRNGKey(5), 2, 16,
                                         jcfg.vocab_size)
    jloss = float(jgpt.loss_fn(want["state"].params, batch, jcfg))
    tloss = tgpt.loss_fn(params, {k: torch.from_numpy(np.array(v))
                                  for k, v in batch.items()}, tiny).item()
    np.testing.assert_allclose(tloss, jloss, rtol=2e-5)


# ------------------------------------------------------------ straggler
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_straggler_supervisor_blip_vs_sustained(pkg):
    """The same wall-time sequence gives the same verdicts in both
    packages: the median baseline from accepted steps, a blip never
    fires, ``dwell`` consecutive slow steps fire once, reset forgets."""
    if pkg == "port":
        from ray_tpu_torch.resilience import StragglerSupervisor
    else:
        from ray_tpu.resilience import StragglerSupervisor
    sup = StragglerSupervisor(factor=3.0, dwell=3, window=8)
    assert sup.enabled
    assert not any(sup.observe(w) for w in (0.01, 0.5, 0.01, 0.012))
    assert sup.baseline_s() == pytest.approx(0.011)
    assert [sup.observe(w) for w in (0.2, 0.2, 0.011)] == [False] * 3
    assert sup.events == 0 and sup.slow_steps == 2
    assert [sup.observe(0.2) for _ in range(3)] == [False, False, True]
    assert sup.events == 1
    assert sup.event_log[-1]["baseline_s"] == pytest.approx(0.011)
    sup.reset()
    assert sup.baseline_s() == 0.0
    assert sup.observe(10.0) is False
    off = StragglerSupervisor(factor=0.0, dwell=1, window=8)
    assert not off.enabled and not any(off.observe(100.0) for _ in range(5))
    with pytest.raises(ValueError, match="dwell"):
        StragglerSupervisor(factor=2.0, dwell=0)
    with pytest.raises(ValueError, match="min_samples"):
        StragglerSupervisor(factor=2.0, window=2)


def test_straggler_per_tier_baselines_match_reference():
    """Random per-tier wall sequences: every verdict and the event log
    equal the reference supervisor's."""
    from ray_tpu.resilience import StragglerSupervisor as JSup
    from ray_tpu_torch.resilience import StragglerSupervisor
    rng = np.random.RandomState(3)
    a = StragglerSupervisor(factor=2.0, dwell=2, window=6)
    b = JSup(factor=2.0, dwell=2, window=6)
    for _ in range(200):
        tier = ("ici", "dcn")[rng.randint(2)]
        wall = (0.01 if tier == "ici" else 0.1) * (
            5.0 if rng.rand() < 0.3 else 1.0 + 0.1 * rng.rand())
        assert a.observe(wall, tier=tier) == b.observe(wall, tier=tier)
    assert a.events == b.events > 0
    assert a.event_log == b.event_log


# ---------------------------------------------------------------- knobs
def test_resilience_config_env_knobs_match_reference(monkeypatch):
    """Defaults, parsed values and the loud clamps of every
    ``RAY_TPU_CKPT_*`` / ``RAY_TPU_ELASTIC_*`` / ``RAY_TPU_STRAGGLER_*``
    knob equal the reference's."""
    import dataclasses

    from ray_tpu.resilience.config import resilience_config as jconfig
    from ray_tpu_torch.resilience import TrainCheckpointer
    from ray_tpu_torch.resilience.config import resilience_config
    envs = [{},
            {"RAY_TPU_CKPT_EVERY": "50", "RAY_TPU_CKPT_DIR": "/tmp/ck",
             "RAY_TPU_CKPT_KEEP": "5", "RAY_TPU_ELASTIC_MIN_DEVICES": "2",
             "RAY_TPU_ELASTIC_GRACEFUL": "0",
             "RAY_TPU_STRAGGLER_FACTOR": "2.5",
             "RAY_TPU_STRAGGLER_DWELL": "5",
             "RAY_TPU_STRAGGLER_WINDOW": "32"},
            {"RAY_TPU_CKPT_EVERY": "-1", "RAY_TPU_CKPT_KEEP": "0",
             "RAY_TPU_ELASTIC_MIN_DEVICES": "0",
             "RAY_TPU_STRAGGLER_FACTOR": "-1",
             "RAY_TPU_STRAGGLER_DWELL": "0",
             "RAY_TPU_STRAGGLER_WINDOW": "1"}]
    try:
        for env in envs:
            for name in envs[1]:
                monkeypatch.delenv(name, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            assert dataclasses.asdict(resilience_config(refresh=True)) == \
                dataclasses.asdict(jconfig(refresh=True))
        assert resilience_config().ckpt_keep == 1
    finally:
        for name in envs[1]:
            monkeypatch.delenv(name, raising=False)
        resilience_config(refresh=True)
        jconfig(refresh=True)
    with pytest.raises(ValueError, match="RAY_TPU_CKPT_DIR"):
        TrainCheckpointer()


def test_ckpt_telemetry_summary_matches_reference():
    from ray_tpu.telemetry.ckpt import CkptTelemetry as JCkpt
    from ray_tpu.telemetry.config import TelemetryConfig as JConfig
    from ray_tpu_torch.telemetry import CkptTelemetry, TelemetryConfig
    a = CkptTelemetry(config=TelemetryConfig(enabled=True))
    b = JCkpt(config=JConfig(enabled=True))
    for t in (a, b):
        t.record_write(0.5, step=2)
        t.record_write(0.25, step=4)
        t.record_failure()
    assert a.summary() == b.summary()
    assert CkptTelemetry(config=TelemetryConfig(enabled=False)) \
        .summary() == {"enabled": False}
