"""Port parity: ``ray_tpu_torch.train.huggingface`` against HF
Transformers and the JAX package (counterpart of ``tests/test_hf_port.py``,
BASELINE config 5).

A tiny ``GPT2LMHeadModel`` is built from a ``GPT2Config`` in memory (no
download), as the reference test's ``tiny_hf`` does.  Its weights go
through the port's ``port_gpt2`` into the port's GPT in the exact
architecture (LayerNorm, the tanh gelu, learned positions, biases, tied
head) and through the JAX package's ``port_gpt2`` into its GPT; the
three forwards give the same logits and loss in f32 within 2e-4 (f32
summation order moves them by ~1e-6; a wrong gelu, eps or bias moves
them by 1e-3 or more).  ``export_gpt2`` writes the ported leaves back
bit for bit.

The engine serves the exact architecture of ``GPTConfig.tiny`` (f32,
biases and norms perturbed off their zeros and ones) token for token
as the JAX engine does, with a prefix hit and decode past position 64,
so the learned table is indexed by absolute position.  The
``TransformersTrainer`` runs a world of one on the CPU: its losses from
a token stream within 1e-5 of the JAX package's ``build_gpt_train`` on
the same packed batches (the reference's ``_pack_token_stream``, its
loop's optax chain), and 2 steps from ``datasets=``.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from transformers import GPT2Config, GPT2LMHeadModel  # noqa: E402

EXACT = dict(norm="layernorm", act="gelu", pos="learned", use_bias=True)


def tiny_hf(vocab=128, d=32, layers=2, heads=2, positions=64, seed=0):
    torch.manual_seed(seed)
    cfg = GPT2Config(vocab_size=vocab, n_embd=d, n_layer=layers,
                     n_head=heads, n_positions=positions,
                     resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    return GPT2LMHeadModel(cfg).eval()


def _ported(hf):
    """(port cfg, port params on the CPU, JAX cfg, JAX params) of one HF
    model, f32."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.train.huggingface import port_gpt2 as jport
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.train.huggingface import port_gpt2
    tcfg, tnp = port_gpt2(hf, dtype=torch.float32)
    jcfg, jnp_params = jport(hf, dtype=jnp.float32)
    return (tcfg, params_from_jax(tnp, tcfg, device="cpu"), jcfg,
            jax.tree.map(jnp.asarray, jnp_params))


def test_gpt2_config_is_the_exact_architecture():
    from ray_tpu_torch.train.huggingface import gpt2_config
    cfg = gpt2_config(GPT2Config())
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads,
            cfg.max_seq) == (50257, 768, 12, 12, 1024)
    assert (cfg.norm, cfg.act, cfg.pos, cfg.use_bias, cfg.tie_embeddings,
            cfg.dtype) == ("layernorm", "gelu", "learned", True, True,
                           torch.bfloat16)


def test_logits_match_hf_and_jax():
    """The port's logits against HF's and against the JAX package's
    ``forward`` on its own ``port_gpt2`` of the same model."""
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu_torch.models import gpt as tgpt
    hf = tiny_hf()
    tcfg, tparams, jcfg, jparams = _ported(hf)
    tokens = np.arange(24, dtype=np.int64).reshape(2, 12) % 128
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
        got, _ = tgpt.forward(tparams, torch.from_numpy(tokens), tcfg)
    want, _ = jgpt.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_loss_matches_hf_and_jax():
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu_torch.models import gpt as tgpt
    hf = tiny_hf(seed=3)
    tcfg, tparams, jcfg, jparams = _ported(hf)
    tokens = (np.arange(26) * 7 % 128).astype(np.int64).reshape(2, 13)
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens),
                 labels=torch.from_numpy(tokens)).loss.item()
        got = float(tgpt.loss_fn(
            tparams, {"tokens": torch.from_numpy(tokens[:, :-1]),
                      "targets": torch.from_numpy(tokens[:, 1:])}, tcfg))
    want = float(jgpt.loss_fn(
        jparams, {"tokens": jnp.asarray(tokens[:, :-1], jnp.int32),
                  "targets": jnp.asarray(tokens[:, 1:], jnp.int32)}, jcfg))
    assert abs(got - ref) < 2e-4, (got, ref)
    assert abs(got - want) < 2e-4, (got, want)


def test_export_round_trip_is_exact():
    """``port_gpt2`` then ``export_gpt2`` into a model of another init
    gives back HF's state bit for bit, from numpy leaves and from the
    port's tensors alike."""
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.train.huggingface import export_gpt2, port_gpt2
    hf = tiny_hf(seed=5)
    cfg, params = port_gpt2(hf, dtype=torch.float32)
    for tree in (params, params_from_jax(params, cfg, device="cpu")):
        hf2 = tiny_hf(seed=9)
        export_gpt2(tree, hf2)
        for (ka, va), (kb, vb) in zip(hf.state_dict().items(),
                                      hf2.state_dict().items()):
            assert ka == kb
            np.testing.assert_array_equal(va.numpy(), vb.numpy(),
                                          err_msg=ka)


def test_load_model_reads_a_local_directory(tmp_path):
    from ray_tpu_torch.train.huggingface import load_model, port_gpt2
    hf = tiny_hf(seed=4)
    hf.save_pretrained(tmp_path)
    cfg, params = load_model(str(tmp_path), dtype=torch.float32)
    _, want = port_gpt2(hf, dtype=torch.float32)
    assert cfg.use_bias and cfg.pos == "learned"
    np.testing.assert_array_equal(params["layers"]["wq"],
                                  want["layers"]["wq"])


# ---------------------------------------------------------------------------
# the engine in the exact architecture
# ---------------------------------------------------------------------------

def _perturbed(tree, rng):
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


def test_exact_architecture_engine_matches_jax_engine():
    """Greedy streams of ``GPTConfig.tiny`` in the exact architecture
    (f32, slots 2, page 16, prefix caching on) equal the JAX engine's
    token for token, logits within 2e-4: a 40-token prompt decoded to
    position 71, then a second sharing its first 32 tokens (a 2-page
    prefix hit whose suffix starts at position 32) decoded past 64."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.inference import InferenceEngine as JaxEngine
    from ray_tpu.models import gpt as jgpt
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.inference import InferenceEngine
    from ray_tpu_torch.models import gpt as tgpt
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, **EXACT)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32, **EXACT)
    params = _perturbed(jax.tree.map(np.asarray, jgpt.init_params(
        jcfg, jax.random.PRNGKey(0))), np.random.default_rng(1))
    geometry = dict(slots=2, page_size=16, buckets=(16, 32, 64),
                    prefix=True)
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, params),
                     telemetry=False, debug_logits=True, **geometry)
    teng = InferenceEngine(tcfg, params_from_jax(params, tcfg, device="cpu"),
                           device="cpu", debug_logits=True, **geometry)
    rng = np.random.RandomState(7)
    first = [int(t) for t in rng.randint(0, 512, 40)]
    second = first[:32] + [int(t) for t in rng.randint(0, 512, 9)]

    def drive(engine):
        events, rids = [], []
        for prompt, new in ((first, 32), (second, 30)):
            rids.append(engine.submit(prompt, max_new_tokens=new))
            while engine.has_work():
                events.extend(tuple(ev) for ev in engine.step())
        return events, rids

    (jev, jrids), (tev, trids) = drive(jeng), drive(teng)
    assert tev == jev
    assert len(tev) == 62
    for jr, tr in zip(jrids, trids):
        np.testing.assert_allclose(np.stack(teng.logits_trace[tr]),
                                   np.stack(jeng.logits_trace[jr]),
                                   atol=2e-4, rtol=2e-4)
    assert teng.stats()["prefix"] == jeng.stats()["prefix"]
    assert teng.stats()["prefix"]["hit_tokens"] == 32
    assert teng.leak_free()


# ---------------------------------------------------------------------------
# TransformersTrainer
# ---------------------------------------------------------------------------

ARGS = {"max_steps": 3, "logging_steps": 1, "save_steps": 3, "seq_len": 16,
        "per_device_train_batch_size": 2, "learning_rate": 1e-3,
        "eos_token_id": 0}


@pytest.fixture(scope="module")
def session():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _jax_losses(hf, stream, steps):
    """The JAX package's ``build_gpt_train`` with the reference loop's
    optax chain on ``make_mesh(dp=1)``, over the reference's packed
    batches of ``stream``."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import training as jtrain
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.train.huggingface import port_gpt2
    from ray_tpu.train.huggingface.transformers_trainer import \
        _pack_token_stream
    cfg, params = port_gpt2(hf, dtype=jnp.float32)
    lr = ARGS["learning_rate"]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, lr, 1, steps, lr * 0.1),
        b1=0.9, b2=0.999, weight_decay=0.01))
    fns = jtrain.build_gpt_train(cfg, make_mesh(dp=1,
                                                devices=jax.devices()[:1]),
                                 optimizer=tx, telemetry=False)
    p = jax.tree.map(jnp.asarray, params)
    state = jtrain.TrainState(p, tx.init(p), jnp.zeros((), jnp.int32))

    def rows():
        while True:
            yield stream

    packer = _pack_token_stream(rows(), ARGS["seq_len"],
                                ARGS["per_device_train_batch_size"], 0)
    losses = []
    for _ in range(steps):
        tokens, targets = next(packer)
        state, m = fns["step_fn"](state, {"tokens": jnp.asarray(tokens),
                                          "targets": jnp.asarray(targets)})
        losses.append(float(m["loss"]))
    return losses


def _trainer(tmp_path, name, **kw):
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.huggingface import TransformersTrainer
    from ray_tpu_torch.train.torch import TorchConfig
    return TransformersTrainer(
        dtype=torch.float32, device="cpu",
        backend_config=TorchConfig(host_collective=False),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path), name=name), **kw)


def test_transformers_trainer_matches_jax_steps(session, tmp_path):
    """Three steps from a token stream: each reported loss within 1e-5 of
    the JAX package's step on the same packed batch, the step count, the
    grad norms finite, and a checkpoint reported at the last step."""
    hf = tiny_hf(seed=1)
    stream = np.random.default_rng(0).integers(0, 128, size=2_000,
                                               dtype=np.int32)
    result = _trainer(tmp_path, "hf_ft", model=hf, token_stream=stream,
                      training_args=ARGS).fit()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert [m["step"] for m in hist] == [1, 2, 3]
    want = _jax_losses(hf, stream, 3)
    np.testing.assert_allclose([m["loss"] for m in hist], want, atol=1e-5)
    assert all(np.isfinite(m["grad_norm"]) for m in hist)
    assert result.checkpoint is not None


def test_transformers_trainer_from_a_dataset(session, tmp_path):
    """``datasets=``: rows with ``input_ids`` reach the worker through the
    port's ``streaming_split``; 2 steps, finite losses."""
    import ray_tpu_torch.data as rdata
    hf = tiny_hf(seed=2)
    rng = np.random.default_rng(1)
    rows = [{"input_ids": rng.integers(0, 128, size=40).tolist()}
            for _ in range(40)]
    result = _trainer(tmp_path, "hf_ft_ds", model=hf,
                      datasets={"train": rdata.from_items(rows)},
                      training_args=dict(ARGS, max_steps=2, save_steps=100,
                                         per_device_train_batch_size=1)
                      ).fit()
    assert result.error is None, result.error
    assert result.metrics["step"] == 2
    assert all(np.isfinite(m["loss"]) for m in result.metrics_history)


def test_transformers_trainer_mesh_must_span_the_workers():
    """The reference's one-worker mesh of 8 virtual devices has no port
    counterpart: a mesh spans the world, one rank a worker."""
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train.huggingface import TransformersTrainer
    with pytest.raises(ValueError, match="num_workers = 1"):
        TransformersTrainer(model=tiny_hf(), training_args={
            "mesh": {"dp": 4, "tp": 2}},
            scaling_config=ScalingConfig(num_workers=1))
    with pytest.raises(ValueError, match="needs `model=`"):
        TransformersTrainer()
