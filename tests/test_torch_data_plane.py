"""The port's streaming data plane against the JAX package's
(counterparts of ``tests/test_data_plane.py``): sources, packer, stream
and cursor images bit-equal to ``ray_tpu.data`` on the same seeds; the
chaos sites (reader kills, pack retries, delayed and hedged reads, the
kill/resume fuzz) replaying identically; ``segment_attention`` and the
packed ``loss_fn`` (and their gradients) within f32 rounding of the
reference's; the cursor riding a port checkpoint; and the streaming
train resume float-equal, in process and across a SIGKILLed
subprocess.

Tolerances: sources, batches, spans and cursor images are compared
bit for bit (numpy on both sides); attention and loss in f32 within
2e-5 (einsum summation order); bf16 attention within bf16 rounding of
the reference (2e-2 on O(1) outputs)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

TINY = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, max_seq=32)


@pytest.fixture(autouse=True)
def _no_faults():
    from ray_tpu.util import chaos as jchaos
    from ray_tpu_torch.util import chaos
    chaos.clear_faults()
    jchaos.clear_faults()
    yield
    chaos.clear_faults()
    jchaos.clear_faults()


@pytest.fixture
def deterministic():
    """The CPU embedding backward (a scatter-add) may change its order
    between calls; a bit-exact resume needs the deterministic one."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _source(pkg="port", seed=7, shards=3, docs=20, vocab=64):
    if pkg == "port":
        from ray_tpu_torch.data import SyntheticDocs
    else:
        from ray_tpu.data import SyntheticDocs
    return SyntheticDocs(seed, num_shards=shards, docs_per_shard=docs,
                         vocab=vocab, min_len=3, max_len=12)


def _collect(loader, n=None):
    out = []
    for sb in loader:
        out.append(sb)
        if n is not None and len(out) >= n:
            break
    return out


def _assert_same_batches(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert set(x.batch) == set(y.batch)
        for k in x.batch:
            np.testing.assert_array_equal(np.asarray(x.batch[k]),
                                          np.asarray(y.batch[k]))
        assert x.spans == y.spans


# --------------------------------------------------- bit-equal to the JAX
def test_sources_and_packer_bit_equal_to_reference(tmp_path):
    """Every document, every packed batch (tokens, targets, segments,
    positions, spans) and the packer's residue are the reference's."""
    from ray_tpu.data import SamplePacker as JPacker
    from ray_tpu.data import TokenFileSource as JFiles
    from ray_tpu.data.source import write_token_shards as jwrite
    from ray_tpu_torch.data import SamplePacker, TokenFileSource
    from ray_tpu_torch.data.source import write_token_shards
    src, ref = _source(), _source("jax")
    for s in range(3):
        for (d, t), (rd, rt) in zip(src.read(s, 0, 20), ref.read(s, 0, 20)):
            assert d == rd and t.dtype == rt.dtype
            np.testing.assert_array_equal(t, rt)
    docs = src.read(0, 0, 20) + src.read(1, 0, 20)
    for pack in (True, False):
        a, b = SamplePacker(2, 24, pack=pack), JPacker(2, 24, pack=pack)
        for i, (d, t) in enumerate(docs):
            a.add(d, t)
            b.add(d, t)
            if i == 11:
                assert a.state_dict() == b.state_dict()
        a.flush()
        b.flush()
        while True:
            x, y = (a.pop_batch(allow_partial=True),
                    b.pop_batch(allow_partial=True))
            assert (x is None) == (y is None)
            if x is None:
                break
            for f in ("tokens", "targets", "segment_ids", "positions"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
            assert x.spans == y.spans
            assert x.packed_tokens == y.packed_tokens
    shards = [[[1, 2, 3], [4, 5], [6, 7, 8, 9]], [[10], [11, 12, 13]]]
    port = TokenFileSource(write_token_shards(str(tmp_path / "p"), shards))
    jax_ = JFiles(jwrite(str(tmp_path / "j"), shards))
    for s in (0, 1):
        got, want = port.read(s, 0, 9), jax_.read(s, 0, 9)
        assert [d for d, _ in got] == [d for d, _ in want]
        for (_, t), (_, u) in zip(got, want):
            np.testing.assert_array_equal(t, u)


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_stream_and_cursor_images_bit_equal_to_reference(pack):
    """The delivered batch sequence and every cursor's uint8 image equal
    the reference loader's; a port loader resumes from a reference
    cursor image (and back)."""
    from ray_tpu.data import StreamingLoader as JLoader
    from ray_tpu_torch.data import StreamingLoader
    kw = dict(batch_size=2, seq_len=24, seed=0, pack=pack,
              device_put=False)
    with StreamingLoader(_source(), prefetch=3, **kw) as a:
        got = _collect(a, 8)
    with JLoader(_source("jax"), **kw) as b:
        want = _collect(b, 8)
    _assert_same_batches(got, want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.cursor_array, y.cursor_array)
    with StreamingLoader(_source(), cursor=want[3].cursor_array,
                         **kw) as c:
        _assert_same_batches(_collect(c, 4), want[4:])
    with JLoader(_source("jax"), cursor=got[5].cursor_array, **kw) as d:
        _assert_same_batches(_collect(d, 2), got[6:])


def test_device_batches_are_tensors_of_the_host_batch():
    """Delivered on a device (the CPU here, a plain copy), a batch is
    the host batch as int32 tensors; ``sharding`` cuts each rank's rows
    before the copy, and ``set_sharding`` re-places the staged one."""
    from ray_tpu_torch.data import StreamingLoader
    kw = dict(batch_size=4, seq_len=24, seed=0)
    with StreamingLoader(_source(), device_put=False, **kw) as h:
        host = _collect(h, 3)
    with StreamingLoader(_source(), device="cpu", **kw) as d:
        first = d.next()
        d.set_sharding(lambda b: {k: v[1::2] for k, v in b.items()})
        rest = _collect(d, 2)
    for k, v in first.batch.items():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), host[0].batch[k])
    for sb, ref in zip(rest, host[1:]):
        for k, v in sb.batch.items():
            np.testing.assert_array_equal(v.numpy(), ref.batch[k][1::2])


def test_cursor_image_roundtrip_and_geometry_refusal():
    from ray_tpu_torch.data import StreamCursor, StreamingLoader
    src = _source()
    with StreamingLoader(src, batch_size=2, seq_len=24,
                         device_put=False) as ld:
        sb = ld.next()
    back = StreamCursor.from_array(sb.cursor_array)
    assert back == sb.cursor and back.batches == 1
    np.testing.assert_array_equal(back.to_array(), sb.cursor_array)
    with pytest.raises(ValueError, match="geometry mismatch"):
        StreamingLoader(src, batch_size=4, seq_len=24,
                        cursor=sb.cursor_array, device_put=False)
    with pytest.raises(ValueError, match="geometry mismatch"):
        StreamingLoader(src, batch_size=2, seq_len=24, seed=9,
                        cursor=sb.cursor_array, device_put=False)
    with pytest.raises(ValueError, match="capacity"):
        sb.cursor.to_array(capacity=8)
    with pytest.raises(ValueError, match="corrupt"):
        StreamCursor.from_array(np.zeros(64, np.uint8))


# ------------------------------------------------------------ chaos sites
@pytest.mark.parametrize("spec, counter", [
    ("data.read@2,data.read@4", "reader_restarts"),
    ("data.pack@2", "pack_retries"),
    ("data.read@2..3:delay=0.05", None),
], ids=["read-kill", "pack-retry", "read-delay"])
def test_faulted_stream_replays_as_the_reference(spec, counter):
    """Under the same fault plan both loaders fire the same sites on the
    same hits, count the same restarts, and deliver the unfaulted
    sequence."""
    from ray_tpu.data import StreamingLoader as JLoader
    from ray_tpu.util import chaos as jchaos
    from ray_tpu_torch.data import StreamingLoader
    from ray_tpu_torch.util import chaos
    kw = dict(batch_size=2, seq_len=24, seed=0, device_put=False)
    with StreamingLoader(_source(), **kw) as clean:
        ref = _collect(clean, 6)
    plan, jplan = chaos.install_faults(spec), jchaos.install_faults(spec)
    with StreamingLoader(_source(), **kw) as a:
        got = _collect(a, 6)
        tel = a.telemetry.summary()
    with JLoader(_source("jax"), **kw) as b:
        want = _collect(b, 6)
        jtel = b.telemetry.summary()
    assert plan.fired == jplan.fired
    assert [s[:2] for s in plan.slowed] == [s[:2] for s in jplan.slowed]
    if counter:
        assert tel[counter] == jtel[counter] >= 1
    _assert_same_batches(got, ref)
    _assert_same_batches(got, want)


def test_reader_retry_budget_exhaustion_is_typed():
    from ray_tpu_torch.data import DataPlaneError, StreamingLoader
    from ray_tpu_torch.util import chaos
    chaos.install_faults("data.read@1,data.read@2,data.read@3")
    with StreamingLoader(_source(), batch_size=2, seq_len=24,
                         retries=2, device_put=False) as ld:
        with pytest.raises(DataPlaneError, match="retry budget"):
            ld.next()


def test_producer_death_delivers_staged_batches_first():
    from ray_tpu_torch.data import DataPlaneError, StreamingLoader
    from ray_tpu_torch.util import chaos
    with StreamingLoader(_source(), batch_size=2, seq_len=24, seed=0,
                         device_put=False) as clean:
        ref = _collect(clean, 8)
    chaos.install_faults("data.read@4")
    got = []
    with StreamingLoader(_source(), batch_size=2, seq_len=24, seed=0,
                         retries=0, device_put=False, prefetch=1) as ld:
        with pytest.raises(DataPlaneError):
            while True:
                got.append(ld.next())
        with pytest.raises(StopIteration):
            ld.next()
    assert got
    _assert_same_batches(got, ref[:len(got)])


class _SlowFirstRead:
    """A pure source whose first read sleeps (the slow-but-alive shard)."""

    def __init__(self, inner, sleep_s):
        self._inner = inner
        self._sleep_s = sleep_s
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def read(self, shard, start, count):
        import time
        self.calls += 1
        if self.calls == 1:
            time.sleep(self._sleep_s)
        return self._inner.read(shard, start, count)


def test_hedged_read_standby_wins_exactly_once():
    from ray_tpu_torch.data import StreamingLoader
    with StreamingLoader(_source(), batch_size=2, seq_len=24, seed=0,
                         device_put=False) as clean:
        ref = _collect(clean, 4)
    slow = _SlowFirstRead(_source(), sleep_s=0.5)
    with StreamingLoader(slow, batch_size=2, seq_len=24, seed=0,
                         hedge_s=0.05, device_put=False) as hedged:
        got = _collect(hedged, 4)
        sched = hedged._schedule
        tel = hedged.telemetry.summary()
    assert sched.read_hedges == 1 and sched.read_hedges_won == 1
    assert tel["read_hedges"] == 1 and tel["read_hedges_won"] == 1
    _assert_same_batches(got, ref)


def test_stall_site_shows_in_telemetry(monkeypatch):
    from ray_tpu_torch.data import StreamingLoader
    from ray_tpu_torch.data.config import data_config
    from ray_tpu_torch.util import chaos
    monkeypatch.setenv("RAY_TPU_DATA_STALL_S", "0.3")
    data_config(refresh=True)
    try:
        chaos.install_faults("data.stall@1")
        with StreamingLoader(_source(), batch_size=2, seq_len=24,
                             device_put=False, prefetch=1) as ld:
            ld.next()
            summary = ld.telemetry.summary()
        assert summary["stall_s_total"] >= 0.2, summary
    finally:
        monkeypatch.delenv("RAY_TPU_DATA_STALL_S")
        data_config(refresh=True)


def test_chaos_fuzz_kill_resume_exactly_once():
    """500 fuzzed operations (deliver / kill the loader and resume from
    the last delivered cursor / arm a reader fault) over one epoch:
    every document exactly once, the sequence the reference's."""
    from ray_tpu.data import StreamingLoader as JLoader
    from ray_tpu_torch.data import StreamingLoader
    from ray_tpu_torch.util import chaos
    kw = dict(batch_size=2, seq_len=24, seed=0, epochs=1, device_put=False)
    with JLoader(_source("jax"), **kw) as ld:
        ref = _collect(ld)
    ref_ids = [s[2] for sb in ref for s in sb.spans]
    assert sorted(ref_ids) == list(range(60))
    ops, fuzz_seed = 0, 0
    while ops < 500:
        assert fuzz_seed < 60, f"fuzz stalled at {ops} ops"
        fuzz_seed += 1
        rng = np.random.RandomState(100 + fuzz_seed)
        got, cursor = [], None
        while True:
            loader = StreamingLoader(_source(), cursor=cursor, **kw)
            try:
                drained = True
                for sb in loader:
                    got.append(sb)
                    cursor = sb.cursor_array
                    ops += 1
                    roll = rng.rand()
                    if roll < 0.25:
                        ops += 1
                        drained = False
                        break
                    elif roll < 0.4:
                        ops += 1
                        chaos.install_faults("data.read@1")
            finally:
                loader.close()
                chaos.clear_faults()
            if drained:
                break
        assert sorted(s[2] for sb in got for s in sb.spans) == \
            sorted(ref_ids), f"fuzz seed {fuzz_seed}: drop/dup"
        _assert_same_batches(got, ref)
    assert ops >= 500


def test_actor_readers_replay_identically_across_a_reader_kill():
    """readers=1 reads shards on a restartable actor of the port's
    runtime; killing it mid-stream restarts it, and the sequence is the
    in-process one."""
    import ray_tpu_torch
    from ray_tpu_torch.data import StreamingLoader
    src = _source(shards=2, docs=12)
    with StreamingLoader(src, batch_size=2, seq_len=24, seed=0,
                         device_put=False) as inproc:
        ref = _collect(inproc, 4)
    ray_tpu_torch.init(num_cpus=2)
    try:
        with StreamingLoader(src, batch_size=2, seq_len=24, seed=0,
                             readers=1, device_put=False) as ld:
            got = [ld.next()]
            reader = ld._schedule._readers[0]
            assert reader._actor is not None
            ray_tpu_torch.kill(reader._actor)
            got += _collect(ld, 3)
            restarts = ld.telemetry.reader_restarts
    finally:
        ray_tpu_torch.shutdown()
    _assert_same_batches(got, ref)
    assert restarts >= 1


# -------------------------------------------- packed attention and loss
def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_attention_matches_reference(dtype):
    """Block-diagonal causal attention over packed segments: the port's
    plain PyTorch against the reference's XLA formulation (f32 within
    2e-5, bf16 within 2e-2); padding rows exactly zero and untouched by
    pad content; f32 gradients within 2e-5 of ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.attention import segment_attention as jseg
    from ray_tpu_torch.ops.attention import segment_attention
    B, S, H, D = 2, 12, 2, 8
    q, k, v = _qkv(0, (B, S, H, D))
    seg = np.asarray([[1, 1, 1, 2, 2, 2, 2, 3, 0, 0, 0, 0],
                      [1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 0]], np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jseg(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                           jnp.asarray(seg)).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = segment_attention(tq, tk, tv, torch.from_numpy(seg))
    assert got.dtype == tdt
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    assert got[0, 8:].abs().max().item() == 0.0
    k2, v2 = tk.clone(), tv.clone()
    k2[0, 8:], v2[0, 8:] = 1e3, 1e3
    assert torch.equal(segment_attention(tq, k2, v2,
                                         torch.from_numpy(seg))[0, :8],
                       got[0, :8])
    if dtype == "float32":
        def jloss(q, k, v):
            return (jseg(q, k, v, jnp.asarray(seg)) ** 2).sum()
        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        (segment_attention(*leaves, torch.from_numpy(seg)) ** 2).sum() \
            .backward()
        for t, g in zip(leaves, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       atol=2e-5, rtol=2e-5)


def _packed_batch(cfg_vocab, B=2, S=24, seed=7, ndocs=12):
    from ray_tpu_torch.data import SamplePacker
    src = _source(seed=seed, vocab=cfg_vocab)
    pk = SamplePacker(B, S)
    for d, t in src.read(0, 0, ndocs):
        pk.add(d, t)
    pk.flush()
    return pk.pop_batch(allow_partial=True), dict(src.read(0, 0, ndocs))


def _tiny_models():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu_torch.convert import params_from_jax
    from ray_tpu_torch.models import gpt as tgpt
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**TINY, dtype=torch.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_packed_loss_fn_and_grads_match_reference():
    """``loss_fn`` on a packed batch (segments, per-document positions,
    ``-1`` targets at document ends and padding) through the trainer's
    attention hook: the loss within 2e-5 and every gradient leaf within
    2e-5 of the reference's ``jax.value_and_grad`` in f32."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.models import training as ttrain
    from ray_tpu_torch.ops.attention import make_flash_attention_fn
    jcfg, tcfg, jparams, tparams = _tiny_models()
    b, _docs = _packed_batch(tcfg.vocab_size)
    assert max(sum(1 for r, *_ in b.spans if r == row)
               for row in range(2)) >= 2, "the batch must co-pack docs"
    batch = b.as_train_batch()
    jval, jgrads = jax.value_and_grad(jgpt.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for attn in (make_flash_attention_fn(rope_theta=tcfg.rope_theta), None):
        val, grads = ttrain.value_and_grad(
            lambda p, bt: tgpt.loss_fn(p, bt, tcfg, attn_fn=attn),
            tparams, tb)
        np.testing.assert_allclose(val.item(), float(jval), rtol=2e-5)
        for path in ttrain._paths(grads):
            g = ttrain._at(grads, path).numpy()
            want = np.asarray(ttrain._at(jgrads, path))
            np.testing.assert_allclose(g, want, atol=2e-5, rtol=2e-5,
                                       err_msg="/".join(path))


def test_packed_forward_equals_per_document_forward():
    """Co-packed documents are invisible to each other: the packed
    forward's logits at each document's span equal that document's
    solo forward (the reference's acceptance parity), within 2e-5."""
    from ray_tpu_torch.models import gpt as tgpt
    _jcfg, tcfg, _jp, tparams = _tiny_models()
    b, docs = _packed_batch(tcfg.vocab_size)
    logits, _ = tgpt.forward(tparams, torch.from_numpy(b.tokens), tcfg,
                             segment_ids=torch.from_numpy(b.segment_ids),
                             positions=torch.from_numpy(b.positions))
    ids = [d for _, _, d, _ in b.spans]
    lmax = max(len(docs[d]) for d in ids)
    solo_in = np.zeros((len(ids), lmax), np.int32)
    for i, d in enumerate(ids):
        solo_in[i, :len(docs[d])] = docs[d]
    solo, _ = tgpt.forward(tparams, torch.from_numpy(solo_in), tcfg)
    for i, (r, c, _d, n) in enumerate(b.spans):
        np.testing.assert_allclose(logits[r, c:c + n].numpy(),
                                   solo[i, :n].numpy(), atol=2e-5,
                                   rtol=2e-5)
    with pytest.raises(ValueError, match="positions"):
        tgpt.forward(tparams, torch.from_numpy(b.tokens), tcfg,
                     segment_ids=torch.from_numpy(b.segment_ids))


def _sp_guard_rank(rank, store_path, out_dir):
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.models import training as ttrain
    from ray_tpu_torch.parallel.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=2)
    try:
        cfg = tgpt.GPTConfig(**TINY, dtype=torch.float32)
        fns = ttrain.build_gpt_train(cfg, make_mesh(sp=2), device="cpu",
                                     telemetry=False)
        state = fns["init_fn"](torch.Generator().manual_seed(0))
        B, S = 2, 16
        batch = {"tokens": torch.zeros(B, S, dtype=torch.int32),
                 "targets": torch.full((B, S), -1, dtype=torch.int32),
                 "segment_ids": torch.ones(B, S, dtype=torch.int32),
                 "positions": torch.zeros(B, S, dtype=torch.int32)}
        try:
            fns["step_fn"](state, fns["shard_batch"](batch))
            msg = "no error"
        except ValueError as e:
            msg = str(e)
        with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
            f.write(msg)
    finally:
        dist.destroy_process_group()


def test_packed_batch_sp_mesh_guard(tmp_path):
    """On an ``sp`` mesh a packed batch fails loudly, as the
    reference's guard does (``tests/test_data_plane.py:682``), and is
    never run unmasked: a spawned 2-rank gloo world."""
    import torch.multiprocessing as mp
    mp.start_processes(_sp_guard_rank,
                       args=(str(tmp_path / "store"), str(tmp_path)),
                       nprocs=2, start_method="spawn")
    for rank in (0, 1):
        msg = (tmp_path / f"rank{rank}.txt").read_text()
        assert "sequence-parallel" in msg, msg


# ----------------------------------------------- the cursor in a checkpoint
def test_cursor_rides_a_port_checkpoint(tmp_path):
    """The cursor image round-trips through ``save_pytree``/
    ``load_pytree`` inside checkpoint extras, and the restored cursor
    resumes the identical stream."""
    from ray_tpu_torch.data import StreamingLoader
    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
    kw = dict(batch_size=2, seq_len=24, seed=0, device_put=False)
    with StreamingLoader(_source(), **kw) as ld:
        seq = _collect(ld, 4)
    save_pytree({"extras": {"data_cursor": seq[1].cursor_array}},
                str(tmp_path / "ck"), name="state")
    back = load_pytree(str(tmp_path / "ck"), name="state")
    arr = np.asarray(back["extras"]["data_cursor"])
    np.testing.assert_array_equal(arr, seq[1].cursor_array)
    with StreamingLoader(_source(), cursor=arr, **kw) as ld2:
        _assert_same_batches(_collect(ld2, 2), seq[2:])


# ---------------------------------------------- streaming train resume
def _tiny_cfg():
    from ray_tpu_torch.models import gpt as tgpt
    return tgpt.GPTConfig(**TINY, dtype=torch.float32)


def test_train_stream_resume_float_equal(tmp_path, deterministic):
    """With reader kills injected mid-run, a run killed at step 4 and
    resumed from its checkpoint (the cursor in its extras) gives the
    uninterrupted run's losses, float-equal, not allclose."""
    from ray_tpu_torch.resilience import (TrainCheckpointer,
                                          run_train_stream_loop)
    from ray_tpu_torch.util import chaos
    cfg = _tiny_cfg()
    kw = dict(steps=6, batch_size=2, seq_len=16, seed=0, device="cpu")
    full = run_train_stream_loop(cfg, **kw)
    assert len(full["losses"]) == 6 and full["data"]["batches"] >= 6
    d = str(tmp_path / "ck")
    plan = chaos.install_faults("data.read@2")
    with TrainCheckpointer(d, every=2, keep=2) as ck:
        part = run_train_stream_loop(cfg, ckpt=ck, **dict(kw, steps=4))
    chaos.clear_faults()
    assert ("data.read", 2) in plan.fired
    assert part["data"]["reader_restarts"] == 1
    assert part["losses"] == full["losses"][:4]
    with TrainCheckpointer(d, every=2, keep=2) as ck2:
        rest = run_train_stream_loop(cfg, ckpt=ck2, resume=True, **kw)
    assert rest["start_step"] == 4
    assert rest["losses"] == full["losses"][4:]
    assert rest["final_step"] == 6


_SIGKILL_CHILD = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.use_deterministic_algorithms(True)
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.resilience import TrainCheckpointer, run_train_stream_loop

cfg = GPTConfig(**{tiny!r}, dtype=torch.float32)
with TrainCheckpointer(sys.argv[1], every=1, keep=3) as ck:
    run_train_stream_loop(
        cfg, steps=8, batch_size=2, seq_len=16, seed=0, ckpt=ck,
        device="cpu", on_step=lambda s: print("STEP", s, flush=True))
print("DONE", flush=True)
"""


def test_stream_sigkill_cross_process_resume(tmp_path, deterministic):
    """A subprocess running the checkpointed streaming loop is SIGKILLed
    mid-stream (prefetch queue full, a write possibly torn); this
    process resumes from the snapshot that survived, and the loss tail
    is float-equal to the uninterrupted run's."""
    from ray_tpu_torch.resilience import (TrainCheckpointer,
                                          run_train_stream_loop)
    cfg = _tiny_cfg()
    kw = dict(steps=8, batch_size=2, seq_len=16, seed=0, device="cpu")
    full = run_train_stream_loop(cfg, **kw)
    d = str(tmp_path / "ck")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RAY_TPU_FAULTS="data.read@2")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGKILL_CHILD.format(root=root, tiny=TINY),
         d], env=env, stdout=subprocess.PIPE, text=True)
    killed_at = None
    for line in proc.stdout:
        if line.startswith("STEP") and int(line.split()[1]) >= 4:
            killed_at = int(line.split()[1])
            proc.kill()
            break
        if line.startswith("DONE"):
            break
    proc.wait(timeout=60)
    assert killed_at is not None, "the child finished before the kill"
    with TrainCheckpointer(d, every=1, keep=3) as ck:
        rest = run_train_stream_loop(cfg, ckpt=ck, resume=True, **kw)
    assert rest["restored_from"] is not None
    assert 0 < rest["start_step"] <= killed_at
    assert rest["losses"] == full["losses"][rest["start_step"]:]


# ------------------------------------------------------------- telemetry
def _data_series(pkg, tel_cls, config, monkeypatch):
    from importlib import import_module
    metrics = import_module(pkg.__name__ + ".util.metrics")
    if pkg.__name__ == "ray_tpu":
        # a dead head's extra-node shm root with all-decimal digits makes
        # the reference's stale-session sweep fail every init on the host
        # (ROADMAP Queue 3, reference side); this test holds the series
        from ray_tpu._private import node as ref_node
        monkeypatch.setattr(ref_node, "_gc_stale_sessions",
                            lambda *a, **k: None)
    pkg.init(num_cpus=1)
    try:
        tel = tel_cls(label="obs", config=config)
        tel.record_batch(100, 0.5, queue_depth=2)
        tel.record_stall(0.003)
        tel.record_reader_restart()
        tel.record_pack_retry()
        tel.record_read_hedge(won=True)
        assert not tel._metrics_dead
        text = metrics.prometheus_text()
        summary = tel.summary()
    finally:
        pkg.shutdown()
    return sorted(ln for ln in text.splitlines() if "data_" in ln), summary


def test_data_telemetry_series_and_summary_match_reference(monkeypatch):
    """Under a session the data recorder emits the reference's
    Prometheus series line for line (names, labels, values), and its
    ``data`` block is the reference's."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.telemetry.config import TelemetryConfig as JConfig
    from ray_tpu.telemetry.data import DataTelemetry as JData
    from ray_tpu_torch.telemetry import DataTelemetry, TelemetryConfig
    got, got_sum = _data_series(ray_tpu_torch, DataTelemetry,
                                TelemetryConfig(enabled=True), monkeypatch)
    want, want_sum = _data_series(ray_tpu, JData, JConfig(enabled=True),
                                  monkeypatch)
    assert got == want and got_sum == want_sum
    text = "\n".join(got)
    for name in ("data_input_tokens_per_sec", "data_prefetch_depth",
                 "data_stall_seconds", "data_reader_restarts_total"):
        assert name in text, name
    assert 'label="obs"' in text
    off = DataTelemetry(config=TelemetryConfig(enabled=False))
    off.record_batch(1, 1.0)
    assert off.summary() == {"enabled": False}
