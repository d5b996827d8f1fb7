"""Port parity: ``ray_tpu_torch.inference`` against the JAX package.

Both engines serve the same model (``SMALL``, f32, the JAX weights
converted by ``params_from_jax``) with ``slots=2, page_size=16,
buckets=(16, 32, 64, 128)`` through the same submit/step schedule:
requests join and leave mid-stream, and the third waits for a slot.
Greedy token streams must be equal token for token, and the logits rows
each token was drawn from equal within 2e-4 (f32 through two layers:
summation order moves them by ~1e-6).  The same holds with the int8 KV
cache (both sides quantize to the same codes, ``test_torch_quant.py``,
and dequantize them in f32) and with prefix caching over shared-prefix
traffic, where the prefix counters and the registered hashes must be
equal as well.

Sampled decoding cannot share the JAX package's ``jax.random`` noise
through the engine, so the sampler is tested by feeding both sides the
same Gumbel noise.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.inference.sampling import \
    sample_tokens_logprobs as jax_sample
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.adapters import AdapterUnavailableError
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.inference import (InferenceEngine, KVPageStore,
                                     PageAllocator, Request,
                                     SamplingParams, SlotScheduler)
from ray_tpu_torch.inference.sampling import sample_from_noise
from ray_tpu_torch.models import gpt as tgpt

SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
             max_seq=256)
GEOMETRY = dict(slots=2, page_size=16, buckets=(16, 32, 64, 128))
# compiled steps of the JAX engines, shared across this file's tests
_JAX_EXECUTABLES = {}


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.GPTConfig(**SMALL, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**SMALL, dtype=torch.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(n, seed):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 512, n)]


def _drive(engine):
    """Submit three prompts (lengths 9, 40, 100) so that they join and
    leave mid-stream; return every event and the request ids."""
    events, rids = [], []

    def tick(n):
        for _ in range(n):
            events.extend(tuple(ev) for ev in engine.step())

    rids.append(engine.submit(_prompt(9, 1), max_new_tokens=10))
    tick(3)
    rids.append(engine.submit(_prompt(40, 2), max_new_tokens=5))
    tick(2)
    rids.append(engine.submit(_prompt(100, 3), max_new_tokens=8))
    while engine.has_work():
        tick(1)
    return events, rids


def _engines(models, **kw):
    jcfg, jparams, tcfg, tparams = models
    jeng = JaxEngine(jcfg, jparams, telemetry=False, debug_logits=True,
                     executable_cache=_JAX_EXECUTABLES, **GEOMETRY, **kw)
    teng = InferenceEngine(tcfg, tparams, device="cpu", debug_logits=True,
                           **GEOMETRY, **kw)
    return jeng, teng


def _assert_same_run(jeng, teng, jrun, trun):
    (jevents, jrids), (tevents, trids) = jrun, trun
    assert tevents == jevents
    for jr, tr in zip(jrids, trids):
        np.testing.assert_allclose(np.stack(teng.logits_trace[tr]),
                                   np.stack(jeng.logits_trace[jr]),
                                   atol=2e-4, rtol=2e-4)
    assert teng.leak_free()


def _greedy_streams(models, kv_dtype):
    jeng, teng = _engines(models, prefix=False, kv_dtype=kv_dtype)
    jrun, trun = _drive(jeng), _drive(teng)
    _assert_same_run(jeng, teng, jrun, trun)
    assert len(trun[0]) == 10 + 5 + 8
    assert teng.stats()["calls"]["prefill"] == 3
    assert teng.cache.quantized == (kv_dtype == "int8")
    for key in ("cache_bytes", "kv_bytes_per_slot", "kv_dtype"):
        assert teng.stats()[key] == jeng.stats()[key], key


def test_greedy_streams_match_jax_engine(models):
    _greedy_streams(models, "model")


def test_int8_greedy_streams_match_jax_engine(models):
    """kv_dtype="int8": both engines write the same codes and scales and
    dequantize them in f32."""
    _greedy_streams(models, "int8")


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_decode_reads_pages_in_place(models, kv_dtype, monkeypatch):
    """The decode step attends over the cache pages through the page
    table (``decode_attention_paged``) and gathers no context: with
    ``gather_pages`` made to raise, the greedy streams still match the
    JAX engine's."""
    from ray_tpu_torch.inference import kv_cache as tkv

    def no_gather(*_args, **_kw):
        raise AssertionError("the decode step gathered the paged context")

    monkeypatch.setattr(tkv, "gather_pages", no_gather)
    _greedy_streams(models, kv_dtype)


def _drive_shared(engine):
    """Shared-prefix traffic: a cold request registers two full pages, a
    second hits both, a third (queued for a slot) hits the first, and a
    fourth hits the second request's third page too.  Nine usable pages
    force idle pages to be evicted along the way."""
    shared = _prompt(32, 11)
    p2 = shared + _prompt(20, 13)
    events, rids = [], []

    def tick(n):
        for _ in range(n):
            events.extend(tuple(ev) for ev in engine.step())

    rids.append(engine.submit(shared + _prompt(5, 12), max_new_tokens=6))
    tick(1)
    rids.append(engine.submit(p2, max_new_tokens=4))
    rids.append(engine.submit(shared[:16] + _prompt(30, 14),
                              max_new_tokens=5))
    tick(2)
    rids.append(engine.submit(p2 + _prompt(3, 15), max_new_tokens=5))
    rids.append(engine.submit(_prompt(70, 16), max_new_tokens=3))
    while engine.has_work():
        tick(1)
    return events, rids


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_prefix_streams_and_counters_match_jax_engine(models, kv_dtype):
    jeng, teng = _engines(models, prefix=True, kv_dtype=kv_dtype,
                          num_pages=10)
    jrun, trun = _drive_shared(jeng), _drive_shared(teng)
    _assert_same_run(jeng, teng, jrun, trun)
    got, want = teng.stats()["prefix"], jeng.stats()["prefix"]
    assert got == want
    assert got["requests_hit"] == 3 and got["hit_tokens"] == 16 * 6
    assert got["evictions"] > 0
    assert teng.prefix_digest() == jeng.prefix_digest()
    assert teng.stats()["calls"]["prefill_cached"] == 3


def test_sampled_rows_independent_of_cobatch(models):
    """A sampled request draws the same tokens alone or co-batched: its
    noise is keyed by (seed, count) only."""
    _j, _jp, tcfg, tparams = models
    sp = SamplingParams(temperature=0.8, top_k=20, seed=123)
    p1, p2 = _prompt(8, 4), _prompt(15, 5)

    def engine():
        return InferenceEngine(tcfg, tparams, device="cpu", **GEOMETRY)

    solo = engine().generate([p1], max_new_tokens=6, sampling=sp)[0]
    both = engine().generate([p1, p2], max_new_tokens=6, sampling=sp)
    assert both[0] == solo
    greedy = engine().generate([p1], max_new_tokens=6)[0]
    assert solo != greedy


@pytest.mark.parametrize("temp, top_k, top_p", [
    (0.0, 0, 1.0),      # greedy
    (1.0, 0, 1.0),      # temperature
    (0.7, 5, 1.0),      # top-k
    (1.3, 0, 0.6),      # top-p
])
def test_sampling_matches_jax_with_injected_noise(temp, top_k, top_p):
    """The JAX sampler's Gumbel noise (``sampling.py:91-93``), computed
    here and fed to the port's noise-to-token function: tokens equal,
    logprobs within f32 rounding."""
    B, V = 6, 64
    rng = np.random.RandomState(7)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    seeds = np.arange(B, dtype=np.int32) + 11
    counts = np.arange(B, dtype=np.int32) * 3
    temps = np.full(B, temp, np.float32)
    top_ks = np.full(B, top_k, np.int32)
    top_ps = np.full(B, top_p, np.float32)
    want_tok, want_lp = jax_sample(*(jnp.asarray(a) for a in (
        logits, seeds, counts, temps, top_ks, top_ps)))
    noise = np.stack([np.asarray(-jnp.log(-jnp.log(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(int(s)), int(c)), (V,),
        minval=1e-20, maxval=1.0)))) for s, c in zip(seeds, counts)])
    got_tok, got_lp = sample_from_noise(
        *(torch.from_numpy(a) for a in (logits, noise, temps, top_ks,
                                        top_ps)))
    assert got_tok.tolist() == np.asarray(want_tok).tolist()
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               atol=1e-5, rtol=1e-5)
    if temp > 0:        # the noise decided something, not just argmax
        assert got_tok.tolist() != logits.argmax(-1).tolist()


def test_page_allocator_invariants():
    alloc = PageAllocator(8)            # pages 1..7 usable
    a, b = alloc.alloc(3), alloc.alloc(4)
    assert alloc.free_count == 0 and 0 not in a + b
    assert alloc.alloc(1) is None       # exhausted -> None, not raise
    alloc.acquire(a[0])
    alloc.release(a)
    assert alloc.free_count == 2 and alloc.refcount(a[0]) == 1
    with pytest.raises(ValueError):
        alloc.release(a[1:])            # double free
    with pytest.raises(ValueError):
        alloc.release([0])              # the reserved garbage page
    alloc.release(a[:1] + b)
    assert alloc.free_count == 7 and alloc.leak_free()


def _lora_engine(tcfg, tparams):
    engine = InferenceEngine(tcfg, tparams, device="cpu", **GEOMETRY,
                             lora=True)
    engine.submit([1, 2, 3], max_new_tokens=2,
                  sampling=SamplingParams(model_id="tenant-a"))


def _adapter_request(tcfg, tparams):
    engine = InferenceEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    engine.submit([1, 2, 3], max_new_tokens=2,
                  sampling=SamplingParams(model_id="tenant-a"))


@pytest.mark.parametrize("make,exc,match", [
    (_lora_engine, AdapterUnavailableError, "never published"),
    (_adapter_request, AdapterUnavailableError, "without adapter")],
    ids=["lora", "model_id"])
def test_unported_engine_options_raise(models, make, exc, match):
    """A request for an adapter the engine cannot serve raises the JAX
    engine's typed error at submit: on an engine with a bank, a tenant
    never published to its store; on an engine built without one, any
    tenant (``tests/test_torch_adapters.py`` holds the bank itself)."""
    _j, _jp, tcfg, tparams = models
    with pytest.raises(exc, match=match):
        make(tcfg, tparams)


@pytest.mark.parametrize("spill_dtype", ["model", "int8"])
def test_page_store_object_store_leg(models, spill_dtype):
    """Under a ``ray_tpu_torch`` session the engine's own page store
    (``store=True``) keeps its spill entries in the runtime's object
    store: the streams, the tier counters and every entry equal the
    in-process store's, bit for bit, with no fetch left in flight."""
    import ray_tpu_torch
    _j, _jp, tcfg, tparams = models
    cfg16 = tgpt.GPTConfig(**SMALL, dtype=torch.bfloat16)
    params16 = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(torch.bfloat16))
                for k, v in tparams.items()}
    shared = _prompt(40, 9)

    def run():
        engine = InferenceEngine(cfg16, params16, device="cpu",
                                 **GEOMETRY, num_pages=6, host_pages=0,
                                 store=True, spill_dtype=spill_dtype)
        outs = [engine.generate([shared + [1, 2]], max_new_tokens=6)[0]]
        for i in range(3):
            engine.generate([_prompt(60, 100 + i)], max_new_tokens=4)
        outs.append(engine.generate([shared + [1, 2]],
                                    max_new_tokens=6)[0])
        assert engine.leak_free()
        tiers = {k: v for k, v in engine.stats()["tiers"].items()
                 if k != "fetch_seconds"}       # wall time
        return engine.store, (outs, tiers)

    inproc, want = run()
    assert not inproc._use_ray and len(inproc) > 0
    ray_tpu_torch.init(num_cpus=1)
    try:
        store, got = run()
        assert store._use_ray and got == want
        for key in list(inproc._entries):
            a, b = store.checkout(key), inproc.checkout(key)
            assert a.keys() == b.keys()
            for name, x in b.items():
                y = a[name]
                if isinstance(x, torch.Tensor):
                    assert x.dtype == y.dtype
                    assert torch.equal(y.view(torch.uint8),
                                       x.view(torch.uint8))
                elif isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype
                    assert x.tobytes() == y.tobytes()
                else:
                    assert x == y
            store.checkin(key)
            inproc.checkin(key)
        assert store.stats() == inproc.stats()
        assert store.stats()["in_flight"] == 0
    finally:
        ray_tpu_torch.shutdown()


def test_kv_cache_helpers_match_jax():
    """The in-place page writes and the context gather land exactly
    where the JAX package's functional scatters do (garbage-page routing
    of rows past ``valid_len`` included)."""
    from ray_tpu.inference import kv_cache as jkv
    from ray_tpu_torch.inference import kv_cache as tkv
    rng = np.random.RandomState(0)
    pages = rng.randn(6, 4, 2, 3).astype(np.float32)
    new = rng.randn(6, 2, 3).astype(np.float32)
    page_row = np.array([3, 5, 0, 0], np.int64)
    want = jkv.write_prefill_at(jnp.asarray(pages), jnp.asarray(new),
                                jnp.asarray(page_row), 2, 4, 4)
    got = tkv.write_prefill_at(torch.from_numpy(pages.copy()),
                               torch.from_numpy(new),
                               torch.from_numpy(page_row), 2, 4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    table = np.array([[1, 2], [4, 3], [0, 0]], np.int64)
    lengths = np.array([5, 2, 0], np.int64)
    tok = rng.randn(3, 2, 3).astype(np.float32)
    want = jkv.write_decode(jnp.asarray(pages), jnp.asarray(tok),
                            jnp.asarray(table), jnp.asarray(lengths), 4)
    got = tkv.write_decode(torch.from_numpy(pages.copy()),
                           torch.from_numpy(tok), torch.from_numpy(table),
                           torch.from_numpy(lengths), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tkv.gather_pages(got, torch.from_numpy(table)).numpy(),
        np.asarray(jkv.gather_pages(want, jnp.asarray(table))))


def test_engine_cancel_set_params_and_validation(models):
    """cancel() retires a request mid-stream and frees its pages;
    set_params() swaps weights between ticks (same weights, same
    tokens); bad submits raise and a full queue sheds load."""
    from ray_tpu_torch.inference import QueueFullError
    _j, _jp, tcfg, tparams = models
    engine = InferenceEngine(tcfg, tparams, device="cpu", max_queue=2,
                             **GEOMETRY)
    p1, p2 = _prompt(12, 6), _prompt(20, 7)
    want = engine.generate([p1], max_new_tokens=4)[0]
    r1 = engine.submit(p1, max_new_tokens=8)
    r2 = engine.submit(p2, max_new_tokens=8)
    engine.step()                   # both prefill, then one decode
    engine.cancel(r2)
    seen = {r1: [], r2: []}
    while engine.has_work():
        for rid, tok, _done in engine.step():
            seen[rid].append(tok)
    assert len(seen[r1]) == 8 - 2 and seen[r2] == []
    assert engine.leak_free() and engine.stats()["free_slots"] == 2
    assert engine.set_params(tparams) == 1
    assert engine.generate([p1], max_new_tokens=4)[0] == want
    with pytest.raises(ValueError, match="empty"):
        engine.submit([])
    with pytest.raises(ValueError, match="max_seq"):
        engine.submit(_prompt(250, 8), max_new_tokens=10)
    engine.submit(p1)
    engine.submit(p2)
    with pytest.raises(QueueFullError):
        engine.submit(p2)


@pytest.mark.parametrize("kv_dtype, plen, tol", [
    ("model", 37, 2e-4),
    ("model", 48, 2e-4),    # an exact page multiple: the last page prefills
    # the hit reads the prefix back as int8 codes where the cold prefill
    # read full precision: the JAX suite's int8 budget
    # (tests/test_inference.py:371-390)
    ("int8", 37, 0.05),
])
def test_prefix_hit_decode_parity(models, kv_dtype, plen, tol):
    """A prefix-hit request (suffix-only prefill over shared pages) gives
    the trajectory and step-by-step logits of the same request run cold
    (``tests/test_inference.py:342-390``)."""
    _j, _jp, tcfg, tparams = models
    engine = InferenceEngine(tcfg, tparams, device="cpu", debug_logits=True,
                             kv_dtype=kv_dtype, **GEOMETRY)
    prompt = _prompt(plen, 21)
    r_cold = engine.generate([prompt], max_new_tokens=5)
    r_hit = engine.generate([prompt], max_new_tokens=5)
    st = engine.stats()
    assert st["prefix"]["hit_tokens"] == 16 * ((plen - 1) // 16)
    assert st["prefix"]["requests_hit"] == 1
    assert st["calls"]["prefill_cached"] == 1
    if kv_dtype == "model":
        assert r_hit == r_cold
    np.testing.assert_allclose(np.stack(engine.logits_trace[1]),
                               np.stack(engine.logits_trace[0]),
                               atol=tol, rtol=tol)
    assert engine.leak_free()


def test_page_allocator_refcount_and_eviction():
    """Shared pages free only at refcount 0, registered refcount-0 pages
    park in the idle LRU pool, and alloc evicts idle pages LRU-first,
    unregistering them, before it fails
    (``tests/test_inference.py:222-256``)."""
    from ray_tpu_torch.inference.kv_cache import PrefixIndex
    idx = PrefixIndex()
    alloc = PageAllocator(6, index=idx)        # pages 1..5 usable
    a = alloc.alloc(2)
    h = PrefixIndex.chain(PrefixIndex.ROOT, [1, 2, 3])
    assert idx.register(h, a[0]) and not idx.register(h, a[1])
    alloc.acquire(a[0])
    assert alloc.refcount(a[0]) == 2
    alloc.release([a[0]])
    assert alloc.refcount(a[0]) == 1 and alloc.free_count == 3
    alloc.release(a)
    assert alloc.refcount(a[0]) == 0 and alloc.is_idle(a[0])
    assert alloc.idle_count == 1 and alloc.free_count == 5
    assert idx.lookup(h) == a[0] and alloc.leak_free()
    alloc.acquire(a[0])                        # a hit revives it
    assert alloc.idle_count == 0 and alloc.refcount(a[0]) == 1
    alloc.release([a[0]])
    b = alloc.alloc(5)                         # evicts the idle page
    assert b is not None and len(set(b)) == 5
    assert alloc.evictions == 1 and idx.lookup(h) is None
    assert alloc.alloc(1) is None
    with pytest.raises(ValueError):
        alloc.acquire(0)
    alloc.release(b)
    with pytest.raises(ValueError):
        alloc.release([b[0]])
    assert alloc.leak_free() and alloc.flush_idle() == 0


def test_prefix_chain_hashes_match_jax():
    """The chain hashes and hit eligibility are the JAX package's, byte
    for byte: the fleet router compares them across replicas."""
    from ray_tpu.inference.kv_cache import PrefixIndex as JIndex
    from ray_tpu_torch.inference.kv_cache import PrefixIndex
    tokens = _prompt(53, 3)
    assert PrefixIndex.chain_hashes(tokens, 16) == \
        JIndex.chain_hashes(tokens, 16)
    assert PrefixIndex.chain_hashes(tokens, 16, salt=b"a") == \
        JIndex.chain_hashes(tokens, 16, salt=b"a")
    for n in (1, 16, 17, 48, 49):
        assert PrefixIndex.hit_eligible(n, 16) == JIndex.hit_eligible(n, 16)


def test_prefix_shared_pages_refcounted_concurrently(models):
    """Two live requests sharing prefix pages: refcount 2 while both
    decode, alive past the first retire, idle after the second, and a
    third request revives them (``tests/test_inference.py:425-459``)."""
    _j, _jp, tcfg, tparams = models
    engine = InferenceEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    sched = engine.scheduler
    free0 = sched.allocator.free_count
    shared = _prompt(32, 41)
    r1 = engine.submit(shared + _prompt(3, 42), max_new_tokens=8)
    engine.step()
    r2 = engine.submit(shared + _prompt(5, 43), max_new_tokens=3)
    engine.step()
    reqs = {r.rid: r for r in sched.active.values()}
    shared_pages = reqs[r1].pages[:2]
    assert reqs[r2].pages[:2] == shared_pages
    assert reqs[r2].cached_tokens == 32
    assert all(sched.allocator.refcount(p) == 2 for p in shared_pages)
    assert engine.leak_free()
    while engine.has_work():
        engine.step()
    assert sched.allocator.free_count == free0
    assert sched.allocator.idle_count > 0 and engine.leak_free()
    r3 = engine.submit(shared + _prompt(4, 44), max_new_tokens=3)
    engine.step()
    (req3,) = sched.active.values()
    assert req3.rid == r3 and req3.cached_tokens == 32
    while engine.has_work():
        engine.step()
    assert sched.allocator.free_count == free0
    assert engine.stats()["prefix"]["requests_hit"] == 2


def test_scheduler_refcount_fuzz():
    """Admit/hit/retire/evict interleavings at the scheduler level
    (``register_prefix`` called as the engine does after a prefill): the
    refcounts match the active references exactly, every page is in
    exactly one of free, idle and held, idle pages are registered, the
    write window past each hit is private, and nothing leaks at drain
    (``tests/test_inference.py:259-339`` without the tiers)."""
    from ray_tpu_torch.inference.kv_cache import assert_tail_private
    rng = np.random.RandomState(42)
    ps = 8
    sched = SlotScheduler(slots=3, page_size=ps, num_pages=24,
                          max_pages_per_slot=8, prefix=True)
    alloc = sched.allocator
    prefixes = [list(rng.randint(0, 97, 2 * ps)) for _ in range(3)]
    rid = 0
    for step in range(300):
        op = rng.rand()
        if op < 0.5 and len(sched.waiting) < 4:
            prompt = list(prefixes[rng.randint(3)]) if rng.rand() < 0.7 \
                else list(rng.randint(0, 97, 2 * ps))
            prompt += list(rng.randint(0, 97, int(rng.randint(1, 2 * ps))))
            sched.submit(Request(rid=rid, prompt=prompt,
                                 max_new_tokens=int(rng.randint(1, 8)),
                                 sampling=SamplingParams()))
            rid += 1
        elif op < 0.8:
            req = sched.try_admit()
            if req is not None:
                assert_tail_private(alloc, sched.prefix_index, req.pages,
                                    req.cached_tokens,
                                    len(req.prompt) + req.max_new_tokens - 1,
                                    ps)
                sched.register_prefix(req)
        elif sched.active:
            sched.retire(list(sched.active)[rng.randint(len(sched.active))])
        held = collections.Counter(p for r in sched.active.values()
                                   for p in r.pages)
        assert dict(held) == alloc._refcount, step
        assert alloc.leak_free(), step
    assert sched.prefix_hit_pages > 0 and alloc.evictions > 0
    while sched.active:
        sched.retire(next(iter(sched.active)))
    assert not alloc._refcount and alloc.free_count == 23


def test_set_params_flushes_the_prefix_cache(models):
    """A weight swap unregisters every cached page (idle ones return to
    the free list), so an identical prompt afterwards runs cold."""
    _j, _jp, tcfg, tparams = models
    engine = InferenceEngine(tcfg, tparams, device="cpu", **GEOMETRY)
    prompt = _prompt(40, 51)
    engine.generate([prompt], max_new_tokens=2)
    st = engine.stats()["prefix"]
    assert st["registered_pages"] == 2 and st["idle_pages"] == 2
    assert len(engine.prefix_digest()) == 2
    engine.set_params(tparams)
    st = engine.stats()["prefix"]
    assert st["registered_pages"] == 0 and st["idle_pages"] == 0
    assert engine.prefix_digest() == frozenset() and engine.leak_free()
    engine.generate([prompt], max_new_tokens=2)
    assert engine.stats()["prefix"]["requests_hit"] == 0
    assert engine.stats()["calls"] == {"prefill": 2, "prefill_cached": 0,
                                       "decode": 2, "verify": 0}


def test_prefix_off_knob(models, monkeypatch):
    """prefix=False, or RAY_TPU_INFER_PREFIX=0 with no argument: no index,
    no hits, no cached prefill.  Unset, the knob is on, as in the JAX
    package."""
    from ray_tpu_torch.inference.config import infer_config
    _j, _jp, tcfg, tparams = models
    prompt = _prompt(37, 52)

    def run(**kw):
        engine = InferenceEngine(tcfg, tparams, device="cpu", **GEOMETRY,
                                 **kw)
        engine.generate([prompt, prompt], max_new_tokens=2)
        return engine

    assert infer_config().prefix is True
    assert run().stats()["prefix"]["requests_hit"] == 1
    engine = run(prefix=False)
    st = engine.stats()
    assert st["prefix"] == {"enabled": False, "hit_pages": 0,
                            "hit_tokens": 0, "requests_hit": 0,
                            "registered_pages": 0, "idle_pages": 0,
                            "evictions": 0}
    assert st["calls"]["prefill"] == 2 and engine.prefix_digest() == set()
    monkeypatch.setenv("RAY_TPU_INFER_PREFIX", "0")
    try:
        assert infer_config(refresh=True).prefix is False
        assert run().stats()["prefix"]["enabled"] is False
    finally:
        monkeypatch.delenv("RAY_TPU_INFER_PREFIX")
        infer_config(refresh=True)


def test_kv_dtype_env_knob(models, monkeypatch, capsys):
    """RAY_TPU_KV_DTYPE resolves through infer_config; an unknown value
    falls back to the model dtype with a line on stderr
    (``tests/test_inference.py:204-218``); an explicit argument wins."""
    from ray_tpu_torch.inference.config import infer_config
    _j, _jp, tcfg, tparams = models
    monkeypatch.setenv("RAY_TPU_KV_DTYPE", "int8")
    try:
        infer_config(refresh=True)
        engine = InferenceEngine(tcfg, tparams, device="cpu", **GEOMETRY)
        assert engine.kv_dtype == "int8" and engine.cache.quantized
        assert engine.cache.k.dtype == torch.int8
        assert InferenceEngine(tcfg, tparams, device="cpu", kv_dtype="model",
                               **GEOMETRY).kv_dtype == "model"
        monkeypatch.setenv("RAY_TPU_KV_DTYPE", "fp4")
        assert infer_config(refresh=True).kv_dtype == "model"
        assert "RAY_TPU_KV_DTYPE='fp4' unknown" in capsys.readouterr().err
    finally:
        monkeypatch.delenv("RAY_TPU_KV_DTYPE")
        infer_config(refresh=True)
    with pytest.raises(ValueError, match="kv_dtype"):
        InferenceEngine(tcfg, tparams, device="cpu", kv_dtype="fp4",
                        **GEOMETRY)


def test_tiny_head_dim_streams_match_jax_engine():
    """``GPTConfig.tiny``'s head dim 16 (d_model 64, 4 heads), which the
    attention kernels are built for as well as GPT-2's 64: the greedy
    stream and its logits match the JAX engine's through prefill and
    decode."""
    kw = dict(SMALL, d_model=64, n_heads=4)
    jcfg = jgpt.GPTConfig(**kw, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**kw, dtype=torch.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    jeng, teng = _engines((jcfg, jparams, tcfg, tparams), prefix=False)
    _assert_same_run(jeng, teng, _drive(jeng), _drive(teng))
