"""Port parity: ``ray_tpu_torch.inference`` against the JAX package.

Both engines serve the same model (``SMALL``, f32, the JAX weights
converted by ``params_from_jax``) with ``slots=2, page_size=16,
buckets=(16, 32, 64, 128)`` and prefix caching off, through the same
submit/step schedule: requests join and leave mid-stream, and the third
waits for a slot.  Greedy token streams must be equal token for token,
and the logits rows each token was drawn from equal within 2e-4 (f32
through two layers: summation order moves them by ~1e-6).

Sampled decoding cannot share the JAX package's ``jax.random`` noise
through the engine, so the sampler is tested by feeding both sides the
same Gumbel noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.inference.sampling import \
    sample_tokens_logprobs as jax_sample
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.inference import (InferenceEngine, PageAllocator,
                                     SamplingParams)
from ray_tpu_torch.inference.sampling import sample_from_noise
from ray_tpu_torch.models import gpt as tgpt

SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
             max_seq=256)
GEOMETRY = dict(slots=2, page_size=16, buckets=(16, 32, 64, 128))


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


def test_greedy_streams_match_jax_engine(models):
    jcfg, jparams, tcfg, tparams = models
    jeng = JaxEngine(jcfg, jparams, prefix=False, telemetry=False,
                     debug_logits=True, **GEOMETRY)
    teng = InferenceEngine(tcfg, tparams, device="cpu", debug_logits=True,
                           **GEOMETRY)
    jevents, jrids = _drive(jeng)
    tevents, trids = _drive(teng)
    assert tevents == jevents
    assert len(tevents) == 10 + 5 + 8
    for jr, tr in zip(jrids, trids):
        np.testing.assert_allclose(np.stack(teng.logits_trace[tr]),
                                   np.stack(jeng.logits_trace[jr]),
                                   atol=2e-4, rtol=2e-4)
    assert teng.leak_free()
    assert teng.stats()["calls"]["prefill"] == 3


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


@pytest.mark.parametrize("kw", [dict(prefix=True), dict(kv_dtype="int8"),
                                dict(spec=True), dict(host_pages=4),
                                dict(lora=True), dict(telemetry=True)])
def test_unported_engine_options_raise(models, kw):
    _j, _jp, tcfg, tparams = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(tcfg, tparams, device="cpu", **GEOMETRY, **kw)


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
