"""Port parity: disaggregated prefill/decode handoff.

A handoff exported by either package's engine, converted across
(``convert.handoff_from_jax`` / ``handoff_to_numpy``), continues greedy
in the other package's engine exactly as the JAX engine's co-located
run does (``GPTConfig.tiny``, f32, page 16; prompt lengths 9, 40 and 48:
a sub-page, a partial-tail and a whole-page context; model-dtype and
int8 caches).  The page export and its byte figures are bit-equal to
``ray_tpu.inference.kv_cache``'s on the same pages, in f32, bf16 (through
the int16 view) and int8.  Then the port's own counterparts of
``tests/test_disagg.py``: round trips with the installed pages bit-equal
to the payload, the warm (metadata-only) import and its
``HandoffContentMissing`` miss, imports under page pressure, and a
partial-residency handoff; sampled streams disaggregated against
co-located within the port (``jax.random`` noise cannot be shared).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.inference import kv_cache as jkv
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.convert import (array_to_tensor, handoff_from_jax,
                                   handoff_to_numpy, params_from_jax)
from ray_tpu_torch.inference import (HandoffContentMissing,
                                     InferenceEngine, SamplingParams)
from ray_tpu_torch.inference import kv_cache as tkv
from ray_tpu_torch.models import gpt as tgpt

GEOMETRY = dict(slots=2, page_size=16, buckets=(16, 32, 64))
PAGE = 16
# the JAX engines' compiled steps, shared within this file per kv dtype
_JAX_EXEC = {"model": {}, "int8": {}}
_JAX_REFS = {}


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_engine(models, kv_dtype="model", **kw):
    jcfg, jparams, _t, _tp = models
    return JaxEngine(jcfg, jparams, telemetry=False, kv_dtype=kv_dtype,
                     executable_cache=_JAX_EXEC[kv_dtype],
                     **{**GEOMETRY, **kw})


def _engine(models, kv_dtype="model", **kw):
    _j, _jp, tcfg, tparams = models
    return InferenceEngine(tcfg, tparams, device="cpu", kv_dtype=kv_dtype,
                           **{**GEOMETRY, **kw})


def _prompt(n, seed):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 512, n)]


def _first_token(engine, prompt, **kw):
    """One first-token-stop submission run to its end -> (rid, token)."""
    rid = engine.submit(prompt, max_new_tokens=1, hold_pages=True, **kw)
    toks = []
    while engine.has_work():
        toks += [int(ev[1]) for ev in engine.step()]
    assert len(toks) == 1
    return rid, toks[0]


def _drain(engine, out):
    while engine.has_work():
        for ev in engine.step():
            assert ev.error is None, ev.error
            out.append(int(ev[1]))
    return out


def _jax_colocated(models, kv_dtype, prompt):
    key = (kv_dtype, tuple(prompt))
    if key not in _JAX_REFS:
        eng = _jax_engine(models, kv_dtype)
        _JAX_REFS[key] = [int(t) for t in
                          eng.generate([prompt], max_new_tokens=6)[0]]
    return _JAX_REFS[key]


# ------------------------------------------------ across the two packages
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("plen", [9, 40, 48])
@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_handoff_crosses_packages_greedy_exact(models, kv_dtype, plen,
                                               direction):
    prompt = _prompt(plen, plen)
    want = _jax_colocated(models, kv_dtype, prompt)
    if direction == "jax_to_port":
        pre, dec = _jax_engine(models, kv_dtype), _engine(models, kv_dtype)
    else:
        pre, dec = _engine(models, kv_dtype), _jax_engine(models, kv_dtype)
    rid, t0 = _first_token(pre, prompt)
    handoff = pre.export_request(rid)
    if direction == "jax_to_port":
        moved = handoff_from_jax(handoff)
        np.testing.assert_array_equal(moved.k, handoff.k)
    else:
        moved = jkv.KVHandoff(**handoff_to_numpy(handoff))
    assert moved.dtype == handoff.dtype == \
        {"model": "float32", "int8": "int8"}[kv_dtype]
    assert moved.nbytes == handoff.nbytes
    assert moved.chain_hashes == handoff.chain_hashes
    dec.import_submit(moved, max_new_tokens=5)
    assert _drain(dec, [t0]) == want
    assert dec.stats()["imports"] == 1 and pre.stats()["exports"] == 1
    for eng in (pre, dec):
        alloc = eng.scheduler.allocator
        assert alloc.free_count == alloc.num_pages - 1


def _filled_caches(kind, rng):
    """A JAX and a port KVCache of the same geometry holding the same
    bits: f32 or bf16 contents, or int8 codes with f32 scales (one
    vector of ties at scale 1 and one all-zero vector included)."""
    geo = dict(n_layers=2, num_pages=5, page_size=8, n_heads=2,
               head_dim=8)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.float32, torch.float32)}[kind]
    kv_dtype = "int8" if kind == "int8" else "model"
    jc = jkv.KVCache(**geo, dtype=jdt, kv_dtype=kv_dtype)
    tc = tkv.KVCache(**geo, dtype=tdt, device="cpu", kv_dtype=kv_dtype)
    names = ("k", "v") + (("k_scale", "v_scale") if kind == "int8" else ())
    for name in names:
        shape = getattr(jc, name).shape
        if kind == "int8" and name in ("k", "v"):
            x = rng.integers(-127, 128, shape).astype(np.int8)
        else:
            x = rng.normal(size=shape).astype(np.float32)
            if name in ("k", "v"):
                x[0, 2, 1, 0] = [127, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 0]
                x[1, 3, 0, 1] = 0.0
        jx = jnp.asarray(x, getattr(jc, name).dtype)
        setattr(jc, name, jx)
        setattr(tc, name, array_to_tensor(np.asarray(jx), "cpu"))
    return jc, tc


def _bits(a):
    """Host data of either package as comparable numpy bits."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_page_export_and_spill_codec_bit_equal(kind):
    rng = np.random.default_rng(0)
    jc, tc = _filled_caches(kind, rng)
    pages = [3, 1, 2]
    want, got = jkv.export_pages(jc, pages), tkv.export_pages(tc, pages)
    assert sorted(want) == sorted(got)
    for name in want:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))
    quantized = kind == "int8"
    itemsize = 1 if quantized else (2 if kind == "bf16" else 4)
    geo = dict(n_layers=2, page_size=8, n_heads=2, head_dim=8,
               itemsize=itemsize, quantized=quantized)
    assert tkv.handoff_page_bytes(**geo) == jkv.handoff_page_bytes(**geo)
    handoff = tkv.KVHandoff(context=list(range(20)), page_size=8,
                            kv_dtype="int8" if quantized else "model",
                            dtype=tkv.dtype_name(tc.k.dtype),
                            chain_hashes=[], next_token=0,
                            next_logprob=0.0, **got)
    assert handoff.dtype == str(jc.k.dtype)
    assert handoff.nbytes == tkv.handoff_page_bytes(**geo) * 3
    # the spill codec: entries, bytes and installed pages bit for bit
    for spill_dtype in ("int8", "model"):
        one_j, one_t = jkv.export_pages(jc, [2]), tkv.export_pages(tc, [2])
        ej = jkv.encode_spill_page(one_j, quantized=quantized,
                                   spill_dtype=spill_dtype)
        et = tkv.encode_spill_page(one_t, quantized=quantized,
                                   spill_dtype=spill_dtype)
        assert et["fmt"] == ej["fmt"] and sorted(et) == sorted(ej)
        for name in ej:
            if name != "fmt":
                np.testing.assert_array_equal(_bits(et[name]),
                                              _bits(ej[name]))
        assert tkv.spill_entry_bytes(et) == jkv.spill_entry_bytes(ej)
        # the device gather gives the same entry as the host export
        ed = tkv.encode_spill_page(tkv.page_contents(tc, [2]),
                                   quantized=quantized,
                                   spill_dtype=spill_dtype)
        for name in ej:
            if name != "fmt":
                np.testing.assert_array_equal(_bits(ed[name]),
                                              _bits(et[name]))
        assert tkv.spill_entry_matches(tc, et)
        jkv.install_spill_page(jc, 4, ej)
        tkv.install_spill_page(tc, 4, et)
        after_j, after_t = jkv.export_pages(jc, [4]), tkv.export_pages(tc,
                                                                       [4])
        for name in after_j:
            np.testing.assert_array_equal(_bits(after_t[name]),
                                          _bits(after_j[name]))
    if not quantized:
        # a model-dtype entry into an int8 cache quantizes on install
        jq, tq = _filled_caches("int8", rng)
        ej = jkv.encode_spill_page(jkv.export_pages(jc, [1]),
                                   quantized=False, spill_dtype="model")
        et = tkv.encode_spill_page(tkv.export_pages(tc, [1]),
                                   quantized=False, spill_dtype="model")
        jkv.install_spill_page(jq, 3, ej)
        tkv.install_spill_page(tq, 3, et)
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(
                _bits(getattr(tq, name)[:, 3]),
                np.asarray(getattr(jq, name)[:, 3]))
    with pytest.raises(ValueError, match="garbage"):
        tkv.install_spill_page(tc, tkv.GARBAGE_PAGE, et)


def test_bf16_handoff_converts_bit_for_bit():
    """A bf16 handoff crosses both ways through the int16 view: the
    port holds a CPU bf16 tensor, the JAX package an ml_dtypes array,
    with the same bits and the same ``dtype`` name."""
    jc, tc = _filled_caches("bf16", np.random.default_rng(1))
    h = jkv.KVHandoff(context=list(range(10)), page_size=8,
                      kv_dtype="model", dtype="bfloat16",
                      chain_hashes=[b"x"], next_token=3, next_logprob=-1.0,
                      trace={"trace_id": "t", "parent_id": None,
                             "sampled": True},
                      **jkv.export_pages(jc, [1, 2]))
    t = handoff_from_jax(h)
    assert isinstance(t.k, torch.Tensor) and t.k.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t.k), _bits(h.k))
    assert t.nbytes == h.nbytes and t.trace == h.trace
    back = handoff_to_numpy(t, bf16_dtype=jnp.bfloat16)
    assert back["k"].dtype == h.k.dtype
    np.testing.assert_array_equal(_bits(back["k"]), _bits(h.k))
    assert jkv.KVHandoff(**back).nbytes == h.nbytes
    raw = handoff_to_numpy(t)
    assert raw["k"].dtype == np.int16
    stripped = t.strip_to([1])
    np.testing.assert_array_equal(_bits(stripped.k), _bits(h.k)[:, 1:])
    assert stripped.page_list == [1]


# -------------------------------------------------- the port's own seams
@pytest.mark.parametrize("plen", [40, 48, 9])
def test_export_import_roundtrip(models, plen):
    """Export after the first token, import into a second engine: the
    continuation equals the co-located run's, the installed pages equal
    the payload at the context positions, both allocators end whole."""
    prompt = _prompt(plen, plen)
    (want,) = _engine(models).generate([prompt], max_new_tokens=6)
    pre, dec = _engine(models), _engine(models)
    rid, t0 = _first_token(pre, prompt)
    assert t0 == want[0]
    # the held pages are accounted to the held request
    assert pre.stats()["held"] == 1 and pre.leak_free()
    handoff = pre.export_request(rid)
    assert pre.stats()["held"] == 0 and pre.stats()["exports"] == 1
    assert handoff.context == prompt
    assert handoff.n_pages == -(-plen // PAGE)
    assert handoff.n_full_pages == plen // PAGE
    assert len(handoff.chain_hashes) == handoff.n_full_pages
    _j, _jp, tcfg, _tp = models
    per_page = tkv.handoff_page_bytes(
        n_layers=tcfg.n_layers, page_size=PAGE, n_heads=tcfg.n_heads,
        head_dim=tcfg.head_dim, itemsize=4, quantized=False)
    assert handoff.nbytes == per_page * handoff.n_pages
    rid2 = dec.import_submit(handoff, max_new_tokens=5)
    dec.step()
    (req,) = dec.scheduler.active.values()
    arrays = tkv.export_pages(dec.cache, req.pages[:handoff.n_pages])
    full, tail = plen // PAGE, plen % PAGE
    for got, sent in ((arrays["k"], handoff.k), (arrays["v"], handoff.v)):
        np.testing.assert_array_equal(got[:, :full], sent[:, :full])
        if tail:
            np.testing.assert_array_equal(got[:, -1, :tail],
                                          sent[:, -1, :tail])
    out = [t0, dec._requests[rid2].generated[1]]
    assert _drain(dec, out) == want
    assert dec.stats()["imports"] == 1
    assert dec.stats()["calls"]["prefill"] == 0
    for eng in (pre, dec):
        alloc = eng.scheduler.allocator
        assert alloc.free_count == alloc.num_pages - 1 and eng.leak_free()


def test_export_import_roundtrip_int8(models):
    """int8 handoffs move codes and scales unchanged: the importer's
    pages equal the payload, the stream equals an int8 co-located run,
    and a page costs ``head_dim + 4`` bytes per vector against ``head_dim
    * 4``; a model-dtype engine refuses the payload."""
    _j, _jp, tcfg, _tp = models
    prompt = _prompt(48, 8)
    (want,) = _engine(models, "int8").generate([prompt], max_new_tokens=6)
    pre, dec = _engine(models, "int8"), _engine(models, "int8")
    rid, t0 = _first_token(pre, prompt)
    h8 = pre.export_request(rid)
    assert h8.kv_dtype == "int8" and h8.dtype == "int8"
    assert h8.k.dtype == np.int8 and h8.k_scale.dtype == np.float32
    geo = dict(n_layers=tcfg.n_layers, page_size=PAGE,
               n_heads=tcfg.n_heads, head_dim=tcfg.head_dim)
    per8 = tkv.handoff_page_bytes(**geo, itemsize=1, quantized=True)
    per32 = tkv.handoff_page_bytes(**geo, itemsize=4, quantized=False)
    assert h8.nbytes == per8 * h8.n_pages
    assert per8 / per32 == pytest.approx((tcfg.head_dim + 4)
                                         / (tcfg.head_dim * 4))
    rid2 = dec.import_submit(h8, max_new_tokens=5)
    dec.step()
    (req,) = dec.scheduler.active.values()
    arrays = tkv.export_pages(dec.cache, req.pages[:h8.n_pages])
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(arrays[name], getattr(h8, name))
    out = [t0, dec._requests[rid2].generated[1]]
    assert _drain(dec, out) == want
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(models).import_submit(h8, max_new_tokens=2)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_sampled_disagg_equals_colocated(models, kv_dtype):
    """Sampled streams: the importer's sampling counts start after the
    prefill side's token, so the disaggregated stream is the co-located
    one token for token (and each token's logprob with it)."""
    prompts = [_prompt(n, 50 + n) for n in (9, 40, 48)]
    sps = [SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=s)
           for s in (3, 4, 5)]
    for prompt, sp in zip(prompts, sps):
        want, want_lp = _engine(models, kv_dtype).generate(
            [prompt], max_new_tokens=8, sampling=sp, return_logprobs=True)
        pre, dec = _engine(models, kv_dtype), _engine(models, kv_dtype)
        rid, t0 = _first_token(pre, prompt, sampling=sp)
        handoff = pre.export_request(rid)
        assert handoff.next_logprob == pytest.approx(want_lp[0][0])
        rid2 = dec.import_submit(handoff, max_new_tokens=7, sampling=sp)
        lps = []
        out = [t0]
        while dec.has_work():
            for ev in dec.step():
                out.append(ev[1])
                lps.append(ev.logprob)
        assert out == want[0]
        np.testing.assert_allclose(lps, want_lp[0][1:], rtol=1e-6)
        assert rid2 not in dec._requests and dec.leak_free()


def test_import_digest_match_skips_transfer(models):
    """Once a whole-page context is resident on the importer, a
    metadata-only handoff installs as prefix hits (no bytes, no writes)
    and continues exactly; with the pages flushed meanwhile, admission
    surfaces ``HandoffContentMissing`` and releases everything."""
    prompt = _prompt(48, 5)                     # 3 full pages
    (want,) = _engine(models).generate([prompt], max_new_tokens=4)
    pre, dec = _engine(models), _engine(models)
    rid, t0 = _first_token(pre, prompt)
    h = pre.export_request(rid)
    dec.import_submit(h, max_new_tokens=3)
    assert _drain(dec, [t0]) == want
    assert set(h.chain_hashes) <= dec.prefix_digest()
    rid, t0 = _first_token(pre, prompt)         # a prefix hit there
    warm = pre.export_request(rid).strip_contents()
    assert warm.nbytes == 0 and warm.k is None
    hit_pages = dec.scheduler.prefix_hit_pages
    dec.import_submit(warm, max_new_tokens=3)
    assert _drain(dec, [t0]) == want
    assert dec.scheduler.prefix_hit_pages == hit_pages + 3
    rid, t0 = _first_token(pre, prompt)
    gone = pre.export_request(rid).strip_contents()
    dec.scheduler.flush_prefix()
    dec.import_submit(gone, max_new_tokens=3)
    errs = []
    while dec.has_work():
        errs += [ev.error for ev in dec.step() if ev.error is not None]
    assert len(errs) == 1 and isinstance(errs[0], HandoffContentMissing)
    assert errs[0].missing_pages == 3
    for eng in (pre, dec):
        alloc = eng.scheduler.allocator
        assert alloc.free_count == alloc.num_pages - 1 and eng.leak_free()


def test_import_into_occupied_allocator_evicts(models):
    """Under page pressure an import evicts idle prefix pages LRU-first
    like any admission, a handoff with no free slot waits, and every
    continuation stays exact."""
    dec = _engine(models, num_pages=9)
    pre = _engine(models, num_pages=9)
    ref = _engine(models, num_pages=9)
    fills = [_prompt(33, 60 + i) for i in range(2)]
    targets = [_prompt(33, 80 + i) for i in range(3)]
    expected = [ref.generate([t], max_new_tokens=4)[0] for t in targets]
    dec.generate(fills, max_new_tokens=4)
    assert dec.scheduler.allocator.idle_count == 4
    assert len(dec.scheduler.allocator._free) == 4
    outs = {}
    for target in targets:
        rid, t0 = _first_token(pre, target)
        outs[dec.import_submit(pre.export_request(rid),
                               max_new_tokens=3)] = [t0]
    assert len(dec.scheduler.waiting) >= 1
    while dec.has_work():
        for ev in dec.step():
            assert ev.error is None
            outs[ev[0]].append(ev[1])
    assert dec.scheduler.allocator.evictions > 0
    assert list(outs.values()) == expected
    for eng in (pre, dec):
        alloc = eng.scheduler.allocator
        assert alloc.free_count == alloc.num_pages - 1 and eng.leak_free()


def test_partial_residency_ships_only_missing_pages(models):
    """A target holding the leading run of a context's pages by hash gets
    a handoff stripped to the rest (``strip_to``): the second request of
    a shared prefix ships only its private tail page, and its stream
    stays exact."""
    shared = _prompt(32, 13)                       # 2 full pages
    p1, p2 = shared + _prompt(8, 70), shared + _prompt(9, 71)
    expected = _engine(models).generate([p1, p2], max_new_tokens=4)
    pre, dec = _engine(models), _engine(models)
    shipped, outs = [], []
    for prompt in (p1, p2):
        rid, t0 = _first_token(pre, prompt)
        h = pre.export_request(rid)
        digest = dec.prefix_digest()
        resident = 0
        while resident < len(h.chain_hashes) and \
                h.chain_hashes[resident] in digest:
            resident += 1
        h = h.strip_to(range(resident, h.n_pages))
        shipped.append(len(h.page_list))
        dec.import_submit(h, max_new_tokens=3)
        outs.append(_drain(dec, [t0]))
    assert outs == expected
    assert shipped == [3, 1]
    assert dec.leak_free() and pre.leak_free()


def test_release_held_and_drain(models):
    """A held export is released without reading (the failure path) and
    ``drain_requests`` releases what is still held: the audit is clean
    after either, and not before."""
    pre = _engine(models)
    rid, _t0 = _first_token(pre, _prompt(40, 2))
    assert pre.leak_free() and pre.stats()["held"] == 1
    assert pre.release_held(rid) and not pre.release_held(rid)
    assert pre.stats()["held"] == 0 and pre.leak_free()
    _first_token(pre, _prompt(40, 3))
    pre.submit(_prompt(20, 4), max_new_tokens=3)
    assert pre.drain_requests() == 2
    assert pre.stats()["held"] == 0 and pre.leak_free()
    alloc = pre.scheduler.allocator
    assert alloc.free_count == alloc.num_pages - 1
