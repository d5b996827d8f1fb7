"""Port parity: the tiered KV cache (device pages -> host pool -> page
store).

The host pool and the page store run the same call sequences as
``ray_tpu.inference.kv_cache``'s and must end in the same stats; the
engine's tier legs run the same traffic as the JAX engine
(``GPTConfig.tiny``, f32, page 16, 9 pages) and must count the same
spills, bytes and hits per tier and the same greedy streams.  Then the port's counterparts of ``tests/test_tiers.py`` (the codec,
demote -> promote exact in the spill's exact arms, a store shared across
two engines, chaos on every leg degrading to re-prefill, a weight swap
invalidating every tier, the env knobs) and of the store's byte cap in
``tests/test_trace.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import HostPagePool as JaxPool
from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.inference import KVPageStore as JaxStore
from ray_tpu.inference import kv_cache as jkv
from ray_tpu.inference.config import infer_config as jax_infer_config
from ray_tpu.models import gpt as jgpt
from ray_tpu.util import chaos as jchaos
from ray_tpu_torch.convert import (array_to_tensor, params_from_jax,
                                   spill_entry_from_jax,
                                   spill_entry_to_numpy)
from ray_tpu_torch.inference import (HostPagePool, InferenceEngine,
                                     KVPageStore)
from ray_tpu_torch.inference import kv_cache as tkv
from ray_tpu_torch.inference.config import infer_config
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.util import chaos

GEOMETRY = dict(slots=2, page_size=16, buckets=(16, 32, 64))
_JAX_EXEC = {"model": {}, "int8": {}}


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(autouse=True)
def _no_faults():
    chaos.clear_faults()
    jchaos.clear_faults()
    yield
    chaos.clear_faults()
    jchaos.clear_faults()


def _engine(models, **kw):
    _j, _jp, tcfg, tparams = models
    return InferenceEngine(tcfg, tparams, device="cpu",
                           **{**GEOMETRY, **kw})


def _jax_engine(models, **kw):
    jcfg, jparams, _t, _tp = models
    return JaxEngine(jcfg, jparams, telemetry=False,
                     executable_cache=_JAX_EXEC[kw.get("kv_dtype",
                                                       "model")],
                     **{**GEOMETRY, **kw})


def _prompt(n, seed):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 512, n)]


def _pressure(engine, rounds=3, seed=100):
    """Evict the engine's idle prefix pages by admitting long fresh
    prompts until pressure demotes them through the tiers."""
    for i in range(rounds):
        engine.generate([_prompt(60, seed + i)], max_new_tokens=4)


def _entry():
    return {"fmt": "model", "k": np.zeros(4, np.float32),
            "v": np.zeros(4, np.float32)}


# ----------------------------------------------------- units vs reference
def _pool_script(Pool, Store):
    store = Store(use_object_store=False)
    pool = Pool(2, store=store)
    pool.put((b"a", 0), _entry())
    pool.put((b"b", 0), _entry())
    sizes = [(len(pool), pool.bytes)]
    pool.put((b"a", 0), _entry())          # dup: move to end, no growth
    pool.put((b"c", 0), _entry())          # overflow demotes b (LRU)
    flags = [(b"b", 0) in pool, (b"b", 0) in store]
    got = pool.take((b"a", 0))
    miss = pool.take((b"zz", 0))
    pool.discard((b"c", 0))                # silent: no miss counted
    pool.put((b"d", 0), _entry())
    cleared = pool.clear()
    p0 = Pool(0, store=store)              # capacity 0: straight on
    p0.put((b"z", 0), _entry())
    lone = Pool(1)                         # no store: a plain drop
    lone.put((b"a", 0), _entry())
    lone.put((b"b", 0), _entry())
    return (sizes, flags, got is not None, miss, cleared, pool.stats(),
            p0.stats(), (b"z", 0) in store, lone.stats(), store.stats())


def test_host_pool_and_store_match_reference():
    assert _pool_script(HostPagePool, KVPageStore) == \
        _pool_script(JaxPool, JaxStore)
    sizes, flags, got, miss, cleared, st, *_ = \
        _pool_script(HostPagePool, KVPageStore)
    assert sizes == [(2, 64)] and flags == [False, True]
    assert got and miss is None and cleared == 1
    assert (st["spills"], st["demotions"], st["hits"], st["misses"]) == \
        (4, 1, 1, 1)
    with pytest.raises(ValueError):
        HostPagePool(-1)


def _store_script(Store):
    store = Store(use_object_store=False)
    e = _entry()
    store.put((b"a", 0), e)
    store.put((b"a", 0), e)                # content-addressed: a no-op
    got = store.checkout((b"a", 0))
    in_flight = store.in_flight
    store.checkin((b"a", 0))
    kept = (b"a", 0) in store              # checkout does not pop
    stale = store.checkout((b"a", 1))      # another param version
    return (got is not None, in_flight, kept, stale, len(store),
            store.stats())


def test_store_checkout_checkin_match_reference():
    assert _store_script(KVPageStore) == _store_script(JaxStore)
    got, in_flight, kept, stale, n, st = _store_script(KVPageStore)
    assert got and in_flight == 1 and kept and stale is None and n == 1
    assert (st["puts"], st["dup_puts"], st["misses"], st["bytes"],
            st["in_flight"]) == (1, 1, 1, 32, 0)


def _cap_script(Store, spill_entry_bytes):
    nb = spill_entry_bytes(_entry())
    store = Store(use_object_store=False, capacity_bytes=2 * nb)
    log = []
    store.put((b"a", 0), _entry())
    store.put((b"b", 0), _entry())
    log.append((len(store), store.evictions))
    assert store.checkout((b"a", 0)) is not None    # a: pinned, recent
    store.put((b"c", 0), _entry())                  # evicts b (LRU)
    log.append(((b"b", 0) in store, (b"a", 0) in store, store.evictions,
                store.bytes_evicted))
    store.checkin((b"a", 0))
    store.put((b"d", 0), _entry())                  # a is evictable now
    log.append(((b"a", 0) in store, sorted(k for k, _ in store._entries)))
    assert store.checkout((b"c", 0)) is not None    # pin both residents:
    assert store.checkout((b"d", 0)) is not None    # the cap overshoots
    store.put((b"e", 0), _entry())
    log.append((len(store), store.evictions, store.bytes))
    store.checkin((b"c", 0))
    store.checkin((b"d", 0))
    return nb, log, store.stats()


def test_store_cap_evicts_lru_and_skips_pinned():
    got = _cap_script(KVPageStore, tkv.spill_entry_bytes)
    assert got == _cap_script(JaxStore, jkv.spill_entry_bytes)
    nb, log, st = got
    assert log == [(2, 0), (False, True, 1, nb), (False, [b"c", b"d"]),
                   (3, 2, 3 * nb)]
    assert st["in_flight"] == 0 and st["capacity_bytes"] == 2 * nb


def _same_entry(a, b):
    """Two spill entries, field for field and bit for bit."""
    assert a.keys() == b.keys()
    for name, x in a.items():
        y = b[name]
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        else:
            assert x == y


def test_store_object_store_leg_under_a_session(models):
    """Under a ``ray_tpu_torch`` session ``KVPageStore()`` keeps its
    entries in the runtime's object store: two engines sharing it give
    the in-process store's streams, counters and entries, bit for bit,
    with no fetch left in flight."""
    import ray_tpu_torch
    shared = _prompt(40, 9)

    def run(store):
        a = _engine(models, num_pages=9, host_pages=0, store=store,
                    spill_dtype="model")
        outs = [a.generate([shared + [1, 2]], max_new_tokens=6)[0]]
        _pressure(a)
        b = _engine(models, num_pages=9, host_pages=0, store=store,
                    spill_dtype="model")
        outs.append(b.generate([shared + [1, 2]], max_new_tokens=6)[0])
        assert a.leak_free() and b.leak_free()
        tiers = {k: v for k, v in b.stats()["tiers"].items()
                 if k != "fetch_seconds"}       # wall time
        return outs, tiers, store.stats()

    inproc = KVPageStore(use_object_store=False)
    want = run(inproc)
    ray_tpu_torch.init(num_cpus=1)
    try:
        store = KVPageStore()
        assert store._use_ray
        got = run(store)
        assert got == want and got[2]["in_flight"] == 0
        assert got[1]["hits"]["store"] >= 2 and len(store) > 0
        for key in list(inproc._entries):
            _same_entry(store.checkout(key), inproc.checkout(key))
            store.checkin(key)
            inproc.checkin(key)
        assert store.in_flight == inproc.in_flight == 0
    finally:
        ray_tpu_torch.shutdown()
    assert not KVPageStore()._use_ray


def test_spill_entry_bytes_count_tensors():
    """A bf16 entry holds CPU tensors: its bytes count like numpy's, and
    the page figure equals ``handoff_page_bytes``."""
    cache = tkv.KVCache(n_layers=2, num_pages=4, page_size=8, n_heads=2,
                        head_dim=8, dtype=torch.bfloat16, device="cpu")
    entry = tkv.encode_spill_page(tkv.export_pages(cache, [1]),
                                  quantized=False, spill_dtype="model")
    assert isinstance(entry["k"], torch.Tensor)
    geo = dict(n_layers=2, page_size=8, n_heads=2, head_dim=8)
    assert tkv.spill_entry_bytes(entry) == tkv.handoff_page_bytes(
        **geo, itemsize=2, quantized=False)
    q = tkv.encode_spill_page(tkv.export_pages(cache, [1]),
                              quantized=False, spill_dtype="int8")
    assert tkv.spill_entry_bytes(q) == tkv.handoff_page_bytes(
        **geo, itemsize=1, quantized=True)
    pool = HostPagePool(1)
    pool.put((b"a", 0), entry)
    assert pool.bytes == tkv.spill_entry_bytes(entry) > 0


def test_spill_codec_roundtrip_and_geometry():
    rng = np.random.default_rng(0)
    cache = tkv.KVCache(n_layers=2, num_pages=4, page_size=8, n_heads=2,
                        head_dim=8, dtype=torch.float32, device="cpu")
    cache.k.copy_(torch.from_numpy(rng.normal(size=cache.k.shape)))
    cache.v.copy_(torch.from_numpy(rng.normal(size=cache.v.shape)))
    orig_k = cache.k[:, 2].clone()
    contents = tkv.export_pages(cache, [2])
    exact = tkv.encode_spill_page(contents, quantized=False,
                                  spill_dtype="model")
    assert tkv.spill_entry_matches(cache, exact)
    tkv.install_spill_page(cache, 3, exact)
    assert torch.equal(cache.k[:, 3], orig_k)
    q = tkv.encode_spill_page(contents, quantized=False,
                              spill_dtype="int8")
    assert q["fmt"] == "int8"
    assert tkv.spill_entry_bytes(q) < tkv.spill_entry_bytes(exact)
    tkv.install_spill_page(cache, 1, q)
    err = (cache.k[:, 1] - orig_k).abs().max()
    assert 0 < err < 0.02 * orig_k.abs().max()
    other = tkv.KVCache(n_layers=2, num_pages=4, page_size=4, n_heads=2,
                        head_dim=8, dtype=torch.float32, device="cpu")
    assert not tkv.spill_entry_matches(other, exact)
    qcache = tkv.KVCache(n_layers=2, num_pages=4, page_size=8, n_heads=2,
                         head_dim=8, dtype=torch.float32, device="cpu",
                         kv_dtype="int8")
    qcache.k.copy_(torch.from_numpy(
        rng.integers(-127, 128, qcache.k.shape).astype(np.int8)))
    entry = tkv.encode_spill_page(tkv.export_pages(qcache, [1]),
                                  quantized=True)
    tkv.install_spill_page(qcache, 2, entry)
    assert torch.equal(qcache.k[:, 2], qcache.k[:, 1])


@pytest.mark.parametrize("spill_dtype", ["model", "int8"])
def test_spill_entry_crosses_packages(spill_dtype):
    """A bf16 spill entry of either package, converted across
    (``spill_entry_from_jax`` / ``spill_entry_to_numpy``), installs into
    the other package's cache bit for bit as its own entry does."""
    rng = np.random.default_rng(2)
    geo = dict(n_layers=2, num_pages=4, page_size=8, n_heads=2,
               head_dim=8)
    jc = jkv.KVCache(**geo, dtype=jnp.bfloat16)
    tc = tkv.KVCache(**geo, dtype=torch.bfloat16, device="cpu")
    for name in ("k", "v"):
        x = jnp.asarray(rng.normal(size=getattr(jc, name).shape),
                        jnp.bfloat16)
        setattr(jc, name, x)
        getattr(tc, name).copy_(array_to_tensor(np.asarray(x), "cpu"))
    ej = jkv.encode_spill_page(jkv.export_pages(jc, [1]), quantized=False,
                               spill_dtype=spill_dtype)
    et = tkv.encode_spill_page(tkv.export_pages(tc, [1]), quantized=False,
                               spill_dtype=spill_dtype)
    moved = spill_entry_from_jax(ej)
    assert tkv.spill_entry_bytes(moved) == jkv.spill_entry_bytes(ej)
    tkv.install_spill_page(tc, 2, moved)
    tkv.install_spill_page(tc, 3, et)
    back = spill_entry_to_numpy(et, bf16_dtype=jnp.bfloat16)
    assert sorted(back) == sorted(ej)
    jkv.install_spill_page(jc, 2, back)
    jkv.install_spill_page(jc, 3, ej)
    for name in ("k", "v"):
        t = getattr(tc, name).view(torch.int16).numpy()
        j = np.asarray(getattr(jc, name)).view(np.int16)
        np.testing.assert_array_equal(t[:, 2], t[:, 3])
        np.testing.assert_array_equal(t[:, 2:], j[:, 2:])


# --------------------------------------------------- engine vs reference
_TIER_KEYS = ("hits", "spill_bytes", "spill_faults", "fetches",
              "fetch_faults")


def _tier_run(engine, shared):
    first = engine.generate([shared + [5, 6, 7]], max_new_tokens=8)[0]
    _pressure(engine)
    again = engine.generate([shared + [5, 6, 7]], max_new_tokens=8)[0]
    st = engine.stats()["tiers"]
    return ([int(t) for t in first], [int(t) for t in again],
            {k: st[k] for k in _TIER_KEYS},
            {k: st["host"][k] for k in ("spills", "demotions", "dropped",
                                        "hits")},
            {k: st["store"][k] for k in ("puts", "gets", "misses")})


@pytest.mark.parametrize("kw", [{"spill_dtype": "model"},
                                {"kv_dtype": "int8"}, {}],
                         ids=["model-spill", "int8-cache", "int8-spill"])
def test_tier_counters_and_streams_match_jax_engine(models, kw):
    """The same traffic through both engines: the same spills, bytes
    and hits per tier, and the same greedy streams (the int8 spill of an
    f32 cache included: both dequantize the same codes in f32)."""
    shared = _prompt(40, 7)
    jrun = _tier_run(_jax_engine(models, num_pages=9, host_pages=4,
                                 store=True, **kw), shared)
    eng = _engine(models, num_pages=9, host_pages=4, store=True, **kw)
    trun = _tier_run(eng, shared)
    assert trun == jrun
    _first, _again, tiers, host, _store = trun
    assert host["spills"] > 0 and tiers["spill_bytes"] > 0
    assert tiers["hits"]["dram"] + tiers["hits"]["store"] >= 2
    assert eng.leak_free() and eng.store.in_flight == 0
    jstats = _jax_engine(models).stats()
    for key in ("deadline_exceeded", "exports", "imports", "held",
                "tiers", "prefix", "spec"):
        assert key in eng.stats(), key
        if isinstance(jstats[key], dict):
            assert sorted(eng.stats()[key]) == sorted(jstats[key]), key


@pytest.mark.parametrize("kw", [{"spill_dtype": "model"},
                                {"kv_dtype": "int8"}])
def test_tiered_demote_promote_exact(models, kw):
    """In the spill's exact arms (model-dtype spill of an f32 cache, the
    int8 cache's own codes) a promoted prefix continues bit-exactly as a
    prefix resident in the cache does.  Against a cold run the int8 arm
    parts (here at the sixth token, in both packages): a hit's prefill
    reads the context back as int8 codes, a cold prefill attends over
    the full-precision K/V (ROADMAP Queue 3)."""
    shared = _prompt(40, 7)
    prompt = shared + [5, 6, 7]
    resident = _engine(models, num_pages=9, **kw)
    cold = resident.generate([prompt], max_new_tokens=8)[0]
    hit = resident.generate([prompt], max_new_tokens=8)[0]
    assert resident.stats()["tiers"]["hits"]["hbm"] == 2
    assert resident.stats()["prefix"]["hit_pages"] == 2
    eng = _engine(models, num_pages=9, host_pages=4, store=True, **kw)
    assert eng.generate([prompt], max_new_tokens=8)[0] == cold
    _pressure(eng)
    st = eng.stats()["tiers"]
    assert st["host"]["spills"] > 0 and st["spill_bytes"] > 0
    per_page = tkv.spill_entry_bytes(tkv.encode_spill_page(
        tkv.export_pages(eng.cache, [1]), quantized=eng.cache.quantized,
        spill_dtype=eng.spill_dtype))
    assert st["spill_bytes"] == per_page * st["host"]["spills"]
    assert eng.generate([prompt], max_new_tokens=8)[0] == hit
    st = eng.stats()["tiers"]
    assert st["hits"]["dram"] + st["hits"]["store"] == 2
    assert st["fetches"] == 2 and eng.leak_free()
    jeng = _jax_engine(models, num_pages=9, **kw)
    jcold, jhit = (jeng.generate([prompt], max_new_tokens=8)[0]
                   for _ in range(2))
    assert ([int(t) for t in jcold], [int(t) for t in jhit]) == (cold, hit)
    assert (cold == hit) == ("kv_dtype" not in kw)


def test_store_only_and_shared_store_cross_engine(models):
    """``host_pages=0`` with a store sends demotes straight on, and a
    second engine sharing the store admits the first one's spilled
    prefix as store hits."""
    shared = _prompt(40, 9)
    ref = _engine(models, num_pages=9).generate([shared + [1, 2]],
                                                max_new_tokens=6)[0]
    store = KVPageStore(use_object_store=False)
    a = _engine(models, num_pages=9, host_pages=0, store=store,
                spill_dtype="model")
    assert a.generate([shared + [1, 2]], max_new_tokens=6)[0] == ref
    _pressure(a)
    assert a.stats()["tiers"]["host"]["demotions"] > 0 and len(store) > 0
    b = _engine(models, num_pages=9, host_pages=0, store=store,
                spill_dtype="model")
    assert b.generate([shared + [1, 2]], max_new_tokens=6)[0] == ref
    st = b.stats()["tiers"]
    assert st["hits"]["store"] >= 2 and st["hits"]["hbm"] == 0
    assert b.stats()["prefix"]["hit_tokens"] == 32
    assert a.leak_free() and b.leak_free() and store.in_flight == 0


@pytest.mark.parametrize("spec,expect", [("kv.spill@1", "spill"),
                                         ("kv.spill@4", "spill"),
                                         ("kv.fetch@1", "fetch"),
                                         ("kv.fetch@1..2:delay=0.01", None)])
def test_kv_chaos_legs_degrade_to_reprefill(models, spec, expect):
    shared = _prompt(40, 11)
    ref = _engine(models, num_pages=9).generate([shared + [3, 4]],
                                                max_new_tokens=6)[0]
    eng = _engine(models, num_pages=9, host_pages=2, store=True,
                  spill_dtype="model")
    assert eng.generate([shared + [3, 4]], max_new_tokens=6)[0] == ref
    plan = chaos.install_faults(spec)
    _pressure(eng)
    out = eng.generate([shared + [3, 4]], max_new_tokens=6)[0]
    chaos.clear_faults()
    assert out == ref
    st = eng.stats()["tiers"]
    if expect == "spill":
        assert st["spill_faults"] + st["host"]["dropped"] >= 1
    elif expect == "fetch":
        assert st["fetch_faults"] >= 1 and plan.fired
    else:
        assert st["fetch_faults"] == 0 and st["fetches"] >= 1
        assert plan.slowdown_s("kv.fetch") > 0
    assert eng.leak_free()


def test_set_params_invalidates_all_tiers(models):
    _j, _jp, _tc, tparams = models
    shared = _prompt(40, 13)
    eng = _engine(models, num_pages=9, host_pages=4, store=True,
                  spill_dtype="model")
    eng.generate([shared + [8]], max_new_tokens=4)
    _pressure(eng)
    assert len(eng.host_pool) + len(eng.store) > 0
    store_before = len(eng.store)
    eng.set_params(tparams)
    assert len(eng.host_pool) == 0
    assert len(eng.store) == store_before   # invalidated by key
    before = dict(eng.stats()["tiers"]["hits"])
    out = eng.generate([shared + [8]], max_new_tokens=4)[0]
    after = eng.stats()["tiers"]["hits"]
    assert after["dram"] == before["dram"]
    assert after["store"] == before["store"]
    assert out == _engine(models, num_pages=9).generate(
        [shared + [8]], max_new_tokens=4)[0]
    assert eng.leak_free()


def test_store_cap_engine_degrades_to_suffix_prefill(models):
    """A 1-byte store cap evicts the shared prefix under spill pressure;
    an engine re-admitting it misses the store and prefills the suffix,
    exactly, and the evictions reach telemetry."""
    shared = _prompt(40, 9)
    ref = _engine(models, num_pages=9).generate([shared + [1, 2]],
                                                max_new_tokens=6)[0]
    store = KVPageStore(use_object_store=False, capacity_bytes=1)
    a = _engine(models, num_pages=9, host_pages=0, store=store,
                spill_dtype="model", telemetry=True)
    assert a.generate([shared + [1, 2]], max_new_tokens=6)[0] == ref
    for i in range(3):
        a.generate([_prompt(60, 100 + i)], max_new_tokens=4)
    assert store.evictions > 0 and len(store) <= 1
    assert a.telemetry.summary()["tiers"]["store_evictions"] > 0
    b = _engine(models, num_pages=9, host_pages=0, store=store,
                spill_dtype="model")
    assert b.generate([shared + [1, 2]], max_new_tokens=6)[0] == ref
    assert b.stats()["tiers"]["hits"]["store"] < 2
    assert a.leak_free() and b.leak_free() and store.in_flight == 0


def test_tier_env_knobs_match_reference(monkeypatch):
    def both():
        t, j = infer_config(refresh=True), jax_infer_config(refresh=True)
        got = (t.host_pages, t.store, t.spill_dtype, t.store_cap)
        assert got == (j.host_pages, j.store, j.spill_dtype, j.store_cap)
        return got

    monkeypatch.setenv("RAY_TPU_KV_HOST_PAGES", "32")
    monkeypatch.setenv("RAY_TPU_KV_STORE", "0")
    monkeypatch.setenv("RAY_TPU_KV_SPILL_DTYPE", "model")
    monkeypatch.setenv("RAY_TPU_KV_STORE_CAP", "1048576")
    assert both() == (32, False, "model", 1048576)
    monkeypatch.setenv("RAY_TPU_KV_HOST_PAGES", "-3")
    monkeypatch.setenv("RAY_TPU_KV_SPILL_DTYPE", "float8")
    monkeypatch.setenv("RAY_TPU_KV_STORE_CAP", "-1")
    assert both() == (0, False, "int8", 0)
    for name in ("HOST_PAGES", "STORE", "SPILL_DTYPE", "STORE_CAP"):
        monkeypatch.delenv(f"RAY_TPU_KV_{name}")
    assert both() == (0, True, "int8", 0)
