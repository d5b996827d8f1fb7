"""Port counterparts of ``tests/test_adapters.py``: banked LoRA serving
and adapter-only training in ``ray_tpu_torch``, held against the JAX
package on ``GPTConfig.tiny`` f32.

Both sides get the same inputs: the JAX package's base weights and its
adapters (``init_adapter`` with ``jax.random`` keys 11 and 22,
``random_b``) cross over through ``convert.params_from_jax`` and
``convert.adapter_from_jax``.  Tolerances:

- greedy token streams: equal, token for token, to the JAX engine's
  (plain, co-batched, int8 KV, speculative, republished mid-decode);
- the single-adapter forward: within 2e-4 of the JAX package's logits
  (f32 through two layers; summation order moves them by ~1e-6), and
  the banked delta within 1e-5 of the reference's;
- adapter-only gradients: within 2e-5 of ``jax.grad`` of the reference
  loss;
- ``salt_bytes``, the registry's LRU and pin order, the store's
  versions and counters: exact.

The RL learner's adapter publication (``rl/learner.py``) is held by the
learner half of the adapter-only training test and by
``test_rl_published_adapter_serves_merged_parity``.  The JAX package's compile counters have no meaning in an eager engine;
their test holds the property they stand for: a hot load or republish
writes the bank in place (the same tensors, at the same addresses).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.adapters import LoraConfig as JaxLoraConfig
from ray_tpu.adapters import lora as jlora
from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.inference import SamplingParams as JaxSampling
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import adapters as tad
from ray_tpu_torch.adapters import (AdapterRegistry, AdapterStore,
                                    AdapterUnavailableError, LoraConfig)
from ray_tpu_torch.adapters import lora as tlora
from ray_tpu_torch.convert import (adapter_from_jax, bank_from_jax,
                                   params_from_jax)
from ray_tpu_torch.inference import InferenceEngine, SamplingParams
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.util import chaos

_KW = {"slots": 3, "page_size": 16, "buckets": (16, 32, 64),
       "telemetry": False}
# compiled steps of the JAX engines, shared across this file's tests
_JAX_EXEC = {}


def _lcfg(**over):
    base = dict(enabled=True, rank=4, scale=0.5, cache_slots=3)
    base.update(over)
    return LoraConfig(**base)


def _jlcfg(**over):
    base = dict(enabled=True, rank=4, scale=0.5, cache_slots=3)
    base.update(over)
    return JaxLoraConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def adapters(tiny):
    """Two non-identity adapters (random B), the reference's and the
    same factors in the port."""
    jcfg, _jp, tcfg, _tp = tiny
    out = {}
    for mid, seed in (("t1", 11), ("t2", 22)):
        ja = jlora.init_adapter(jcfg, _jlcfg(), jax.random.PRNGKey(seed),
                                random_b=True)
        ta = adapter_from_jax(jax.tree.map(np.asarray, ja), tcfg, _lcfg(),
                              device="cpu")
        out[mid] = (ja, ta)
    return out


@pytest.fixture(autouse=True)
def _no_faults():
    chaos.clear_faults()
    yield
    chaos.clear_faults()


def _engine(tiny, **over):
    _jcfg, _jp, tcfg, tparams = tiny
    kw = dict(_KW)
    kw.update(over)
    params = kw.pop("params", tparams)
    return InferenceEngine(tcfg, params, device="cpu", **kw)


def _jengine(tiny, **over):
    jcfg, jparams, _t, _tp = tiny
    kw = dict(_KW)
    kw.update(over)
    params = kw.pop("params", jparams)
    return JaxEngine(jcfg, params, executable_cache=_JAX_EXEC, **kw)


def _merged(tiny, adapter, scale=0.5):
    _jcfg, _jp, tcfg, tparams = tiny
    return tlora.merge_adapter(tparams, adapter, tcfg, scale=scale)


def _greedy(model_id=None, **over):
    return SamplingParams(temperature=0.0, model_id=model_id, **over)


def _jgreedy(model_id=None, **over):
    return JaxSampling(temperature=0.0, model_id=model_id, **over)


def _prompt(n, vocab, seed=0):
    return [int(t) for t in np.random.RandomState(seed).randint(1, vocab,
                                                                size=n)]


def _store_with(adapters, ids=("t1", "t2"), side=1):
    store = AdapterStore(use_object_store=False)
    for mid in ids:
        store.put(mid, adapters[mid][side], scale=0.5)
    return store


def _jstore_with(adapters, ids=("t1", "t2")):
    from ray_tpu.adapters import AdapterStore as JaxStore
    store = JaxStore(use_object_store=False)
    for mid in ids:
        store.put(mid, adapters[mid][0], scale=0.5)
    return store


def _drain(eng, rids):
    out = {r: [] for r in rids}
    while eng.has_work():
        for (rid, tok, _d) in eng.step():
            if rid in out:
                out[rid].append(int(tok))
    return [out[r] for r in rids]


# ------------------------------------------------------------ factor math
def test_fresh_adapter_is_identity_and_merge_oracle(tiny, adapters):
    """Standard LoRA init (B = 0) is an exact no-op; a random-B adapter
    through the single-adapter forward equals the merged weights and
    the JAX package's forward with the same factors."""
    jcfg, jparams, tcfg, tparams = tiny
    lcfg = _lcfg()
    fresh = tlora.init_adapter(tcfg, lcfg, torch.Generator().manual_seed(1),
                               device="cpu")
    merged = tlora.merge_adapter(tparams, fresh, tcfg, scale=0.5)
    for k in tparams["layers"]:
        assert torch.equal(merged["layers"][k], tparams["layers"][k])
    tokens = torch.tensor([_prompt(12, tcfg.vocab_size)])
    base_out, _ = tgpt.forward(tparams, tokens, tcfg)
    lora_out, _ = tgpt.forward(tparams, tokens, tcfg,
                               lora={**fresh, "scale": 0.5})
    assert torch.equal(base_out, lora_out)

    ja, ta = adapters["t1"]
    ref, _ = tgpt.forward(_merged(tiny, ta), tokens, tcfg)
    via_lora, _ = tgpt.forward(tparams, tokens, tcfg,
                               lora={**ta, "scale": 0.5})
    assert not torch.allclose(ref, base_out)
    np.testing.assert_allclose(via_lora.numpy(), ref.numpy(),
                               atol=2e-4, rtol=2e-4)
    jout, _ = jgpt.forward(jparams, jnp.asarray(tokens.numpy()), jcfg,
                           lora={**ja, "scale": 0.5})
    np.testing.assert_allclose(via_lora.numpy(), np.asarray(jout),
                               atol=2e-4, rtol=2e-4)
    # the merged-weights oracle itself equals the reference's
    jm = jlora.merge_adapter(jparams, ja, jcfg, scale=0.5)
    tm = _merged(tiny, ta)
    for k in ("wq", "wo", "w1", "w2", "w3"):
        np.testing.assert_allclose(tm["layers"][k].numpy(),
                                   np.asarray(jm["layers"][k]),
                                   atol=1e-6, rtol=1e-6)


def test_banked_delta_matches_reference(tiny, adapters):
    """The banked ``lora_delta`` (each row gathers its own slot) against
    the reference's on the same bank and ids."""
    jcfg, _jp, tcfg, _tp = tiny
    jbank = jlora.bank_zeros(jcfg, _jlcfg())
    jbank = jlora.bank_install(jbank, 1, adapters["t1"][0], scale=0.5)
    jbank = jlora.bank_install(jbank, 2, adapters["t2"][0], scale=0.7)
    tbank = bank_from_jax(jax.tree.map(np.asarray, jbank), device="cpu")
    x = np.random.default_rng(0).standard_normal((4, 3, 64)).astype(
        np.float32)
    ids = np.array([2, 0, 1, 2], np.int32)
    for name in ("wq", "w1", "wo"):
        if name == "wo":
            x_in = np.random.default_rng(1).standard_normal(
                (4, 3, 64)).astype(np.float32)
        else:
            x_in = x
        jl = {k: v[:, 1] for k, v in jbank.items() if k != "scale"}
        jl.update(scale=jbank["scale"], ids=jnp.asarray(ids))
        tl = {k: v[:, 1] for k, v in tbank.items() if k != "scale"}
        tl.update(scale=tbank["scale"], ids=torch.from_numpy(ids).long())
        want = np.asarray(jgpt.lora_delta(jl, name, jnp.asarray(x_in)))
        got = tgpt.lora_delta(tl, name, torch.from_numpy(x_in)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        assert not got[1].any()           # slot 0: the identity


def test_bank_install_clear_and_slot_zero_guard(tiny, adapters):
    jcfg, _jp, tcfg, _tp = tiny
    lcfg = _lcfg()
    bank = tlora.bank_zeros(tcfg, lcfg, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in bank.items()}
    assert bank["scale"].shape == (lcfg.bank_slots,)
    bank = tlora.bank_install(bank, 1, adapters["t1"][1], scale=0.5)
    jbank = jlora.bank_install(jlora.bank_zeros(jcfg, _jlcfg()), 1,
                               adapters["t1"][0], scale=0.5)
    for k, v in jbank.items():            # bit-equal to the reference's
        assert np.array_equal(bank[k].numpy(), np.asarray(v)), k
    assert float(bank["scale"][1]) == 0.5
    assert float(bank["wq_a"][1].abs().max()) > 0
    assert float(bank["wq_a"][0].abs().max()) == 0
    assert float(bank["scale"][0]) == 0.0
    with pytest.raises(ValueError, match="identity"):
        tlora.bank_install(bank, 0, adapters["t1"][1])
    bank = tlora.bank_clear(bank, 1)
    assert float(bank["wq_a"][1].abs().max()) == 0
    # written in place: the same tensors throughout
    assert {k: v.data_ptr() for k, v in bank.items()} == ptrs


def test_salt_bytes_distinct_per_tenant_and_version():
    assert tad.salt_bytes(None, 1) == b"" and tad.salt_bytes("", 1) == b""
    s11, s12 = tad.salt_bytes("t1", 1), tad.salt_bytes("t1", 2)
    s21 = tad.salt_bytes("t2", 1)
    assert len({s11, s12, s21}) == 3
    for mid in (None, "", "t1", "tenant-é", "a@b"):
        for v in (0, 1, 7, 123456):
            assert tad.salt_bytes(mid, v) == jlora.salt_bytes(mid, v)


def test_moe_configs_are_rejected(tiny):
    _jcfg, _jp, tcfg, _tp = tiny
    moe_cfg = dataclasses.replace(tcfg, n_experts=4)
    with pytest.raises(ValueError, match="MoE|expert"):
        tlora.init_adapter(moe_cfg, _lcfg(), device="cpu")


def test_adapter_entry_points_default_to_the_card(tiny, monkeypatch):
    """``init_adapter`` and ``bank_zeros`` with no device run on the card
    and, without one, raise instead of drifting to the CPU."""
    _jcfg, _jp, tcfg, _tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlora.init_adapter(tcfg, _lcfg(), torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlora.bank_zeros(tcfg, _lcfg())
    fresh = tlora.init_adapter(tcfg, _lcfg(),
                               torch.Generator().manual_seed(1),
                               device="cpu")
    assert {v.device.type for v in fresh.values()} == {"cpu"}


def test_lora_config_reads_the_references_env(monkeypatch):
    from ray_tpu.adapters import lora_config as jax_lora_config
    monkeypatch.setenv("RAY_TPU_LORA", "1")
    monkeypatch.setenv("RAY_TPU_LORA_RANK", "16")
    monkeypatch.setenv("RAY_TPU_LORA_TARGETS", "w2,wq,bogus")
    monkeypatch.setenv("RAY_TPU_ADAPTER_CACHE", "5")
    got = tad.lora_config(refresh=True)
    want = jax_lora_config(refresh=True)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    monkeypatch.setenv("RAY_TPU_LORA_TARGETS", "w2,wq")
    got = tad.lora_config(refresh=True)
    assert got.targets == jax_lora_config(refresh=True).targets == \
        ("wq", "w2")
    assert got.bank_slots == 6 and got.enabled and got.rank == 16
    monkeypatch.undo()
    tad.lora_config(refresh=True)
    jax_lora_config(refresh=True)


# --------------------------------------------------------- store/registry
def _store_script(store_cls, adapter, err_cls):
    store = store_cls(use_object_store=False)
    out = ["t1" in store]
    out.append((store.put("t1", adapter, scale=0.5),
                store.put("t1", adapter, scale=0.7)))
    out.append(store.latest_version("t1"))
    got, _payload, scale = store.checkout("t1")
    out.append((got, scale, store.in_flight))
    store.checkin()
    out.append(store.in_flight)
    got, _, scale = store.get("t1", version=1)
    out.append((got, scale))
    for args in (("nope",), ("t1", 9)):
        try:
            store.get(*args)
        except err_cls as e:
            out.append(str(e))
    out.append((store.salt_for("t1"), store.salt_for("t1", version=1),
                store.salt_for("nope")))
    out.append(store.stats())
    return out


def test_adapter_store_versions_checkout_and_misses(adapters):
    from ray_tpu.adapters import AdapterStore as JaxStore
    from ray_tpu.adapters import AdapterUnavailableError as JaxErr
    got = _store_script(AdapterStore, adapters["t1"][1],
                        AdapterUnavailableError)
    want = _store_script(JaxStore, adapters["t1"][0], JaxErr)
    assert got == want
    assert got[1] == (1, 2) and got[-1]["in_flight"] == 0
    assert got[-1]["bytes_published"] > 0
    assert "never published" in got[6] and "not in store" in got[7]


def _registry_script(reg_cls, err_cls):
    """The reference tests' LRU and pin sequences, every answer
    recorded."""
    out = []
    reg = reg_cls(cache_slots=2)
    out += [reg.place("a", 1), reg.place("b", 1)]
    reg.touch("a", 1)
    out += [reg.place("c", 1), reg.resident_ids, reg.lookup("a"),
            reg.place("a", 2), reg.lookup("a"), reg.lookup("a", 1)]
    reg.pin("a", 2)
    reg.pin("c", 1)
    try:
        reg.place("d", 1)
    except err_cls as e:
        out.append(str(e))
    reg.unpin("a", 2)
    out += [reg.place("d", 1)]
    reg.unpin("c", 1)
    out += [reg.pinned_total, reg.digest(), reg.stats()]
    try:
        reg.unpin("c", 1)
    except RuntimeError as e:
        out.append(str(e))
    reg = reg_cls(cache_slots=2)
    out += [reg.place("a", 1)]
    reg.pin("a", 1)
    out += [reg.place("a", 2), reg.lookup("a", 1), reg.lookup("a", 2),
            reg.lookup("a")]
    try:
        reg.place("a", 1)
    except err_cls as e:
        out.append(str(e))
    reg.unpin("a", 1)
    out += [reg.place("b", 1), reg.lookup("a"), reg.pinned_total,
            reg.resident_ids]
    return out


def test_adapter_registry_lru_eviction_and_pin_discipline():
    from ray_tpu.adapters import AdapterRegistry as JaxRegistry
    from ray_tpu.adapters import AdapterUnavailableError as JaxErr
    got = _registry_script(AdapterRegistry, AdapterUnavailableError)
    assert got == _registry_script(JaxRegistry, JaxErr)
    assert {got[0][0], got[1][0]} == {1, 2}
    assert got[2] == (got[1][0], "b")          # b's row is recycled
    assert any("pinned" in str(x) for x in got)
    assert any("without a pin" in str(x) for x in got)


def test_adapter_registry_pinned_republish_gets_fresh_slot():
    """A republish while the old version is pinned lands in a fresh row;
    both stay addressable by exact version; the stale row is evictable
    once its pins drain."""
    reg = AdapterRegistry(cache_slots=2)
    s_old, _ = reg.place("a", 1)
    reg.pin("a", 1)
    s_new, ev = reg.place("a", 2)
    assert s_new != s_old and ev is None
    assert reg.lookup("a", 1) == (s_old, 1)
    assert reg.lookup("a") == (s_new, 2)
    with pytest.raises(AdapterUnavailableError, match="pinned"):
        reg.place("a", 1)
    reg.unpin("a", 1)
    s_b, evicted = reg.place("b", 1)
    assert s_b == s_old and evicted is None
    assert reg.pinned_total == 0


# --------------------------------------------------- engine parity battery
def test_engine_adapter_parity_vs_merged_weights(tiny, adapters):
    """An engine decoding under a banked adapter emits the JAX banked
    engine's tokens and the merged-weights engine's; base traffic on the
    same engine equals a plain engine; sampled decoding under the bank
    equals sampled decoding of the merged weights."""
    _jcfg, _jp, tcfg, _tp = tiny
    ja, ta = adapters["t1"]
    eng = _engine(tiny, lora=_lcfg())
    eng.load_adapter("t1", ta, scale=0.5)
    jeng = _jengine(tiny, lora=_jlcfg())
    jeng.load_adapter("t1", ja, scale=0.5)
    merged = _engine(tiny, params=_merged(tiny, ta))
    plain = _engine(tiny)
    p = _prompt(9, tcfg.vocab_size, seed=1)
    got = eng.generate([p], 10, _greedy("t1"))
    assert got == jeng.generate([p], 10, _jgreedy("t1"))
    assert got == merged.generate([p], 10, _greedy())
    sp = SamplingParams(temperature=0.7, seed=5, model_id="t1")
    assert eng.generate([p], 10, sp) == merged.generate(
        [p], 10, SamplingParams(temperature=0.7, seed=5))
    assert eng.generate([p], 10, _greedy()) == plain.generate(
        [p], 10, _greedy())
    assert eng.leak_free() and merged.leak_free()
    assert eng.stats()["adapters"]["enabled"]


def test_mixed_cobatch_solo_equals_batched(tiny, adapters):
    """Two tenants and base traffic co-batched on one engine: every
    stream equals the JAX engine's co-batch and its solo merged run."""
    _jcfg, _jp, tcfg, _tp = tiny
    eng = _engine(tiny, lora=_lcfg())
    jeng = _jengine(tiny, lora=_jlcfg())
    for mid in ("t1", "t2"):
        eng.load_adapter(mid, adapters[mid][1], scale=0.5)
        jeng.load_adapter(mid, adapters[mid][0], scale=0.5)
    prompts = [_prompt(7, tcfg.vocab_size, seed=s) for s in (1, 2, 3)]
    tenants = ["t1", "t2", None]
    solo = [_engine(tiny, params=_merged(tiny, adapters[t][1])
                    if t else tiny[3]).generate([p], 8, _greedy())[0]
            for p, t in zip(prompts, tenants)]
    got = _drain(eng, [eng.submit(p, 8, _greedy(t))
                       for p, t in zip(prompts, tenants)])
    want = _drain(jeng, [jeng.submit(p, 8, _jgreedy(t))
                         for p, t in zip(prompts, tenants)])
    assert got == want == solo
    assert eng.leak_free()


def test_adapter_parity_int8_kv(tiny, adapters):
    _jcfg, _jp, tcfg, _tp = tiny
    ja, ta = adapters["t1"]
    eng = _engine(tiny, lora=_lcfg(), kv_dtype="int8")
    eng.load_adapter("t1", ta, scale=0.5)
    jeng = _jengine(tiny, lora=_jlcfg(), kv_dtype="int8")
    jeng.load_adapter("t1", ja, scale=0.5)
    ref = _engine(tiny, params=_merged(tiny, ta), kv_dtype="int8")
    p = _prompt(8, tcfg.vocab_size, seed=4)
    got = eng.generate([p], 8, _greedy("t1"))
    assert got == jeng.generate([p], 8, _jgreedy("t1"))
    assert got == ref.generate([p], 8, _greedy())


def test_adapter_parity_spec_decode(tiny, adapters):
    """Speculation under an adapter: the verify forward reads the bank
    too, and the stream equals the JAX engine's and plain decode of the
    merged weights."""
    _jcfg, _jp, tcfg, _tp = tiny
    ja, ta = adapters["t1"]
    eng = _engine(tiny, lora=_lcfg(), spec=True, spec_k=3)
    eng.load_adapter("t1", ta, scale=0.5)
    jeng = _jengine(tiny, lora=_jlcfg(), spec=True, spec_k=3)
    jeng.load_adapter("t1", ja, scale=0.5)
    ref = _engine(tiny, params=_merged(tiny, ta))
    p = _prompt(6, tcfg.vocab_size, seed=5) * 2
    got = eng.generate([p], 10, _greedy("t1"))
    assert got == jeng.generate([p], 10, _jgreedy("t1"))
    assert got == ref.generate([p], 10, _greedy())
    assert eng.stats()["calls"]["verify"] > 0
    assert eng.leak_free()


def test_adapter_prefix_reuse_and_salt_non_aliasing(tiny, adapters):
    """The same (tenant, prompt) twice prefix-hits the salted chain and
    still equals the merged oracle; base traffic over the same tokens
    does not alias the tenant's entries; the registered chain hashes are
    the JAX engine's."""
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters)
    eng = _engine(tiny, lora=_lcfg(), adapter_store=store, prefix=True)
    jeng = _jengine(tiny, lora=_jlcfg(), adapter_store=_jstore_with(
        adapters), prefix=True)
    p = _prompt(37, tcfg.vocab_size, seed=6)
    expect = _engine(tiny, params=_merged(tiny, adapters["t1"][1]),
                     prefix=True).generate([p], 6, _greedy())
    assert eng.generate([p], 6, _greedy("t1")) == expect
    assert jeng.generate([p], 6, _jgreedy("t1")) == expect
    hits0 = eng.stats()["prefix"]["hit_pages"]
    assert eng.generate([p], 6, _greedy("t1")) == expect
    hits1 = eng.stats()["prefix"]["hit_pages"]
    assert hits1 >= hits0 + 2
    plain = _engine(tiny, prefix=True)
    assert eng.generate([p], 6, _greedy()) == plain.generate(
        [p], 6, _greedy())
    assert eng.stats()["prefix"]["hit_pages"] == hits1
    # the JAX engine through the same traffic registers the same salted
    # and unsalted chains, with the same hit counts
    assert jeng.generate([p], 6, _jgreedy("t1")) == expect
    jeng.generate([p], 6, _jgreedy())
    assert eng.prefix_digest() == jeng.prefix_digest()
    assert eng.stats()["prefix"]["hit_pages"] == \
        jeng.stats()["prefix"]["hit_pages"]
    assert eng.leak_free()


def test_hot_load_and_republish_keep_compiles_frozen(tiny, adapters):
    """A tenant's hot load, a republish and the eviction they cause
    write the bank in place: the same tensors at the same addresses, so
    the steps read one bank for the engine's life; the streams follow
    the new version."""
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters, ids=("t1",))
    eng = _engine(tiny, lora=_lcfg(), adapter_store=store)
    bank = eng.lora_bank
    ptrs = {k: v.data_ptr() for k, v in bank.items()}
    p = _prompt(8, tcfg.vocab_size, seed=7)
    eng.generate([p], 6, _greedy("t1"))
    rid_live = eng.submit(p, 12, _greedy("t1"))
    store.put("t2", adapters["t2"][1], scale=0.5)
    rid2 = eng.submit(_prompt(8, tcfg.vocab_size, seed=8), 6,
                      _greedy("t2"))
    out = _drain(eng, [rid_live, rid2])
    assert len(out[1]) == 6
    store.put("t1", adapters["t2"][1], scale=0.5)     # v2 = t2's factors
    ref = _engine(tiny, params=_merged(tiny, adapters["t2"][1]))
    assert eng.generate([p], 6, _greedy("t1")) == ref.generate(
        [p], 6, _greedy())
    assert eng.lora_bank is bank
    assert {k: v.data_ptr() for k, v in eng.lora_bank.items()} == ptrs
    assert eng.adapters.loads == 3
    assert eng.leak_free()


def plain_base(tiny, prompt, n=3):
    return _engine(tiny).generate([prompt], n, _greedy())[0]


def test_tenant_submitted_mid_tick_waits_for_its_slot(tiny, adapters):
    """A tenant request submitted after the tick resolved the bank rows
    (as the fleet's concurrent mode submits while a worker steps) is not
    admitted on the identity slot: it waits a tick, decodes under its
    adapter, and its K/V goes into the prefix index under the tenant's
    salt, never under the base chain."""
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters, ids=("t1",))
    eng = _engine(tiny, lora=_lcfg(), adapter_store=store, prefix=True)
    p = _prompt(37, tcfg.vocab_size, seed=12)
    base_p = _prompt(5, tcfg.vocab_size, seed=13)
    late = []
    resolve = eng._resolve_adapters

    def resolve_then_submit(events):
        resolve(events)
        if not late:
            late.append(eng.submit(p, 6, _greedy("t1")))

    eng._resolve_adapters = resolve_then_submit
    rid_base = eng.submit(base_p, 3, _greedy())
    out = {}
    while eng.has_work():
        for (rid, tok, _d) in eng.step():
            out.setdefault(rid, []).append(int(tok))
    del eng._resolve_adapters
    expect = _engine(tiny, params=_merged(tiny, adapters["t1"][1]),
                     prefix=True).generate([p], 6, _greedy())
    assert out[rid_base] == plain_base(tiny, base_p)
    assert [out[late[0]]] == expect
    assert eng.generate([p], 6, _greedy("t1")) == expect
    assert eng.stats()["prefix"]["hit_pages"] >= 2
    hits = eng.stats()["prefix"]["hit_pages"]
    plain = _engine(tiny, prefix=True)
    assert eng.generate([p], 6, _greedy()) == plain.generate(
        [p], 6, _greedy())
    assert eng.stats()["prefix"]["hit_pages"] == hits
    with pytest.raises(RuntimeError, match="unresolved"):
        eng._lora_ids([1, -1])
    assert eng.leak_free()


def test_republish_mid_decode_keeps_pinned_version_factors(tiny, adapters):
    """A request decoding under v1 when the tenant republishes v2, with
    a co-batched request resolving v2 while the v1 pin is live: both
    finish under their own version's factors, as in the JAX engine."""
    _jcfg, _jp, tcfg, _tp = tiny
    p1 = _prompt(8, tcfg.vocab_size, seed=13)
    p2 = _prompt(8, tcfg.vocab_size, seed=14)

    def run(eng, store, greedy, v2):
        rid1 = eng.submit(p1, 8, greedy("t1"))
        out = {rid1: []}
        rid2 = None
        while eng.has_work():
            for (rid, tok, _d) in eng.step():
                out[rid].append(int(tok))
            if rid2 is None:
                store.put("t1", v2, scale=0.5)
                rid2 = eng.submit(p2, 4, greedy("t1"))
                out[rid2] = []
        return out[rid1], out[rid2]

    store = _store_with(adapters, ids=("t1",))
    got = run(_engine(tiny, lora=_lcfg(), adapter_store=store), store,
              _greedy, adapters["t2"][1])
    jstore = _jstore_with(adapters, ids=("t1",))
    want = run(_jengine(tiny, lora=_jlcfg(), adapter_store=jstore), jstore,
               _jgreedy, adapters["t2"][0])
    assert got == want
    assert got[0] == _engine(tiny, params=_merged(
        tiny, adapters["t1"][1])).generate([p1], 8, _greedy())[0]
    assert got[1] == _engine(tiny, params=_merged(
        tiny, adapters["t2"][1])).generate([p2], 4, _greedy())[0]


def test_bad_geometry_publish_is_typed_not_fatal(tiny, adapters):
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters, ids=("t1",))
    store.put("bad", tlora.init_adapter(
        tcfg, _lcfg(rank=7), torch.Generator().manual_seed(9),
        random_b=True, device="cpu"))
    eng = _engine(tiny, lora=_lcfg(), adapter_store=store)
    p = _prompt(8, tcfg.vocab_size, seed=15)
    rid_bad = eng.submit(p, 4, _greedy("bad"))
    rid_ok = eng.submit(p, 4, _greedy("t1"))
    got_ok, bad_err = [], None
    while eng.has_work():
        for ev in eng.step():
            rid, tok, _d = ev
            if rid == rid_bad and ev.error is not None:
                bad_err = ev.error
            elif rid == rid_ok and ev.error is None:
                got_ok.append(tok)
    assert isinstance(bad_err, AdapterUnavailableError)
    assert "do not fit" in str(bad_err)
    assert len(got_ok) == 4
    assert eng.leak_free() and store.stats()["in_flight"] == 0
    with pytest.raises(AdapterUnavailableError, match="do not fit"):
        eng.load_adapter("bad2", tlora.init_adapter(tcfg, _lcfg(rank=7),
                                                     device="cpu"))


def test_submit_rejections_are_typed(tiny, adapters):
    _jcfg, _jp, tcfg, _tp = tiny
    p = _prompt(6, tcfg.vocab_size)
    with pytest.raises(AdapterUnavailableError, match="without adapter"):
        _engine(tiny).submit(p, 4, _greedy("t1"))
    eng = _engine(tiny, lora=_lcfg(),
                  adapter_store=_store_with(adapters, ids=("t1",)))
    with pytest.raises(AdapterUnavailableError, match="never published"):
        eng.submit(p, 4, _greedy("ghost"))
    assert not eng.has_work() and eng.leak_free()


def test_chaos_adapter_load_fault_and_delay(tiny, adapters):
    """An injected ``serve.adapter_load`` fault retires the waiting
    request with the typed error while the resident tenant decodes; the
    ``:delay=`` flavor completes."""
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters)
    eng = _engine(tiny, lora=_lcfg(), adapter_store=store)
    p = _prompt(8, tcfg.vocab_size, seed=9)
    eng.generate([p], 4, _greedy("t1"))
    plan = chaos.install_faults("serve.adapter_load@1")
    rid_ok = eng.submit(p, 5, _greedy("t1"))
    rid_bad = eng.submit(_prompt(8, tcfg.vocab_size, seed=10), 5,
                         _greedy("t2"))
    got_ok, bad_err = [], None
    while eng.has_work():
        for ev in eng.step():
            rid, tok, _d = ev
            if rid == rid_bad and ev.error is not None:
                bad_err = ev.error
            elif rid == rid_ok and ev.error is None:
                got_ok.append(tok)
    assert isinstance(bad_err, AdapterUnavailableError)
    assert len(got_ok) == 5
    assert plan.fired == [("serve.adapter_load", 1)]
    chaos.clear_faults()
    chaos.install_faults("serve.adapter_load@1:delay=0.05")
    assert eng.generate([p], 4, _greedy("t2"))
    chaos.clear_faults()
    assert eng.leak_free() and store.stats()["in_flight"] == 0
    assert eng.adapters.pinned_total == 0


def test_leak_audit_covers_adapter_pins_and_store(tiny, adapters):
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters, ids=("t1",))
    eng = _engine(tiny, lora=_lcfg(), adapter_store=store)
    eng.generate([_prompt(6, tcfg.vocab_size)], 4, _greedy("t1"))
    assert eng.leak_free()
    eng.adapters.pin("t1", 1)
    assert not eng.leak_free()
    eng.adapters.unpin("t1", 1)
    assert eng.leak_free()
    store.checkout("t1")
    assert not eng.leak_free()
    store.checkin()
    assert eng.leak_free()


def test_disaggregated_handoff_carries_the_adapter(tiny, adapters):
    """A tenant's first-token-stop prefill exported from one engine and
    imported by another decodes under the same pinned version: the
    stream equals a co-located run, and the handoff's chain hashes are
    salted."""
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters, ids=("t1",))
    pre = _engine(tiny, lora=_lcfg(), adapter_store=store)
    dec = _engine(tiny, lora=_lcfg(), adapter_store=store)
    p = _prompt(20, tcfg.vocab_size, seed=21)
    rid = pre.submit(p, 1, _greedy("t1"), hold_pages=True)
    first = _drain(pre, [rid])[0]
    h = pre.export_request(rid)
    assert h.model_id == "t1" and h.adapter_version == 1
    assert h.chain_hashes == tgpt_chain(p, tad.salt_bytes("t1", 1))
    rid2 = dec.import_submit(h, max_new_tokens=5, sampling=_greedy("t1"))
    rest = _drain(dec, [rid2])[0]
    colocated = _engine(tiny, lora=_lcfg(), adapter_store=store).generate(
        [p], 6, _greedy("t1"))[0]
    assert first + rest == colocated
    assert pre.leak_free() and dec.leak_free()


def tgpt_chain(tokens, salt):
    from ray_tpu_torch.inference import kv_cache as kvc
    return kvc.PrefixIndex.chain_hashes(tokens, _KW["page_size"], salt=salt)


# ------------------------------------------------ adapter-only training
def test_adapter_only_training_identity_grads_and_publish(tiny, adapters):
    """``build_gpt_train(lora=...)``: step 0 is exactly the base model,
    the adapter's gradients equal ``jax.grad`` of the reference loss
    within 2e-5, training moves only the adapter (the base is
    bit-unchanged), and its publish payload is adapter-sized."""
    jcfg, jparams, tcfg, tparams = tiny
    lcfg = _lcfg()
    fns = ttrain.build_gpt_train(tcfg, lora=lcfg, base_params=tparams,
                                 telemetry=False, device="cpu")
    full = ttrain.build_gpt_train(tcfg, telemetry=False, device="cpu")
    st = fns["init_fn"](torch.Generator().manual_seed(1))
    assert fns["lora"] == lcfg
    assert sorted(st.params) == sorted(
        k for t in ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
        for k in (f"{t}_a", f"{t}_b"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    targets = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "targets": torch.from_numpy(targets).long()}
    assert float(fns["loss_fn"](st.params, batch)) == pytest.approx(
        float(full["loss_fn"](tparams, batch)), abs=1e-5)

    # gradients of a non-identity adapter against the reference's
    ja, ta = adapters["t1"]
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    jloss, jgrads = jax.value_and_grad(lambda a: jgpt.loss_fn(
        jparams, jbatch, jcfg, lora={**a, "scale": 0.5}))(ja)
    loss, grads = fns["value_and_grad_fn"](
        {k: v.clone() for k, v in ta.items()}, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(g),
                                   atol=2e-5, rtol=2e-5, err_msg=k)

    before = {k: v.clone() for k, v in tparams["layers"].items()}
    losses = []
    for _ in range(4):
        st, m = fns["step_fn"](st, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for k, v in tparams["layers"].items():
        assert torch.equal(v, before[k]), k
    store = AdapterStore(use_object_store=False)
    assert store.put("tenant", st.params) == 1
    nbytes = tad.adapter_nbytes(st.params)
    assert store.stats()["bytes_published"] == nbytes
    assert nbytes < tgpt.num_params(tparams) * 4 / 10
    with pytest.raises(ValueError, match="base_params"):
        ttrain.build_gpt_train(tcfg, lora=lcfg, telemetry=False,
                               device="cpu")


def test_rl_learner_publishes_adapter_sized_versions(tiny, adapters):
    """The learner half of the reference's adapter-only training test:
    an adapter-only ``InProcessLearner`` over the reference's base takes
    an RL step whose gradients equal the reference learner's, its
    publications are adapter-sized and versioned, and a full-weights
    learner refuses adapter publication."""
    from ray_tpu.rl.learner import InProcessLearner as JLearner
    from ray_tpu_torch.rl.learner import InProcessLearner
    jcfg, jparams, tcfg, tparams = tiny
    lcfg = _lcfg()
    learner = InProcessLearner(tcfg, lora=lcfg, base_params=tparams, seed=3,
                               device="cpu")
    jl = JLearner(jcfg, lora=_jlcfg(), base_params=jparams, seed=3)
    ja, ta = adapters["t1"]
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (4, 24)
                                    ).astype(np.int32),
             "targets": rng.integers(0, tcfg.vocab_size, (4, 24)
                                     ).astype(np.int32),
             "rewards": rng.standard_normal(4).astype(np.float32)}
    (jloss, _jm), jgrads = jl.fns["pg_grad_fn"](ja, batch)
    (loss, _m), grads = learner.fns["pg_grad_fn"](ta, batch)
    # the loss cancels per-row terms of ~100 (24 action tokens each) to
    # ~0.04: summation order moves it by ~1e-7 of the terms
    assert float(loss) == pytest.approx(float(jloss), abs=2e-5)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(g),
                                   atol=2e-5, rtol=2e-5, err_msg=k)
    learner.update(batch)
    store = AdapterStore(use_object_store=False)
    assert learner.publish_adapter(store, "tenant-rl") == 1
    assert learner.publish_adapter(store, "tenant-rl") == 2
    nbytes = tad.adapter_nbytes(learner.params_host())
    assert store.stats()["bytes_published"] == 2 * nbytes
    assert nbytes < tgpt.num_params(tparams) * 4 / 10
    plain = InProcessLearner(tcfg, fns=ttrain.build_gpt_rl_train(
        tcfg, device="cpu"))
    with pytest.raises(ValueError, match="WeightStore"):
        plain.publish_adapter(store, "x")


def test_rl_published_adapter_serves_merged_parity(tiny):
    """The RL -> serve seam: train adapter-only through the RL learner,
    publish to the store, decode under the tenant; the stream equals an
    engine serving the merged weights."""
    from ray_tpu_torch.rl.learner import InProcessLearner
    _jcfg, _jp, tcfg, tparams = tiny
    lcfg = _lcfg(scale=1.0)
    learner = InProcessLearner(tcfg, lora=lcfg, base_params=tparams, seed=4,
                               device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (4, 24)
                                    ).astype(np.int32),
             "targets": rng.integers(0, tcfg.vocab_size, (4, 24)
                                     ).astype(np.int32),
             "rewards": rng.standard_normal(4).astype(np.float32)}
    for _ in range(2):
        learner.update(batch)
    store = AdapterStore(use_object_store=False)
    learner.publish_adapter(store, "tenant-rl")
    eng = _engine(tiny, lora=lcfg, adapter_store=store)
    p = _prompt(8, tcfg.vocab_size, seed=12)
    out = eng.generate([p], 8, _greedy("tenant-rl"))
    _, host, scale = store.get("tenant-rl")
    ref = _engine(tiny, params=tlora.merge_adapter(tparams, host, tcfg,
                                                   scale=scale))
    assert out == ref.generate([p], 8, _greedy())
    assert eng.leak_free()


# --------------------------------------------------------------- fleet
def _fcfg(**over):
    from ray_tpu_torch.fleet import FleetConfig
    base = dict(retries=2, affinity=True, affinity_cap=8,
                adapter_affinity=True, up_depth=4.0, ttft_slo=0.0,
                dwell=1.0, backoff=1.0, backoff_max=8.0, hedge=False)
    base.update(over)
    return FleetConfig(**base)


def _tel():
    from ray_tpu_torch.telemetry.config import TelemetryConfig
    from ray_tpu_torch.telemetry.fleet import FleetTelemetry
    return FleetTelemetry(config=TelemetryConfig(enabled=True))


def test_fleet_multitenant_acceptance(tiny, adapters):
    """Two replicas serving two tenants and base traffic: each stream
    equals the JAX engine's solo merged run; a mid-traffic republish
    resolves to the new version and writes the banks in place; every
    audit is clean after the drain."""
    from ray_tpu_torch.fleet import EngineReplica, FleetRouter
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters)
    reps = [EngineReplica(f"r{i}", _engine(tiny, lora=_lcfg(),
                                           adapter_store=store))
            for i in range(2)]
    router = FleetRouter(reps, cfg=_fcfg(), rng_seed=0, telemetry=_tel())
    prompts = [_prompt(8, tcfg.vocab_size, seed=s) for s in (1, 2, 3)]
    tenants = ["t1", "t2", None]
    jparams = tiny[1]
    solo = [_jengine(tiny, params=jlora.merge_adapter(
        jparams, adapters[t][0], tiny[0], scale=0.5) if t else jparams)
        .generate([p], 6, _jgreedy())[0] for p, t in zip(prompts, tenants)]
    streams = [router.remote({"tokens": p, "max_new_tokens": 6,
                              "model_id": t})
               for p, t in zip(prompts, tenants)]
    assert [s.result() for s in streams] == solo
    ptrs = [{k: v.data_ptr() for k, v in r.engine.lora_bank.items()}
            for r in reps]
    live = [router.remote({"tokens": p, "max_new_tokens": 6,
                           "model_id": t})
            for p, t in zip(prompts, tenants)]
    router.poll()
    store.put("t1", adapters["t2"][1], scale=0.5)
    assert [s.result() for s in live] == solo
    ref2 = _engine(tiny, params=_merged(tiny, adapters["t2"][1]))
    s = router.remote({"tokens": prompts[0], "max_new_tokens": 6,
                       "model_id": "t1"})
    assert s.result() == ref2.generate([prompts[0]], 6, _greedy())[0]
    assert [{k: v.data_ptr() for k, v in r.engine.lora_bank.items()}
            for r in reps] == ptrs
    for r in reps:
        while r.engine.has_work():
            r.step()
        assert r.leak_free()
        assert r.engine.adapters.pinned_total == 0
    assert store.stats()["in_flight"] == 0
    assert router.stats()["adapter_store"]["models"] == 2


def test_router_adapter_affinity_vs_residency_blind(tiny, adapters):
    from ray_tpu_torch.fleet import EngineReplica, FleetRouter
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters)
    cold = EngineReplica("cold", _engine(tiny, lora=_lcfg(),
                                         adapter_store=store))
    warm = EngineReplica("warm", _engine(tiny, lora=_lcfg(),
                                         adapter_store=store))
    p = _prompt(8, tcfg.vocab_size, seed=3)
    warm.engine.generate([p], 2, _greedy("t1"))
    assert "t1" in warm.adapter_digest()
    assert "t1" not in cold.adapter_digest()
    loads_before = warm.engine.adapters.loads
    router = FleetRouter([cold, warm], cfg=_fcfg(), rng_seed=0,
                         telemetry=_tel())
    for seed in range(4):
        s = router.remote({"tokens": _prompt(8, tcfg.vocab_size, seed=seed),
                           "max_new_tokens": 2, "model_id": "t1"})
        s.result()
        assert s.replica_id == "warm"
    assert warm.engine.adapters.loads == loads_before
    blind = FleetRouter([cold, warm], cfg=_fcfg(adapter_affinity=False),
                        rng_seed=0, telemetry=_tel())
    picks = set()
    for seed in range(6):
        s = blind.remote({"tokens": _prompt(8, tcfg.vocab_size,
                                            seed=10 + seed),
                          "max_new_tokens": 2, "model_id": "t1"})
        s.result()
        picks.add(s.replica_id)
    assert "cold" in picks


def test_fleet_reroute_on_adapter_unavailable(tiny, adapters):
    from ray_tpu_torch.fleet import EngineReplica, FleetRouter
    _jcfg, _jp, tcfg, _tp = tiny
    store = _store_with(adapters)
    good = EngineReplica("good", _engine(tiny, lora=_lcfg(),
                                         adapter_store=store))
    bad = EngineReplica("bad", _engine(tiny, lora=_lcfg(),
                                       adapter_store=store))
    orig = bad.submit

    def reject(prompt, **kw):
        sampling = kw.get("sampling")
        if sampling is not None and sampling.model_id:
            raise AdapterUnavailableError(sampling.model_id,
                                          "bank pinned full")
        return orig(prompt, **kw)

    bad.submit = reject
    tel = _tel()
    router = FleetRouter([bad, good], cfg=_fcfg(adapter_affinity=False),
                         rng_seed=0, telemetry=tel)
    outs = []
    for seed in range(4):
        s = router.remote({"tokens": _prompt(8, tcfg.vocab_size, seed=seed),
                           "max_new_tokens": 2, "model_id": "t1"})
        outs.append(s.result())
        assert s.replica_id == "good"
    assert all(len(o) == 2 for o in outs)
    assert tel.retries.get("adapter", 0) >= 1


def test_adapter_converters_check_geometry(tiny, adapters):
    jcfg, _jp, tcfg, _tp = tiny
    ja, ta = adapters["t1"]
    for k, v in ja.items():
        assert np.array_equal(ta[k].numpy(), np.asarray(v))
    bad = dict(jax.tree.map(np.asarray, ja))
    bad["wq_a"] = bad["wq_a"][:, :, :2]
    with pytest.raises(ValueError, match="wq_a"):
        adapter_from_jax(bad, tcfg, _lcfg(), device="cpu")
