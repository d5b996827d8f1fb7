"""Port parity for speculative decoding: ``ray_tpu_torch.inference``'s
self-drafter, exact acceptance and verify forward against the JAX package.

- The drafter (``spec.DraftState``) and ``accept_drafts`` give the JAX
  package's answers on seeded random and motif streams.
- Both engines serve the same model (``SMALL``, f32, the JAX weights
  converted by ``params_from_jax``) with ``slots=2, page_size=16`` and
  prefix caching on, through the same submit/step schedule with
  speculation on at k = 1, 4 and 8, in the model dtype and with the int8
  KV cache: the events must be equal, the logits rows each token was
  drawn from equal within 2e-4 (f32 through two layers), and the spec
  counters (proposed, accepted, the accepted-per-verify histogram) equal.
  With int8 the port's spec run is held to the JAX package's spec run:
  a verify reads its own rows at full precision where decode reads int8
  codes, so spec and plain may part there.
- The rest are the port's counterparts of ``tests/test_spec.py``: spec
  against plain decode within the port (greedy across accept regimes,
  sampled trajectory-exact, EOS inside an accepted block, co-batching),
  the rollback leak audit with prefix sharing, the stats block, drain,
  validation and the env knobs.  The disaggregated import case is left
  to the serving slice (ROADMAP Queue 1, ``serve_gpt`` and the fleet).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import InferenceEngine as JaxEngine
from ray_tpu.inference import SamplingParams as JaxSamplingParams
from ray_tpu.inference import engine as jengine
from ray_tpu.inference.sampling import accept_drafts as jax_accept
from ray_tpu.inference.spec import DraftState as JaxDraftState
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.inference import InferenceEngine, SamplingParams
from ray_tpu_torch.inference import engine as tengine
from ray_tpu_torch.inference.sampling import accept_drafts
from ray_tpu_torch.inference.spec import DraftState
from ray_tpu_torch.models import gpt as tgpt

SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
             max_seq=256)
GEOMETRY = dict(slots=2, page_size=16, buckets=(16, 32, 64, 128))
# compiled steps of this file's JAX engines
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


def _motif_prompt(seed, shared=24, motif=6, reps=4, prefix_seed=None):
    """Templated traffic: a random prefix, then a motif repeated verbatim
    (the drafter locks onto its period at once).  Requests with the same
    ``prefix_seed`` share the prefix's first page."""
    rng = np.random.RandomState(seed)
    head = _prompt(shared, prefix_seed) if prefix_seed is not None else \
        [int(t) for t in rng.randint(0, 512, shared)]
    return head + [int(t) for t in rng.randint(0, 512, motif)] * reps


def _engine(models, **kw):
    _j, _jp, tcfg, tparams = models
    return InferenceEngine(tcfg, tparams, device="cpu", **{**GEOMETRY, **kw})


def _spec(k=4, **kw):
    return SamplingParams(spec=True, spec_k=k, **kw)


# ------------------------------------------------------------- the drafter
def _streams(rng):
    """Seeded token streams with repeats at every distance: small-vocab
    random, motif runs, and a loop that breaks off."""
    yield [int(t) for t in rng.randint(0, 4, 60)]
    yield [int(t) for t in rng.randint(0, 50, 60)]
    motif = [int(t) for t in rng.randint(0, 512, 5)]
    yield [int(t) for t in rng.randint(0, 512, 10)] + motif * 6
    yield [7, 8] * 10 + [int(t) for t in rng.randint(0, 9, 30)]


@pytest.mark.parametrize("max_n", [1, 2, 3, 4])
def test_draftstate_proposals_match_jax(max_n):
    """Every proposal for k = 1..8 after every appended token (the
    engine's sync pattern: a prompt, then generated tokens one block at a
    time) equals the JAX package's ``DraftState``'s."""
    rng = np.random.RandomState(max_n)
    checked = 0
    for stream in _streams(rng):
        for cut in (1, 5, 17):
            prompt = stream[:cut]
            ours, ref = DraftState(prompt, max_n), JaxDraftState(prompt,
                                                                 max_n)
            t = cut
            while t <= len(stream):
                generated = stream[cut:t]
                ours.sync(prompt, generated)
                ref.sync(prompt, generated)
                assert ours.tokens == ref.tokens
                for k in range(1, 9):
                    got = ours.propose(k)
                    assert got == ref.propose(k), (stream, t, k)
                    checked += bool(got)
                t += int(rng.randint(1, 4))
    assert checked > 100      # the streams do repeat themselves


def test_draftstate_period_extension_and_budget():
    """``tests/test_spec.py``'s drafter cases: the tight loop unrolls to
    the full budget, a long-range copy continues the template, nothing
    matches itself, and the budget halves per n-gram step down."""
    ds = DraftState([5, 9, 5, 9, 5, 9])
    assert ds.propose(4) == [5, 9, 5, 9] and ds.propose(1) == [5]
    a, b = [10, 11, 12, 13], [20, 21, 22, 23]
    assert DraftState(a + b + a).propose(3) == b[:3]
    assert DraftState([1, 2, 3, 4]).propose(4) == []
    assert DraftState([]).propose(4) == [] == DraftState([7]).propose(4)
    ds = DraftState([1, 2, 3, 9, 4, 5, 9])
    assert ds.propose(4) == [4] and ds.propose(8) == [4, 5]
    assert len(DraftState([5, 9, 5, 9, 5, 9]).propose(8)) == 8


def test_draftstate_sync_is_incremental_and_idempotent():
    prompt = [3, 1, 4, 1, 5]
    ds = DraftState(prompt)
    ds.sync(prompt, [9, 2])
    ds.sync(prompt, [9, 2])
    assert len(ds) == 7
    ds.sync(prompt, [9, 2, 6])
    assert len(ds) == 8 and ds.tokens[-1] == 6
    with pytest.raises(ValueError):
        DraftState([], max_n=0)


def test_spec_module_is_the_ports_own_pure_python_copy():
    """``ray_tpu_torch/inference/spec.py`` imports only ``typing`` (and
    ``__future__``), like the JAX package's, and nothing of ``ray_tpu``."""
    path = pathlib.Path(tengine.__file__).with_name("spec.py")
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= {"__future__", "typing"}, roots


def test_accept_drafts_matches_jax():
    """The exact-prefix rule: the cases of ``tests/test_spec.py`` and 500
    random ones over a 3-token alphabet (many partial matches)."""
    sampled = [5, 6, 7, 8, 9]
    assert accept_drafts(sampled, [5, 6, 7, 8]) == (4, [5, 6, 7, 8, 9])
    assert accept_drafts(sampled, [5, 0, 7, 8]) == (1, [5, 6])
    assert accept_drafts(sampled, [0, 6, 7, 8]) == (0, [5])
    assert accept_drafts(sampled, [0, 6]) == (0, [5])
    rng = np.random.RandomState(0)
    hist = {}
    for _ in range(500):
        k = int(rng.randint(1, 9))
        drafts = rng.randint(0, 3, k).tolist()
        sampled = rng.randint(0, 3, k + 1).tolist()
        sampled[:k] = [d if rng.rand() < 0.7 else s
                       for d, s in zip(drafts, sampled[:k])]
        got = accept_drafts(np.array(sampled, np.int32), drafts)
        assert got == jax_accept(np.array(sampled, np.int32), drafts)
        hist[got[0]] = hist.get(got[0], 0) + 1
    assert len(hist) >= 6


# --------------------------------------------- the verify's context mask
def test_cached_context_attention_matches_jax_at_a_partial_page():
    """The context is the slot's first ``cached_len`` positions, not a
    page multiple: what lies past it in the gathered pages (here NaN in
    the port's pages, finite noise in the reference's, which masks it)
    contributes nothing."""
    rng = np.random.RandomState(1)
    S, H, D, C, cached = 5, 2, 16, 48, 37
    q, ks, vs = (rng.randn(1, S, H, D).astype(np.float32) for _ in range(3))
    kctx, vctx = (rng.randn(1, C, H, D).astype(np.float32)
                  for _ in range(2))
    want = jengine._cached_context_attention(
        *(jnp.asarray(a) for a in (q, kctx, vctx, ks, vs)), cached)
    kctx[:, cached:] = np.nan
    vctx[:, cached:] = np.nan
    got = tengine._cached_context_attention(
        *(torch.from_numpy(a) for a in (q, kctx, vctx, ks, vs)), cached)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_verify_reads_no_position_past_the_length(models, kv_dtype):
    """The verify forward's context is exactly the slot's first ``L``
    positions: filling every cache position at ``L`` and past it in the
    slot's pages (the partial page's tail included) with NaN changes
    none of its logits."""
    engine = _engine(models, kv_dtype=kv_dtype, prefix=False)
    rid = engine.submit(_motif_prompt(5), max_new_tokens=20)
    for _ in range(3):
        engine.step()
    (slot, req), = engine.scheduler.active.items()
    L = int(engine.scheduler.lengths[slot])
    assert L % 16                       # a partial page
    drafts = [1, 2, 3]
    tokens = torch.tensor([[req.generated[-1]] + drafts])
    row = torch.from_numpy(engine.scheduler.page_table[slot])
    with torch.inference_mode():
        want = engine._verify_step(tokens, L, 4, row)
        cache = engine.cache
        stores = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                       if cache.quantized else [])
        for pos in range(L, len(req.pages) * 16):
            page = req.pages[pos // 16]
            for t in stores:
                if t.dtype.is_floating_point:
                    t[:, page, pos % 16] = float("nan")
        got = engine._verify_step(tokens, L, 4, row)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert rid == req.rid


def test_decode_masks_speculating_rows_to_the_garbage_page(models):
    """A decode step with a speculating slot in ``skip`` writes nothing
    into that slot's pages, leaves its length alone and delivers it
    nothing; the other slot decodes as usual."""
    engine = _engine(models, prefix=False)
    r0 = engine.submit(_prompt(20, 1), max_new_tokens=8)
    r1 = engine.submit(_prompt(30, 2), max_new_tokens=8)
    engine.step()
    sched = engine.scheduler
    slots = {req.rid: slot for slot, req in sched.active.items()}
    spec_slot = slots[r1]
    pages = sched.active[spec_slot].pages
    before = engine.cache.k[:, pages].clone(), engine.cache.v[:, pages].clone()
    lengths = sched.lengths.copy()
    table = sched.page_table.copy()
    events = []
    with torch.inference_mode():
        engine._decode(events, skip={spec_slot})
    assert [ev[0] for ev in events] == [r0]
    assert torch.equal(engine.cache.k[:, pages], before[0])
    assert torch.equal(engine.cache.v[:, pages], before[1])
    assert sched.lengths[spec_slot] == lengths[spec_slot]
    assert sched.lengths[slots[r0]] == lengths[slots[r0]] + 1
    assert (sched.page_table == table).all()     # masked on a copy


# ------------------------------------------- the engine against the JAX one
def _drive_spec(engine, sp, plain):
    """Templated requests that join and leave mid-stream, speculating
    under ``sp``; the third shares the first one's prefix page (a hit),
    waits for a slot and decodes plainly under ``plain``, co-batched with
    the second's verifies."""
    events, rids = [], []

    def tick(n):
        for _ in range(n):
            events.extend(tuple(ev) for ev in engine.step())

    rids.append(engine.submit(_motif_prompt(1, prefix_seed=9),
                              max_new_tokens=24, sampling=sp))
    tick(3)
    rids.append(engine.submit(_motif_prompt(2, motif=5, reps=5),
                              max_new_tokens=20, sampling=sp))
    tick(2)
    rids.append(engine.submit(_motif_prompt(3, prefix_seed=9),
                              max_new_tokens=12, sampling=plain))
    rids.append(engine.submit(_prompt(33, 4), max_new_tokens=10,
                              sampling=sp))
    while engine.has_work():
        tick(1)
    return events, rids


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_greedy_spec_streams_match_jax_engine(models, kv_dtype, k):
    jcfg, jparams, tcfg, tparams = models
    jeng = JaxEngine(jcfg, jparams, telemetry=False, debug_logits=True,
                     executable_cache=_JAX_EXECUTABLES, kv_dtype=kv_dtype,
                     prefix=True, **GEOMETRY)
    teng = _engine(models, kv_dtype=kv_dtype, prefix=True,
                   debug_logits=True)
    jevents, jrids = _drive_spec(
        jeng, JaxSamplingParams(spec=True, spec_k=k),
        JaxSamplingParams(spec=False))
    tevents, trids = _drive_spec(teng, _spec(k), SamplingParams(spec=False))
    assert tevents == jevents
    for jr, tr in zip(jrids, trids):
        np.testing.assert_allclose(np.stack(teng.logits_trace[tr]),
                                   np.stack(jeng.logits_trace[jr]),
                                   atol=2e-4, rtol=2e-4)
    got, want = teng.stats()["spec"], jeng.stats()["spec"]
    assert got == want
    assert got["proposed"] > 0 and got["accepted"] > 0
    assert got["drafts"] == 0
    calls = teng.stats()["calls"]
    assert calls["verify"] == sum(got["k_hist"].values())
    assert calls["prefill_cached"] == 1 == \
        teng.stats()["prefix"]["requests_hit"]
    assert teng.leak_free()


# ------------------------------------------ spec against plain, in the port
@pytest.mark.parametrize("regime", ["high", "mid", "low"])
def test_greedy_parity_across_accept_regimes(models, regime):
    """Speculation does not show in the output at any accept rate: a
    repeated-token prompt (accept ~1), random prompts (mid) and a short
    random generation (almost every verify rolls back) give the plain
    engine's greedy tokens and logprobs."""
    if regime == "high":
        prompts = [_prompt(8, 13) + [47] * 24]
        max_new = 64
    elif regime == "mid":
        prompts = [_prompt(40, s) for s in (5, 6)]
        max_new = 32
    else:
        prompts = [_prompt(21, s) for s in (7, 8)]
        max_new = 6
    ref = _engine(models)
    want, want_lp = ref.generate(prompts, max_new_tokens=max_new,
                                 return_logprobs=True)
    eng = _engine(models)
    got, got_lp = eng.generate(prompts, max_new_tokens=max_new,
                               sampling=_spec(4), return_logprobs=True)
    assert got == want
    np.testing.assert_allclose(got_lp, want_lp, rtol=0, atol=2e-4)
    st = eng.stats()["spec"]
    assert st["proposed"] > 0
    if regime == "high":
        assert st["accept_rate"] > 0.8
    assert eng.stats()["free_pages"] == ref.stats()["free_pages"]
    assert eng.stats()["free_slots"] == 2 and st["drafts"] == 0
    assert eng.leak_free()


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0, top_k=50, top_p=0.95),   # tests/test_spec.py's
    dict(temperature=1.0, top_k=3, top_p=1.0),     # some drafts land
])
def test_sampled_parity_trajectory_exact(models, kw):
    """Sampled decode: verify row i draws the noise of ``(seed,
    len(generated) + i)``, as plain decode does at that position, so the
    sampled trajectory and each token's logprob are plain decode's."""
    prompts = [_prompt(8, 13) + [47] * 24, _motif_prompt(11),
               _prompt(40, 12)]
    sp = dict(kw, seed=1234)
    ref = _engine(models)
    greedy = ref.generate(prompts, max_new_tokens=40)
    want, want_lp = ref.generate(prompts, max_new_tokens=40,
                                 sampling=SamplingParams(**sp),
                                 return_logprobs=True)
    eng = _engine(models)
    got, got_lp = eng.generate(prompts, max_new_tokens=40,
                               sampling=_spec(4, **sp),
                               return_logprobs=True)
    assert got == want and got != greedy
    np.testing.assert_allclose(got_lp, want_lp, rtol=0, atol=2e-4)
    st = eng.stats()["spec"]
    assert st["proposed"] > 0
    if kw["top_k"] == 3:
        assert st["accepted"] > 0


def test_eos_inside_accepted_block(models):
    """An EOS inside an accepted block ends the request there, as plain
    decode does, and the rest of the block is dropped."""
    prompt = _motif_prompt(3)
    ref = _engine(models)
    (traj,) = ref.generate([prompt], max_new_tokens=48)
    eos = traj[len(traj) // 2]
    (want,) = ref.generate([prompt], max_new_tokens=48, eos_token=eos)
    assert want[-1] == eos and len(want) < 48
    eng = _engine(models)
    (got,) = eng.generate([prompt], max_new_tokens=48, sampling=_spec(4),
                          eos_token=eos)
    assert got == want
    st = eng.stats()
    assert st["free_slots"] == 2 and st["spec"]["drafts"] == 0
    assert eng.leak_free()


def test_mixed_spec_nonspec_cobatch_parity(models):
    """A speculating request and a plain one in one tick stream (the
    plain slot decodes beside the dead row while the other verifies)
    each give their solo run's tokens."""
    p_spec, p_plain = _motif_prompt(21), _prompt(40, 22)
    solo = _engine(models)
    (want_spec,) = solo.generate([p_spec], max_new_tokens=40)
    (want_plain,) = solo.generate([p_plain], max_new_tokens=40)
    eng = _engine(models)
    r1 = eng.submit(p_spec, max_new_tokens=40, sampling=_spec(4))
    r2 = eng.submit(p_plain, max_new_tokens=40,
                    sampling=SamplingParams(spec=False))
    out = {r1: [], r2: []}
    while eng.has_work():
        for r, tok, _d in eng.step():
            out[r].append(tok)
    assert out[r1] == want_spec and out[r2] == want_plain
    st = eng.stats()
    assert 0 < st["spec"]["accepted"] <= st["spec"]["proposed"]
    # the plain request decoded in every tick it was active: some of
    # them beside a verify
    assert st["calls"]["decode"] >= 39 and st["calls"]["verify"] > 0


def test_rollback_leak_fuzz_with_prefix_sharing(models):
    """Churn with speculation on over prompts that share prefix pages
    (motif and random, k in {2, 4, 8}, random lengths and EOS): hundreds
    of rolled-back tails, prefix hits and retirements inside blocks; the
    tokens equal a plain engine's and afterwards every page, slot and
    drafter state is back home."""
    rng = np.random.RandomState(9)
    shared = [_prompt(32, 300 + i) for i in range(2)]
    jobs = []
    for i in range(12):
        head = shared[i % 2] if i % 3 else []
        body = (_motif_prompt(100 + i, shared=4) if i % 2
                else _prompt(int(rng.randint(8, 40)), 200 + i))
        eos = int(rng.randint(0, 512)) if i % 4 == 0 else None
        jobs.append((head + body, int(rng.randint(4, 40)), eos,
                     int(rng.choice([2, 4, 8]))))

    def run(spec):
        eng = _engine(models, prefix=True, num_pages=16)
        free0 = eng.stats()["free_pages"]
        rids = [eng.submit(p, max_new_tokens=n, eos_token=e,
                           sampling=_spec(k) if spec else None)
                for p, n, e, k in jobs]
        out = {r: [] for r in rids}
        while eng.has_work():
            for r, tok, _d in eng.step():
                out[r].append(tok)
            assert eng.leak_free()
        return eng, free0, [out[r] for r in rids]

    ref, _free, want = run(False)
    eng, free0, got = run(True)
    assert got == want
    st = eng.stats()
    assert st["spec"]["k_hist"].get(0, 0) > 0      # rejections happened
    assert st["prefix"]["requests_hit"] > 0
    assert st["free_pages"] == free0 and st["free_slots"] == 2
    assert st["spec"]["drafts"] == 0 and st["active"] == 0
    assert eng.leak_free() and not eng.scheduler.allocator._refcount


def test_stats_block_and_drain_clears_drafts(models):
    eng = _engine(models)
    eng.submit(_prompt(8, 13) + [47] * 24, max_new_tokens=40,
               sampling=_spec(4))
    eng.submit(_prompt(30, 42), max_new_tokens=40)
    for _ in range(6):
        eng.step()
    st = eng.stats()["spec"]
    assert set(st) == {"proposed", "accepted", "accept_rate", "k_hist",
                       "drafts"}
    assert st["drafts"] == 1 and st["proposed"] > 0
    assert 0.0 <= st["accept_rate"] <= 1.0
    assert sum(st["k_hist"].values()) == eng.stats()["calls"]["verify"]
    assert eng.drain_requests() == 2
    st = eng.stats()
    assert st["spec"]["drafts"] == 0
    assert st["active"] == 0 and st["free_slots"] == 2
    assert eng.leak_free() and not eng.has_work()


def test_spec_k_validation(models):
    _j, _jp, tcfg, tparams = models
    with pytest.raises(ValueError, match="spec_k"):
        InferenceEngine(tcfg, tparams, device="cpu", spec=True, spec_k=0,
                        **GEOMETRY)
    eng = _engine(models)
    with pytest.raises(ValueError, match="spec_k"):
        eng.submit([1, 2, 3], sampling=_spec(-1))
    assert not eng.has_work()
    # spec off: spec_k is not consulted
    eng.submit([1, 2, 3], sampling=SamplingParams(spec=False, spec_k=0))
    assert eng.scheduler.waiting[0].spec_k == 0


def test_spec_env_knobs(models, monkeypatch, capsys):
    """RAY_TPU_INFER_SPEC and RAY_TPU_INFER_SPEC_K set the engine's
    defaults (off and 4 unset; under 1 falls back to 4 with a line on
    stderr); constructor arguments pin them, and a request's
    ``SamplingParams`` overrides them."""
    from ray_tpu_torch.inference.config import infer_config
    cfg = infer_config(refresh=True)
    assert (cfg.spec, cfg.spec_k) == (False, 4)
    assert _engine(models).spec is False
    try:
        monkeypatch.setenv("RAY_TPU_INFER_SPEC", "1")
        monkeypatch.setenv("RAY_TPU_INFER_SPEC_K", "8")
        infer_config(refresh=True)
        eng = _engine(models)
        assert (eng.spec, eng.spec_k) == (True, 8)
        eng.submit([1, 2, 3])
        eng.submit([1, 2, 3], sampling=SamplingParams(spec_k=2))
        eng.submit([1, 2, 3], sampling=SamplingParams(spec=False))
        assert [r.spec_k for r in eng.scheduler.waiting] == [8, 2, 0]
        assert _engine(models, spec=False, spec_k=3).spec is False
        monkeypatch.setenv("RAY_TPU_INFER_SPEC_K", "0")
        assert infer_config(refresh=True).spec_k == 4
        assert "RAY_TPU_INFER_SPEC_K=0 < 1; using 4" in \
            capsys.readouterr().err
    finally:
        monkeypatch.delenv("RAY_TPU_INFER_SPEC")
        monkeypatch.delenv("RAY_TPU_INFER_SPEC_K")
        infer_config(refresh=True)
    eng = _engine(models)
    eng.submit([1, 2, 3], sampling=SamplingParams(spec=True))
    assert eng.scheduler.waiting[0].spec_k == 4
