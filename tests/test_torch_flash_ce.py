"""Port parity: ``ray_tpu_torch.ops.flash_ce`` against the JAX package.

The JAX side is ``ray_tpu.ops.flash_ce`` with its Pallas kernels in
interpret mode (small blocks, as ``tests/test_ops.py`` runs them); the
port side, on CPU tensors, is the autograd.Function the card runs, with
the plain bodies the CUDA kernels are held against.

Tolerance: f32 on both sides.  The loss is a sum of N log-sum-exps over
V logits, held to 1e-5 of itself; each gradient to 1e-4 of its own
largest value (the JAX suite's grad bound, tests/test_ops.py:545).  dhead
sums N rows and dx sums V columns, so summation order moves them by
~1e-6 of their scale, while a wrong mask, a leaked padded column or a
missing rounding point moves them by 1e-3 or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_ce as JC
from ray_tpu_torch.ops import flash_ce as TC

BLOCKS = dict(block_n=128, block_v=256, bwd_block_n=128, bwd_block_v=256)


def _inputs(N, d, V, seed, masked="some"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, d)).astype(np.float32)
    head = (rng.standard_normal((d, V)) * 0.05).astype(np.float32)
    tgt = rng.integers(0, V, N).astype(np.int32)
    if masked == "some":
        tgt[::5] = -1
    elif masked == "all":
        tgt[:] = -1
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, head, tgt, scale


def _run_jax(x, head, tgt, scale, norm):
    def f(x, head, scale):
        if norm:
            s, n = JC.flash_ce_norm_sum(x, head, jnp.asarray(tgt), scale,
                                        eps=1e-6, **BLOCKS)
        else:
            s, n = JC.flash_ce_sum(x, head, jnp.asarray(tgt), **BLOCKS)
        return s / jnp.maximum(n, 1.0), n

    (loss, n), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(a) for a in (x, head, scale)))
    return float(loss), float(n), [np.asarray(g) for g in grads]


def _run_port(x, head, tgt, scale, norm):
    xt, ht, st = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, head, scale))
    if norm:
        s, n = TC.flash_ce_norm_sum(xt, ht, torch.from_numpy(tgt), st,
                                    eps=1e-6)
    else:
        s, n = TC.flash_ce_sum(xt, ht, torch.from_numpy(tgt))
    loss = s / n.clamp_min(1.0)
    loss.backward()
    grads = [t.grad.numpy() if t.grad is not None else np.zeros(t.shape,
                                                                np.float32)
             for t in (xt, ht, st)]
    return float(loss.detach()), float(n), grads


@pytest.mark.parametrize("N, d, V, norm", [
    (256, 128, 512, False),    # exact tiles
    (200, 128, 1000, False),   # ragged rows, V not a multiple of 128
    (64, 256, 384, True),      # d = 256, the norm prologue
    (200, 128, 1000, True),    # the prologue on ragged rows and vocab
])
def test_flash_ce_matches_jax(N, d, V, norm):
    x, head, tgt, scale = _inputs(N, d, V, seed=N + V)
    assert TC.supports(N, d, V) and JC.supports(N, d, V)
    lj, nj, gj = _run_jax(x, head, tgt, scale, norm)
    lt, nt, gt = _run_port(x, head, tgt, scale, norm)
    assert nt == nj == float((tgt >= 0).sum())
    assert lt == pytest.approx(lj, rel=1e-5)
    names = ["dx", "dhead"] + (["dscale"] if norm else [])
    for name, got, want in zip(names, gt, gj):
        err = np.abs(got - want).max() / max(1e-8, np.abs(want).max())
        assert err < 1e-4, (name, err)


@pytest.mark.parametrize("norm", [False, True])
def test_flash_ce_all_masked(norm):
    """Every target -1 (test_ops.py:628, :951): zero loss, zero count
    and zero gradients, with no NaN from the empty normalisation, on
    both sides."""
    x, head, tgt, scale = _inputs(64, 128, 384, seed=7, masked="all")
    lj, nj, gj = _run_jax(x, head, tgt, scale, norm)
    lt, nt, gt = _run_port(x, head, tgt, scale, norm)
    assert lt == lj == 0.0 and nt == nj == 0.0
    for got, want in zip(gt, gj):
        assert np.isfinite(got).all()
        assert np.abs(got).max() == 0.0 and np.abs(want).max() == 0.0


def test_flash_ce_kernel_plain_versions_match_dense():
    """The forward kernel's plain version gives the dense formulation's
    statistics, and the backward's plain version its gradients, with the
    head in the kernel's [V, d] layout (what the card's kernels read)."""
    x, head, tgt, _ = _inputs(96, 128, 300, seed=3)
    xt, wt, tt = (torch.from_numpy(x), torch.from_numpy(head.T.copy()),
                  torch.from_numpy(tgt))
    lse, true = TC.plain_flash_ce_fwd(xt, wt, tt)
    logits = x @ head
    m = logits.max(-1)
    want = m + np.log(np.exp(logits - m[:, None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)
    live = tgt >= 0
    np.testing.assert_allclose(true.numpy()[live],
                               logits[live, tgt[live]], atol=1e-5)
    assert (true.numpy()[~live] == 0).all()


@pytest.mark.parametrize("kw, ok, fragment", [
    ({}, True, "prologue"),
    (dict(enabled=False), False, "fuse_norm"),
    (dict(mode="xla"), False, "declined"),
    (dict(norm="layernorm"), False, "only rmsnorm"),
    (dict(has_bias=True), False, "bias"),
    (dict(n_devices=2), False, "declined"),
])
def test_uses_flash_ce_norm_matches_jax_gate(kw, ok, fragment):
    """The port's gate takes the JAX gate's arguments (with ``enabled``
    pinned, as the model passes it) and reaches the same verdict."""
    args = (2048, 768, 50304)
    want = JC.uses_flash_ce_norm(*args, **{"enabled": True, **kw})
    got = TC.uses_flash_ce_norm(*args, **kw)
    assert bool(got) == bool(want) == ok
    assert fragment in got.reason


def test_flash_ce_declined_shape_takes_the_dense_path():
    """d % 128 != 0: both packages fall back to the dense formulation."""
    x, head, tgt, _ = _inputs(64, 96, 256, seed=6)
    assert not TC.supports(64, 96, 256)
    s, n = TC.flash_ce_sum(*(torch.from_numpy(a) for a in (x, head, tgt)))
    s_j, n_j = JC._xla_ce_sum(*(jnp.asarray(a) for a in (x, head, tgt)))
    assert float(n) == float(n_j)
    assert float(s) == pytest.approx(float(s_j), rel=1e-5)


# ---------------------------------------------------------------------------
# the bf16 kernels' order of work, in their plain versions
# ---------------------------------------------------------------------------

def _tiled_inputs(N, d, V, seed, masked):
    """Inputs in the kernels' layout (w = head^T [V, d]) with the first
    row's target at column 0 and the last row's at V - 1."""
    x, head, tgt, scale = _inputs(N, d, V, seed, masked=masked)
    if masked != "all":
        tgt[0], tgt[-1] = 0, V - 1
    return (torch.from_numpy(x), torch.from_numpy(head.T.copy()),
            torch.from_numpy(tgt), torch.from_numpy(scale))


def _close(got, want, rel):
    got, want = got.double(), want.double()
    scale = max(1e-30, want.abs().max().item())
    assert (got - want).abs().max().item() <= rel * scale


# (N, d, V, norm, tile_v, chunk_rows, masked): exact and ragged tiles,
# V = 1000 against 128- and 256-column tiles, N = 200 against 64- and
# 128-row chunks, a chunk whose every target is masked
TILED = [
    (256, 128, 512, False, 128, 128, "some"),
    (200, 128, 1000, False, 128, 64, "some"),
    (200, 128, 1000, True, 256, 128, "some"),
    (64, 256, 384, True, 128, 32, "some"),
    (200, 128, 1000, True, 128, 128, "first"),
    (96, 128, 300, False, 128, 64, "all"),
]


def _masked(tgt, masked, chunk):
    if masked == "first":     # the first chunk wholly masked
        tgt[:chunk] = -1
    return tgt


@pytest.mark.parametrize("N, d, V, norm, tile_v, chunk, masked", TILED)
def test_tiled_plain_versions_match_dense(N, d, V, norm, tile_v, chunk,
                                          masked):
    """The plain forward folding per-vocab-tile (max, sum-exp) partials in
    tile order, and the plain backward summing dw over row chunks in
    f32, give the dense plain versions' results (f32: the same sums in
    another order, 1e-6 of each output's largest value; dx 2e-6, since
    the BLAS splits a chunk's 1000-term dl w products otherwise than the
    whole batch's, which alone moved dx by 1.2e-6 of its largest value
    at N = 200, V = 1000)."""
    x, w, tgt, scale = _tiled_inputs(N, d, V, N + V, masked)
    tgt = _masked(tgt, masked, chunk)
    fnorm = (scale, 1e-6) if norm else None
    dense = TC.plain_flash_ce_fwd(x, w, tgt, fnorm)
    tiled = TC.plain_flash_ce_fwd(x, w, tgt, fnorm, tile_v=tile_v)
    for a, b in zip(tiled, dense):
        _close(a, b, 1e-6)
    lse = dense[0]
    srow = (tgt >= 0).float() * 0.37
    bnorm = (scale, 1e-6, dense[2]) if norm else None
    want = TC.plain_flash_ce_bwd(x, w, tgt, lse, srow, bnorm)
    got = TC.plain_flash_ce_bwd(x, w, tgt, lse, srow, bnorm,
                                chunk_rows=chunk)
    for name, a, b in zip(("dx", "dw", "dscale"), got, want):
        assert a.shape == b.shape
        _close(a, b, 2e-6 if name == "dx" else 1e-6)


@pytest.mark.parametrize("norm", [False, True])
def test_tiled_plain_versions_at_the_hf_vocab(norm):
    """HF GPT-2's vocabulary, V = 50257 = 392 x 128 + 81: the last
    128-column tile holds 81 live columns.  The tiled plain versions
    (the bf16 kernels' order of work) give the dense ones' lse, true
    logit, dx and dw (f32, the bounds above), with targets at columns 0
    and V - 1: a padded column that counted would add exp(0) per row to
    the sum and move lse by ~1e-4."""
    N, d, V = 64, 128, 50257
    x, w, tgt, scale = _tiled_inputs(N, d, V, 11, "some")
    fnorm = (scale, 1e-6) if norm else None
    dense = TC.plain_flash_ce_fwd(x, w, tgt, fnorm)
    tiled = TC.plain_flash_ce_fwd(x, w, tgt, fnorm, tile_v=128)
    for a, b in zip(tiled, dense):
        _close(a, b, 1e-6)
    srow = (tgt >= 0).float() * 0.37
    bnorm = (scale, 1e-6, dense[2]) if norm else None
    want = TC.plain_flash_ce_bwd(x, w, tgt, dense[0], srow, bnorm)
    got = TC.plain_flash_ce_bwd(x, w, tgt, dense[0], srow, bnorm,
                                chunk_rows=32)
    for name, a, b in zip(("dx", "dw", "dscale"), got, want):
        _close(a, b, 2e-6 if name == "dx" else 1e-6)


@pytest.mark.parametrize("N, d, V, norm, tile_v, chunk, masked", TILED)
def test_tiled_plain_versions_match_pallas(N, d, V, norm, tile_v, chunk,
                                           masked):
    """The tiled plain versions against the reference's Pallas forward
    and backward kernels (interpret mode, at ``BLOCKS`` sizes): lse,
    the true logit and rstd, then dx, dhead and dscale for a loss
    cotangent of 0.37 (f32 on both sides: lse and the true logit within
    1e-5 of their largest value, gradients within 1e-4, the module's
    bounds).  A target at column 0 and at V - 1 and masked rows take
    part in every case."""
    x, w, tgt, scale = _tiled_inputs(N, d, V, N + V + 1, masked)
    tgt = _masked(tgt, masked, chunk)
    head = jnp.asarray(w.numpy().T)
    jn = (jnp.asarray(scale.numpy()), 1e-6) if norm else None
    want = JC._fwd_pallas(jnp.asarray(x.numpy()), head,
                          jnp.asarray(tgt.numpy()), block_n=128,
                          block_v=256, norm=jn)
    fnorm = (scale, 1e-6) if norm else None
    got = TC.plain_flash_ce_fwd(x, w, tgt, fnorm, tile_v=tile_v)
    for a, b in zip(got, want):
        _close(a, torch.from_numpy(np.asarray(b)), 1e-5)
    gs = 0.37
    jbn = (*jn, jnp.asarray(got[2].numpy())) if norm else None
    jgrads = JC._bwd_pallas(jnp.asarray(x.numpy()), head,
                            jnp.asarray(tgt.numpy()),
                            jnp.asarray(got[0].numpy()), jnp.float32(gs),
                            block_n=128, block_v=256, norm=jbn)
    srow = (tgt >= 0).float() * gs
    bnorm = (scale, 1e-6, got[2]) if norm else None
    grads = TC.plain_flash_ce_bwd(x, w, tgt, got[0], srow, bnorm,
                                  chunk_rows=chunk)
    refs = [np.asarray(jgrads[0]), np.asarray(jgrads[1]).T,
            *([np.asarray(jgrads[2])] if norm else [])]
    for a, b in zip(grads, refs):
        assert tuple(a.shape) == b.shape
        _close(a, torch.from_numpy(b), 1e-4)
    if masked == "all":
        assert all(float(a.abs().max()) == 0.0 for a in grads)


# ---------------------------------------------------------------------------
# the gates on a CUDA device (constructible without a card)
# ---------------------------------------------------------------------------

CUDA = torch.device("cuda")


@pytest.mark.parametrize("d, dtype, verdict", [
    (768, torch.bfloat16, "kernel"),
    (1024, torch.bfloat16, "kernel"),     # gpt2_medium
    (1280, torch.bfloat16, "kernel"),     # gpt2_large
    (1536, torch.bfloat16, "raise"),
    (768, torch.float32, "kernel"),
    (1024, torch.float32, "raise"),
    (1280, torch.float32, "raise"),
    (768, torch.float16, "raise"),
    (96, torch.bfloat16, "plain"),        # the JAX gate declines it too
])
def test_cuda_gate_declines_unbuilt_widths(d, dtype, verdict):
    """On a CUDA device the gate takes the widths the kernels are built
    for, declines what the JAX gate declines (the dense CE, as there),
    and raises, naming the ROADMAP item, for a width the JAX gate takes
    but no kernel of the dtype is built for; on the CPU every streamed
    shape is taken (the plain versions)."""
    gates = (lambda: TC.supports(2048, d, 50304, device=CUDA, dtype=dtype),
             lambda: TC.uses_flash_ce_norm(2048, d, 50304, device=CUDA,
                                           dtype=dtype))
    for gate in gates:
        if verdict == "raise":
            with pytest.raises(NotImplementedError, match="Queue 2 item A"):
                gate()
        else:
            assert bool(gate()) == (verdict == "kernel")
    cpu = TC.supports(2048, d, 50304, device="cpu", dtype=dtype)
    assert bool(cpu) == (verdict != "plain")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_gate_and_wrapper_check_agree(dtype):
    """The wrappers' check is the gate on a CUDA device: among the widths
    the JAX gate takes, both pass exactly the dtype's
    ``_KERNEL_WIDTHS`` and raise for the rest."""
    for d in range(128, 2049, 128):
        if d in TC._KERNEL_WIDTHS[dtype]:
            assert TC.supports(4096, d, 50304, device=CUDA, dtype=dtype)
            TC._check_width("flash_ce", 4096, d, 50304, dtype)
            continue
        for check in (lambda: TC.supports(4096, d, 50304, device=CUDA,
                                          dtype=dtype),
                      lambda: TC._check_width("flash_ce", 4096, d, 50304,
                                              dtype)):
            with pytest.raises(NotImplementedError, match="Queue 2 item A"):
                check()


def _small_model(d_model):
    from ray_tpu_torch.models import gpt as tgpt

    cfg = tgpt.GPTConfig(vocab_size=300, d_model=d_model, n_layers=1,
                         n_heads=2, max_seq=32, dtype=torch.float32)
    params = tgpt.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 300, (2, 32), generator=g),
             "targets": torch.randint(0, 300, (2, 32), generator=g)}
    batch["targets"][0, :5] = -1
    return cfg, params, batch


def _gate_on_card(monkeypatch, seen):
    gate = TC.supports

    def on_card(N, d, V, *, device=None, dtype=None):
        seen.append((device.type, dtype))
        return gate(N, d, V, device=CUDA, dtype=dtype)

    def refuse(*_a, **_k):
        raise AssertionError("the flash-CE kernels were reached")

    monkeypatch.setattr(TC, "supports", on_card)
    monkeypatch.setattr(TC.FlashCE, "apply", refuse)


def test_model_loss_takes_the_dense_ce_where_the_gate_declines(
        monkeypatch):
    """The model's loss asks the flash-CE gate for its operands' device
    and dtype: where it declines (d = 96, not lane-aligned, which the JAX
    gate declines too), ``loss_fn`` runs the unfused final norm and the
    dense CE, never the kernels' autograd.Function, and the loss and
    gradients are those of the same model on the CPU (f32, 1e-5
    relative)."""
    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.models.training import value_and_grad

    cfg, params, batch = _small_model(96)
    want_loss, want = value_and_grad(
        lambda p, b: tgpt.loss_fn(p, b, cfg), params, batch)
    seen = []
    _gate_on_card(monkeypatch, seen)
    got_loss, got = value_and_grad(
        lambda p, b: tgpt.loss_fn(p, b, cfg), params, batch)
    assert seen and all(s == ("cpu", torch.float32) for s in seen)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    for name in ("embed", "ln_f"):
        err = (got[name] - want[name]).abs().max() / want[name].abs().max()
        assert float(err) < 1e-5, name


def test_model_loss_raises_where_no_kernel_is_built(monkeypatch):
    """At a width the JAX gate takes but no f32 kernel is built for
    (d = 128 on a card), the loss raises, naming the ROADMAP item: it
    never sends the card's tensors to the dense CE instead."""
    from ray_tpu_torch.models import gpt as tgpt

    cfg, params, batch = _small_model(128)
    seen = []
    _gate_on_card(monkeypatch, seen)
    with pytest.raises(NotImplementedError, match="Queue 2 item A"):
        tgpt.loss_fn(params, batch, cfg)
    assert seen == [("cpu", torch.float32)]
