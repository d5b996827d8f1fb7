"""Port parity: ``ray_tpu_torch.ops.attention`` against the JAX package.

The same numpy inputs go through the JAX function (its Pallas kernels
in interpret mode, as ``tests/test_ops.py`` runs them on the CPU) and
the port's counterpart, which on a CPU tensor is the plain version the
CUDA kernel is held against on the card.

Tolerance: both sides compute in f32 and differ only in summation
order, which moves O(1) outputs by ~1e-6.  2e-5 (the JAX suite's own
kernel-vs-einsum bound) leaves an order of margin and still catches a
wrong mask or rounding point, which moves outputs by 1e-3 or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as JA
from ray_tpu_torch.ops import attention as TA
from ray_tpu_torch.parallel.ring_attention import local_attention

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope_rotate_matches_jax(batched_positions):
    """RoPE at [S] (prefill) and [B, S] (decode) positions.  Angles
    reach ~255 rad here, where one f32 ulp of the angle is ~1.5e-5, so
    the rotation is held to 1e-4."""
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 16, 3, 64)
    pos = (rng.integers(0, 256, (2, 16)) if batched_positions
           else np.arange(16) + 200).astype(np.int32)
    want = JA.rope_rotate(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TA.rope_rotate(torch.from_numpy(x), torch.from_numpy(pos),
                         10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", [
    (1, 128, 2, 64),    # JAX takes its pack2 kernel (D=64, even heads)
    (2, 128, 3, 32),    # JAX takes its unpacked _fwd kernel
    (1, 40, 2, 64),     # a ragged bucket: JAX falls back to einsum
    (2, 128, 4, 64),    # pack2 over two batches and two head pairs
    # lengths at the edges of the Hopper kernels' 64-row tiles (one row,
    # a tile less or more by one, a partial last tile), several batches
    # and heads; JAX takes its einsum path at each
    (2, 1, 3, 64),
    (2, 63, 2, 64),
    (1, 65, 3, 64),
    (2, 127, 2, 64),
    (1, 129, 4, 64),
    (2, 200, 3, 64),
    # GPTConfig.tiny's head dim: JAX takes its unpacked _fwd kernel at
    # 128 and einsum at 65
    (2, 128, 4, 16),
    (1, 65, 4, 16),
])
def test_flash_attention_matches_jax(shape):
    """o against ``JA.flash_attention``, and the kernel's second output,
    lse [B, H, S], against the row logsumexp of the same causal scores
    taken in JAX.  Both within 2e-5 (f32, summation order only)."""
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True)
    got = TA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    S, D = shape[1], shape[3]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    s = jnp.where(jnp.tril(jnp.ones((S, S), bool)), s, -jnp.inf)
    want_lse = jax.nn.logsumexp(s, axis=-1)
    _o, lse = TA.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=D ** -0.5)
    assert lse.shape == (shape[0], shape[2], S)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_flash_attention_fwd_lse():
    """The kernel's second output, the row logsumexp kept for the
    backward, against a numpy computation of the same scores."""
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, 1, 64, 2, 32) for _ in range(3))
    _o, lse = TA.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=32 ** -0.5)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * 32 ** -0.5
    s = np.where(np.tril(np.ones((64, 64), bool)), s, -np.inf)
    m = s.max(-1)
    want = m + np.log(np.exp(s - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, **TOL)


def _decode_inputs(rng):
    B, S, H, D = 3, 256, 2, 64
    q = _rand(rng, B, H, D)
    k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, H, D)
    lengths = np.array([1, 100, 256], np.int32)
    return q, k, v, lengths


def test_decode_attention_matches_jax_pallas():
    """Ragged lengths including 1 and the full context."""
    q, k, v, lengths = _decode_inputs(np.random.default_rng(3))
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lengths),
                               impl="pallas")
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_ignores_nan_garbage():
    """Positions at or past a row's length hold garbage (the garbage
    page, padded tails).  Filled with NaN on the port side, the output
    stays finite and equal to the JAX kernel's on clean inputs."""
    q, k, v, lengths = _decode_inputs(np.random.default_rng(4))
    # jnp.asarray may share the numpy buffers and JAX runs async: finish
    # the clean-input reference before any NaN is written, and write
    # the NaN into copies
    want = np.asarray(JA.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        impl="pallas"))
    dead = np.arange(k.shape[1])[None, :] >= lengths[:, None]
    k, v = k.copy(), v.copy()
    k[dead], v[dead] = np.nan, np.nan
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              torch.from_numpy(lengths))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("garbage", [False, True])
def test_decode_attention_int8_matches_jax_pallas(garbage):
    """The ``quantized=True`` variant: int8 codes with per-(position,
    head) f32 scales from the JAX ``quantize_block``, through the JAX
    Pallas body (interpret mode, as ``tests/test_ops.py:766`` runs it)
    and the port's plain int8 branch, within 2e-5 in f32.  With
    ``garbage``, the port's codes past each length are overwritten with
    extreme codes and its scales with NaN: the output must not change."""
    from ray_tpu.quant import quantize_block
    rng = np.random.default_rng(7)
    B, S, H, D = 4, 256, 3, 64
    q = _rand(rng, B, H, D)
    k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, H, D)
    lengths = np.array([1, 100, 129, 256], np.int32)
    k8, ks = (np.array(a) for a in quantize_block(jnp.asarray(k), block=D))
    v8, vs = (np.array(a) for a in quantize_block(jnp.asarray(v), block=D))
    ks, vs = ks[..., 0].copy(), vs[..., 0].copy()
    want = np.asarray(JA.decode_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(lengths), impl="pallas", block_k=128,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    if garbage:
        dead = np.arange(S)[None, :] >= lengths[:, None]
        k8, v8 = k8.copy(), v8.copy()
        k8[dead], v8[dead] = 127, -128
        ks[dead], vs[dead] = np.nan, np.nan
    got = TA.decode_attention(
        *(torch.from_numpy(a) for a in (q, k8, v8, lengths)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="together"):
        TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k8),
                            torch.from_numpy(v8), torch.from_numpy(lengths),
                            k_scale=torch.from_numpy(ks))


def _bf16(x):
    """f32 values that bf16 holds exactly."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _paged_case(page_size, int8, seed, D=64):
    """A paged layer and its table, as the engine hands them to the
    decode step: rows of length 1, one page exactly, one page + 1 and
    the full table; pages in shuffled order; rows 2 and 3 share their
    first (prefix) page; every table entry from ``ceil(len / page)`` on
    names the garbage page 0.  The context (max_pages * page) is a
    multiple of 128, so the JAX kernel tiles it.  Returns the clean
    inputs (the JAX kernel's) and a copy whose garbage page and
    positions at or past each length hold NaN (int8: extreme codes and
    NaN scales), the port's."""
    from ray_tpu.quant import quantize_block
    rng = np.random.default_rng(seed)
    H = 2
    S = np.lcm(page_size, 128)
    S = S if S > page_size else 2 * S
    max_pages = S // page_size
    lengths = np.array([1, page_size, page_size + 1, S], np.int32)
    needed = -(-lengths // page_size)
    P = needed.sum()               # + the garbage page, - the shared one
    ids = 1 + rng.permutation(P - 1)
    table = np.zeros((4, max_pages), np.int32)
    nxt = 0
    for b, n in enumerate(needed):
        for j in range(n):
            if b == 3 and j == 0:
                table[b, j] = table[2, 0]
                continue
            table[b, j] = ids[nxt]
            nxt += 1
    assert nxt == P - 1
    q = _bf16(_rand(rng, 4, H, D))
    kp, vp = (_bf16(_rand(rng, P, page_size, H, D)) for _ in range(2))
    # positions no row reaches: the garbage page and each row's tail
    dead = np.ones((P, page_size), bool)
    for b in range(4):
        for p in range(lengths[b]):
            dead[table[b, p // page_size], p % page_size] = False
    assert dead[0].all()
    clean = dict(q=q, k=kp, v=vp)
    if int8:
        for n, x in (("k", kp), ("v", vp)):
            codes, sc = (np.array(a) for a in
                         quantize_block(jnp.asarray(x), block=D))
            clean[n], clean[f"{n}s"] = codes, sc[..., 0].copy()
    dirty = {n: x.copy() for n, x in clean.items()}
    if int8:
        dirty["k"][dead], dirty["v"][dead] = 127, -128
        dirty["ks"][dead], dirty["vs"][dead] = np.nan, np.nan
    else:
        dirty["k"][dead], dirty["v"][dead] = np.nan, np.nan
    return clean, dirty, table, lengths


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_values", "int8"])
@pytest.mark.parametrize("page_size", [1, 7, 32, 128])
def test_decode_attention_paged_matches_jax_pallas(page_size, int8):
    """The paged entry against the JAX Pallas decode kernel (interpret
    mode) over the reference's ``gather_pages`` of the same pages, at
    page sizes 1, 7, 32 and 128, through a shuffled table with a shared
    prefix page; the port's garbage page and tails hold NaN (int8:
    extreme codes, NaN scales) and must not reach the output."""
    from ray_tpu.inference import kv_cache as jkv
    clean, dirty, table, lengths = _paged_case(page_size, int8,
                                               seed=page_size)
    jt = jnp.asarray(table)
    ctx = {n: jkv.gather_pages(jnp.asarray(clean[n]), jt)
           for n in clean if n != "q"}
    scales = (dict(k_scale=ctx["ks"], v_scale=ctx["vs"]) if int8 else {})
    want = np.asarray(JA.decode_attention(
        jnp.asarray(clean["q"]), ctx["k"], ctx["v"], jnp.asarray(lengths),
        impl="pallas", **scales))
    t = {n: torch.from_numpy(x) for n, x in dirty.items()}
    tscales = (dict(k_scale_pages=t["ks"], v_scale_pages=t["vs"])
               if int8 else {})
    got = TA.decode_attention_paged(
        t["q"], t["k"], t["v"], torch.from_numpy(table),
        torch.from_numpy(lengths), **tscales)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_attention_paged_plain_is_gather_then_plain(int8):
    """The paged plain version is exactly the engine's former decode
    path, ``gather_pages`` then :func:`plain_decode_attention`, bit for
    bit: on the CPU the engine computes what it computed before it read
    the pages in place."""
    from ray_tpu_torch.inference.kv_cache import gather_pages
    _clean, dirty, table, lengths = _paged_case(7, int8, seed=11)
    t = {n: torch.from_numpy(x) for n, x in dirty.items()}
    t["q"] = t["q"].bfloat16()
    if not int8:
        t["k"], t["v"] = t["k"].bfloat16(), t["v"].bfloat16()
    table64, lens = torch.from_numpy(table).long(), torch.from_numpy(lengths)
    scales = (dict(k_scale=gather_pages(t["ks"], table64),
                   v_scale=gather_pages(t["vs"], table64)) if int8 else {})
    want = TA.plain_decode_attention(
        t["q"], gather_pages(t["k"], table64), gather_pages(t["v"], table64),
        lens, scale=64 ** -0.5, **scales)
    got = TA.decode_attention_paged(
        t["q"], t["k"], t["v"], torch.from_numpy(table), lens,
        **({"k_scale_pages": t["ks"], "v_scale_pages": t["vs"]}
           if int8 else {}))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the training path: fused RoPE, forward and backward
# ---------------------------------------------------------------------------

def _grad_err(got, want):
    """Largest error as a share of the reference leaf's largest value
    (the JAX suite's grad measure, tests/test_models.py:177)."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(1e-8, float(np.abs(want).max())))


@pytest.mark.parametrize("shape, blocks", [
    # JAX takes _flash_pack2_rope (D=64, even heads), one kv strip
    ((1, 128, 2, 64), None),
    # pack2 + RoPE with 128-row backward blocks: its backward walks two
    # kv strips and skips the dead one (mirrors test_ops.py:161)
    ((2, 256, 2, 64), 128),
    # odd heads and D=32: JAX takes the unpacked _fwd/_bwd with RoPE
    ((2, 128, 3, 32), None),
    # lengths at the edges of the Hopper kernels' 64-row tiles, several
    # batches and heads: JAX rotates with rope_rotate and differentiates
    # its einsum path
    ((2, 1, 2, 64), None),
    ((1, 63, 3, 64), None),
    ((2, 65, 3, 64), None),
    ((1, 127, 2, 64), None),
    ((2, 129, 2, 64), None),
    ((2, 200, 3, 64), None),
    # GPTConfig.tiny's head dim 16, where the partner of a column under
    # the D/2 roll is 8 columns away
    ((2, 128, 4, 16), None),
    ((1, 65, 4, 16), None),
    # head dim 128 (Llama's): RoPE's partner column is 64 away; JAX takes
    # the unpacked _fwd/_bwd with RoPE, and einsum at 65
    ((2, 128, 2, 128), None),
    ((1, 65, 2, 128), None),
])
def test_flash_attention_rope_grads_match_jax(shape, blocks):
    """``flash_attention(positions=...)``, the training path's fused
    RoPE, forward and dq/dk/dv, against the JAX kernels in interpret
    mode on the same inputs and cotangent.  The port side runs the same
    autograd.Function the card runs, with the plain bodies.

    Tolerance: f32 on both sides; o within 2e-5 (as above) and each
    gradient within 1e-4 of its own largest value, the JAX suite's grad
    bound: the gradients sum up to 256 score products, so summation
    order moves them by ~1e-6 of their scale, while a wrong rotation,
    mask or rounding point moves them by 1e-2 or more."""
    B, S, H, D = shape
    rng = np.random.default_rng(5)
    q, k, v, do = (_rand(rng, *shape) for _ in range(4))
    pos = np.arange(S, dtype=np.int32)
    kw = {} if blocks is None else dict(block_q=blocks, block_k=blocks,
                                        bwd_block_q=blocks,
                                        bwd_block_k=blocks)
    kernel_shape = JA.supports(S, S, D)
    if D == 64 and kernel_shape:
        assert JA.uses_pack2(S, S, H, D, **({} if blocks is None else dict(
            block_q=blocks, block_k=blocks)))

    def jfn(q, k, v):
        return JA.flash_attention(q, k, v, causal=True,
                                  positions=jnp.asarray(pos),
                                  rope_theta=10000.0, **kw)

    o_j, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    g_j = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o_t = TA.flash_attention(qt, kt, vt, causal=True,
                             positions=torch.from_numpy(pos),
                             rope_theta=10000.0)
    o_t.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), **TOL)
    for name, got, want in zip("dq dk dv".split(), (qt.grad, kt.grad,
                                                   vt.grad), g_j):
        if not np.abs(np.asarray(want)).max():
            # S = 1: one key per row, so dq is 0 exactly.  The port's f32
            # dp - delta is the difference of two 64-term sums of ~10
            # taken in two orders (a few 1e-6), times scale and |k|
            assert np.abs(got.numpy()).max() < 1e-5, name
            continue
        assert _grad_err(got.numpy(), want) < 1e-4, name


def test_rope_inside_the_kernel_is_not_rope_rotate():
    """The fused RoPE rotates in f32 and rounds once (``_rot``), where
    ``rope_rotate`` rotates in the storage dtype: in bf16 the two differ,
    so the kernel path must not reuse the serving path's rotation.  In
    f32 both agree, which ties the fused path to the serving one."""
    rng = np.random.default_rng(6)
    x = _rand(rng, 1, 64, 2, 64)
    pos = torch.arange(64)
    cos2, sinm = TA.rope_tables(pos, 64, 10000.0, torch.float32)
    np.testing.assert_allclose(
        TA._rot(torch.from_numpy(x), cos2, sinm).numpy(),
        TA.rope_rotate(torch.from_numpy(x), pos, 10000.0).numpy(),
        atol=1e-6, rtol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    cb, sb = TA.rope_tables(pos, 64, 10000.0, torch.bfloat16)
    assert not torch.equal(TA._rot(xb, cb, sb),
                           TA.rope_rotate(xb, pos, 10000.0))


def test_make_flash_attention_fn_marks_fused_rope():
    fn = TA.make_flash_attention_fn(rope_theta=10000.0)
    assert fn.fused_rope is True
    assert TA.make_flash_attention_fn().fused_rope is False
    with pytest.raises(ValueError, match="must name its axes"):
        TA.make_flash_attention_fn(type("Mesh", (), {"size": 4})())
    # a packed batch of one document per row is plain causal attention
    q, k, v = torch.randn(3, 1, 8, 2, 64, generator=torch.Generator()
                          .manual_seed(0)).unbind(0)
    got = TA.flash_attention(q, k, v, segment_ids=torch.ones(1, 8))
    torch.testing.assert_close(got, local_attention(q, k, v), atol=1e-6,
                               rtol=1e-5)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("D, ok", [(64, True), (16, True), (32, False),
                                   (128, True), (256, False)])
def test_cuda_gate_declines_unbuilt_head_dims(D, ok):
    """On a CUDA device (constructible without a card) the attention gate
    takes the head dims the kernels are built for (GPT-2's 64, tiny's 16,
    Llama's 128) and raises for the rest, naming the ROADMAP item: a CUDA
    tensor never goes to a plain version.  On the CPU every head dim is
    taken (the plain versions)."""
    if ok:
        assert TA.supports(D, device=CUDA)
    else:
        with pytest.raises(NotImplementedError, match="Queue 2 item B"):
            TA.supports(D, device=CUDA)
    assert TA.supports(D, device="cpu") and TA.supports(D)


def test_cuda_gate_and_wrapper_check_agree():
    """The wrappers' check takes exactly the head dims the CUDA gate
    passes, ``_KERNEL_HEAD_DIMS``, and refuses the rest as the gate
    does."""
    t = torch.zeros(1)
    for D in range(8, 257, 8):
        if D in TA._KERNEL_HEAD_DIMS:
            assert TA.supports(D, device=CUDA)
            TA._check_kernel_dtype("flash_attention", t, D)
        else:
            for check in (lambda: TA.supports(D, device=CUDA),
                          lambda: TA._check_kernel_dtype(
                              "flash_attention", t, D)):
                with pytest.raises(NotImplementedError,
                                   match="Queue 2 item B"):
                    check()


# ---------------------------------------------------------------------------
# non-causal attention and head dim 128
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("shape", [
    # JAX runs its Pallas _fwd/_bwd (pack2 at D = 64) in interpret mode
    (2, 256, 2, 64),
    (2, 256, 2, 128),
    # a ragged length: JAX takes its einsum path (local_attention);
    # the Hopper kernels' last key tile is cut at S
    (2, 200, 2, 64),
    (2, 200, 2, 128),
])
def test_flash_attention_noncausal_matches_jax(shape, rope):
    """``flash_attention(causal=False)``, forward and dq/dk/dv, against
    the JAX package on the same inputs and cotangent, with and without
    the fused RoPE.  The port side runs the autograd.Function the card
    runs, with the plain bodies.  Tolerance: the reference's own
    (``tests/test_ops.py:24-71``, ``:249-268``): 2e-5 on o and 5e-4
    absolute on each gradient (f32 on both sides; the gradients here
    are O(1), and a causal mask left on, or a key past S given weight,
    moves them by 1e-2 or more)."""
    B, S, H, D = shape
    rng = np.random.default_rng(21 + D + S)
    q, k, v, do = (_rand(rng, *shape) for _ in range(4))
    pos = np.arange(S, dtype=np.int32)
    rkw = dict(positions=pos, rope_theta=10000.0) if rope else {}

    def jfn(q, k, v):
        return JA.flash_attention(
            q, k, v, causal=False,
            **{n: jnp.asarray(x) if n == "positions" else x
               for n, x in rkw.items()})

    o_j, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    g_j = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o_t = TA.flash_attention(
        qt, kt, vt, causal=False,
        **{n: torch.from_numpy(x) if n == "positions" else x
           for n, x in rkw.items()})
    o_t.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), **TOL)
    for name, got, want in zip("dq dk dv".split(), (qt.grad, kt.grad,
                                                   vt.grad), g_j):
        err = float(np.abs(got.numpy() - np.asarray(want)).max())
        assert err < 5e-4, (name, err)
    # and it is not the causal result
    causal = TA.flash_attention(qt.detach(), kt.detach(), vt.detach())
    assert (causal - o_t.detach()).abs().max() > 1e-2


def test_flash_attention_noncausal_lse():
    """The forward's lse without the mask: the logsumexp of every key's
    score, against numpy."""
    rng = np.random.default_rng(22)
    q, k, v = (_rand(rng, 1, 65, 2, 128) for _ in range(3))
    _o, lse = TA.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=128 ** -0.5,
        causal=False)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * 128 ** -0.5
    m = s.max(-1)
    want = m + np.log(np.exp(s - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_decode_attention_head_dim_128_matches_jax_pallas(int8):
    """Decode at head dim 128 over a padded context, ragged lengths (1,
    a split's 128, one more, the full 256), against the JAX Pallas
    decode kernel in interpret mode; int8 codes and scales from the JAX
    ``quantize_block``.  Tolerance 2e-5 (f32, summation order)."""
    from ray_tpu.quant import quantize_block
    rng = np.random.default_rng(23)
    B, S, H, D = 4, 256, 2, 128
    q = _rand(rng, B, H, D)
    k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, H, D)
    lengths = np.array([1, 128, 129, 256], np.int32)
    scales, tscales = {}, {}
    if int8:
        k, ks = (np.array(a) for a in quantize_block(jnp.asarray(k), block=D))
        v, vs = (np.array(a) for a in quantize_block(jnp.asarray(v), block=D))
        ks, vs = ks[..., 0].copy(), vs[..., 0].copy()
        scales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                      block_k=128)
        tscales = dict(k_scale=torch.from_numpy(ks),
                       v_scale=torch.from_numpy(vs))
    want = np.asarray(JA.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        impl="pallas", **scales))
    got = TA.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)), **tscales)
    assert got.shape == (B, H, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("page_size", [7, 128])
def test_decode_attention_paged_head_dim_128_matches_jax_pallas(page_size,
                                                                int8):
    """The paged entry at head dim 128, as
    ``test_decode_attention_paged_matches_jax_pallas`` at 64: a
    shuffled table with a shared prefix page, NaN (int8: extreme codes,
    NaN scales) in the garbage page and past each length."""
    from ray_tpu.inference import kv_cache as jkv
    clean, dirty, table, lengths = _paged_case(page_size, int8,
                                               seed=31 + page_size, D=128)
    jt = jnp.asarray(table)
    ctx = {n: jkv.gather_pages(jnp.asarray(clean[n]), jt)
           for n in clean if n != "q"}
    scales = (dict(k_scale=ctx["ks"], v_scale=ctx["vs"]) if int8 else {})
    want = np.asarray(JA.decode_attention(
        jnp.asarray(clean["q"]), ctx["k"], ctx["v"], jnp.asarray(lengths),
        impl="pallas", **scales))
    t = {n: torch.from_numpy(x) for n, x in dirty.items()}
    tscales = (dict(k_scale_pages=t["ks"], v_scale_pages=t["vs"])
               if int8 else {})
    got = TA.decode_attention_paged(
        t["q"], t["k"], t["v"], torch.from_numpy(table),
        torch.from_numpy(lengths), **tscales)
    assert got.shape[-1] == 128 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
