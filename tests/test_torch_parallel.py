"""Port parity: ``ray_tpu_torch.parallel`` (the sharding rules, meshes,
parameter shards, ring and Ulysses attention) against ``ray_tpu.parallel``.

The rules and specs are checked in this process, on meshes described by
their shape alone.  Everything that needs a process group runs in one
4-rank gloo world (``torch.multiprocessing``, a ``FileStore`` under the
test's directory) that takes every mesh shape in turn; its ranks import
only ``torch`` and the port and write their results to files.  The JAX
side runs once in this process on its 8-device host mesh
(``make_mesh(..., devices=jax.devices()[:4])``) while the world runs.

- Meshes: each rank's coordinates are the position of JAX device r in
  the reference mesh's device array, and each rank's shard of every
  ``GPTConfig.tiny`` parameter is, bit for bit, the block JAX device r
  holds under the reference's ``NamedSharding``; ``gather_params`` gives
  the full tree back bit for bit.
- Attention at [4, 32, 4, 16] f32 on ``{dp: 2, sp: 2}`` and ``{sp: 4}``:
  ring (contiguous and zigzag) and Ulysses, values and the gradients of
  ``sum(out ** 2)`` in q, k and v, against the port's ``local_attention``
  and against the reference's ``make_ring_attention_fn`` /
  ``make_ulysses_attention_fn``, at ``tests/test_parallel.py``'s bounds:
  ring values atol 2e-5 and gradients atol 5e-5; Ulysses values rtol
  2e-4 atol 2e-5, gradients rtol 2e-3 atol 2e-4.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
MESHES = [("dp2-tp2", dict(dp=2, tp=2)), ("fsdp4", dict(fsdp=4)),
          ("fsdp2-tp2", dict(fsdp=2, tp=2)), ("dp2-sp2", dict(dp=2, sp=2)),
          ("sp2-tp2", dict(sp=2, tp=2)), ("dcn2-fsdp2", dict(dcn=2, fsdp=2)),
          ("sp4", dict(sp=4)), ("tp4", dict(tp=4)), ("dp4", dict(dp=4))]
MESH_IDS = [m[0] for m in MESHES]
ATTN = [("dp2-sp2", dict(dp=2, sp=2)), ("sp4", dict(sp=4))]
ATTN_IDS = [a[0] for a in ATTN]
VARIANTS = ("ring", "zigzag", "ulysses")
AB, AS, AH, AD = 4, 32, 4, 16
# the kernel gates on a mesh: d_model 128 passes the fused epilogue's and
# flash-CE's gates on one device (tests/test_torch_training.py's SMALL)
GATE_MESHES = [("fsdp4", dict(fsdp=4)), ("dp2-tp2", dict(dp=2, tp=2))]
SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
             max_seq=128)
RING_TOL = dict(values=dict(atol=2e-5), grads=dict(atol=5e-5))
ULYSSES_TOL = dict(values=dict(rtol=2e-4, atol=2e-5),
                   grads=dict(rtol=2e-3, atol=2e-4))


class _Shape:
    """A mesh described by its shape alone (the rules read nothing else)."""

    def __init__(self, **axes):
        from ray_tpu_torch.parallel.mesh import MeshShape, MeshSpec
        spec = MeshSpec.create(**axes)
        self.shape = MeshShape(spec.axis_names, [s for _, s in spec.axes])


def _jax_mesh(axes):
    import jax

    from ray_tpu.parallel.mesh import make_mesh
    n = int(np.prod(list(axes.values())))
    return make_mesh(**axes, devices=jax.devices()[:n])


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


# ------------------------------------------------------------------ rules


def test_mesh_spec_resolution():
    from ray_tpu_torch.parallel.mesh import MeshSpec
    spec = MeshSpec.create(dp=-1, tp=2)
    assert dict(spec.resolve(8).axes) == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError):
        MeshSpec.create(dp=3, tp=3).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec.create(bogus=2)


def test_validate_divisibility():
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu_torch.parallel import mesh as tmesh
    jm, tm = _jax_mesh(dict(dp=2, sp=2, tp=2)), _Shape(dp=2, sp=2, tp=2)
    tmesh.validate_divisibility(tm, batch=4, seq=64, n_heads=4, d_model=64)
    for kw in (dict(n_heads=3), dict(seq=31), dict(d_model=63),
               dict(batch=3)):
        with pytest.raises(ValueError) as want:
            jmesh.validate_divisibility(jm, **kw)
        with pytest.raises(ValueError) as got:
            tmesh.validate_divisibility(tm, **kw)
        assert str(got.value) == str(want.value)


def test_logical_to_spec_rules():
    """The reference's own case (fsdp absent -> batch over dp alone; sp
    absent -> None) and every logical name of the rule table on several
    meshes: the port's tuple equals the reference's ``PartitionSpec``."""
    from ray_tpu.parallel import sharding as jshd
    from ray_tpu_torch.parallel import sharding as tshd
    spec = tshd.logical_to_spec(("batch", "seq", "heads", None),
                                mesh=_Shape(dp=2, tp=4))
    assert spec == ("dp", None, "tp")
    names = [n for n, _ in jshd.DEFAULT_RULES] + [None, "unknown"]
    for axes in (dict(dp=2, tp=4), dict(dcn=2, dp=2, fsdp=2),
                 dict(fsdp=2, sp=2, tp=2), dict(dp=1, tp=1)):
        jm, tm = _jax_mesh(axes), _Shape(**axes)
        for i in range(len(names)):
            logical = tuple(names[i:i + 3])
            assert tshd.logical_to_spec(logical, mesh=tm) == tuple(
                jshd.logical_to_spec(logical, mesh=jm)), (axes, logical)
        assert tshd.data_axes(tm) == jshd.data_axes(jm)
    assert tshd.rules_dict() == jshd.rules_dict()


@pytest.mark.parametrize("name", MESH_IDS)
def test_param_specs_match_reference(name):
    """The spec of every leaf of ``param_logical_axes`` equals the
    reference's ``PartitionSpec`` on the same mesh shape."""
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import sharding as jshd
    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.parallel import sharding as tshd
    axes = dict(MESHES)[name]
    want = jshd.tree_specs(_jax_mesh(axes), jgpt.param_logical_axes(
        jgpt.GPTConfig.tiny(dtype=jnp.float32)))
    got = tshd.tree_specs(_Shape(**axes), tgpt.param_logical_axes(
        tgpt.GPTConfig.tiny(dtype=torch.float32)))
    want = {p: tuple(s) for p, s in _leaves(want)}
    assert dict(_leaves(got)) == want


def test_zigzag_permutation_matches_reference():
    from ray_tpu.parallel import ring_attention as jring
    from ray_tpu_torch.parallel import ring_attention as tring
    for seq, n in ((32, 4), (32, 2), (16, 2)):
        for a, b in zip(tring.zigzag_permutation(seq, n),
                        jring.zigzag_permutation(seq, n)):
            np.testing.assert_array_equal(a, np.asarray(b))
        for r in range(n):
            np.testing.assert_array_equal(
                tring.zigzag_positions(r, n, seq // n).numpy(),
                np.asarray(jring.zigzag_positions(r, n, seq // n)))
    with pytest.raises(ValueError) as want:
        jring.zigzag_permutation(30, 4)
    with pytest.raises(ValueError) as got:
        tring.zigzag_permutation(30, 4)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ world


def _attn_fn(mesh, variant):
    from ray_tpu_torch.parallel.ring_attention import make_ring_attention_fn
    from ray_tpu_torch.parallel.ulysses import make_ulysses_attention_fn
    if variant == "ulysses":
        return make_ulysses_attention_fn(mesh, causal=True)
    return make_ring_attention_fn(
        mesh, causal=True,
        layout="zigzag" if variant == "zigzag" else "contiguous")


def _world(rank, store, in_path, out_dir):
    """One rank of the gloo world: every mesh, then every attention case;
    rank 0 writes what every rank found."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.ring_attention import zigzag_permutation
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    data = dict(np.load(in_path))
    index = json.loads(str(data.pop("index")))
    full = _unflat({k[2:]: torch.from_numpy(v) for k, v in data.items()
                    if k.startswith("p/")})
    logical = gpt.param_logical_axes(gpt.GPTConfig.tiny(
        dtype=torch.float32))
    found = {}
    for name, axes in MESHES:
        mesh = make_mesh(**axes)
        shards = sharding.shard_params(full, mesh, logical)
        back = sharding.gather_params(shards, mesh, logical)
        same, whole = {}, {}
        for (path, s), (_, f), (_, b) in zip(_leaves(shards), _leaves(full),
                                             _leaves(back)):
            block = f[tuple(slice(a, b_) for a, b_ in
                            index[name][path][rank])]
            same[path] = bool(torch.equal(s, block))
            whole[path] = bool(torch.equal(b, f))
        found[name] = {"shape": dict(mesh.shape.items()),
                       "coords": [mesh.coordinate(a)
                                  for a in mesh.axis_names],
                       "same": same, "whole": whole}
    everyone = [None] * WORLD
    dist.all_gather_object(everyone, found)
    if rank == 0:
        with open(os.path.join(out_dir, "meshes.json"), "w") as f:
            json.dump(everyone, f)

    q, k, v = (torch.from_numpy(data[n]) for n in "qkv")
    for name, axes in ATTN:
        mesh = make_mesh(**axes)
        spec = sharding.logical_to_spec(("batch", "seq"), mesh=mesh)
        for variant in VARIANTS:
            perm = inv = slice(None)
            if variant == "zigzag":
                perm, inv = zigzag_permutation(AS, axes["sp"])
            local = [sharding.shard_tensor(t[:, perm], spec, mesh)
                     .requires_grad_(True) for t in (q, k, v)]
            out = _attn_fn(mesh, variant)(*local)
            (out ** 2).sum().backward()
            got = [sharding.gather_tensor(t, spec, mesh)[:, inv]
                   for t in [out.detach()] + [t.grad for t in local]]
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}-{variant}.npz"),
                         **dict(zip(("out", "dq", "dk", "dv"),
                                    (t.numpy() for t in got))))

    # which kernel entry points one loss-and-gradient step calls
    from ray_tpu_torch.models import training
    from ray_tpu_torch.ops import flash_ce, fused_norm
    calls, strided = {}, {}
    for mod, fn in ((fused_norm, "matmul_residual_norm"),
                    (flash_ce, "flash_ce_norm_sum"),
                    (flash_ce, "flash_ce_sum")):
        def counted(*a, _f=getattr(mod, fn), _n=fn, **k):
            calls[_n] = calls.get(_n, 0) + 1
            if _n == "matmul_residual_norm" and not all(
                    t.is_contiguous() for t in a[:4]):
                # the card's wrapper takes contiguous a, w, resid, scale
                strided[_n] = strided.get(_n, 0) + 1
            return _f(*a, **k)
        setattr(mod, fn, counted)
    cfg = gpt.GPTConfig(**SMALL, dtype=torch.float32)
    gates, strides = {}, {}
    for name, axes in GATE_MESHES:
        mesh = make_mesh(**axes)
        fns = training.build_gpt_train(cfg, mesh, device="cpu",
                                       telemetry=False)
        state = fns["init_fn"](torch.Generator().manual_seed(0))
        batch = {n: torch.from_numpy(data["gate_" + n]) for n in
                 ("tokens", "targets")}
        calls.clear()
        strided.clear()
        fns["value_and_grad_fn"](state.params, fns["shard_batch"](batch))
        gates[name] = dict(calls)
        strides[name] = dict(strided)
    if rank == 0:
        with open(os.path.join(out_dir, "gates.json"), "w") as f:
            json.dump(gates, f)
        with open(os.path.join(out_dir, "strides.json"), "w") as f:
            json.dump(strides, f)
    dist.destroy_process_group()


def _jax_attention(axes, variant, q, k, v):
    """The reference's output and gradients of sum(out ** 2)."""
    import jax

    from ray_tpu.parallel import ring_attention as jring
    from ray_tpu.parallel.ulysses import make_ulysses_attention_fn
    mesh = _jax_mesh(axes)
    if variant == "ulysses":
        fn = make_ulysses_attention_fn(mesh, causal=True)
    else:
        fn = jring.make_ring_attention_fn(
            mesh, causal=True,
            layout="zigzag" if variant == "zigzag" else "contiguous")
    if variant == "zigzag":
        perm, inv = jring.zigzag_permutation(AS, axes["sp"])
        inner = fn

        def fn(q, k, v):
            return inner(q[:, perm], k[:, perm], v[:, perm])[:, inv]

    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: (fn(*a) ** 2).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(t) for t in (out,) + tuple(grads)]


def _device_blocks(axes, shapes):
    """For each leaf, the [start, stop) of each dimension of the block
    JAX device r holds, r = 0..3."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import sharding as jshd
    mesh = _jax_mesh(axes)
    specs = dict(_leaves(jshd.tree_specs(mesh, jgpt.param_logical_axes(
        jgpt.GPTConfig.tiny(dtype=jnp.float32)))))
    out = {}
    for path, shape in shapes.items():
        idx = NamedSharding(mesh, specs[path]).devices_indices_map(shape)
        by_id = {d.id: sl for d, sl in idx.items()}
        out[path] = [[list(s.indices(n)[:2]) for s, n in
                      zip(by_id[r], shape)] for r in range(WORLD)]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import torch.multiprocessing as mp

    from ray_tpu.models import gpt as jgpt
    tmp = tmp_path_factory.mktemp("parallel")
    params = dict(_leaves(jax.tree.map(np.asarray, jgpt.init_params(
        jgpt.GPTConfig.tiny(dtype=jnp.float32), jax.random.PRNGKey(0)))))
    shapes = {p: v.shape for p, v in params.items()}
    index = {name: _device_blocks(axes, shapes) for name, axes in MESHES}
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((AB, AS, AH, AD)).astype(np.float32)
               for _ in range(3))
    in_path = str(tmp / "inputs.npz")
    tok = rng.integers(0, SMALL["vocab_size"], (4, 33)).astype(np.int64)
    np.savez(in_path, q=q, k=k, v=v, index=json.dumps(index),
             gate_tokens=tok[:, :-1], gate_targets=tok[:, 1:],
             **{"p/" + p: a for p, a in params.items()})
    t0 = time.monotonic()
    ctx = mp.start_processes(_world, args=(str(tmp / "store"), in_path,
                                           str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    ref = {(name, variant): _jax_attention(axes, variant, q, k, v)
           for name, axes in ATTN for variant in VARIANTS}
    jax_s = time.monotonic() - t0
    devices = {name: np.vectorize(lambda d: d.id)(_jax_mesh(axes).devices)
               for name, axes in MESHES}
    jshapes = {name: dict(_jax_mesh(axes).shape) for name, axes in MESHES}
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True)
                  for t in (q, k, v))
    from ray_tpu_torch.parallel.ring_attention import local_attention
    out = local_attention(tq, tk, tv, causal=True)
    (out ** 2).sum().backward()
    local = [t.detach().numpy() for t in (out, tq.grad, tk.grad, tv.grad)]
    while not ctx.join(timeout=1):
        pass
    with open(tmp / "meshes.json") as f:
        meshes = json.load(f)
    with open(tmp / "gates.json") as f:
        gates = json.load(f)
    with open(tmp / "strides.json") as f:
        strides = json.load(f)
    port = {(name, variant): [np.load(tmp / f"{name}-{variant}.npz")[n]
                              for n in ("out", "dq", "dk", "dv")]
            for name, _ in ATTN for variant in VARIANTS}
    print(f"JAX side {jax_s:.1f} s; world of {WORLD} "
          f"{time.monotonic() - t0:.1f} s")
    return {"meshes": meshes, "devices": devices, "jshapes": jshapes,
            "ref": ref, "port": port, "local": local, "gates": gates,
            "strides": strides}


@pytest.mark.parametrize("name", MESH_IDS)
def test_make_mesh_axes(world, name):
    """``make_mesh`` gives the reference's axis sizes, and rank r sits
    where JAX device r sits in the reference mesh."""
    for r, found in enumerate(world["meshes"]):
        got = found[name]
        assert got["shape"] == world["jshapes"][name]
        where = np.argwhere(world["devices"][name] == r)[0].tolist()
        assert got["coords"] == where, (r, got["coords"], where)


@pytest.mark.parametrize("name", MESH_IDS)
def test_shards_are_the_reference_device_blocks(world, name):
    """Each rank's shard of every leaf is, bit for bit, the block JAX
    device r holds; ``gather_params`` gives the full tree back bit for
    bit on every rank."""
    for r, found in enumerate(world["meshes"]):
        got = found[name]
        assert all(got["same"].values()), (r, got["same"])
        assert all(got["whole"].values()), (r, got["whole"])


def _check(world, name, variant, which, tol):
    sel = slice(0, 1) if which == "values" else slice(1, 4)
    for got, local, ref, label in zip(world["port"][(name, variant)][sel],
                                      world["local"][sel],
                                      world["ref"][(name, variant)][sel],
                                      ("out", "dq", "dk", "dv")[sel]):
        np.testing.assert_allclose(got, local, **tol[which],
                                   err_msg=f"{label} vs local_attention")
        np.testing.assert_allclose(got, ref, **tol[which],
                                   err_msg=f"{label} vs the reference")


@pytest.mark.parametrize("name", ATTN_IDS)
def test_ring_attention_matches_local(world, name):
    _check(world, name, "ring", "values", RING_TOL)


@pytest.mark.parametrize("name", ATTN_IDS)
def test_ring_attention_grads(world, name):
    _check(world, name, "ring", "grads", RING_TOL)


@pytest.mark.parametrize("name", ATTN_IDS)
def test_zigzag_ring_attention_matches_local(world, name):
    _check(world, name, "zigzag", "values", RING_TOL)


@pytest.mark.parametrize("name", ATTN_IDS)
def test_zigzag_ring_attention_grads(world, name):
    _check(world, name, "zigzag", "grads", RING_TOL)


@pytest.mark.parametrize("name", ATTN_IDS)
def test_ulysses_attention_matches_local(world, name):
    _check(world, name, "ulysses", "values", ULYSSES_TOL)
    _check(world, name, "ulysses", "grads", ULYSSES_TOL)


def test_tp_declines_the_fused_epilogue_and_flash_ce(world):
    """On {fsdp: 4} each rank's rows are whole after the gathers, so a
    step of the d_model-128 model takes the fused epilogue in both
    layers and flash-CE with the norm prologue, per rank; on {dp: 2,
    tp: 2} both decline as the reference's gates decline a sharded mesh
    (the tp sum sits between the out-proj and the residual; the head is
    vocab-sharded), and the step calls neither.  On a CUDA device the
    epilogue's gate gives that reason."""
    from ray_tpu_torch.ops import fused_norm
    assert world["gates"]["fsdp4"] == {"matmul_residual_norm": 2,
                                       "flash_ce_norm_sum": 1}
    assert world["gates"]["dp2-tp2"] == {}
    cuda = torch.device("cuda")
    assert fused_norm.out_proj_norm_plan(24576, 768, 768, seq=1024,
                                         device=cuda)
    plan = fused_norm.out_proj_norm_plan(24576, 384, 768, seq=1024,
                                         tp_size=2, device=cuda)
    assert not plan and "tp=2" in plan.reason


def test_fsdp_gathers_hand_the_epilogue_contiguous_weights(world):
    """On {fsdp: 4} each layer's out-projection weight is all-gathered
    along its last dimension; the epilogue's entry point, whose kernel
    on the card takes only contiguous operands, gets every operand
    contiguous in every call (``comm.all_gather_dim`` returns a
    contiguous tensor whatever the dimension)."""
    assert world["gates"]["fsdp4"]["matmul_residual_norm"] == 2
    assert world["strides"] == {"fsdp4": {}, "dp2-tp2": {}}
