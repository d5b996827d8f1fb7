"""Port parity: ``ray_tpu_torch.parallel.mesh`` against
``ray_tpu.parallel.mesh``: the copied axis bookkeeping gives the
reference's answers and errors, and ``make_mesh`` builds a data-parallel
``DeviceMesh`` read as the reference's callers read a JAX mesh; in a
4-rank gloo world ``pp`` and ``ep`` meshes build, and ``mesh_groups``
gives the ``pp`` and ``ep`` groups and each rank's stage neighbours (the
other axes: tests/test_torch_parallel.py)."""

import json
import os

import pytest
import torch

from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.parallel import mesh as tmesh


@pytest.mark.parametrize("arg", ["dp=4", "dcn=2,fsdp=4", "dp=-1,tp=2",
                                 " dp = 2 , sp=2 ", ""])
def test_parse_mesh_axes_matches_jax(arg):
    assert tmesh.parse_mesh_axes(arg) == jmesh.parse_mesh_axes(arg)


@pytest.mark.parametrize("arg", ["zz=2", "dp=2,dp=2", "dp=0", "dp=x",
                                 "fsdp=2,dcn=2", "dp"])
def test_parse_mesh_axes_errors_match_jax(arg):
    with pytest.raises(jmesh.MeshAxisError) as want:
        jmesh.parse_mesh_axes(arg)
    with pytest.raises(tmesh.MeshAxisError) as got:
        tmesh.parse_mesh_axes(arg)
    assert str(got.value) == str(want.value)
    assert got.value.axis == want.value.axis


def test_mesh_spec_matches_jax():
    for sizes, n in (({"dp": -1}, 8), ({"dp": 2, "tp": -1}, 8),
                     ({"dcn": 2, "fsdp": 4}, 8), ({"dp": 2}, 8)):
        t = tmesh.MeshSpec.create(**sizes).resolve(n)
        j = jmesh.MeshSpec.create(**sizes).resolve(n)
        assert t.axes == j.axes and t.size == j.size
        assert t.describe() == j.describe()
        assert t.tier_split() == j.tier_split()
        assert t.to_dict() == j.to_dict()
    with pytest.raises(ValueError):
        tmesh.MeshSpec.create(dp=-1, tp=-1).resolve(8)


def test_suggest_accum_steps_matches_jax():
    for batch in (1, 6, 24, 96):
        for div in (1, 2, 4, 8):
            for prefer in (1, 3, 8):
                assert tmesh.suggest_accum_steps(batch, div, prefer) == \
                    jmesh.suggest_accum_steps(batch, div, prefer)


def test_validate_divisibility_matches_jax():
    import jax
    jm = jmesh.make_mesh(dp=4, devices=jax.devices()[:4])

    class Fake:      # the port's mesh is dp-only: hold the shape logic
        shape = tmesh.MeshShape(("dp",), (4,))

    for kw in (dict(batch=8), dict(batch=6), dict(batch=8, accum_steps=4),
               dict(batch=8, accum_steps=3), dict(seq=7)):
        try:
            jmesh.validate_divisibility(jm, **kw)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            tmesh.validate_divisibility(Fake, **kw)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want, kw


def test_make_mesh_outside_a_process_group():
    """No process group: a mesh of 1 (``dp=-1`` or ``dp=1``), a
    ``DeviceMesh`` whose ``size`` is an int, still callable, and whose
    ``shape`` answers by axis name; no group to reduce over."""
    from torch.distributed.device_mesh import DeviceMesh
    for m in (tmesh.make_mesh(), tmesh.make_mesh(dp=1),
              tmesh.single_device_mesh()):
        assert isinstance(m, DeviceMesh)
        assert m.size == 1 and m.size() == 1 and not m.size > 1
        assert m.shape["dp"] == 1 and m.shape.get("sp", 1) == 1
        assert tuple(m.shape) == (1,) and dict(m.shape.items()) == {"dp": 1}
        assert m.group is None and m.axis_names == ("dp",)
        assert tmesh.mesh_axis_size(m, "dp") == 1
        assert tmesh.MeshSpec.from_mesh(m).to_dict() == {"dp": 1}
    with pytest.raises(ValueError, match="exceeds device count 1"):
        tmesh.make_mesh(dp=2)


@pytest.mark.parametrize("axes, exc, match", [
    pytest.param(dict(tp=2), ValueError, "exceeds device count 1",
                 id="axes0"),
    pytest.param(dict(dp=1, fsdp=2), ValueError, "exceeds device count 1",
                 id="axes1"),
    pytest.param(dict(sp=2), ValueError, "exceeds device count 1",
                 id="axes2"),
    pytest.param(dict(pp=2), ValueError, "exceeds device count 1",
                 id="axes3"),
    pytest.param(dict(ep=2), ValueError, "exceeds device count 1",
                 id="axes4"),
])
def test_non_dp_axes_raise_item_9b(axes, exc, match):
    """Outside a process group a mesh of tp, fsdp, sp, pp or ep above 1
    asks for more ranks than the world of one holds (inside a group they
    build: tests/test_torch_parallel.py, tests/test_torch_pipeline.py,
    tests/test_torch_moe.py); no axis raises for being unported."""
    with pytest.raises(exc, match=match):
        tmesh.make_mesh(**axes)


def test_attention_and_training_take_a_dp_mesh_only():
    """``make_flash_attention_fn`` and ``build_gpt_train`` accept a
    data-parallel mesh of one.  A sequence axis declines the flash hook
    (its attention is ring or Ulysses), and a mesh of two devices with no
    process group behind it is refused by the training step."""
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops.attention import make_flash_attention_fn
    dp = tmesh.single_device_mesh()
    assert make_flash_attention_fn(dp, rope_theta=1e4).fused_rope

    class SP:
        size = 2
        shape = tmesh.MeshShape(("dp", "sp"), (1, 2))

    with pytest.raises(ValueError, match="ring or Ulysses"):
        make_flash_attention_fn(SP)
    cfg = gpt.GPTConfig.tiny(dtype=torch.float32)
    with pytest.raises(ValueError, match="live process group"):
        training.build_gpt_train(cfg, SP, device="cpu")
    fns = training.build_gpt_train(cfg, dp, device="cpu", telemetry=False)
    assert fns["attn_fn"].fused_rope


def _neighbour_world(rank, store, tmp):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    out = {}
    for name, axes in (("pp4", dict(pp=4)), ("pp2-dp2", dict(pp=2, dp=2)),
                       ("dcn2-ep2", dict(dcn=2, ep=2)),
                       ("ep2-tp2", dict(ep=2, tp=2))):
        mesh = tmesh.make_mesh(**axes)
        g = tmesh.mesh_groups(mesh)
        out[name] = {"pp": list(g.stage_neighbours("pp")),
                     "dcn": list(g.stage_neighbours("dcn")),
                     "pp_size": dist.get_world_size(g.pp) if g.pp else 1,
                     "ep_size": dist.get_world_size(g.ep) if g.ep else 1,
                     "coords": g.coords}
    with open(os.path.join(tmp, f"r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def test_pp_and_ep_meshes_build_with_stage_neighbours(tmp_path):
    """In a world of 4, ``make_mesh`` builds {pp 4}, {pp 2, dp 2},
    {dcn 2, ep 2} and {ep 2, tp 2}; ``mesh_groups`` gives the pp and ep
    groups and, along pp and dcn, each rank's previous and next stage
    (global ranks, None at the ends): rank r sits at the JAX device
    order's coordinate of r."""
    import torch.multiprocessing as mp
    mp.start_processes(_neighbour_world,
                       args=(str(tmp_path / "store"), str(tmp_path)),
                       nprocs=4, join=True, start_method="spawn")
    got = [json.loads((tmp_path / f"r{r}.json").read_text())
           for r in range(4)]
    none = [None, None]
    assert [g["pp4"]["pp"] for g in got] == [[None, 1], [0, 2], [1, 3],
                                             [2, None]]
    assert [g["pp4"]["pp_size"] for g in got] == [4] * 4
    # {pp 2, dp 2}: rank = 2 pp + dp
    assert [g["pp2-dp2"]["pp"] for g in got] == [[None, 2], [None, 3],
                                                [0, None], [1, None]]
    assert [g["pp2-dp2"]["dcn"] for g in got] == [none] * 4
    # {dcn 2, ep 2}: stages along dcn, the ep pairs (0, 1) and (2, 3)
    assert [g["dcn2-ep2"]["dcn"] for g in got] == [[None, 2], [None, 3],
                                                  [0, None], [1, None]]
    assert [g["dcn2-ep2"]["ep_size"] for g in got] == [2] * 4
    assert [g["dcn2-ep2"]["coords"] for g in got] == [
        {"dcn": 0, "ep": 0}, {"dcn": 0, "ep": 1}, {"dcn": 1, "ep": 0},
        {"dcn": 1, "ep": 1}]
    assert [g["ep2-tp2"]["pp"] for g in got] == [none] * 4
    assert [g["ep2-tp2"]["ep_size"] for g in got] == [2] * 4
