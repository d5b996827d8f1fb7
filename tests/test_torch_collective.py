"""Port counterparts of ``tests/test_collective_pg.py``'s collective
tests for ``ray_tpu_torch.util.collective``: the host backend's
allreduce/allgather/broadcast, send/recv and ring ops at world 4, and
the process-group backend (``"ici"``: one ``torch.distributed`` world,
gloo here) across two actor processes; plus the single-process device
verbs (``"nccl"``, the ``XlaGroup`` counterpart) and the rendezvous
record's freshness window.  Each test starts its own runtime."""

import json
import time

import numpy as np
import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_host_collective_allreduce(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class Worker:
        def __init__(self, rank, world):
            from ray_tpu_torch.util import collective
            collective.init_collective_group(world, rank, backend="host",
                                             group_name="g1")
            self.rank = rank

        def do_allreduce(self):
            from ray_tpu_torch.util import collective
            return collective.allreduce(np.full(4, self.rank + 1.0),
                                        group_name="g1")

        def do_allgather(self):
            from ray_tpu_torch.util import collective
            return collective.allgather(np.array([self.rank]),
                                        group_name="g1")

        def do_broadcast(self):
            from ray_tpu_torch.util import collective
            return collective.broadcast(
                np.arange(3) if self.rank == 0 else np.zeros(3),
                src_rank=0, group_name="g1")

    world = 3
    workers = [Worker.remote(r, world) for r in range(world)]
    outs = ray.get([w.do_allreduce.remote() for w in workers], timeout=60)
    for out in outs:
        np.testing.assert_array_equal(out, np.full(4, 1.0 + 2.0 + 3.0))
    gathered = ray.get([w.do_allgather.remote() for w in workers],
                       timeout=60)
    for g in gathered:
        assert [int(a[0]) for a in g] == [0, 1, 2]
    bcast = ray.get([w.do_broadcast.remote() for w in workers], timeout=60)
    for b in bcast:
        np.testing.assert_array_equal(b, np.arange(3))


def test_host_collective_send_recv(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    class P2P:
        def __init__(self, rank):
            from ray_tpu_torch.util import collective
            collective.init_collective_group(2, rank, backend="host",
                                             group_name="p2p")
            self.rank = rank

        def run(self):
            from ray_tpu_torch.util import collective
            if self.rank == 0:
                collective.send(np.array([42.0]), dst_rank=1,
                                group_name="p2p")
                return None
            return collective.recv(src_rank=0, group_name="p2p")

    a, b = P2P.remote(0), P2P.remote(1)
    _, received = ray.get([a.run.remote(), b.run.remote()], timeout=60)
    np.testing.assert_array_equal(received, np.array([42.0]))


def test_host_ring_ops_world4(ray_start_regular):
    """Ring reduce-scatter/allgather with every reduce op (the ring
    forced: small tensors would take the direct path)."""
    ray = ray_start_regular

    @ray.remote
    class W:
        def __init__(self, rank, world):
            from ray_tpu_torch.util import collective
            collective.HostGroup.RING_MIN_BYTES = 0
            collective.init_collective_group(world, rank, backend="host",
                                             group_name="ring4")
            self.rank = rank

        def run(self):
            from ray_tpu_torch.util import collective
            r = self.rank
            out = {}
            out["sum"] = collective.allreduce(
                np.arange(10.0) + r, group_name="ring4")
            out["max"] = collective.allreduce(
                np.full(5, float(r)), group_name="ring4", op="max")
            out["min"] = collective.allreduce(
                np.full(5, float(r)), group_name="ring4", op="min")
            out["product"] = collective.allreduce(
                np.full(3, 2.0), group_name="ring4", op="product")
            out["rs"] = collective.reducescatter(
                np.ones((8, 2)) * (r + 1), group_name="ring4")
            out["reduce"] = collective.reduce(
                np.full(6, float(r + 1)), dst_rank=1, group_name="ring4")
            return out

    world = 4
    ws = [W.remote(r, world) for r in range(world)]
    outs = ray.get([w.run.remote() for w in ws], timeout=120)
    base = np.arange(10.0)
    for o in outs:
        np.testing.assert_allclose(o["sum"], base * 4 + 6)
        np.testing.assert_allclose(o["max"], np.full(5, 3.0))
        np.testing.assert_allclose(o["min"], np.zeros(5))
        np.testing.assert_allclose(o["product"], np.full(3, 16.0))
        np.testing.assert_allclose(o["rs"], np.ones((2, 2)) * 10)
    np.testing.assert_allclose(outs[1]["reduce"], np.full(6, 10.0))
    np.testing.assert_allclose(outs[0]["reduce"], np.full(6, 1.0))


def test_process_group_backend_two_process_world(ray_start_regular):
    """Two actor processes form one ``torch.distributed`` world through
    the ``"ici"`` backend (gloo here: the workers hold no card) and run
    its collectives; numpy in gives numpy out, a tensor a tensor; the
    world's mesh is a data-parallel mesh of 2."""
    ray = ray_start_regular

    @ray.remote
    class W:
        def __init__(self, rank, world):
            from ray_tpu_torch.util import collective
            collective.init_collective_group(world, rank, backend="ici",
                                             group_name="ici1")
            self.rank = rank

        def world_info(self):
            import torch.distributed as dist

            from ray_tpu_torch.util import collective
            mesh = collective.get_group("ici1").global_mesh()
            return (dist.get_world_size(), dist.get_backend(),
                    int(mesh.size), mesh.shape["dp"])

        def run(self):
            import torch

            from ray_tpu_torch.util import collective
            s = collective.allreduce(np.full(4, self.rank + 1.0),
                                     group_name="ici1")
            mx = collective.allreduce(torch.full((2,), float(self.rank)),
                                      group_name="ici1", op="max")
            g = collective.allgather(np.array([float(self.rank)]),
                                     group_name="ici1")
            b = collective.broadcast(np.full(3, float(self.rank + 5)),
                                     src_rank=1, group_name="ici1")
            rs = collective.reducescatter(np.arange(4.0),
                                          group_name="ici1")
            collective.barrier(group_name="ici1")
            return s, mx.tolist(), g, b, rs

        def destroy(self):
            import torch.distributed as dist

            from ray_tpu_torch.util import collective
            collective.destroy_collective_group("ici1")
            return dist.is_initialized()

    ws = [W.remote(r, 2) for r in range(2)]
    infos = ray.get([w.world_info.remote() for w in ws], timeout=120)
    assert infos == [(2, "gloo", 2, 2)] * 2
    outs = ray.get([w.run.remote() for w in ws], timeout=120)
    for r, (s, mx, g, b, rs) in enumerate(outs):
        assert isinstance(s, np.ndarray)
        np.testing.assert_allclose(s, np.full(4, 3.0))
        assert mx == [1.0, 1.0]
        assert [float(a[0]) for a in g] == [0.0, 1.0]
        np.testing.assert_allclose(b, np.full(3, 6.0))
        np.testing.assert_allclose(rs, np.arange(4.0)[2 * r:2 * r + 2] * 2)
    assert ray.get([w.destroy.remote() for w in ws], timeout=60) == \
        [False, False]


def test_process_group_rendezvous_ignores_a_stale_record(ray_start_regular):
    """A joiner ignores a coordinator record older than the freshness
    window (a dead run's address) and times out instead of joining it;
    a fresh record is taken."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util.collective import ProcessGroup

    cp = global_worker().cp
    key = b"__ici_coordinator_stale"
    old = time.time() - ProcessGroup._COORD_FRESH_S - 5
    cp.kv_put(key, json.dumps({"addr": "127.0.0.1:1", "ts": old}).encode(),
              namespace="_collective")
    probe = ProcessGroup.__new__(ProcessGroup)
    probe.group_name, probe._rendezvous_id = "stale", "stale"
    with pytest.raises(TimeoutError, match="stale"):
        probe._rendezvous(0.3)
    cp.kv_put(key, json.dumps({"addr": "127.0.0.1:2",
                               "ts": time.time()}).encode(),
              namespace="_collective")
    assert probe._rendezvous(5.0) == "127.0.0.1:2"
    assert ray_tpu_torch.is_initialized()


def test_local_device_group_verbs():
    """The single-process verbs (backend ``"nccl"``, ``XlaGroup``'s
    counterpart) over explicit devices: one leading row per device."""
    import torch

    from ray_tpu_torch.util import collective
    collective.init_collective_group(2, 0, backend="nccl",
                                     group_name="local2",
                                     devices=["cpu", "cpu"])
    try:
        x = np.array([[1.0, 2.0], [3.0, 5.0]])
        np.testing.assert_array_equal(
            collective.allreduce(x, group_name="local2"), [[4.0, 7.0]])
        np.testing.assert_array_equal(
            collective.allreduce(x, group_name="local2", op="max"),
            [[3.0, 5.0]])
        parts = collective.allgather(torch.tensor(x), group_name="local2")
        assert [p.tolist() for p in parts] == [[[1.0, 2.0]], [[3.0, 5.0]]]
        rs = collective.reducescatter(np.array([[1.0, 2.0], [3.0, 4.0]]),
                                      group_name="local2")
        np.testing.assert_array_equal(rs, [[4.0], [6.0]])
        collective.barrier(group_name="local2")
    finally:
        collective.destroy_collective_group("local2")
    assert not collective.is_group_initialized("local2")
