"""Port counterparts of ``tests/test_data.py``: each test runs the same
pipeline on the same inputs through ``ray_tpu.data`` (the JAX package's
runtime, in this process) and ``ray_tpu_torch.data`` (the port's, in
its own session), and holds the port to the reference.

Tolerance: none.  Rows are compared as Python values or numpy arrays,
exactly, and in order wherever the reference's order is fixed by its
inputs and seeds (shuffles, splits, sorts, batches, aggregates, equal
``streaming_split``).  A greedy ``streaming_split`` hands blocks to
whichever consumer asks first, in both packages, so its streams are
compared as sets.  Float aggregates are bit-equal: the port sums as
pyarrow does (``block.arrow_sum``).  The waits on threads and actors
each carry their own timeout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# how long the streaming test's last map block waits for a pool task
_POOL_WAIT_S = 60.0


@pytest.fixture(scope="module")
def pkgs():
    """Both runtimes, started once for the module.  A dead head's
    extra-node shm root with all-decimal digits makes the reference's
    stale-session sweep fail every init on the host (ROADMAP Queue 3,
    reference side); the sweep is patched out for the reference's
    session only."""
    import ray_tpu
    import ray_tpu.data as ref_data
    import ray_tpu_torch
    import ray_tpu_torch.data as port_data
    from ray_tpu._private import node as ref_node
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_node, "_gc_stale_sessions", lambda *a, **k: None)
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield ref_data, port_data
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
        mp.undo()


def both(pkgs, fn):
    """``fn(data_module)`` for the reference, then the port."""
    ref_data, port_data = pkgs
    return fn(ref_data), fn(port_data)


def _runtime(data):
    import importlib
    return importlib.import_module(data.__name__.split(".")[0])


def test_range_count_take(pkgs):
    ref, port = both(pkgs, lambda d: (d.range(100).count(),
                                      d.range(100).take(5)))
    assert port == ref
    assert port[0] == 100 and [r["id"] for r in port[1]] == [0, 1, 2, 3, 4]


def test_map_batches(pkgs):
    ref, port = both(pkgs, lambda d: d.range(100).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2}).take(3))
    assert port == ref
    assert [r["sq"] for r in port] == [0, 1, 4]


def test_map_filter_flatmap(pkgs):
    def run(d):
        ds = d.from_items([1, 2, 3, 4, 5])
        return (ds.map(lambda r: {"v": r["item"] * 2}).take_all(),
                ds.filter(lambda r: r["item"] % 2 == 0).take_all(),
                ds.flat_map(lambda r: [{"v": r["item"]}] * 2).take_all())
    ref, port = both(pkgs, run)
    assert port == ref
    assert [r["v"] for r in port[0]] == [2, 4, 6, 8, 10]
    assert len(port[2]) == 10


def test_iter_batches_exact_sizes(pkgs):
    ref, port = both(pkgs, lambda d: [
        b["id"] for b in d.range(103, override_num_blocks=7)
        .iter_batches(batch_size=10)])
    assert [len(b) for b in port] == [len(b) for b in ref]
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b, a)
    assert sum(len(b) for b in port) == 103


def test_random_shuffle_preserves_rows(pkgs):
    """A seeded shuffle yields the reference's rows in its order."""
    ref, port = both(pkgs, lambda d: [
        r["id"] for r in d.range(200, override_num_blocks=4)
        .random_shuffle(seed=42).take_all()])
    assert port == ref
    assert sorted(port) == list(range(200)) and port[:20] != list(range(20))


def test_repartition(pkgs):
    def run(d):
        rt = _runtime(d)
        mat = d.range(100, override_num_blocks=2).repartition(5).materialize()
        blocks = rt.get(list(mat._block_refs), timeout=120)
        return mat.num_blocks(), mat.count(), [
            list(d.block.BlockAccessor.for_block(b).to_numpy()["id"])
            for b in blocks]
    ref, port = both(pkgs, run)
    assert port == ref
    assert port[:2] == (5, 100)


def test_sort_groupby(pkgs):
    items = [{"k": i % 3, "v": float(i)} for i in range(30)]

    def run(d):
        ds = d.from_items(items)
        return (ds.sort("v", descending=True).take(1)[0],
                ds.groupby("k").sum("v").take_all(),
                ds.groupby("k").count().take_all(),
                ds.groupby("k").min("v").take_all(),
                ds.groupby("k").max("v").take_all(),
                ds.groupby("k").mean("v").take_all(),
                list(ds.groupby("k").sum("v").to_pandas()["v_sum"]))
    ref, port = both(pkgs, run)
    assert port == ref
    assert port[0]["v"] == 29.0
    assert sorted(port[-1]) == sorted(
        [sum(i for i in range(30) if i % 3 == k) for k in range(3)])


def test_aggregates_are_the_references_bit_for_bit(pkgs):
    """Float sums and means: over several blocks the port sums each
    block pairwise as pyarrow does and adds the blocks in order; a
    group's sum runs over its rows in order, as pyarrow's hash sum does
    over one block."""
    x = np.random.default_rng(7).standard_normal(1000) * 1e3
    rows = [{"x": float(v), "k": i % 5} for i, v in enumerate(x)]

    def run(d):
        ds = d.from_items(rows, override_num_blocks=4)
        one = d.from_items(rows, override_num_blocks=1)
        return (ds.sum("x"), ds.mean("x"), ds.min("x"), ds.max("x"),
                d.range(101, override_num_blocks=3).mean("id"),
                d.range(101, override_num_blocks=3).sum("id"),
                one.groupby("k").sum("x").take_all(),
                one.groupby("k").mean("x").take_all())
    ref, port = both(pkgs, run)
    assert port == ref


def test_grouped_float_sums_over_blocks(pkgs):
    """Over several blocks pyarrow's threaded hash sum adds the blocks'
    partial sums in whatever order its threads finish, so the reference
    differs from itself run to run in the last bits; the port sums each
    group's rows in order.  Groups and their order are exact; the sums
    agree to 1e-12 relative."""
    x = np.random.default_rng(7).standard_normal(1000) * 1e3
    rows = [{"x": float(v), "k": i % 5} for i, v in enumerate(x)]
    ref, port = both(pkgs, lambda d: d.from_items(
        rows, override_num_blocks=4).groupby("k").sum("x").take_all())
    assert [r["k"] for r in port] == [r["k"] for r in ref]
    np.testing.assert_allclose([r["x_sum"] for r in port],
                               [r["x_sum"] for r in ref], rtol=1e-12)


def test_split_for_train(pkgs):
    ref, port = both(pkgs, lambda d: [
        [r["id"] for r in s.take_all()] for s in d.range(100).split(4)])
    assert port == ref
    counts = [len(s) for s in port]
    assert sum(counts) == 100 and max(counts) - min(counts) <= 1


def test_train_test_split_shuffled(pkgs):
    ref, port = both(pkgs, lambda d: [
        [r["id"] for r in s.take_all()] for s in
        d.range(100, override_num_blocks=3).train_test_split(
            0.3, shuffle=True, seed=5)])
    assert port == ref
    assert [len(s) for s in port] == [70, 30]


def test_parquet_roundtrip(pkgs, tmp_path):
    def run(d):
        out = str(tmp_path / d.__name__)
        ds = d.range(50).map_batches(
            lambda b: {"id": b["id"], "x": b["id"] * 0.5})
        ds.write_parquet(out)
        back = d.read_parquet(out)
        return back.count(), back.sum("x"), back.take_all()
    ref, port = both(pkgs, run)
    assert port == ref
    assert port[0] == 50
    assert abs(port[1] - sum(i * 0.5 for i in range(50))) < 1e-9
    # each package reads the other's files to the same rows
    ref_data, port_data = pkgs
    assert port_data.read_parquet(str(tmp_path / "ray_tpu.data")) \
        .take_all() == ref[2]
    assert ref_data.read_parquet(str(tmp_path / "ray_tpu_torch.data")) \
        .take_all() == ref[2]


def test_csv_read(pkgs, tmp_path):
    p = tmp_path / "f.csv"
    p.write_text("a,b\n1,x\n2,y\n3,z\n")
    ref, port = both(pkgs, lambda d: (d.read_csv(str(p)).count(),
                                      d.read_csv(str(p)).take_all()))
    assert port == ref
    assert port[1][0] == {"a": 1, "b": "x"}


def test_tensor_columns(pkgs):
    arr = np.random.default_rng(0).random((10, 8)).astype(np.float32)
    ref, port = both(pkgs, lambda d: next(
        d.from_numpy(arr, column="feat").iter_batches(batch_size=4)))
    assert port["feat"].shape == (4, 8)
    np.testing.assert_array_equal(port["feat"], ref["feat"])
    np.testing.assert_array_equal(port["feat"], arr[:4])


def test_tensor_columns_keep_their_trailing_shape(pkgs):
    """The port's tensor column keeps ``[n, 2, 3]``; the reference's
    arrow column flattens it to ``[n, 6]``, the same values."""
    arr = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    ref, port = both(pkgs, lambda d: next(
        d.from_numpy(arr).iter_batches(batch_size=None))["data"])
    assert port.shape == (4, 2, 3) and ref.shape == (4, 6)
    np.testing.assert_array_equal(port.reshape(4, 6), ref)


def test_dataset_in_trainer(pkgs, tmp_path):
    """Train ingest: every worker pulls a disjoint stream of one shared
    execution (``streaming_split(equal=True)``), through
    ``get_dataset_shard`` and ``iter_torch_batches``; together they see
    each row once, and each worker's rows are the reference worker's."""

    def run(d):
        name = d.__name__.split(".")[0]
        train = __import__(f"{name}.train", fromlist=["train"])
        out_dir = tmp_path / name
        out_dir.mkdir()
        torch_iter = name == "ray_tpu_torch"

        def loop(config):
            import json
            import os
            mod = __import__(config["pkg"] + ".train", fromlist=["train"])
            shard = mod.get_dataset_shard("train")
            rank = mod.get_context().get_world_rank()
            ids, kinds = [], set()
            if config["torch"]:
                batches = shard.iter_torch_batches(batch_size=8,
                                                   device="cpu")
            else:
                batches = shard.iter_batches(batch_size=8)
            for batch in batches:
                kinds.add(type(batch["id"]).__name__)
                ids.extend(int(x) for x in batch["id"])
            with open(os.path.join(config["out"], f"ids_{rank}.json"),
                      "w") as f:
                json.dump({"ids": ids, "kinds": sorted(kinds),
                           "shard": type(shard).__module__}, f)
            mod.report({"n": len(ids)})

        trainer = train.DataParallelTrainer(
            loop, train_loop_config={"out": str(out_dir), "pkg": name,
                                     "torch": torch_iter},
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="ingest",
                                       storage_path=str(out_dir)),
            datasets={"train": d.range(64, override_num_blocks=4)})
        result = trainer.fit()
        assert result.error is None
        import json
        return [json.loads((out_dir / f"ids_{r}.json").read_text())
                for r in (0, 1)]
    ref, port = both(pkgs, run)
    assert [w["ids"] for w in port] == [w["ids"] for w in ref]
    assert sorted(port[0]["ids"] + port[1]["ids"]) == list(range(64))
    assert all(w["ids"] for w in port), "a worker saw no data"
    assert all(w["kinds"] == ["Tensor"] for w in port)
    assert all(w["shard"] == "ray_tpu_torch.data.iterator" for w in port)


def test_actor_pool_map_operator(pkgs):
    class AddBias:
        def __init__(self, bias):
            self.bias = bias
            self.calls = 0

        def __call__(self, batch):
            self.calls += 1
            batch["id"] = batch["id"] + self.bias
            return batch

    ref, port = both(pkgs, lambda d: [
        r["id"] for r in d.range(64, override_num_blocks=8).map_batches(
            AddBias, concurrency=2, fn_constructor_args=(100,)).take_all()])
    assert port == ref
    assert sorted(port) == list(range(100, 164))


def test_streaming_overlap_and_budget(pkgs, monkeypatch, tmp_path):
    """Downstream work is dispatched while upstream blocks are still in
    flight, and per-operator in-flight stays within the budget, read
    from the port's scheduling events; the rows are the reference's.

    The overlap is forced by the setup, not left to timing: the map
    stage's last block (ids 56..63) waits until a pool task has run
    (the pool's UDF touches a file of the run), so that block cannot be
    done before a pool task was dispatched.  An executor that does not
    stream runs no pool task while a map task is in flight: the block
    then gives up after ``_POOL_WAIT_S`` and the order assertion fails.
    The other seven blocks do not wait, so block 0 (which the pool needs
    first, outputs being released in order) always finds a CPU."""
    import time

    import ray_tpu_torch.data.streaming_executor as se
    events = []
    orig_launch = se.PhysicalOperator.launch_one
    orig_done = se.PhysicalOperator.on_done

    def launch_one(self):
        events.append(("submit", self.name))
        return orig_launch(self)

    def on_done(self, ref):
        events.append(("done", self.name))
        return orig_done(self, ref)

    monkeypatch.setattr(se.PhysicalOperator, "launch_one", launch_one)
    monkeypatch.setattr(se.PhysicalOperator, "on_done", on_done)
    runs = iter(range(100))

    def pipeline(d):
        pool_ran = str(tmp_path / f"pool-ran-{next(runs)}")

        def stage1(batch):
            # two waves of 4 map tasks on 4 CPUs: the pool is fed between
            time.sleep(0.2)
            if len(batch["id"]) and batch["id"][0] >= 56:
                deadline = time.monotonic() + _POOL_WAIT_S
                while not os.path.exists(pool_ran) and \
                        time.monotonic() < deadline:
                    time.sleep(0.01)
            return batch

        class Stage2:
            def __call__(self, batch):
                open(pool_ran, "a").close()
                batch["id"] = batch["id"] + 1
                return batch

        return [r["id"] for r in d.range(64, override_num_blocks=8)
                .map_batches(stage1)
                .map_batches(Stage2, concurrency=2, batch_size=None)
                .take_all()]

    def warm(d):
        def stage1(batch):
            time.sleep(0.2)
            return batch
        return d.range(4, override_num_blocks=4).map_batches(stage1)

    ref_data, port_data = pkgs
    want = pipeline(ref_data)
    assert pipeline(port_data) == want        # warms the worker pool
    # the pool's actors took two of those workers with them: four map
    # tasks at once leave four task workers warm, so a cold start does
    # not hold back the measured stage's first block
    assert len(warm(port_data).take_all()) == 4
    events.clear()
    assert pipeline(port_data) == want
    assert want == list(range(1, 65))
    order = [(k, n) for k, n in events]
    first_pool = next(i for i, (k, n) in enumerate(order)
                      if k == "submit" and n.startswith("ActorPoolMap"))
    last_map_done = max(i for i, (k, n) in enumerate(order)
                        if k == "done" and n.startswith("Map["))
    assert first_pool < last_map_done, (
        "no pool task was dispatched before the map stage drained")
    inflight, peak = 0, 0
    for k, n in order:
        if n.startswith("Map["):
            inflight += 1 if k == "submit" else -1
            peak = max(peak, inflight)
    from ray_tpu_torch.data.dataset import DEFAULT_WINDOW
    assert peak <= DEFAULT_WINDOW


def test_iter_batches_prefetch_thread(pkgs):
    ref, port = both(pkgs, lambda d: [
        [list(b["id"]) for b in d.range(40, override_num_blocks=4)
         .iter_batches(batch_size=8, prefetch_blocks=p)] for p in (3, 0)])
    assert port == ref
    assert port[0] == port[1] and sum(len(b) for b in port[0]) == 40


def test_iter_torch_batches_match_iter_jax_batches(pkgs):
    """``iter_torch_batches(device="cpu")`` lands the values
    ``iter_jax_batches`` lands, as tensors; ``dtypes`` casts; the
    reference's ``sharding=`` is refused; without a card
    ``device=None`` raises rather than falling back to the CPU."""
    import torch
    ref_data, port_data = pkgs
    arr = np.random.default_rng(1).random((64, 5)).astype(np.float32)
    want = [(np.asarray(b["id"]), np.asarray(b["x"])) for b in
            ref_data.range(64, override_num_blocks=4).map_batches(
                lambda b: {"id": b["id"], "x": arr[b["id"]]})
            .iter_jax_batches(batch_size=8)]
    got = list(port_data.range(64, override_num_blocks=4).map_batches(
        lambda b: {"id": b["id"], "x": arr[b["id"]]})
        .iter_torch_batches(batch_size=8, device="cpu",
                            dtypes={"x": torch.float64}))
    assert len(got) == len(want) == 8
    for (wid, wx), b in zip(want, got):
        assert isinstance(b["id"], torch.Tensor)
        assert b["x"].dtype == torch.float64
        np.testing.assert_array_equal(b["id"].numpy(), wid)
        np.testing.assert_array_equal(b["x"].numpy(), wx.astype(np.float64))
    with pytest.raises(ValueError, match="sharding"):
        next(port_data.range(8).iter_torch_batches(
            batch_size=4, device="cpu", sharding=object()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(port_data.range(8).iter_torch_batches(batch_size=4))


def test_distributed_sort_global_order(pkgs):
    rng = np.random.default_rng(3)
    vals = rng.permutation(500).astype(float).tolist()
    names = [f"n{i:03d}" for i in rng.permutation(60)]

    def run(d):
        ds = d.from_items([{"v": v} for v in vals]).repartition(8)
        sds = d.from_items([{"name": s} for s in names]).repartition(4)
        return ([r["v"] for r in ds.sort("v").take_all()],
                [r["v"] for r in ds.sort("v", descending=True).take_all()],
                ds.sort("v").materialize().num_blocks(),
                [r["name"] for r in sds.sort("name").take_all()])
    ref, port = both(pkgs, run)
    assert port == ref
    assert port[0] == sorted(vals) and port[1] == sorted(vals, reverse=True)
    assert port[2] > 1 and port[3] == sorted(names)


def test_sort_is_stable_with_equal_keys(pkgs):
    items = [{"k": i % 4, "i": i} for i in range(40)]
    ref, port = both(pkgs, lambda d: [
        [r["i"] for r in d.from_items(items).repartition(3)
         .sort("k", descending=desc).take_all()] for desc in (False, True)])
    assert port == ref


def test_shuffle_streams_splits_while_maps_run(pkgs):
    import time

    def slow(batch):
        time.sleep(0.05)
        return batch

    def run(d):
        rt = _runtime(d)
        se = __import__(d.__name__ + ".streaming_executor",
                        fromlist=["x"])
        ds = d.range(200, override_num_blocks=8).map_batches(slow)
        shuffled = ds.random_shuffle(seed=7)
        ops = shuffled._build_operators(window=2)
        shuffle_op = [op for op in ops
                      if isinstance(op, se.ShuffleOperator)][0]
        refs = list(se.StreamingExecutor(ops).execute(
            list(shuffled._block_refs)))
        blocks = rt.get(refs, timeout=300)
        rows = [v for b in blocks for v in
                d.block.BlockAccessor.for_block(b).to_numpy()["id"].tolist()]
        return rows, shuffle_op.overlapped_splits, [
            r["id"] for r in shuffled.take_all()]
    ref, port = both(pkgs, run)
    assert port[0] == ref[0] and port[2] == ref[2]
    assert sorted(port[0]) == list(range(200))
    assert port[1] > 0, "no split completed while maps were still running"
    assert port[2] != sorted(port[2])


def test_streaming_split_disjoint_across_actors(pkgs):
    """Greedy dispatch: which consumer takes a block depends on who asks
    first, in both packages, so the streams are compared as sets."""
    def run(d):
        rt = _runtime(d)
        it_a, it_b = d.range(120, override_num_blocks=6).streaming_split(2)

        @rt.remote
        def consume(it):
            return [row["id"] for row in it.iter_rows()]

        return rt.get([consume.remote(it_a), consume.remote(it_b)],
                      timeout=120)
    ref, port = both(pkgs, run)
    got_a, got_b = port
    assert set(got_a).isdisjoint(got_b)
    assert sorted(got_a + got_b) == sorted(ref[0] + ref[1]) == \
        list(range(120))


def test_streaming_split_equal_round_robin(pkgs):
    def run(d):
        rt = _runtime(d)
        its = d.range(100, override_num_blocks=4).streaming_split(
            2, equal=True)

        @rt.remote
        def drain(it):
            return [list(b["id"]) for b in it.iter_batches(batch_size=None)]

        return rt.get([drain.remote(it) for it in its], timeout=120)
    ref, port = both(pkgs, run)
    assert port == ref
    assert [len(p) for p in port] == [2, 2]


def test_streaming_split_multi_epoch(pkgs):
    def run(d):
        (it,) = d.range(40, override_num_blocks=4).streaming_split(1)
        return ([r["id"] for r in it.iter_rows()],
                [r["id"] for r in it.iter_rows()])
    ref, port = both(pkgs, run)
    assert port == ref
    assert sorted(port[0]) == sorted(port[1]) == list(range(40))


def test_streaming_split_abandoned_epoch_not_wedged(pkgs):
    """A partially consumed epoch must not wedge the next; the second
    epoch runs in a thread whose join has its own timeout."""
    import threading
    from itertools import islice

    def run(d):
        (it,) = d.range(40, override_num_blocks=4).streaming_split(1)
        first = [r["id"] for r in islice(it.iter_rows(), 5)]
        box = {}
        t = threading.Thread(target=lambda: box.setdefault(
            "rows", [r["id"] for r in it.iter_rows()]), daemon=True)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), "the second epoch wedged"
        return first, box["rows"]
    ref, port = both(pkgs, run)
    assert port == ref
    assert len(port[0]) == 5 and sorted(port[1]) == list(range(40))


def test_streaming_split_equal_splits_leftover_blocks(pkgs):
    def run(d):
        rt = _runtime(d)
        its = d.range(50, override_num_blocks=5).streaming_split(
            2, equal=True)

        @rt.remote
        def drain(it):
            return [r["id"] for r in it.iter_rows()]

        return rt.get([drain.remote(i) for i in its], timeout=120)
    ref, port = both(pkgs, run)
    assert port == ref
    a, b = port
    assert sorted(a + b) == list(range(50)) and abs(len(a) - len(b)) <= 1


def test_union_streams_lazily(pkgs):
    def run(d):
        a = d.from_items([{"x": i} for i in range(20)])
        b = d.from_items([{"x": i + 100} for i in range(20)])

        def bump(row):
            return {"x": row["x"] + 1}

        u = a.map(bump).union(b.map(bump))
        return (u.num_blocks() == a.num_blocks() + b.num_blocks(),
                u.take(3), u.count(), [r["x"] for r in u.take_all()],
                [r["x"] for r in u.map(lambda r: {"x": r["x"] * 2})
                 .take_all()],
                [r["x"] for r in u.random_shuffle(seed=3).take_all()])
    ref, port = both(pkgs, run)
    assert port == ref
    assert port[0] and [r["x"] for r in port[1]] == [1, 2, 3]
    assert port[2] == 40 and port[3][-1] == 120


def test_limit_stops_upstream_execution(pkgs):
    def run(d):
        rt = _runtime(d)
        probe = f"limit_probe_{d.__name__.split('.')[0]}"

        @rt.remote
        class Touch:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1

            def count(self):
                return self.n

        touch = Touch.options(name=probe).remote()
        rt.get(touch.count.remote(), timeout=60)

        def spy(batch):
            a = rt.get_actor(probe)
            rt.get(a.bump.remote(), timeout=60)
            return batch

        ds = d.from_items([{"x": i} for i in range(160)],
                          override_num_blocks=16).map_batches(spy)
        rows = ds.limit(25).take_all()
        return [r["x"] for r in rows], rt.get(touch.count.remote(),
                                              timeout=60)
    ref, port = both(pkgs, run)
    assert port[0] == ref[0] == list(range(25))
    assert port[1] < 16, f"limit ran {port[1]}/16 upstream blocks"


def test_op_bytes_budget_backpressure(pkgs):
    ref_data, port_data = pkgs
    import ray_tpu_torch
    from ray_tpu_torch.data.context import DataContext
    from ray_tpu_torch.data.streaming_executor import StreamingExecutor
    ctx = DataContext.get_current()
    old = ctx.op_bytes_budget
    ctx.op_bytes_budget = 2 * 1024 * 1024
    try:
        ds = port_data.from_items([{"i": i} for i in range(12)],
                                  override_num_blocks=12)

        def fatten(batch):
            n = len(batch["i"])
            return {"i": batch["i"],
                    "blob": np.zeros((n, 200_000), np.float32)}

        ds2 = ds.map_batches(fatten)
        ops = ds2._build_operators(8)
        consumed = 0
        for ref in StreamingExecutor(ops).execute(list(ds2._block_refs)):
            ray_tpu_torch.get(ref, timeout=120)
            consumed += 1
        assert consumed == 12
        fat_op = ops[0]
        assert fat_op.max_outstanding_bytes <= ctx.op_bytes_budget \
            + 900_000, fat_op.max_outstanding_bytes
        assert fat_op.max_outstanding_bytes > 0
    finally:
        ctx.op_bytes_budget = old


def test_range_tensor_and_tfrecords_roundtrip(pkgs, tmp_path):
    def run(d):
        out = str(tmp_path / d.__name__)
        d.from_items([{"bytes": f"rec-{i}".encode()} for i in range(7)]) \
            .write_tfrecords(out)
        files = sorted(os.listdir(out))
        raw = [open(os.path.join(out, f), "rb").read() for f in files]
        return (d.range_tensor(10, shape=(2,)).take(10),
                sorted(r["bytes"] for r in d.read_tfrecords(out).take(20)),
                raw)
    ref, port = both(pkgs, run)
    assert port == ref        # the same rows, and the same file bytes
    assert len(port[0]) == 10
    assert port[1] == [f"rec-{i}".encode() for i in range(7)]


def test_parquet_write_fans_out_tasks(pkgs, tmp_path):
    import glob as _glob

    def run(d):
        ds = d.range(200)
        out = str(tmp_path / d.__name__)
        ds.write_parquet(out)
        files = _glob.glob(out + "/part-*.parquet")
        return len(files), ds.num_blocks(), sum(
            r["id"] for r in d.read_parquet(out).take(300))
    ref, port = both(pkgs, run)
    assert port == ref
    assert port[0] == port[1] and port[2] == sum(range(200))


def test_text_binary_numpy_json_readers(pkgs, tmp_path):
    (tmp_path / "t.txt").write_text("alpha\nbeta\n")
    (tmp_path / "b.bin").write_bytes(b"\x00\x01ab\x00")
    np.save(tmp_path / "a.npy", np.arange(12).reshape(4, 3))
    (tmp_path / "j.json").write_text('{"a": 1, "s": "x"}\n'
                                     '{"a": 2, "s": "y"}\n')

    def run(d):
        return (d.read_text(str(tmp_path / "t.txt")).take_all(),
                d.read_binary_files(str(tmp_path / "b.bin")).take_all(),
                d.read_numpy(str(tmp_path / "a.npy")).take_all(),
                d.read_json(str(tmp_path / "j.json")).take_all())
    ref, port = both(pkgs, run)
    assert port == ref
    assert port[1][0]["bytes"] == b"\x00\x01ab\x00"


_NO_ARROW = r"""
import sys
BLOCKED = ("pyarrow", "pandas", "jax", "jaxlib", "ray_tpu")
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, Blocker())
for m in list(sys.modules):
    if m.split(".")[0] in BLOCKED:
        del sys.modules[m]
import numpy as np
import ray_tpu_torch.data as data
import ray_tpu_torch.adapters
from ray_tpu_torch.data.block import BlockAccessor, batch_to_block
blk = batch_to_block([{"a": 1, "s": "x"}, {"a": 2, "s": "y"}])
acc = BlockAccessor(blk)
assert acc.num_rows() == 2 and acc.to_pylist()[1] == {"a": 2, "s": "y"}
for fn in (acc.to_arrow, acc.to_pandas):
    try:
        fn()
    except ImportError as e:
        assert "not installed" in str(e), e
    else:
        raise SystemExit("no ImportError")
try:
    data.read_parquet("nowhere.parquet")
except ImportError as e:
    assert "pyarrow" in str(e)
else:
    raise SystemExit("no ImportError")
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("OK", bad)
sys.exit(1 if bad else 0)
"""


def test_data_and_adapters_import_without_pyarrow_pandas_or_jax():
    """``import ray_tpu_torch.data`` and ``ray_tpu_torch.adapters`` with
    neither pyarrow, pandas, jax nor ray_tpu importable; the formats
    that need pyarrow or pandas raise an ``ImportError`` naming it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _NO_ARROW], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")
