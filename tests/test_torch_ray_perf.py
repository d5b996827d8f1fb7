"""Port parity: ``ray_tpu_torch._private.ray_perf`` and ``scale_probe``
against the JAX package's copies.

The microbenchmark driver and the scale probes keep the reference's
names, signatures and printed metric names, so that a port number sits
beside the reference's line for line.  Here, on the CPU:

- each kernel probe at a small shape returns the reference's keys and
  result name, and its FLOP count (``effective_tflops`` x the step time)
  equals the reference's at the same shape, exactly: the count is a
  formula of the shape, so any drift in it is a changed formula;
- ``train_step_perf`` returns the reference's telemetry keys with the
  same analytic FLOPs per token;
- ``main`` in a port session, through the CLI's ``microbenchmark``,
  prints exactly the metric names of the reference's ``main`` (read from
  its source), in its order;
- the scale probes at small sizes return the keys of the reference's
  probes (read from its source).

The reference probes run as the JAX package runs them on the CPU (Pallas
in interpret mode); the port's take ``device="cpu"``, their kernels'
plain versions.  Timings are not compared: they say nothing here.
"""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_source(name: str) -> ast.Module:
    with open(os.path.join(REPO, "ray_tpu", "_private", name)) as f:
        return ast.parse(f.read())


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _flops(r: dict) -> float:
    """The FLOP count a result was computed with (the rate's numerator)."""
    if "effective_gflops" in r:
        return r["effective_gflops"] * 1e9 * r["us_per_step"] * 1e-6
    return r["effective_tflops"] * 1e12 * r["ms_per_step"] * 1e-3


# (probe, kwargs): both arms of each A/B at a small shape, the new
# attention variants (non-causal, head dim 128) among them
_PROBES = [
    ("attention_perf", dict(batch=1, seq=128, heads=2, head_dim=64,
                            steps=1)),
    ("attention_perf", dict(batch=1, seq=128, heads=2, head_dim=128,
                            steps=1, causal=False, pack2=True)),
    ("ce_perf", dict(n_tokens=128, d_model=64, vocab=512, steps=1)),
    ("ce_perf", dict(n_tokens=128, d_model=64, vocab=512, steps=1,
                     mode="noremat")),
    ("fused_norm_perf", dict(n_tokens=128, heads=2, head_dim=64,
                             d_model=128, steps=1)),
    ("fused_norm_perf", dict(n_tokens=128, heads=2, head_dim=64,
                             d_model=128, steps=1, fused=False)),
    ("decode_perf", dict(batch=2, ctx=128, heads=2, head_dim=128, steps=1,
                         impl="pallas")),
    ("decode_perf", dict(batch=2, ctx=128, heads=2, head_dim=64, steps=1,
                         impl="xla")),
    ("decode_perf", dict(batch=2, ctx=128, heads=2, head_dim=64, steps=1,
                         impl="auto")),
    ("collective_perf", dict(tokens=64, d_model=32, d_out=64, steps=1,
                             n_devices=1)),
]


@pytest.mark.parametrize("probe, kwargs", _PROBES,
                         ids=[f"{p}-{i}" for i, (p, _) in
                              enumerate(_PROBES)])
def test_kernel_probe_matches_reference(probe, kwargs, capsys):
    from ray_tpu._private import ray_perf as ref
    from ray_tpu_torch._private import ray_perf as port

    want = getattr(ref, probe)(**kwargs)
    ref_out = capsys.readouterr().out
    got = getattr(port, probe)(**kwargs, device="cpu")
    port_out = capsys.readouterr().out
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert _flops(g) == pytest.approx(_flops(w), rel=1e-9)
        assert all(v > 0 for k, v in g.items()
                   if k not in ("name", "gathered_bytes_per_device"))
    # the printed lines name the same results, in the same form
    strip = re.compile(r"[-0-9.,]+")
    assert ([strip.sub("#", ln) for ln in port_out.splitlines()]
            == [strip.sub("#", ln) for ln in ref_out.splitlines()])


def test_train_step_perf_matches_reference_telemetry(capsys):
    """The telemetry block's keys are the reference's and its analytic
    FLOPs per token equal (the same smoke GPT on both sides)."""
    import json

    from ray_tpu._private import ray_perf as ref
    from ray_tpu_torch._private import ray_perf as port

    want = ref.train_step_perf(steps=2)
    got = port.train_step_perf(steps=2, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["metric"] == "train_step_telemetry"
    assert sorted(got) == sorted(want)
    assert got["flops_per_token"] == want["flops_per_token"]
    assert got["tokens_per_step"] == want["tokens_per_step"] == 4 * 128
    assert got["steps"] == want["steps"] == 2
    assert got["steady_step_s"] > 0 and got["mfu"] > 0


def _ref_main_names():
    """The metric names of the reference's ``main``, in order: the first
    argument of each ``timeit`` call."""
    fn = _function(_ref_source("ray_perf.py"), "main")
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "timeit"]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [c.args[0].value for c in calls]


def test_microbenchmark_cli_prints_reference_metric_names(capsys):
    """``ray_tpu_torch microbenchmark`` (``cmd_microbenchmark``) starts a
    port session, runs ``ray_perf.main`` at a short duration and prints
    exactly the reference's metric names, in its order, each with a
    positive rate."""
    from ray_tpu_torch.scripts import scripts

    names = _ref_main_names()
    assert len(names) == 11
    scripts.main(["microbenchmark", "--duration", "0.05"])
    out = capsys.readouterr().out
    got = re.findall(r"^(.*) per second ([0-9.]+)$", out, re.M)
    assert [n for n, _ in got] == names
    assert all(float(r) > 0 for _, r in got)


def _ref_probe_keys(name: str) -> set:
    """The keys of the dict literal a reference probe returns."""
    fn = _function(_ref_source("scale_probe.py"), name)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


def test_scale_probes_return_reference_keys():
    """The four probes at small sizes (200 tasks, 200 refs, 8 actors,
    1 MiB to 2 nodes), each in a fresh port session as ``main`` runs
    them, return the keys of the reference's probes and count what they
    were asked to."""
    import ray_tpu_torch
    from ray_tpu_torch._private import scale_probe as sp

    runs = {"probe_queue_tasks": lambda: sp.probe_queue_tasks(200),
            "probe_wait_many_refs": lambda: sp.probe_wait_many_refs(200),
            "probe_actors": lambda: sp.probe_actors(8, calls_per_actor=2),
            "probe_broadcast": lambda: sp.probe_broadcast(size_mb=1,
                                                          n_nodes=2)}
    out = {}
    for name, run in runs.items():
        ray_tpu_torch.init(num_cpus=4)
        try:
            out[name] = run()
        finally:
            ray_tpu_torch.shutdown()
        assert set(out[name]) == _ref_probe_keys(name), name
    assert out["probe_queue_tasks"]["n"] == 200
    assert out["probe_wait_many_refs"]["n"] == 200
    assert out["probe_actors"]["n_actors"] == 8
    assert out["probe_broadcast"]["n_nodes"] == 2


def test_scale_probe_main_writes_no_tracked_file():
    """``python -m ray_tpu_torch._private.scale_probe`` writes to the path
    it is given, else under ``build/`` (git-ignored), never over the
    reference's ``SCALE_r05.json``."""
    from ray_tpu_torch._private import scale_probe as sp

    assert sp.DEFAULT_OUT.startswith("build" + os.sep)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "/build/" in f.read().split()
