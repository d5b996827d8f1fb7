"""Metrics-naming drift lint for the port (the counterpart of
``tests/test_metrics_naming.py``, which scans ``ray_tpu/telemetry``).

Every ``Counter``/``Histogram``/``Gauge`` registered with a literal name
in ``ray_tpu_torch/telemetry/*.py``: counters end ``_total``, histograms
carry a unit suffix, no name is registered by two modules, and the port
registers the JAX package's names (dashboards read one set of series
whichever package serves).
"""

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import test_metrics_naming as ref  # noqa: E402

HIST_SUFFIXES = ref.HIST_SUFFIXES


def registrations(package):
    """``[(file, kind, name), ...]`` in ``<package>/telemetry``."""
    import ast
    out = []
    for f in sorted((REPO / package / "telemetry").glob("*.py")):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            kind = (func.id if isinstance(func, ast.Name)
                    else func.attr if isinstance(func, ast.Attribute)
                    else None)
            first = node.args[0]
            if kind in ("Counter", "Histogram", "Gauge") \
                    and isinstance(first, ast.Constant) \
                    and isinstance(first.value, str):
                out.append((f.name, kind, first.value))
    return out


def test_lint_finds_registrations():
    regs = registrations("ray_tpu_torch")
    assert len(regs) >= 20
    assert any(n == "serve_failovers_total" for _, _, n in regs)
    assert any(n == "serve_hedges_won_total" for _, _, n in regs)


def test_counters_end_in_total():
    bad = [(f, n) for f, kind, n in registrations("ray_tpu_torch")
           if kind == "Counter" and not n.endswith("_total")]
    assert not bad, f"Counter names must end '_total': {bad}"


def test_histograms_carry_a_unit_suffix():
    bad = [(f, n) for f, kind, n in registrations("ray_tpu_torch")
           if kind == "Histogram" and not n.endswith(HIST_SUFFIXES)]
    assert not bad, f"Histogram names must end in {HIST_SUFFIXES}: {bad}"


def test_no_duplicate_metric_names_across_modules():
    seen, dups = {}, []
    for f, kind, n in registrations("ray_tpu_torch"):
        prev = seen.setdefault(n, (f, kind))
        if prev != (f, kind):
            dups.append((n, prev, (f, kind)))
    assert not dups, f"metric names registered by two modules: {dups}"


def test_port_registers_the_references_names():
    port = {(k, n) for _f, k, n in registrations("ray_tpu_torch")}
    want = {(k, n) for _f, k, n in registrations("ray_tpu")}
    assert port == want, (sorted(port - want), sorted(want - port))
