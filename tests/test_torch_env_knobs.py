"""Env-knob drift lint for the port: code vs README (the counterpart of
``tests/test_env_knobs.py``, which scans ``ray_tpu/``).

Every ``RAY_TPU_*`` environment variable that a string literal in
``ray_tpu_torch/**/*.py`` or ``chip_smoke.py`` names (docstrings
excluded: prose mentions are fine) must have a row in a README knob
table.  The other way: the README's knob tables are shared by both
packages, so every documented knob the port does not read must be one
of the JAX package's own (its Pallas blocking and kernel switches),
listed below; a port knob that goes dead, or a reference knob the port
starts reading, shows up as a difference from that list.
"""

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

from test_env_knobs import KNOB, readme_knobs  # noqa: E402

# documented knobs only the JAX package reads: the Pallas kernels'
# blocking and schedule switches, its decode-attention switch, the
# bench's smoke flag and the GCE metadata probe of its TPU detector
REFERENCE_ONLY = {
    "RAY_TPU_ATTN_BWD_BK", "RAY_TPU_ATTN_BWD_BQ", "RAY_TPU_ATTN_PACK2",
    "RAY_TPU_ATTN_PACK2_BK", "RAY_TPU_ATTN_PACK2_BQ", "RAY_TPU_BENCH_SMOKE",
    "RAY_TPU_CE", "RAY_TPU_CE_BN", "RAY_TPU_CE_BV", "RAY_TPU_CE_BWD_BN",
    "RAY_TPU_CE_BWD_BV", "RAY_TPU_DISABLE_GCE_METADATA", "RAY_TPU_FUSE_NORM",
    "RAY_TPU_FUSE_NORM_BN", "RAY_TPU_INFER_DECODE"}


def port_knobs():
    import ast
    found = {}
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        tree = ast.parse(f.read_text())
        docstrings = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef,
                                 ast.FunctionDef, ast.AsyncFunctionDef)):
                body = node.body
                if (body and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)):
                    docstrings.add(id(body[0].value))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and id(node) not in docstrings):
                for name in KNOB.findall(node.value):
                    found.setdefault(name, set()).add(
                        str(f.relative_to(REPO)))
    return found


def test_scan_finds_the_ports_knobs():
    """An empty scan would pass everything: the port reads its serving,
    training, data and fleet knobs."""
    code = port_knobs()
    assert len(code) >= 90
    for name in ("RAY_TPU_KV_DTYPE", "RAY_TPU_ACCUM", "RAY_TPU_PP_SCHEDULE",
                 "RAY_TPU_FLEET_HEDGE", "RAY_TPU_DATA_PACK"):
        assert name in code, name


def test_every_port_knob_is_documented():
    documented = readme_knobs()
    missing = {k: sorted(v) for k, v in sorted(port_knobs().items())
               if k not in documented}
    assert not missing, (
        "env knobs the port reads but the README knob tables lack (add a "
        f"row or delete the knob): {missing}")


def test_documented_knobs_the_port_does_not_read_are_the_references():
    unread = readme_knobs() - set(port_knobs())
    assert unread == REFERENCE_ONLY, (
        "README knobs the port does not read, against the JAX package's "
        f"own: extra {sorted(unread - REFERENCE_ONLY)}, now read "
        f"{sorted(REFERENCE_ONLY - unread)}")
