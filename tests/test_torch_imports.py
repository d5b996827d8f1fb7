"""The port stands alone: ``ray_tpu_torch``, every one of its
submodules and ``chip_smoke.py`` import without ``jax`` or any
``ray_tpu`` module, and its entry points never drift to the CPU on their
own."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import ray_tpu_torch
names = ["ray_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    ray_tpu_torch.__path__, "ray_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_ray_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 35


# the training slice's modules, the third slice's (prefix caching, the
# int8 cache, the RMSNorm kernels) and the serving surface's (chaos,
# tracing, telemetry, the watchdog, the adapters' error), which the
# probe above must reach
_SLICE_MODULES = ("ray_tpu_torch/ops/flash_ce.py",
                  "ray_tpu_torch/models/training.py",
                  "ray_tpu_torch/telemetry/flops.py",
                  "ray_tpu_torch/ops/rmsnorm.py",
                  "ray_tpu_torch/quant/__init__.py",
                  "ray_tpu_torch/quant/block_scale.py",
                  "ray_tpu_torch/util/chaos.py",
                  "ray_tpu_torch/util/tracing.py",
                  "ray_tpu_torch/telemetry/config.py",
                  "ray_tpu_torch/telemetry/chrome_trace.py",
                  "ray_tpu_torch/telemetry/trace.py",
                  "ray_tpu_torch/telemetry/infer.py",
                  "ray_tpu_torch/resilience/watchdog.py",
                  "ray_tpu_torch/adapters/__init__.py")


def _imported_roots(path):
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_port_names_jax_or_ray_tpu():
    """Every import statement, including those inside functions (which
    the probe does not run), in every module of the port and in
    ``chip_smoke.py``."""
    root = pathlib.Path(REPO)
    files = sorted((root / "ray_tpu_torch").rglob("*.py")) + \
        [root / "chip_smoke.py"]
    assert all((root / m) in files for m in _SLICE_MODULES)
    for f in files:
        bad = {r for r in _imported_roots(f)
               if r in ("jax", "jaxlib", "ray_tpu")}
        assert not bad, (str(f), bad)


def test_entry_points_raise_without_a_card(monkeypatch):
    from ray_tpu_torch import GPTConfig, InferenceEngine, init_params
    from ray_tpu_torch.ops import _build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, params)
    # with the CPU asked for, the plain versions run and nothing builds
    engine = InferenceEngine(cfg, params, device="cpu", slots=1,
                             page_size=16, buckets=(16,))
    assert len(engine.generate([[1, 2, 3]], max_new_tokens=2)[0]) == 2
    assert _build._lib is None
