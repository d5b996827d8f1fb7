"""The port stands alone: ``ray_tpu_torch`` and every one of its
submodules import without ``jax`` or any ``ray_tpu`` module, and its
entry points never drift to the CPU on their own."""

import os
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
    assert n_modules >= 14


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
