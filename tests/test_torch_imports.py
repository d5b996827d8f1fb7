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
    assert n_modules >= 101


_FIRST_PROBE = r"""
import importlib, pkgutil, sys
import ray_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                               "ray_tpu_torch.")]
bad = []
for name in names:
    for m in [m for m in sys.modules
              if m == "ray_tpu_torch" or m.startswith("ray_tpu_torch.")]:
        del sys.modules[m]
    try:
        importlib.import_module(name)
    except Exception as e:  # noqa: BLE001
        bad.append((name, repr(e)))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_every_module_imports_first():
    """Each module of the port imports as the first of the package (the
    package's ``__init__`` imports no submodule of the engine, so an
    import cycle among them shows only when one is imported first)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _FIRST_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


# the training slice's modules, the third slice's (prefix caching, the
# int8 cache, the RMSNorm kernels), the serving surface's (chaos,
# tracing, telemetry, the watchdog, the adapters' error) and the fleet's
# (replicas, routers, reconciler, disaggregated pools, their telemetry
# and the request parser) and the runtime's (the node manager, workers,
# the object store and its native source's binding, the control plane,
# the API, the CLI and the GPU manager) and serving on the runtime's
# (serve's controller, replica, handle and proxies) and the training
# options' and data parallelism's (the fused CE, the step recorder, the
# dp mesh, the collectives and train/) and the data plane's and
# resilience's (sources, packer, stream, checkpointer, elastic loop,
# straggler supervisor and their recorders) and the Dataset API's and
# the adapters' (blocks, the executor, datasets, iterators, readers,
# connectors; LoRA config, factor math, store and registry) and the RL
# loop's (rl/, the learner group, its recorder and the supervised
# loop) and rllib's (modules, env runners and algorithms, and the
# profiling helpers) and the libraries' (tune with its searchers and
# schedulers, dag with channels, workflow, util's pools, job, dashboard,
# autoscaler, air and tqdm_ray), which the probe above must reach
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
                  "ray_tpu_torch/adapters/__init__.py",
                  "ray_tpu_torch/fleet/__init__.py",
                  "ray_tpu_torch/fleet/config.py",
                  "ray_tpu_torch/fleet/replica.py",
                  "ray_tpu_torch/fleet/router.py",
                  "ray_tpu_torch/fleet/reconciler.py",
                  "ray_tpu_torch/fleet/disagg.py",
                  "ray_tpu_torch/telemetry/fleet.py",
                  "ray_tpu_torch/inference/serve_gpt.py",
                  "ray_tpu_torch/_private/node.py",
                  "ray_tpu_torch/_private/node_manager.py",
                  "ray_tpu_torch/_private/worker.py",
                  "ray_tpu_torch/_private/worker_proc.py",
                  "ray_tpu_torch/_private/worker_forkserver.py",
                  "ray_tpu_torch/_private/object_store.py",
                  "ray_tpu_torch/_private/shmstore_native.py",
                  "ray_tpu_torch/_private/control_plane.py",
                  "ray_tpu_torch/actor.py",
                  "ray_tpu_torch/remote_function.py",
                  "ray_tpu_torch/util/placement_group.py",
                  "ray_tpu_torch/util/metrics.py",
                  "ray_tpu_torch/util/state/__init__.py",
                  "ray_tpu_torch/scripts/scripts.py",
                  "ray_tpu_torch/accelerators/gpu.py",
                  "ray_tpu_torch/serve/__init__.py",
                  "ray_tpu_torch/serve/handle.py",
                  "ray_tpu_torch/serve/_private/controller.py",
                  "ray_tpu_torch/serve/_private/replica.py",
                  "ray_tpu_torch/serve/_private/proxy.py",
                  "ray_tpu_torch/serve/_private/mux_context.py",
                  "ray_tpu_torch/ops/fused_ce.py",
                  "ray_tpu_torch/telemetry/step.py",
                  "ray_tpu_torch/parallel/mesh.py",
                  "ray_tpu_torch/util/collective.py",
                  "ray_tpu_torch/train/__init__.py",
                  "ray_tpu_torch/train/backend.py",
                  "ray_tpu_torch/train/checkpoint.py",
                  "ray_tpu_torch/train/checkpoint_manager.py",
                  "ray_tpu_torch/train/config.py",
                  "ray_tpu_torch/train/data_parallel_trainer.py",
                  "ray_tpu_torch/train/result.py",
                  "ray_tpu_torch/train/session.py",
                  "ray_tpu_torch/train/storage.py",
                  "ray_tpu_torch/train/worker_group.py",
                  "ray_tpu_torch/train/torch/__init__.py",
                  "ray_tpu_torch/train/torch/config.py",
                  "ray_tpu_torch/parallel/pipeline.py",
                  "ray_tpu_torch/parallel/moe.py",
                  "ray_tpu_torch/data/__init__.py",
                  "ray_tpu_torch/data/config.py",
                  "ray_tpu_torch/data/source.py",
                  "ray_tpu_torch/data/packer.py",
                  "ray_tpu_torch/data/stream.py",
                  "ray_tpu_torch/telemetry/data.py",
                  "ray_tpu_torch/telemetry/ckpt.py",
                  "ray_tpu_torch/telemetry/elastic.py",
                  "ray_tpu_torch/resilience/__init__.py",
                  "ray_tpu_torch/resilience/config.py",
                  "ray_tpu_torch/resilience/checkpoint.py",
                  "ray_tpu_torch/resilience/straggler.py",
                  "ray_tpu_torch/resilience/elastic.py",
                  "ray_tpu_torch/data/block.py",
                  "ray_tpu_torch/data/context.py",
                  "ray_tpu_torch/data/streaming_executor.py",
                  "ray_tpu_torch/data/dataset.py",
                  "ray_tpu_torch/data/iterator.py",
                  "ray_tpu_torch/data/read_api.py",
                  "ray_tpu_torch/data/io_extra.py",
                  "ray_tpu_torch/data/connectors.py",
                  "ray_tpu_torch/adapters/config.py",
                  "ray_tpu_torch/adapters/lora.py",
                  "ray_tpu_torch/adapters/store.py",
                  "ray_tpu_torch/adapters/registry.py",
                  "ray_tpu_torch/rl/__init__.py",
                  "ray_tpu_torch/rl/config.py",
                  "ray_tpu_torch/rl/reward.py",
                  "ray_tpu_torch/rl/rollout.py",
                  "ray_tpu_torch/rl/replay.py",
                  "ray_tpu_torch/rl/learner.py",
                  "ray_tpu_torch/rl/loop.py",
                  "ray_tpu_torch/rllib/__init__.py",
                  "ray_tpu_torch/rllib/core/__init__.py",
                  "ray_tpu_torch/rllib/core/learner_group.py",
                  "ray_tpu_torch/telemetry/rl.py",
                  "ray_tpu_torch/resilience/supervisor.py",
                  "ray_tpu_torch/rllib/core/rl_module.py",
                  "ray_tpu_torch/rllib/core/learner.py",
                  "ray_tpu_torch/rllib/env/env_runner.py",
                  "ray_tpu_torch/rllib/env/multi_agent_env.py",
                  "ray_tpu_torch/rllib/algorithms/ppo.py",
                  "ray_tpu_torch/rllib/algorithms/dqn.py",
                  "ray_tpu_torch/rllib/algorithms/bc.py",
                  "ray_tpu_torch/rllib/algorithms/impala.py",
                  "ray_tpu_torch/rllib/algorithms/sac.py",
                  "ray_tpu_torch/rllib/algorithms/multi_agent_ppo.py",
                  "ray_tpu_torch/util/profiling.py",
                  "ray_tpu_torch/models/mlp.py",
                  "ray_tpu_torch/models/resnet.py",
                  "ray_tpu_torch/train/huggingface/__init__.py",
                  "ray_tpu_torch/train/huggingface/weights.py",
                  "ray_tpu_torch/train/huggingface/transformers_trainer.py",
                  "ray_tpu_torch/tune/__init__.py",
                  "ray_tpu_torch/tune/callbacks.py",
                  "ray_tpu_torch/tune/schedulers.py",
                  "ray_tpu_torch/tune/trainable.py",
                  "ray_tpu_torch/tune/tuner.py",
                  "ray_tpu_torch/tune/search/__init__.py",
                  "ray_tpu_torch/tune/search/sample.py",
                  "ray_tpu_torch/tune/search/searcher.py",
                  "ray_tpu_torch/tune/search/tpe.py",
                  "ray_tpu_torch/tune/search/bayesopt.py",
                  "ray_tpu_torch/experimental/__init__.py",
                  "ray_tpu_torch/experimental/channel.py",
                  "ray_tpu_torch/experimental/tqdm_ray.py",
                  "ray_tpu_torch/dag/__init__.py",
                  "ray_tpu_torch/dag/compiled.py",
                  "ray_tpu_torch/workflow/__init__.py",
                  "ray_tpu_torch/workflow/events.py",
                  "ray_tpu_torch/util/actor_pool.py",
                  "ray_tpu_torch/util/queue.py",
                  "ray_tpu_torch/util/multiprocessing.py",
                  "ray_tpu_torch/util/joblib.py",
                  "ray_tpu_torch/job/__init__.py",
                  "ray_tpu_torch/dashboard/__init__.py",
                  "ray_tpu_torch/dashboard/app.py",
                  "ray_tpu_torch/_private/ray_perf.py",
                  "ray_tpu_torch/_private/scale_probe.py",
                  "ray_tpu_torch/autoscaler/__init__.py",
                  "ray_tpu_torch/autoscaler/v2.py",
                  "ray_tpu_torch/air/__init__.py",
                  "ray_tpu_torch/air/integrations/__init__.py",
                  "ray_tpu_torch/air/integrations/wandb.py",
                  "ray_tpu_torch/air/integrations/mlflow.py")


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


_RL_PROBE = r"""
import sys
import torch
assert not torch.cuda.is_available()
import ray_tpu_torch.rl
import ray_tpu_torch.rllib.core.learner_group
import ray_tpu_torch.telemetry.rl
import ray_tpu_torch.resilience.supervisor
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.rl import InProcessLearner, run_rl_loop
from ray_tpu_torch.resilience import run_supervised_rl_loop
cfg = GPTConfig.tiny(dtype=torch.float32)
for call in (lambda: InProcessLearner(cfg), lambda: run_rl_loop(cfg, steps=1),
             lambda: run_supervised_rl_loop(cfg, steps=1)):
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError("an RL entry point ran without a card")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "triton"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_rl_slice_imports_no_jax_and_needs_a_card():
    """``rl``, the learner group, the RL recorder and the supervised loop
    import with no jax, no ``ray_tpu`` and no triton in ``sys.modules``
    and no card visible; their entry points then raise rather than
    drift to the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", _RL_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_RLLIB_PROBE = r"""
import sys
import torch
assert not torch.cuda.is_available()
import ray_tpu_torch.rllib
import ray_tpu_torch.rllib.algorithms.bc
import ray_tpu_torch.rllib.algorithms.dqn
import ray_tpu_torch.rllib.algorithms.impala
import ray_tpu_torch.rllib.algorithms.multi_agent_ppo
import ray_tpu_torch.rllib.algorithms.ppo
import ray_tpu_torch.rllib.algorithms.sac
import ray_tpu_torch.rllib.core.rl_module
import ray_tpu_torch.rllib.env.env_runner
import ray_tpu_torch.rllib.env.multi_agent_env
import ray_tpu_torch.train.checkpoint
import ray_tpu_torch.util.profiling
from ray_tpu_torch.rllib.algorithms import bc, dqn, impala, ppo, sac
from ray_tpu_torch.rllib.core import rl_module as rm
disc = rm.DiscreteMLPModule(rm.MLPModuleConfig())
cont = rm.ContinuousModuleConfig()
for call in (lambda: ppo.PPOLearner(disc, ppo.PPOConfig()),
             lambda: dqn.DQNLearner(disc, dqn.DQNConfig()),
             lambda: bc.BCLearner(disc, bc.BCConfig()),
             lambda: impala.IMPALALearner(disc, impala.IMPALAConfig()),
             lambda: sac.SACLearner(rm.SquashedGaussianModule(cont),
                                    rm.TwinQModule(cont), sac.SACConfig())):
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError("an rllib learner built without a card")
ppo.PPOLearner(disc, ppo.PPOConfig(), device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "triton",
                                    "gymnasium", "tensorstore"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_rllib_profiling_checkpoint_import_alone_and_need_a_card():
    """``rllib`` (its algorithms, env runners and modules),
    ``util.profiling`` and ``train.checkpoint`` import with no jax, no
    ``ray_tpu``, no triton, no gymnasium and no tensorstore in
    ``sys.modules`` and no card visible; each learner then raises rather
    than drift to the CPU, and runs there when asked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", _RLLIB_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_MODELS_PROBE = r"""
import sys
import torch
assert not torch.cuda.is_available()
import ray_tpu_torch.models.mlp
import ray_tpu_torch.models.resnet
import ray_tpu_torch.train.huggingface
from ray_tpu_torch.models.mlp import MLP, build_mlp_train
from ray_tpu_torch.models.resnet import ResNet18, build_resnet_train
model = ResNet18(num_classes=10)
for call in (lambda: model.init(), lambda: build_resnet_train(model),
             lambda: build_mlp_train(MLP())):
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError("a model entry point ran without a card")
fns = build_resnet_train(model, device="cpu")
state = fns["init_fn"](torch.Generator().manual_seed(0))
state, m = fns["step_fn"](state, (torch.randn(2, 32, 32, 3),
                                  torch.tensor([1, 2])))
assert torch.isfinite(m["loss"]), m
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "triton",
                                    "transformers", "flax"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_models_and_huggingface_import_alone_and_need_a_card():
    """``models.mlp``, ``models.resnet`` and ``train.huggingface`` import
    with no jax, no ``ray_tpu``, no triton and no ``transformers`` in
    ``sys.modules`` and no card visible; their entry points then raise
    rather than drift to the CPU, and a ResNet-18 step runs there when
    asked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", _MODELS_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_WORKER_PROBE = r"""
import sys
import ray_tpu_torch
import ray_tpu_torch._private.worker_proc
assert "torch" not in sys.modules, "the runtime imported torch"


def probe():
    import os
    import sys
    main = sys.modules["__main__"]
    return (sorted(m for m in sys.modules
                   if m.split(".")[0] in ("torch", "jax", "jaxlib",
                                          "ray_tpu")),
            os.environ.get("CUDA_VISIBLE_DEVICES"),
            os.path.basename(getattr(main, "__file__", "") or ""))


ray_tpu_torch.init(num_cpus=1)
try:
    print(repr(ray_tpu_torch.get(ray_tpu_torch.remote(probe).remote(),
                                 timeout=120)))
finally:
    ray_tpu_torch.shutdown()
"""


def test_cpu_worker_imports_no_torch():
    """A CPU task's worker, forked from the template, runs without
    torch, jax or ray_tpu in its ``sys.modules`` and sees no card; the
    driver that imported the runtime has no torch either."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _WORKER_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    bad, visible, start = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert bad == [], bad
    assert visible == ""
    assert start == "worker_forkserver.py"


_SERVE_PROBE = r"""
import sys
import ray_tpu_torch.serve
from ray_tpu_torch.serve._private import controller, proxy, replica
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "ray_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_serve_imports_no_torch():
    """``serve``, its controller, proxies and replica wrapper import no
    torch: the controller and the proxies run in CPU workers, and only a
    replica loads the deployment's class (and torch with it)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _SERVE_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_TRAIN_PROBE = r"""
import sys
import ray_tpu_torch.train
import ray_tpu_torch.train.torch
import ray_tpu_torch.util.collective
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "ray_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_train_and_collectives_import_no_torch():
    """``train``, ``train.torch`` and ``util.collective`` import no
    torch: a driver builds a trainer without it, and the collective
    group's rendezvous actor runs in a CPU worker; torch is imported
    where a verb or a train loop needs it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_LIBS_PROBE = r"""
import sys
import ray_tpu_torch
import ray_tpu_torch.air
import ray_tpu_torch.air.integrations.mlflow
import ray_tpu_torch.air.integrations.wandb
import ray_tpu_torch.autoscaler
import ray_tpu_torch.autoscaler.v2
import ray_tpu_torch.dag
import ray_tpu_torch.dag.compiled
import ray_tpu_torch.dashboard.app
import ray_tpu_torch.experimental.channel
import ray_tpu_torch.experimental.tqdm_ray
import ray_tpu_torch.job
import ray_tpu_torch.tune
import ray_tpu_torch.tune.callbacks
import ray_tpu_torch.tune.search.bayesopt
import ray_tpu_torch.tune.search.tpe
import ray_tpu_torch.util
import ray_tpu_torch.util.joblib
import ray_tpu_torch.util.multiprocessing
import ray_tpu_torch.util.queue
import ray_tpu_torch.workflow
from ray_tpu_torch.dag import ClassNode, FunctionNode, InputNode

@ray_tpu_torch.remote
def f(x):
    return x

@ray_tpu_torch.remote
class A:
    def g(self, x):
        return x

assert isinstance(f.bind(1), FunctionNode)
with InputNode() as inp:
    node = A.bind()
    assert isinstance(node, ClassNode)
    node.g.bind(inp)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "ray_tpu",
                                    "triton", "aiohttp"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_libraries_import_no_torch_and_bind_builds_nodes():
    """tune (its searchers and schedulers), dag, the channels, workflow,
    util's pools, job, dashboard, autoscaler, air and tqdm_ray import no
    torch, jax, ``ray_tpu``, triton or aiohttp (only a trial's own
    function loads torch; the dashboard imports aiohttp when it starts);
    ``.bind()`` on a remote function and an actor class builds DAG
    nodes."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _LIBS_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
