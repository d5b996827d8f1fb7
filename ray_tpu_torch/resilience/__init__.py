"""``ray_tpu_torch.resilience`` — supervision and recovery for training
and serving, the counterpart of ``ray_tpu.resilience``:

- **train** — async checkpoint/resume (:class:`TrainCheckpointer`,
  :func:`run_train_ckpt_loop`; with the streaming data plane's cursor in
  the snapshot, :func:`run_train_stream_loop`): snapshots off the
  critical path, retention, corrupt snapshots fall back loudly, resume
  float-equal;
- **elastic** — cross-mesh restore (:func:`reshard_state`, the mesh and
  accumulation sidecar, :class:`MeshMismatchError`), global-batch
  invariant accumulation, and the shrink/expand loop
  :func:`run_elastic_train_loop` driven by the ``mesh.loss`` /
  ``mesh.restore`` / ``mesh.step`` chaos sites, with the
  :class:`StragglerSupervisor`;
- **serving** — the :class:`EngineWatchdog` wedge detector;
- **RL** — the supervised actor/learner loop
  :func:`run_supervised_rl_loop`: dead rollout actors replaced, a dead
  learner restored from its checkpoint and republished, a killed loop
  resumed, a failed publication skipped.

Config via ``RAY_TPU_CKPT_*``, ``RAY_TPU_ELASTIC_*`` and
``RAY_TPU_STRAGGLER_*`` (:func:`resilience_config`).
"""

from ray_tpu_torch.resilience.checkpoint import (  # noqa: F401
    TrainCheckpointer, run_train_ckpt_loop, run_train_stream_loop)
from ray_tpu_torch.resilience.config import (  # noqa: F401
    ResilienceConfig, resilience_config)
from ray_tpu_torch.resilience.elastic import (  # noqa: F401
    ElasticError, MeshMismatchError, ReshardError, StateShardings,
    host_state, reshard_state, run_elastic_train_loop, state_shardings,
    validate_resharding)
from ray_tpu_torch.resilience.straggler import (  # noqa: F401
    StragglerSupervisor)
from ray_tpu_torch.resilience.supervisor import (  # noqa: F401
    run_supervised_rl_loop)
from ray_tpu_torch.resilience.watchdog import EngineWatchdog  # noqa: F401

__all__ = [
    "ResilienceConfig", "resilience_config",
    "TrainCheckpointer", "run_train_ckpt_loop", "run_train_stream_loop",
    "ElasticError", "MeshMismatchError", "ReshardError",
    "StateShardings", "state_shardings", "host_state",
    "validate_resharding", "reshard_state", "run_elastic_train_loop",
    "StragglerSupervisor",
    "EngineWatchdog",
    "run_supervised_rl_loop",
]
