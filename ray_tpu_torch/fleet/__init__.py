"""``ray_tpu_torch.fleet`` — fleet-scale serving: N replicas as one
service.

Counterpart of ``ray_tpu.fleet``, the layer above one engine, run
in-process and driven from the host:

- :class:`~ray_tpu_torch.fleet.router.FleetRouter` — a
  ``DeploymentHandle``-shaped router over
  :class:`~ray_tpu_torch.fleet.replica.EngineReplica` objects:
  power-of-two-choices on queue depth, tier-aware **prefix affinity**
  (prompts route to the replica whose prefix index already holds their
  pages), **mid-stream failover** (a dead or wedged replica's streams
  re-admit on a healthy one, re-prefilling prompt + already-emitted
  tokens; at-most-once token delivery, a typed
  :class:`~ray_tpu_torch.fleet.router.ReplicaUnavailableError` only
  when retries run out), gray-failure demotion and hedging.
- :class:`~ray_tpu_torch.fleet.reconciler.Reconciler` — an
  autoscaler-v2-style instance state machine (STARTING → RUNNING →
  DRAINING → STOPPED / WEDGED → RESTARTING, and RUNNING ⇄ DEGRADED →
  DRAINING): watchdog-signalled restarts with capped backoff,
  dwell-gated drain-restart of chronically slow replicas, queue-depth /
  TTFT-SLO scale-up, drain-based scale-down.
- :class:`~ray_tpu_torch.fleet.disagg.DisaggRouter` — a prefill pool
  (streams end at the first token) and a decode pool that imports the
  handed-off KV pages (:class:`~ray_tpu_torch.fleet.disagg.
  HandoffStore`, in-process), with digest affinity making warm
  handoffs metadata-only, and per-pool
  :class:`~ray_tpu_torch.fleet.disagg.PoolView` adapters for the
  reconciler.

Recovery is tested under deterministic ``RAY_TPU_FAULTS`` plans (sites
``serve.replica`` / ``serve.route`` / ``serve.tick`` /
``serve.tick[<replica_id>]`` / ``serve.handoff`` in
:mod:`ray_tpu_torch.util.chaos`).  Config via ``RAY_TPU_FLEET_*``
(:func:`fleet_config`).
"""

from ray_tpu_torch.fleet.config import (FleetConfig,  # noqa: F401
                                        fleet_config)
from ray_tpu_torch.fleet.disagg import (DisaggRouter,  # noqa: F401
                                        DisaggStream, HandoffStore,
                                        PoolView)
from ray_tpu_torch.fleet.reconciler import (DEGRADED,  # noqa: F401
                                            DRAINING, RESTARTING,
                                            RUNNING, STARTING, STOPPED,
                                            WEDGED, Instance, Reconciler)
from ray_tpu_torch.fleet.replica import EngineReplica  # noqa: F401
from ray_tpu_torch.fleet.router import (FleetRouter,  # noqa: F401
                                        FleetStream,
                                        ReplicaUnavailableError)

__all__ = [
    "FleetConfig", "fleet_config",
    "EngineReplica", "FleetRouter", "FleetStream",
    "ReplicaUnavailableError",
    "DisaggRouter", "DisaggStream", "HandoffStore", "PoolView",
    "Reconciler", "Instance",
    "STARTING", "RUNNING", "DRAINING", "STOPPED", "WEDGED",
    "RESTARTING", "DEGRADED",
]
