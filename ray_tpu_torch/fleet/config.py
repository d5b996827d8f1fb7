"""Fleet-layer env knobs, the port's copy of ``ray_tpu/fleet/config.py``.

One frozen dataclass resolved from the environment once, as
``infer_config()`` is; ``refresh=True`` re-reads it for tests and
callers that flip flags after import.  Every knob and default is the
reference's.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet router/reconciler knobs, resolved once from the environment.

    - ``RAY_TPU_FLEET_RETRIES`` (default ``2``): mid-stream failover
      budget per request — how many times a stream may be re-admitted
      on a healthy replica after its replica died or wedged before the
      router gives up with a typed
      :class:`~ray_tpu_torch.fleet.router.ReplicaUnavailableError`.
      Draining/queue-full rejections are immediate re-route signals
      and do **not** consume this budget (each replica is tried at
      most once per routing attempt, so re-routing always terminates).
    - ``RAY_TPU_FLEET_AFFINITY`` (default ``1``): prefix-affinity
      routing — prompts whose chained page hashes hit a replica's
      prefix index route to that replica (the prefix cache working
      fleet-wide); ``0`` falls back to pure power-of-two-choices.
    - ``RAY_TPU_FLEET_AFFINITY_CAP`` (default ``8``): queue-depth cap
      above which an affinity hit is overridden — a hot replica must
      not absorb every shared-prefix request while its neighbours sit
      idle (the arXiv:2011.03641 saturated-not-overloaded argument).
    - ``RAY_TPU_FLEET_ADAPTER_AFFINITY`` (default ``1``): adapter-
      residency affinity (multi-tenant serving) — a request whose
      ``model_id`` is already resident in a replica's LoRA bank scores
      toward that replica (skipping the store fetch + bank install a
      cold replica would pay), composing with the prefix-affinity
      score above; ``0`` is the residency-blind A/B arm.
    - ``RAY_TPU_FLEET_UP_DEPTH`` (default ``4``): mean waiting-queue
      depth per running replica that, sustained for the dwell, scales
      the fleet up.
    - ``RAY_TPU_FLEET_TTFT_SLO`` (default ``0`` = off): TTFT SLO in
      seconds — recent first-token latencies above this, sustained
      for the dwell, also scale up (queue depth can look fine while
      TTFT burns on slow prefills).
    - ``RAY_TPU_FLEET_DWELL`` (default ``5``): anti-flap hysteresis in
      seconds — the minimum time a scale signal must persist before
      the reconciler acts, and the minimum dwell in a state before a
      voluntary transition (failure transitions are immediate).
    - ``RAY_TPU_FLEET_BACKOFF`` (default ``0.5``) /
      ``RAY_TPU_FLEET_BACKOFF_MAX`` (default ``30``): restart backoff
      — a wedged/dead replica restarts after
      ``min(backoff * 2**restarts, backoff_max)`` seconds, so a
      crash-looping replica cannot hot-loop the factory.
    - ``RAY_TPU_FLEET_SLOW_FACTOR`` (default ``3``, ``0`` = off): the
      gray-failure demotion threshold — a replica whose EWMA tick
      latency exceeds this multiple of the fleet median is excluded
      from routing (soft demotion: when *every* replica is slow the
      router still routes, a demotion must never be a dead-end) and
      reported to the reconciler as DEGRADED.
    - ``RAY_TPU_FLEET_HEDGE`` (default ``1``): tail-latency hedging —
      a stream whose first token has not arrived by the hedge deadline
      is re-admitted on a second replica; the first responder wins and
      the loser is cancelled (at-most-once delivery is structural:
      stream bindings are keyed ``(replica_id, rid)`` and the losing
      binding drops before its token could land).
    - ``RAY_TPU_FLEET_HEDGE_FACTOR`` (default ``2``): hedge deadline
      as a multiple of the router's rolling p99 TTFT — informed by
      observed tails, so healthy traffic almost never hedges.
    - ``RAY_TPU_FLEET_HEDGE_MIN`` (default ``0.05``): hedge-deadline
      floor in seconds (and the whole deadline until enough TTFT
      samples exist) — a cold fleet must not hedge every request.
    - ``RAY_TPU_FLEET_DISAGG`` (default ``0``): serve in disaggregated
      prefill/decode mode — callers reading this config split the
      fleet into a prefill pool and a decode pool behind the
      :class:`~ray_tpu_torch.fleet.disagg.DisaggRouter` instead of N
      co-located replicas.
    - ``RAY_TPU_FLEET_PREFILL_REPLICAS`` (default ``1``): how many of
      a disaggregated fleet's replicas form the prefill pool (the rest
      decode) — prefill is compute-bound and batches well, so one
      prefill replica typically feeds several decode replicas.
    - ``RAY_TPU_FLEET_HANDOFF_INLINE`` (default ``0``): force KV
      handoffs to bypass the object store and pass the payload
      in-process (``1``).  Otherwise the payload rides the runtime's
      object store whenever a ``ray_tpu_torch`` session is up.
    """
    retries: int = 2
    affinity: bool = True
    affinity_cap: int = 8
    adapter_affinity: bool = True
    up_depth: float = 4.0
    ttft_slo: float = 0.0
    dwell: float = 5.0
    backoff: float = 0.5
    backoff_max: float = 30.0
    slow_factor: float = 3.0
    hedge: bool = True
    hedge_factor: float = 2.0
    hedge_min: float = 0.05
    disagg: bool = False
    prefill_replicas: int = 1
    handoff_inline: bool = False


_CONFIG: Optional[FleetConfig] = None


def fleet_config(refresh: bool = False) -> FleetConfig:
    """The process-wide :class:`FleetConfig` (env read once, cached)."""
    global _CONFIG
    if _CONFIG is None or refresh:
        env = os.environ.get

        def nonneg(name, default, cast=float):
            val = cast(env(name, default))
            if val < 0:
                print(f"{name}={val} negative; using {default}",
                      file=sys.stderr)
                return cast(default)
            return val

        _CONFIG = FleetConfig(
            retries=nonneg("RAY_TPU_FLEET_RETRIES", "2", int),
            affinity=env("RAY_TPU_FLEET_AFFINITY", "1") != "0",
            affinity_cap=nonneg("RAY_TPU_FLEET_AFFINITY_CAP", "8", int),
            adapter_affinity=env("RAY_TPU_FLEET_ADAPTER_AFFINITY",
                                 "1") != "0",
            up_depth=nonneg("RAY_TPU_FLEET_UP_DEPTH", "4"),
            ttft_slo=nonneg("RAY_TPU_FLEET_TTFT_SLO", "0"),
            dwell=nonneg("RAY_TPU_FLEET_DWELL", "5"),
            backoff=nonneg("RAY_TPU_FLEET_BACKOFF", "0.5"),
            backoff_max=nonneg("RAY_TPU_FLEET_BACKOFF_MAX", "30"),
            slow_factor=nonneg("RAY_TPU_FLEET_SLOW_FACTOR", "3"),
            hedge=env("RAY_TPU_FLEET_HEDGE", "1") != "0",
            hedge_factor=nonneg("RAY_TPU_FLEET_HEDGE_FACTOR", "2"),
            hedge_min=nonneg("RAY_TPU_FLEET_HEDGE_MIN", "0.05"),
            disagg=env("RAY_TPU_FLEET_DISAGG", "0") != "0",
            prefill_replicas=max(
                nonneg("RAY_TPU_FLEET_PREFILL_REPLICAS", "1", int), 1),
            handoff_inline=env("RAY_TPU_FLEET_HANDOFF_INLINE",
                               "0") != "0",
        )
    return _CONFIG
