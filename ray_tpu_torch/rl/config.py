"""RL-loop env knobs, the single home for actor/learner config
(``ray_tpu/rl/config.py``): one frozen dataclass resolved from the
environment once, ``refresh=True`` for tests and A/B drivers that flip
flags after import.  The same ``RAY_TPU_RL_*`` variables as the
reference, corrected with the same messages.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """Actor/learner RL-loop knobs, resolved once from the environment.

    - ``RAY_TPU_RL_ACTORS`` (default ``1``): rollout actor replicas.
      Each wraps its own :class:`~ray_tpu_torch.inference.InferenceEngine`,
      so extra actors cost slots and pages.
    - ``RAY_TPU_RL_BATCH`` (default ``8``): trajectories per rollout
      batch (also the RLOO batch — the leave-one-out baseline needs
      >= 2).
    - ``RAY_TPU_RL_HORIZON`` (default ``16``): max new tokens per
      rollout (trajectories ending early on EOS are padded: the learner
      batch keeps one shape).
    - ``RAY_TPU_RL_QUEUE`` (default ``4``): trajectory-queue capacity
      (batches).  Bounded by design — an unbounded queue converts a
      slow learner into unbounded staleness.
    - ``RAY_TPU_RL_MAX_LAG`` (default ``1``): staleness bound, in
      learner param versions.  A trajectory batch generated at version
      ``v`` is dropped (never trained on) once the learner has moved
      past ``v + max_lag``; actors re-sync before every rollout, so
      their params never lag the latest publication by more than the
      publish cadence.
    - ``RAY_TPU_RL_OVERFLOW`` (default ``drop``): full-queue policy —
      ``drop`` evicts the oldest batch (freshness wins), ``wait``
      rejects the put so the producer backs off (throughput wins).
      The staleness bound above is hard either way.
    - ``RAY_TPU_RL_PUBLISH_EVERY`` (default ``1``): learner steps
      between weight publications (higher = fewer snapshots, more
      actor-side lag).
    - ``RAY_TPU_RL_BASELINE`` (default ``rloo``): advantage baseline —
      ``rloo`` (leave-one-out), ``mean`` (batch mean), ``none``
      (plain REINFORCE).
    - ``RAY_TPU_RL_TEMPERATURE`` (default ``1.0``): rollout sampling
      temperature.  ``1.0`` keeps the behavior distribution equal to
      the model softmax the learner differentiates (on-policy); other
      values are exploration knobs that reintroduce off-policy bias.
    - ``RAY_TPU_RL_PUT_TIMEOUT`` (default ``0`` = non-blocking):
      seconds a ``wait``-policy queue put may block for a pop to free
      space before raising the typed
      :class:`~ray_tpu_torch.rl.replay.ReplayPutTimeout` — the bound that
      keeps a rollout actor from blocking forever on a dead learner
      (timeouts count as ``backpressure_rejections``).
    """
    actors: int = 1
    batch: int = 8
    horizon: int = 16
    queue: int = 4
    max_lag: int = 1
    overflow: str = "drop"
    publish_every: int = 1
    baseline: str = "rloo"
    temperature: float = 1.0
    put_timeout: float = 0.0


_CONFIG: Optional[RLConfig] = None


def rl_config(refresh: bool = False) -> RLConfig:
    """The process-wide :class:`RLConfig` (env read once, cached)."""
    global _CONFIG
    if _CONFIG is None or refresh:
        env = os.environ.get
        overflow = env("RAY_TPU_RL_OVERFLOW", "drop")
        if overflow not in ("drop", "wait"):
            print(f"RAY_TPU_RL_OVERFLOW={overflow!r} unknown; "
                  "using 'drop'", file=sys.stderr)
            overflow = "drop"
        baseline = env("RAY_TPU_RL_BASELINE", "rloo")
        if baseline not in ("rloo", "mean", "none"):
            print(f"RAY_TPU_RL_BASELINE={baseline!r} unknown; "
                  "using 'rloo'", file=sys.stderr)
            baseline = "rloo"

        def pos_int(name, default):
            val = int(env(name, str(default)))
            if val < 1:
                print(f"{name}={val} must be >= 1; using {default}",
                      file=sys.stderr)
                return default
            return val

        temperature = float(env("RAY_TPU_RL_TEMPERATURE", "1.0"))
        if temperature <= 0:
            # <= 0 means greedy sampling: every trajectory in a batch
            # is identical, all advantages are 0, every learner step a
            # no-op — degenerate silently is the one thing it must not
            # do
            print(f"RAY_TPU_RL_TEMPERATURE={temperature} must be > 0 "
                  "(greedy rollouts zero the policy gradient); "
                  "using 1.0", file=sys.stderr)
            temperature = 1.0
        put_timeout = float(env("RAY_TPU_RL_PUT_TIMEOUT", "0"))
        if put_timeout < 0:
            print(f"RAY_TPU_RL_PUT_TIMEOUT={put_timeout} negative; "
                  "using 0 (non-blocking puts)", file=sys.stderr)
            put_timeout = 0.0
        max_lag = int(env("RAY_TPU_RL_MAX_LAG", "1"))
        if max_lag < 0:
            print(f"RAY_TPU_RL_MAX_LAG={max_lag} negative; using 0 "
                  "(actors only ever train fully fresh batches)",
                  file=sys.stderr)
            max_lag = 0
        _CONFIG = RLConfig(
            actors=pos_int("RAY_TPU_RL_ACTORS", 1),
            batch=pos_int("RAY_TPU_RL_BATCH", 8),
            horizon=pos_int("RAY_TPU_RL_HORIZON", 16),
            queue=pos_int("RAY_TPU_RL_QUEUE", 4),
            max_lag=max_lag,
            overflow=overflow,
            publish_every=pos_int("RAY_TPU_RL_PUBLISH_EVERY", 1),
            baseline=baseline,
            temperature=temperature,
            put_timeout=put_timeout,
        )
    return _CONFIG
