"""Supervised actor/learner RL loop: survive deaths mid-training.

Counterpart of ``ray_tpu/resilience/supervisor.py``.  ``run_rl_loop`` is
the fair-weather driver: any actor or learner failure loses the whole
run.  This module is the Podracer answer (arXiv:2104.06272: preemption
is normal, checkpoint/restart is the recovery path) applied to the RL
loop:

- **actor supervision** — every rollout is health-checked by outcome;
  a dead actor (engine fault, injected ``rl.rollout`` kill) is
  replaced by a fresh :class:`~ray_tpu_torch.rl.rollout.RolloutActor`
  seeded from the **latest**
  :class:`~ray_tpu_torch.rl.replay.WeightStore` version.  The
  reference's replacement compiles nothing (``restart_compiles``); the
  port's engine runs eagerly, so its counterpart ``restart_builds`` (the
  kernel library's builds from the replacement's spawn to the end of
  the run) is 0 by construction: ``ops/_build`` builds its library at
  most once per process, before any engine launches.  A restart costs
  engine construction and one parameter copy;
- **learner checkpointing** — every ``ckpt_every`` learner steps the
  full learner ``TrainState`` (params, optimizer state, step), the
  published version and the rollout-seed cursor snapshot through the
  async :class:`~ray_tpu_torch.resilience.checkpoint.TrainCheckpointer`.
  A learner death (injected ``rl.learner``) restores the newest valid
  snapshot in place and **republishes** under a fresh version, so
  actors resync and stale in-queue batches age out through the
  ``max_lag`` bound;
- **loop resume** — a killed *process* reruns with ``resume=True``:
  learner state, step counter and seed cursor restore from the
  checkpoint; lost work is bounded by (checkpoint interval + one
  :class:`~ray_tpu_torch.rl.replay.ReplayQueue` of trajectories),
  never the run;
- **publish supervision** — a failed weight publication (injected
  ``rl.publish``) is counted and skipped; actors continue on the
  previous consistent version.

Wait-policy rejections here are non-blocking (held batch + retry): the
driver is single-threaded, so a timed put would stall waiting for its
own consumer.  The timed put (``RAY_TPU_RL_PUT_TIMEOUT`` ->
:class:`~ray_tpu_torch.rl.replay.ReplayPutTimeout`, counted as
backpressure) is the contract for actors whose learner pops from
another thread or process.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.substrate import resolve_device
from ray_tpu_torch.resilience.checkpoint import TrainCheckpointer
from ray_tpu_torch.rl.config import RLConfig, rl_config
from ray_tpu_torch.rl.learner import InProcessLearner
from ray_tpu_torch.rl.loop import LoopState, loop_result, run_rounds
from ray_tpu_torch.rl.replay import ReplayQueue, WeightStore
from ray_tpu_torch.rl.reward import target_token_reward
from ray_tpu_torch.rl.rollout import RolloutActor
from ray_tpu_torch.util import chaos


def _drain_engine(engine) -> None:
    """Best-effort retire of everything a (possibly dying) engine
    holds.  Never raises — the engine may be the thing that just
    failed."""
    try:
        engine.drain_requests()
    except Exception:  # noqa: BLE001 — cleanup of a broken engine
        pass


def run_supervised_rl_loop(cfg, *, steps: int,
                           rlcfg: Optional[RLConfig] = None,
                           reward_fn: Optional[Callable] = None,
                           prompt: Optional[Sequence[int]] = None,
                           prompt_len: int = 4,
                           eos_token: Optional[int] = None,
                           seed: int = 0,
                           lr: float = 1e-3,
                           mesh=None,
                           optimizer=None,
                           ckpt: Optional[TrainCheckpointer] = None,
                           ckpt_every: Optional[int] = None,
                           resume: bool = False,
                           max_actor_restarts: int = 8,
                           max_learner_restarts: int = 3,
                           engine_kwargs: Optional[Dict[str, Any]] = None,
                           learner_fns: Optional[Dict[str, Any]] = None,
                           telemetry: Optional[bool] = None,
                           device=None) -> Dict[str, Any]:
    """``run_rl_loop`` semantics under supervision (in-process learner).

    Same fixed-seed determinism contract as ``run_rl_loop`` *until the
    first fault*: an undisturbed supervised run reproduces
    ``run_rl_loop``'s trajectories exactly (same seeds, same order).
    After a fault the trajectories diverge by construction — recovery
    is judged on the reward criterion (final-third mean within
    tolerance of an uninterrupted run), not bitwise.

    ``ckpt``/``ckpt_every`` arm learner checkpointing (``ckpt_every``
    defaults to the checkpointer's own ``RAY_TPU_CKPT_EVERY`` cadence);
    ``resume=True`` restores the newest valid snapshot before the
    first rollout.  ``max_learner_restarts=0`` disables in-place
    learner recovery: the death propagates, and the caller reruns with
    ``resume=True`` (the killed-loop path).

    Returns the ``run_rl_loop`` result dict plus ``actor_restarts``,
    ``learner_restarts``, ``publish_failures``, ``resumed_from``,
    ``restart_builds`` (per actor replacement, the kernel builds from its
    spawn to the end of the run: 0 by construction, see the module
    docstring)
    and the ``checkpoint`` telemetry block.  The engines and the learner
    run on ``device`` (None: the card).
    """
    rlcfg = rlcfg or rl_config()
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    if prompt is None:
        prompt = [int(t) for t in
                  rng.randint(0, cfg.vocab_size, prompt_len)]
    prompts = [list(prompt)] * rlcfg.batch
    seq_len = len(prompt) + rlcfg.horizon
    if reward_fn is None:
        target = int(rng.randint(0, cfg.vocab_size))
        reward_fn = target_token_reward(
            target, length_penalty=1.0 / max(rlcfg.horizon, 1),
            eos_token=eos_token)

    from ray_tpu_torch.telemetry.config import TelemetryConfig
    from ray_tpu_torch.telemetry.rl import RLTelemetry
    tel = RLTelemetry(config=None if telemetry is None else
                      TelemetryConfig(enabled=bool(telemetry)))

    learner = InProcessLearner(cfg, mesh=mesh, baseline=rlcfg.baseline,
                               lr=lr, optimizer=optimizer, seed=seed,
                               fns=learner_fns, device=dev)
    store = WeightStore(use_object_store=False)
    # put_timeout pinned to 0 — single-threaded driver, see the module
    # docstring
    queue = ReplayQueue(rlcfg.queue, max_lag=rlcfg.max_lag,
                        overflow=rlcfg.overflow, put_timeout=0)
    ckpt_every = (ckpt.every if ckpt is not None and ckpt_every is None
                  else (ckpt_every or 0))

    st = LoopState(rollout_seed=seed * 1_000_003)
    publish_failures = 0
    resumed_from = None

    def checkpoint_now():
        if ckpt is None:
            return
        ckpt.save(learner.state_host(), step=st.learner_steps,
                  extras={"version": np.asarray(store.version),
                          "learner_steps": np.asarray(st.learner_steps),
                          "rollout_seed": np.asarray(st.rollout_seed)})

    def restore_learner() -> bool:
        """Newest valid snapshot -> learner + counters; False when the
        directory holds nothing usable (fresh start)."""
        nonlocal resumed_from
        if ckpt is None:
            return False
        example = {"state": learner.state_host(),
                   "extras": {"version": np.asarray(0),
                              "learner_steps": np.asarray(0),
                              "rollout_seed": np.asarray(0)}}
        restored = ckpt.restore_latest(example=example)
        if restored is None:
            return False
        learner.load_state(restored["state"])
        st.learner_steps = int(restored["extras"]["learner_steps"])
        st.rollout_seed = int(restored["extras"]["rollout_seed"])
        resumed_from = restored["path"]
        return True

    def publish(must: bool = False) -> bool:
        """One supervised publication; a failure (injected or real) is
        fatal only when ``must`` (the seed publish — actors cannot
        start without version 1)."""
        nonlocal publish_failures
        t0 = time.monotonic()
        try:
            version = store.publish(learner.params_host())
        except Exception as e:  # noqa: BLE001 — supervised: skip one
            if must:
                raise
            publish_failures += 1
            print(f"weight publish failed ({e!r}); actors stay on "
                  f"version {store.version}", file=sys.stderr)
            return False
        tel.record_publish(time.monotonic() - t0, version=version)
        return True

    if resume:
        restore_learner()
    publish(must=True)           # seeds actors (fresh or restored)
    checkpoint_now()             # in-place learner recovery needs >= 1
    # history/reward_curve index THIS call's counted steps; a resumed
    # run starts its records at `base_steps`, so mid-loop rollbacks
    # must truncate relative to it, not to the absolute step counter
    base_steps = st.learner_steps
    ekw = dict(engine_kwargs or {})
    ekw.setdefault("telemetry", False)
    ekw.setdefault("device", dev)

    def spawn_actor(aid: int) -> RolloutActor:
        version, params = store.latest()
        actor = RolloutActor(cfg, params, actor_id=aid,
                             temperature=rlcfg.temperature,
                             eos_token=eos_token, engine_kwargs=ekw)
        actor.engine.param_version = version
        return actor

    actors = [spawn_actor(i) for i in range(rlcfg.actors)]
    actor_restarts = 0
    learner_restarts = 0
    # the kernel library's build count at each replacement's spawn
    builds_at_restart: List[int] = []

    def rollout(i, actor):
        """Supervised: a rollout that raises kills only its actor; the
        replacement syncs to the latest publication and takes over the
        same slot in the fleet."""
        nonlocal actor_restarts
        try:
            return actor.rollout(prompts, horizon=rlcfg.horizon,
                                 seq_len=seq_len, reward_fn=reward_fn,
                                 seed=st.rollout_seed)
        except Exception as e:  # noqa: BLE001 — supervise
            if actor_restarts >= max_actor_restarts:
                raise
            actor_restarts += 1
            tel.record_actor_restart()
            print(f"rollout actor {actor.actor_id} died ({e!r}); "
                  f"restarting from version {store.version}",
                  file=sys.stderr)
            _drain_engine(actor.engine)
            # leak check NOW (the same clean-idle invariant the shutdown
            # path asserts), then drop the engine: keeping dead engines
            # around would pin their params and KV cache (a whole
            # replica of device memory each) for the rest of the run
            if not actor.idle():
                raise RuntimeError(
                    f"dead rollout engine {actor.actor_id} did not drain "
                    "clean (slots/pages still held) — the recovery path "
                    "broke the allocator invariants") from e
            builds_at_restart.append(_build.builds)
            actors[i] = spawn_actor(actor.actor_id)
            return None

    def update(batch):
        """Supervised: a learner death restores the newest snapshot in
        place, rolls the records back with it and republishes."""
        nonlocal learner_restarts
        try:
            chaos.maybe_fail("rl.learner")
            return learner.update(batch.as_learner_batch())
        except Exception as e:  # noqa: BLE001 — supervise
            if ckpt is None or learner_restarts >= max_learner_restarts:
                raise
            learner_restarts += 1
            tel.record_learner_restart()
            print(f"learner died ({e!r}); restoring from its checkpoint "
                  "and republishing", file=sys.stderr)
            if not restore_learner():
                raise
            # roll the records back with the learner so history[i] /
            # reward_curve[i] stays "the i-th counted step of THIS call"
            # (clamped: a corrupt-newest fallback can restore a snapshot
            # older than this call's starting point, which invalidates
            # every record of this call)
            keep = max(st.learner_steps - base_steps, 0)
            del st.history[keep:]
            del st.reward_curve[keep:]
            publish(must=True)       # fresh version: actors resync
            return None

    def after_step():
        if ckpt_every and st.learner_steps % ckpt_every == 0:
            checkpoint_now()

    try:
        run_rounds(st, steps=steps, actors=actors, store=store,
                   queue=queue, rlcfg=rlcfg, tel=tel, rollout=rollout,
                   update=update, publish=publish, after_step=after_step)
    finally:
        leftover = queue.drain() + list(st.pending.values())
        if ckpt is not None:
            ckpt.flush()
    return dict(
        loop_result(st, queue=queue, store=store, tel=tel, actors=actors,
                    learner=learner, leftover=leftover),
        backpressure_rejections=queue.backpressure_rejections,
        publish_failures=publish_failures,
        actor_restarts=actor_restarts,
        learner_restarts=learner_restarts,
        restart_builds=[_build.builds - b for b in builds_at_restart],
        resumed_from=resumed_from,
        checkpoint=(ckpt.telemetry.summary() if ckpt is not None
                    else {"enabled": False}))
