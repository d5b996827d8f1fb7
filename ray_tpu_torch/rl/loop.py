"""The closed loop: actors generate, the learner trains, weights flow.

Counterpart of ``ray_tpu/rl/loop.py``.  ``run_rl_loop`` wires the pieces
into the Podracer/Sebulba shape (arXiv:2104.06272): rollout actors on
one side (each an :class:`~ray_tpu_torch.inference.InferenceEngine`
replica), policy-gradient learner(s) on the other
(:func:`~ray_tpu_torch.models.training.build_gpt_rl_train`, optionally
hosted on the :class:`~ray_tpu_torch.rllib.core.learner_group.
LearnerGroup`), meeting through
:class:`~ray_tpu_torch.rl.replay.WeightStore` (versioned snapshots,
object store when a session is up) and
:class:`~ray_tpu_torch.rl.replay.ReplayQueue` (bounded, hard staleness
bound).  The driver sequences one producer/consumer round per learner
step — actors re-sync to the latest publication before every rollout,
so actor-side lag is bounded by the publish cadence and queue-side lag
by ``max_lag``, deterministically (fixed seeds reproduce the whole
loop, which is what makes the reward-improves acceptance test
meaningful).

The default task is the programmatic length-penalized target-token
reward (:mod:`ray_tpu_torch.rl.reward`) — an easy smooth objective whose
expected value must rise under a correct policy gradient.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.ops.substrate import resolve_device
from ray_tpu_torch.rl.config import RLConfig, rl_config
from ray_tpu_torch.rl.learner import InProcessLearner, LearnerGroupAdapter
from ray_tpu_torch.rl.replay import ReplayQueue, WeightStore
from ray_tpu_torch.rl.reward import target_token_reward
from ray_tpu_torch.rl.rollout import RolloutActor


def run_rl_loop(cfg, *, steps: int,
                rlcfg: Optional[RLConfig] = None,
                reward_fn: Optional[Callable] = None,
                prompt: Optional[Sequence[int]] = None,
                prompt_source=None,
                prompt_len: int = 4,
                eos_token: Optional[int] = None,
                seed: int = 0,
                lr: float = 1e-3,
                mesh=None,
                optimizer=None,
                num_learners: int = 0,
                engine_kwargs: Optional[Dict[str, Any]] = None,
                telemetry: Optional[bool] = None,
                device=None,
                num_gpus_per_learner: Optional[float] = None
                ) -> Dict[str, Any]:
    """Run ``steps`` learner updates of the actor/learner loop.

    ``num_learners=0`` runs the learner in-process; ``>= 1`` hosts it
    on the LearnerGroup (a ``ray_tpu_torch`` session must be up) with
    the group's object-store snapshot as the publication path, each
    learner actor holding ``num_gpus_per_learner`` cards (default: 1
    when ``device`` is a card, else 0).  The engines and the learners
    run on ``device`` (None: the card).  The engine keeps no compiled
    executables, so no executable cache is passed.

    ``prompt_source``: a :class:`~ray_tpu_torch.data.DocumentSource` (or
    a prebuilt :class:`~ray_tpu_torch.rl.rollout.PromptDataset`): each
    learner round draws its ``rlcfg.batch`` prompts from the
    deterministic document schedule instead of repeating one fixed
    prompt; the final prompt cursor is returned as
    ``result["prompt_cursor"]`` for preemption-proof resume.

    Returns a result dict: per-step ``history`` (learner metrics +
    rollout reward), the ``reward_curve`` (rollout-side mean reward
    per learner step — the policy-improvement signal), queue/staleness
    counters, the telemetry summary and final engine stats.
    """
    rlcfg = rlcfg or rl_config()
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    prompt_ds = None
    if prompt_source is not None:
        from ray_tpu_torch.rl.rollout import PromptDataset
        prompt_ds = (prompt_source
                     if isinstance(prompt_source, PromptDataset)
                     else PromptDataset(prompt_source,
                                        prompt_len=prompt_len))
        prompt_len = prompt_ds.prompt_len
    if prompt is None:
        prompt = [int(t) for t in
                  rng.randint(0, cfg.vocab_size, prompt_len)]
    prompts = [list(prompt)] * rlcfg.batch   # shared context: RLOO's
    seq_len = len(prompt) + rlcfg.horizon    # leave-one-out wants it
    if reward_fn is None:
        target = int(rng.randint(0, cfg.vocab_size))
        reward_fn = target_token_reward(target,
                                        length_penalty=1.0 / max(
                                            rlcfg.horizon, 1),
                                        eos_token=eos_token)

    from ray_tpu_torch.telemetry.rl import RLTelemetry
    tel = RLTelemetry(config=None if telemetry is None else
                      _tel_config(telemetry))

    if num_learners >= 1:
        if rlcfg.batch % num_learners:
            # LearnerGroup.update trims the batch to a multiple of the
            # world size — a non-dividing batch would silently discard
            # trajectories (actor compute) on every learner step
            raise ValueError(
                f"rollout batch {rlcfg.batch} is not divisible by "
                f"num_learners={num_learners}: the learner group would "
                "silently drop the remainder rows every step "
                "(RAY_TPU_RL_BATCH)")
        if optimizer is not None or mesh is not None:
            # silently training with a different optimizer/mesh than
            # the caller pinned would invalidate any A/B against the
            # in-process arm — refuse instead
            raise ValueError("optimizer/mesh overrides are in-process-"
                             "learner options; the LearnerGroup-hosted "
                             "path (num_learners >= 1) builds its own "
                             "per-actor optimizer (lr=)")
        if num_gpus_per_learner is None:
            num_gpus_per_learner = 1.0 if dev.type == "cuda" else 0.0
        learner = LearnerGroupAdapter(
            cfg, num_learners=num_learners, baseline=rlcfg.baseline, lr=lr,
            seed=seed, device=str(dev),
            num_gpus_per_learner=num_gpus_per_learner)
    else:
        learner = InProcessLearner(cfg, mesh=mesh,
                                   baseline=rlcfg.baseline, lr=lr,
                                   optimizer=optimizer, seed=seed,
                                   device=dev)
    store = WeightStore(use_object_store=num_learners >= 1)
    # put_timeout pinned to 0: this driver runs producer and consumer
    # on one thread, so a timed put (RAY_TPU_RL_PUT_TIMEOUT) would
    # wait for a pop that cannot happen until it returns — the
    # hold-and-retry `pending` mechanism of `run_rounds` is the
    # backpressure path here
    queue = ReplayQueue(rlcfg.queue, max_lag=rlcfg.max_lag,
                        overflow=rlcfg.overflow, put_timeout=0)

    def publish():
        t0 = time.monotonic()
        if isinstance(learner, LearnerGroupAdapter):
            version, ref = learner.publish_ref()
            version = store.publish(ref, version=version)
        else:
            version = store.publish(learner.params_host())
        tel.record_publish(time.monotonic() - t0, version=version)
        return version

    publish()                                # version 1 seeds actors
    _, params0 = store.latest()
    ekw = dict(engine_kwargs or {})
    ekw.setdefault("telemetry", False)
    ekw.setdefault("device", dev)
    actors = [RolloutActor(cfg, params0, actor_id=i,
                           temperature=rlcfg.temperature,
                           eos_token=eos_token, engine_kwargs=ekw)
              for i in range(rlcfg.actors)]
    for actor in actors:
        actor.engine.param_version = store.version

    st = LoopState(rollout_seed=seed * 1_000_003)

    def rollout(i, actor):
        drawn = (prompts if prompt_ds is None
                 else prompt_ds.next_prompts(rlcfg.batch))
        return actor.rollout(drawn, horizon=rlcfg.horizon,
                             seq_len=seq_len, reward_fn=reward_fn,
                             seed=st.rollout_seed)

    try:
        run_rounds(st, steps=steps, actors=actors, store=store,
                   queue=queue, rlcfg=rlcfg, tel=tel, rollout=rollout,
                   update=lambda b: learner.update(b.as_learner_batch()),
                   publish=publish)
    finally:
        leftover = queue.drain() + list(st.pending.values())
        if isinstance(learner, LearnerGroupAdapter):
            learner.stop()
    return dict(loop_result(st, queue=queue, store=store, tel=tel,
                            actors=actors, learner=learner,
                            leftover=leftover),
                prompt_cursor=(prompt_ds.cursor_array()
                               if prompt_ds is not None else None))


@dataclasses.dataclass
class LoopState:
    """What a driver's rounds carry from one to the next: the counted
    learner steps, the rollout-seed cursor, this call's per-step records
    and the batches actors hold under backpressure."""
    learner_steps: int = 0
    rollout_seed: int = 0
    history: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)
    reward_curve: List[float] = dataclasses.field(default_factory=list)
    pending: Dict[int, Any] = dataclasses.field(default_factory=dict)


def run_rounds(st: LoopState, *, steps: int, actors: List[RolloutActor],
               store: WeightStore, queue: ReplayQueue, rlcfg: RLConfig,
               tel, rollout: Callable, update: Callable,
               publish: Callable, after_step: Optional[Callable] = None
               ) -> None:
    """Producer/consumer rounds until ``st.learner_steps == steps``:
    the one loop body of :func:`run_rl_loop` and
    :func:`~ray_tpu_torch.resilience.supervisor.run_supervised_rl_loop`.

    A round puts the held batches first, then rolls out once per actor
    (synced to the latest publication; ``rollout(i, actor)`` draws with
    seed ``st.rollout_seed`` and returns the batch, or None when the
    actor died and ``actors[i]`` holds its replacement), then drains
    what is fresh enough into the learner (``update(batch)`` returns the
    step's metrics, or None when the learner died and was restored: the
    round ends there), publishing every ``rlcfg.publish_every`` steps
    and calling ``after_step()`` after each counted step."""
    while st.learner_steps < steps:
        # -------- held batches first: a held batch is strictly older
        # than any fresh rollout, so it must win the freed queue space
        # (retrying inline per actor would let earlier actors re-fill
        # the queue every round and starve the held one forever)
        for aid in list(st.pending):
            if queue.put(st.pending[aid]):
                del st.pending[aid]
            else:
                tel.record_backpressure()
        # -------- actor side: one rollout per replica, freshest params
        # first (sync before every rollout, so an actor's params never
        # lag the latest publication at generation time)
        for i, actor in enumerate(actors):
            if actor.actor_id in st.pending:
                continue                    # backpressured: no rollout
            if actor.param_version != store.version:
                actor.sync(*store.latest())
            st.rollout_seed += rlcfg.batch
            batch = rollout(i, actor)
            if batch is None:
                continue                    # replaced: the fleet moves on
            tel.record_rollout(batch.wall_s, tokens=batch.gen_tokens,
                               param_version=batch.param_version)
            # under the "wait" overflow policy a rejected put means
            # backpressure: the actor holds its batch and retries before
            # rolling a new one (no trajectory silently discarded)
            if not queue.put(batch):
                tel.record_backpressure()
                st.pending[actor.actor_id] = batch
        # -------- learner side: drain what is fresh enough
        while st.learner_steps < steps:
            batch = queue.pop(store.version)
            if batch is None:
                break
            lag = store.version - batch.param_version
            t0 = time.monotonic()
            metrics = update(batch)
            if metrics is None:
                break                       # restored: back to rollouts
            tel.record_learner_step(time.monotonic() - t0,
                                    version_lag=lag)
            st.learner_steps += 1
            metrics["rollout_reward_mean"] = float(np.mean(batch.rewards))
            metrics["param_version_lag"] = float(lag)
            st.history.append(metrics)
            st.reward_curve.append(metrics["rollout_reward_mean"])
            if st.learner_steps % rlcfg.publish_every == 0:
                publish()
            if after_step is not None:
                after_step()


def loop_result(st: LoopState, *, queue: ReplayQueue, store: WeightStore,
                tel, actors: List[RolloutActor], learner,
                leftover: list) -> Dict[str, Any]:
    """The result keys both drivers return, once every engine drained
    clean (a real check, not an assert: it must survive python -O, and
    a slot/page leak here means the engine invariants broke)."""
    tel.record_queue_counters(drops_stale=queue.drops_stale,
                              drops_overflow=queue.drops_overflow)
    leaked = [a.actor_id for a in actors if not a.idle()]
    if leaked:
        raise RuntimeError(f"rollout engines {leaked} did not drain "
                           "clean at shutdown (slots/pages still held)")
    return {
        "steps": st.learner_steps,
        "history": st.history,
        "reward_curve": st.reward_curve,
        "leftover_batches": len(leftover),
        "drops_stale": queue.drops_stale,
        "drops_overflow": queue.drops_overflow,
        "param_version": store.version,
        "publishes": store.publish_count,
        "telemetry": tel.summary(),
        "engine_stats": [a.engine.stats() for a in actors],
        "actors": [a.engine for a in actors],
        "learner": learner,
    }


def _tel_config(enabled: bool):
    from ray_tpu_torch.telemetry.config import TelemetryConfig
    return TelemetryConfig(enabled=bool(enabled))
