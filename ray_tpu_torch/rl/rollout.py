"""Rollout actors: the inference engine as an RL trajectory generator.

Counterpart of ``ray_tpu/rl/rollout.py``, the Sebulba half of the
Podracer split (arXiv:2104.06272): an actor replica owns one
:class:`~ray_tpu_torch.inference.InferenceEngine`, the same paged-cache,
continuous-batching engine that serves traffic, and turns (prompts,
params at a version) into trajectory batches: sampled completions, the
sampler's own chosen-token logprobs (``log pi(a|s)``, which the tests
hold against a teacher-forced recompute) and a programmatic reward.
Weight publications from the learner swap in through
:meth:`~ray_tpu_torch.inference.InferenceEngine.set_params`, which copies
into the engine's own tensors: one resident snapshot per actor.

The sampler is the port's counter-based one (``inference/sampling.py``):
a rollout is a pure function of (params, prompts, seed), but sampled
tokens are not the reference's ``jax.random`` draws; greedy rollouts
are token-equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.inference import InferenceEngine, SamplingParams
from ray_tpu_torch.rl.reward import batch_rewards


@dataclasses.dataclass
class TrajectoryBatch:
    """One rollout batch, in the learner's batch layout.

    ``tokens``/``targets`` follow :func:`ray_tpu_torch.models.training.
    build_gpt_rl_train`'s contract: ``targets[b, t]`` is the token the
    policy *sampled* at position ``t+1`` when that position is part of
    the completion, ``-1`` everywhere else (prompt and pad positions
    carry no gradient).  ``param_version`` tags which published snapshot
    generated the batch: the staleness bound prices batches in these
    versions."""
    tokens: np.ndarray          # [B, S] int32
    targets: np.ndarray         # [B, S] int32  (-1 = masked)
    rewards: np.ndarray         # [B] f32
    logprobs: List[List[float]]  # actor-side per-token model logprobs
    completions: List[List[int]]
    param_version: int
    actor_id: int = 0
    gen_tokens: int = 0
    wall_s: float = 0.0

    def as_learner_batch(self) -> Dict[str, np.ndarray]:
        return {"tokens": self.tokens, "targets": self.targets,
                "rewards": self.rewards}


def trajectories_to_batch(prompts: Sequence[Sequence[int]],
                          completions: List[List[int]],
                          seq_len: int) -> Dict[str, np.ndarray]:
    """Pack (prompt, completion) pairs into fixed [B, seq_len] arrays
    (every rollout batch has the learner's one shape).  The pad token is
    0: masked targets make its value irrelevant."""
    B = len(prompts)
    tokens = np.zeros((B, seq_len), np.int32)
    targets = np.full((B, seq_len), -1, np.int32)
    for b, (prompt, comp) in enumerate(zip(prompts, completions)):
        if not prompt:
            # lo=0 would slice targets[b, -1:...] and assign nothing:
            # an all-masked row trains as a silent no-op, so refuse
            raise ValueError(f"trajectory {b}: empty prompt (the "
                             "first action needs a context position)")
        seq = list(prompt) + list(comp)
        if len(seq) > seq_len:
            raise ValueError(f"trajectory {b}: prompt+completion = "
                             f"{len(seq)} tokens > seq_len {seq_len}")
        tokens[b, :len(seq)] = seq
        # position t predicts token t+1; only sampled tokens are actions
        lo, hi = len(prompt), len(seq)
        targets[b, lo - 1:hi - 1] = seq[lo:hi]
    return {"tokens": tokens, "targets": targets}


class PromptDataset:
    """Deterministic prompt stream for rollout actors over the streaming
    data plane's document schedule (``data/stream.py:_DocSchedule``).

    Prompts come from a :class:`~ray_tpu_torch.data.DocumentSource` in
    the trainer's round-robin shard order, cut to a fixed ``prompt_len``
    (the learner wants one [B, S] shape); documents shorter than
    ``prompt_len`` are skipped (counted).  The position serialises
    through :meth:`cursor_array` / ``cursor=`` as the trainer's does, so
    a preempted RL run resumes on the identical prompt sequence."""

    def __init__(self, source, *, prompt_len: int, cursor=None,
                 readers: Optional[int] = None,
                 retries: Optional[int] = None):
        from ray_tpu_torch.data.config import data_config
        from ray_tpu_torch.data.stream import StreamCursor, _DocSchedule
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got "
                             f"{prompt_len}")
        dcfg = data_config()
        self.prompt_len = int(prompt_len)
        if cursor is None:
            cursor = StreamCursor(
                seed=0, num_shards=source.num_shards,
                batch_size=0, seq_len=self.prompt_len, pack=False,
                shard_offsets=[0] * source.num_shards)
        elif not isinstance(cursor, StreamCursor):
            cursor = StreamCursor.from_array(cursor)
        if (cursor.num_shards, cursor.seq_len) != \
                (source.num_shards, self.prompt_len):
            raise ValueError(
                "prompt cursor geometry mismatch: cursor has "
                f"(shards, prompt_len)=({cursor.num_shards}, "
                f"{cursor.seq_len}), dataset wants "
                f"({source.num_shards}, {self.prompt_len})")
        self._cursor = cursor.copy()
        self._schedule = _DocSchedule(
            source, self._cursor,
            readers=dcfg.readers if readers is None else readers,
            retries=dcfg.retries if retries is None else retries)
        self.skipped_short = 0

    def next_prompts(self, n: int) -> List[List[int]]:
        """The next ``n`` fixed-length prompts of the schedule.  A full
        epoch of skips without one usable document raises: the schedule
        wraps epochs forever and would otherwise spin here."""
        out: List[List[int]] = []
        skipped_run = 0
        total = self._schedule.source.total_docs()
        while len(out) < n:
            _doc_id, toks = self._schedule.next_doc()
            if len(toks) < self.prompt_len:
                self.skipped_short += 1
                skipped_run += 1
                if skipped_run > total:
                    raise ValueError(
                        f"no document in the source reaches "
                        f"prompt_len={self.prompt_len} (skipped a "
                        f"full epoch of {total} documents) — lower "
                        "prompt_len or fix the corpus")
                continue
            skipped_run = 0
            out.append([int(t) for t in toks[:self.prompt_len]])
        return out

    @property
    def reader_restarts(self) -> int:
        return self._schedule.reader_restarts

    def cursor_array(self) -> np.ndarray:
        """Fixed-capacity serialisation (checkpoint extras)."""
        return self._cursor.to_array()


class RolloutActor:
    """One rollout replica: engine + reward + version bookkeeping.
    ``device``: where the engine runs (None: the card, unless
    ``engine_kwargs`` names one)."""

    def __init__(self, cfg, params, *, actor_id: int = 0,
                 temperature: float = 1.0,
                 eos_token: Optional[int] = None,
                 engine_kwargs: Optional[Dict[str, Any]] = None,
                 device=None):
        self.actor_id = actor_id
        self.temperature = float(temperature)
        self.eos_token = eos_token
        kw = dict(engine_kwargs or {})
        if device is not None:
            kw["device"] = device
        # rollouts have no deadline semantics: an actor engine must not
        # inherit the serving fleet's RAY_TPU_INFER_*DEADLINE defaults
        # (an expired request would truncate a trajectory mid-flight)
        kw.setdefault("ttft_deadline", 0)
        kw.setdefault("deadline", 0)
        self.engine = InferenceEngine(cfg, params, **kw)
        self._rollouts = 0

    @property
    def param_version(self) -> int:
        return self.engine.param_version

    def sync(self, version: int, params) -> None:
        """Swap to a published snapshot (no-op when current)."""
        if version != self.engine.param_version:
            self.engine.set_params(params, version=version)

    def rollout(self, prompts: Sequence[Sequence[int]], *,
                horizon: int, seq_len: int,
                reward_fn: Callable[[Sequence[int]], float],
                seed: int = 0) -> TrajectoryBatch:
        """Generate one trajectory batch under the current params.

        Trajectory ``i`` samples with seed ``seed + i`` through the
        engine's per-sequence sampler, so a rollout is a pure function of
        (params, prompts, seed): co-batching, slot assignment and actor
        count never change it.

        Fault site ``rl.rollout`` fires on entry, before any request is
        submitted, so an injected actor death leaves the engine drained
        and the supervisor can replace the actor without leaking slots
        or pages."""
        from ray_tpu_torch.util import chaos
        chaos.maybe_fail("rl.rollout")
        t0 = time.monotonic()
        rids = [self.engine.submit(
            p, max_new_tokens=horizon,
            sampling=SamplingParams(temperature=self.temperature,
                                    seed=seed + i),
            eos_token=self.eos_token)
            for i, p in enumerate(prompts)]
        toks: Dict[int, List[int]] = {r: [] for r in rids}
        lps: Dict[int, List[float]] = {r: [] for r in rids}
        while self.engine.has_work():
            for ev in self.engine.step():
                if ev.error is not None:
                    # a request died mid-rollout: the trajectory is
                    # incomplete, and its terminal (-1, 0.0) event would
                    # train the learner on a fake action, so the actor
                    # fails loudly and the supervisor replaces it
                    raise ev.error
                rid, tok, _done = ev
                toks[rid].append(tok)
                lps[rid].append(ev.logprob)
        completions = [toks[r] for r in rids]
        logprobs = [lps[r] for r in rids]
        wall = time.monotonic() - t0
        arrays = trajectories_to_batch(prompts, completions, seq_len)
        rewards = batch_rewards(reward_fn, completions)
        self._rollouts += 1
        return TrajectoryBatch(
            tokens=arrays["tokens"], targets=arrays["targets"],
            rewards=rewards, logprobs=logprobs,
            completions=completions,
            param_version=self.engine.param_version,
            actor_id=self.actor_id,
            gen_tokens=sum(len(c) for c in completions),
            wall_s=wall)

    def idle(self) -> bool:
        """True when the engine holds no slots, pages or requests, the
        clean-shutdown invariant the loop asserts: every slot free,
        nothing queued, and every page but the garbage page (page 0,
        which the allocator reserves) back in the free pool (prefix-cache
        idle pages count as free)."""
        sched = self.engine.scheduler
        return (not sched.active and not sched.waiting
                and len(sched.free_slots) == self.engine.slots
                and sched.allocator.free_count
                == sched.allocator.num_pages - 1)
