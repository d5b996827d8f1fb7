"""Programmatic rewards for the end-to-end RL proof
(``ray_tpu/rl/reward.py``).

No learned reward model: rewards here are pure functions of the
sampled token ids, so the whole actor->queue->learner loop is
deterministic under fixed seeds and the "does the reward actually go
up" acceptance test has no moving parts besides the policy.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


def target_token_reward(target: int, *, length_penalty: float = 0.0,
                        eos_token: int = None
                        ) -> Callable[[Sequence[int]], float]:
    """Length-penalized target-token reward.

    ``reward(completion) = #(tok == target) - length_penalty * len``
    where EOS (when configured) is excluded from both counts — it ends
    the episode, it is not part of the answer.  The optimum is a
    completion dense in ``target`` that stops as soon as the penalty
    outweighs another target token; with ``length_penalty = 0`` it
    reduces to the plain occurrence count.  An easy, smooth objective:
    every extra unit of ``P(target)`` raises the expected reward, so a
    correct policy gradient must improve it monotonically in
    expectation — which is exactly what the acceptance test asserts.
    """

    def reward(completion: Sequence[int]) -> float:
        toks = [t for t in completion
                if eos_token is None or t != eos_token]
        hits = sum(1 for t in toks if t == target)
        return float(hits) - length_penalty * len(toks)

    return reward


def batch_rewards(reward_fn: Callable[[Sequence[int]], float],
                  completions: List[List[int]]) -> np.ndarray:
    """Apply a per-completion reward to a rollout batch -> [B] f32."""
    return np.array([reward_fn(c) for c in completions], np.float32)
