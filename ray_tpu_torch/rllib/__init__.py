"""``ray_tpu_torch.rllib`` — reinforcement learning, the counterpart of
``ray_tpu.rllib``.  What is ported: the data-parallel
:class:`~ray_tpu_torch.rllib.core.learner_group.LearnerGroup`, which
hosts the RL loop's GPT policy learners.  The algorithms (PPO, DQN,
IMPALA, SAC, BC), ``core/rl_module.py`` and ``env/`` are ROADMAP Queue 1
item 12."""

from ray_tpu_torch.rllib.core.learner_group import LearnerGroup  # noqa: F401

__all__ = ["LearnerGroup"]
