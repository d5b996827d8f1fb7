"""``ray_tpu_torch.rl`` — Podracer-style actor/learner RL for the GPT
family, the counterpart of ``ray_tpu.rl``.

**Actor replicas** wrap the continuous-batching inference engine to
generate rollout trajectories (sampled completions and the sampler's own
chosen-token logprobs), **learner replicas** run the REINFORCE/RLOO
policy-gradient step (:func:`~ray_tpu_torch.models.training.
build_gpt_rl_train`), and the two meet through the object store: the
learner publishes versioned weight snapshots
(:class:`~ray_tpu_torch.rl.replay.WeightStore`) that actors swap in with
``engine.set_params`` (a copy into the engine's own tensors), while
trajectory batches flow back through a bounded, staleness-bounded
:class:`~ray_tpu_torch.rl.replay.ReplayQueue`: the Sebulba split of
arXiv:2104.06272.

Config via ``RAY_TPU_RL_*`` (:func:`rl_config`); ``run_rl_loop`` is the
driver; the :class:`~ray_tpu_torch.rllib.core.learner_group.LearnerGroup`
hosts multi-learner data parallelism via ``learner_cls=
"ray_tpu_torch.rl.learner.GPTPolicyLearner"``.
"""

from ray_tpu_torch.rl.config import RLConfig, rl_config  # noqa: F401
from ray_tpu_torch.rl.learner import (GPTPolicyLearner,  # noqa: F401
                                      InProcessLearner, LearnerGroupAdapter,
                                      RLLearnerConfig)
from ray_tpu_torch.rl.loop import run_rl_loop  # noqa: F401
from ray_tpu_torch.rl.replay import (ReplayPutTimeout,  # noqa: F401
                                     ReplayQueue, WeightStore)
from ray_tpu_torch.rl.reward import (batch_rewards,  # noqa: F401
                                     target_token_reward)
from ray_tpu_torch.rl.rollout import (RolloutActor,  # noqa: F401
                                      TrajectoryBatch, trajectories_to_batch)

__all__ = [
    "RLConfig", "rl_config",
    "RolloutActor", "TrajectoryBatch", "trajectories_to_batch",
    "ReplayQueue", "ReplayPutTimeout", "WeightStore",
    "InProcessLearner", "GPTPolicyLearner", "LearnerGroupAdapter",
    "RLLearnerConfig",
    "target_token_reward", "batch_rewards",
    "run_rl_loop",
]
