"""``ray_tpu_torch.rllib`` — reinforcement learning, the counterpart of
``ray_tpu.rllib`` (parity: ``ray.rllib``): the RL modules
(``core/rl_module.py``), the env runners (``env/``), PPO, DQN, BC,
IMPALA, SAC and multi-agent PPO (``algorithms/``), and the data-parallel
:class:`~ray_tpu_torch.rllib.core.learner_group.LearnerGroup`, which
also hosts the ``ray_tpu_torch.rl`` loop's GPT policy learners.  The
learners run on the card unless their config or caller names the CPU;
the env runners sample on the CPU.  ``gymnasium`` is imported by the
runners and the algorithm drivers, never by these modules."""

from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import (
    MultiAgentPPO, MultiAgentPPOConfig)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (DiscreteMLPModule,
                                                MLPModuleConfig)
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.multi_agent_env import (MultiAgentCartPole,
                                                     MultiAgentEnv,
                                                     MultiAgentEnvRunner)

__all__ = ["PPO", "PPOConfig", "IMPALA", "IMPALAConfig",
           "DiscreteMLPModule", "MLPModuleConfig",
           "SingleAgentEnvRunner"]
