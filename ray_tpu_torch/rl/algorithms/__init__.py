"""RL algorithms of the port: PPO (single- and multi-agent, local or
remote env runners, one learner or several learner actors), APPO and
IMPALA over remote env runners, and DQN, SAC, BC/MARWIL, CQL, IQL and
DreamerV3 on local runners."""

from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rl.algorithms.bc import BC, BCConfig, MARWIL, MARWILConfig
from ray_tpu_torch.rl.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rl.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.algorithms.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rl.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.algorithms.iql import IQL, IQLConfig
from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig

__all__ = ["APPO", "APPOConfig", "PPO", "PPOConfig", "DQN", "DQNConfig",
           "SAC", "SACConfig", "BC", "BCConfig", "MARWIL", "MARWILConfig",
           "CQL", "CQLConfig", "IQL", "IQLConfig", "IMPALA", "IMPALAConfig",
           "DreamerV3", "DreamerV3Config"]
