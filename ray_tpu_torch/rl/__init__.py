"""Reinforcement learning of the port (ray_tpu/rl on PyTorch).

Everything on local runners and one device: PPO on a device rollout
over a batched tensor env (``CartPoleTensor``) or on numpy envs stepped
on the host through env-to-module connectors, Anakin's fused rollout ->
GAE -> PPO update (``ray_tpu_torch.rl.podracer``), the IMPALA learner's
V-trace, DQN, SAC, offline BC/MARWIL, CQL and IQL, DreamerV3, and
multi-agent PPO over parallel (``MultiAgentEnvRunner``) and turn-based
(``TurnBasedEnvRunner``) envs. What is not ported yet raises
``NotImplementedError`` naming its ROADMAP.md Queue 1 item: remote env
runners, APPO's and IMPALA's asynchronous loops and
``OfflineData.from_dataset`` (item 9), several learner actors (item
4.3).
"""

from ray_tpu_torch.rl import spaces
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rl.algorithms.bc import BC, BCConfig, MARWIL, MARWILConfig
from ray_tpu_torch.rl.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rl.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.algorithms.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rl.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.algorithms.iql import IQL, IQLConfig
from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rl.connectors import (
    Connector, ConnectorPipeline, FrameStack, ObsNormalizer, RewardClip)
from ray_tpu_torch.rl.env import (
    CartPole, CartPoleTensor, Env, Pendulum, TensorEnv, make_env,
    make_tensor_env, register_env)
from ray_tpu_torch.rl.env_runner import SingleAgentEnvRunner, TensorEnvRunner
from ray_tpu_torch.rl.learner import Learner, LearnerGroup, compute_gae
from ray_tpu_torch.rl.multi_agent import (
    MultiAgentEnv, MultiAgentEnvRunner, RepeatedRockPaperScissors, TicTacToe,
    TurnBasedEnvRunner)
from ray_tpu_torch.rl.offline import OfflineData, collect_episodes
from ray_tpu_torch.rl.rl_module import (
    ActorCritic, RLModuleSpec, params_from_jax)
from ray_tpu_torch.rl.sample_batch import SampleBatch, concat_samples

__all__ = [
    "APPO", "APPOConfig", "ActorCritic", "Algorithm", "AlgorithmConfig",
    "BC", "BCConfig", "CQL", "CQLConfig", "CartPole", "CartPoleTensor",
    "Connector", "ConnectorPipeline", "DQN", "DQNConfig", "DreamerV3",
    "DreamerV3Config", "Env", "FrameStack", "IMPALA", "IMPALAConfig",
    "IQL", "IQLConfig", "Learner", "LearnerGroup", "MARWIL",
    "MARWILConfig", "MultiAgentEnv", "MultiAgentEnvRunner",
    "ObsNormalizer", "OfflineData", "PPO", "PPOConfig", "Pendulum",
    "RLModuleSpec", "RepeatedRockPaperScissors", "RewardClip", "SAC",
    "SACConfig", "SampleBatch", "SingleAgentEnvRunner", "TensorEnv",
    "TensorEnvRunner", "TicTacToe", "TurnBasedEnvRunner",
    "collect_episodes", "compute_gae", "concat_samples", "make_env",
    "make_tensor_env", "params_from_jax", "register_env", "spaces",
]
