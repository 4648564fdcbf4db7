"""Algorithm / AlgorithmConfig: the RL training loop (port of
ray_tpu/rl/algorithm.py; reference: rllib/algorithms/algorithm.py:1190
and algorithm_config.py:109).

The fluent config and the train/save/restore surface are the
reference's.
``build_algo(device=None)`` follows the port's device rule: the
algorithm runs on the card unless ``device="cpu"`` is passed.
Checkpoints go through ``torch.save`` / ``torch.load`` (the reference
uses its runtime's serialization).

``multi_agent(policies=, policy_mapping_fn=, policies_to_train=)``
configures multi-agent training (``rl/multi_agent.py``); only an
algorithm with ``supports_multi_agent`` (PPO) takes it, any other raises
``ValueError`` when built.

``num_env_runners`` and ``num_learners`` start actors on the port's
runtime (``ray_tpu_torch.init()`` first): PPO, APPO and IMPALA sample
through remote env runners, and PPO trains on several learner actors
(``rl/learner.py``). As in the reference, DQN, SAC, DreamerV3 and the
offline algorithms sample locally whatever ``num_env_runners`` says.
``stop()`` releases an algorithm's actors.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rl.connectors import ConnectorPipeline
from ray_tpu_torch.rl.env import Env, TensorEnv, make_env, make_tensor_env
from ray_tpu_torch.rl.multi_agent import MultiAgentEnv
from ray_tpu_torch.rl.rl_module import RLModuleSpec
from ray_tpu_torch.rl.spaces import Box

class AlgorithmConfig:
    """Fluent config; subclass per algorithm for defaults."""

    algo_class = None  # set by subclasses

    def __init__(self):
        # environment
        self.env: Any = None
        self.env_creator: Optional[Callable[[], Env]] = None
        # env runners
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 8
        self.rollout_fragment_length: int = 128
        # the reference's prefer_jax_env: sample on the device through a
        # TensorEnv where one is registered
        self.prefer_tensor_env: bool = True
        # training
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.grad_clip: Optional[float] = None
        # learners
        self.num_learners: int = 0
        # module
        self.hidden: Tuple[int, ...] = (64, 64)
        # env→module connectors: FACTORIES (each runner builds its own
        # stateful pipeline; see rl/connectors.py)
        self.connector_factories: list = []
        # evaluation-runner split (reference: algorithm.py:1407 evaluate)
        self.evaluation_interval: Optional[int] = None
        self.evaluation_duration: int = 10  # episodes per evaluate()
        self.evaluation_num_envs: int = 4
        # multi-agent (reference: algorithm_config.py multi_agent():
        # policies + policy_mapping_fn + policies_to_train)
        self.policies: Optional[Dict[str, Any]] = None
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None
        self.policies_to_train: Optional[List[str]] = None
        # misc
        self.seed: int = 0

    # -- fluent sections (reference: algorithm_config.py) ---------------
    def environment(self, env=None, *, env_creator=None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_creator is not None:
            self.env_creator = env_creator
        return self

    def env_runners(self, *, num_env_runners=None,
                    num_envs_per_env_runner=None,
                    rollout_fragment_length=None,
                    prefer_tensor_env=None) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if prefer_tensor_env is not None:
            self.prefer_tensor_env = prefer_tensor_env
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown training option {key!r}")
            setattr(self, key, value)
        return self

    def learners(self, *, num_learners=None) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        return self

    def rl_module(self, *, hidden=None) -> "AlgorithmConfig":
        if hidden is not None:
            self.hidden = tuple(hidden)
        return self

    def evaluation(self, *, evaluation_interval=None,
                   evaluation_duration=None,
                   evaluation_num_envs=None) -> "AlgorithmConfig":
        """Evaluation-runner split (reference: algorithm.py:1407
        evaluate; evaluation_interval in iterations, duration in
        episodes)."""
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        if evaluation_num_envs is not None:
            self.evaluation_num_envs = evaluation_num_envs
        return self

    def multi_agent(self, *, policies=None, policy_mapping_fn=None,
                    policies_to_train=None) -> "AlgorithmConfig":
        """Multi-agent setup (reference: algorithm_config.py
        multi_agent()). ``policies`` maps policy id -> (obs_space,
        action_space) or None to infer from the first mapped agent;
        ``policy_mapping_fn(agent_id) -> policy_id``."""
        if policies is not None:
            self.policies = (dict.fromkeys(policies)
                             if not isinstance(policies, dict)
                             else dict(policies))
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        if policies_to_train is not None:
            self.policies_to_train = list(policies_to_train)
        return self

    @property
    def is_multi_agent(self) -> bool:
        return self.policy_mapping_fn is not None

    def make_multi_agent_env(self) -> MultiAgentEnv:
        if self.env_creator is not None:
            return self.env_creator()
        if isinstance(self.env, type) and issubclass(self.env,
                                                     MultiAgentEnv):
            return self.env()
        raise ValueError(
            f"multi-agent config needs an env_creator or a "
            f"MultiAgentEnv class, got {self.env!r}")

    def env_to_module(self, connectors: list) -> "AlgorithmConfig":
        """Configure the env→module connector pipeline (reference:
        AlgorithmConfig.env_to_module_connector). Pass factories
        (zero-arg callables) so every env runner gets its own state."""
        self.connector_factories = list(connectors)
        return self

    def build_connectors(self) -> ConnectorPipeline:
        """Each call builds a fresh pipeline; empty (the identity) when
        nothing is configured."""
        return ConnectorPipeline([f() for f in self.connector_factories])

    def debugging(self, *, seed=None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    # -- env construction ----------------------------------------------
    def make_python_env(self) -> Env:
        if self.env_creator is not None:
            return self.env_creator()
        if isinstance(self.env, str):
            return make_env(self.env)
        if isinstance(self.env, type) and issubclass(self.env, Env):
            return self.env()
        raise ValueError(f"cannot build env from {self.env!r}")

    def make_tensor_env(self) -> Optional[TensorEnv]:
        if not self.prefer_tensor_env:
            return None
        if isinstance(self.env, str):
            return make_tensor_env(self.env)
        if isinstance(self.env, type) and issubclass(self.env, TensorEnv):
            return self.env()
        if isinstance(self.env, TensorEnv):
            return self.env
        return None

    def module_spec(self) -> RLModuleSpec:
        env = self.make_tensor_env() or self.make_python_env()
        obs_space = env.observation_space
        mult = self.build_connectors().obs_dim_multiplier()
        if mult > 1:  # e.g. FrameStack widens the module's input
            lo = np.tile(np.broadcast_to(
                obs_space.low, obs_space.shape).ravel(), mult)
            hi = np.tile(np.broadcast_to(
                obs_space.high, obs_space.shape).ravel(), mult)
            obs_space = Box(lo.astype(np.float32), hi.astype(np.float32))
        return RLModuleSpec(obs_space=obs_space,
                            action_space=env.action_space,
                            hidden=self.hidden)

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build_algo(self, device: DeviceLike = None) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use a subclass "
                             "like PPOConfig")
        return self.algo_class(self.copy(), device=device)


class Algorithm:
    """Iteration-driven trainer: train / save_to_path /
    restore_from_path."""

    # Subclasses that consume config.multi_agent() set this; everything
    # else fails at build time instead of mis-running a MultiAgentEnv
    # through the single-agent path.
    supports_multi_agent = False

    def __init__(self, config: AlgorithmConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.iteration = 0
        self._env_steps_lifetime = 0
        self._episode_returns: List[float] = []
        self._episode_lens: List[int] = []
        if (config.evaluation_interval
                and type(self).evaluate is Algorithm.evaluate):
            # Fail at build time, not at iteration N mid-job.
            raise ValueError(
                f"{type(self).__name__} does not implement evaluate(); "
                "remove evaluation_interval from the config")
        if config.is_multi_agent and not self.supports_multi_agent:
            raise ValueError(
                f"{type(self).__name__} does not support multi_agent(); "
                "use PPO, or drop the policy_mapping_fn")
        self.setup(config)

    # -- subclass hooks --------------------------------------------------
    def setup(self, config: AlgorithmConfig) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        """One unit of sampling + learning; returns metrics."""
        raise NotImplementedError

    # -- public loop -----------------------------------------------------
    def train(self) -> Dict[str, Any]:
        start = time.perf_counter()
        steps_before = self._env_steps_lifetime
        metrics = self.training_step()
        self.iteration += 1
        elapsed = time.perf_counter() - start
        sampled = self._env_steps_lifetime - steps_before
        recent = self._episode_returns[-100:]
        recent_lens = self._episode_lens[-100:]
        result = {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": sampled,
            "num_env_steps_sampled_lifetime": self._env_steps_lifetime,
            "env_steps_per_sec": sampled / max(elapsed, 1e-9),
            "time_this_iter_s": elapsed,
            "episode_return_mean": (float(np.mean(recent)) if recent
                                    else float("nan")),
            "episode_len_mean": (float(np.mean(recent_lens))
                                 if recent_lens else float("nan")),
            "episodes_total": len(self._episode_returns),
        }
        result.update(metrics)
        if (self.config.evaluation_interval
                and self.iteration % self.config.evaluation_interval == 0):
            result["evaluation"] = self.evaluate()
        return result

    def evaluate(self) -> Dict[str, Any]:
        """Run the evaluation-runner split (reference:
        algorithm.py:1407). Subclasses with evaluation support override."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement evaluate()")

    def record_episodes(self, returns: List[float],
                        lens: Optional[List[int]] = None) -> None:
        self._episode_returns.extend(returns)
        if lens:
            self._episode_lens.extend(lens)

    # -- checkpointing (reference: rllib/utils/checkpoints.py
    #    Checkpointable.save_to_path / restore_from_path) ----------------
    def get_state(self) -> Dict[str, Any]:
        return {
            "iteration": self.iteration,
            "env_steps_lifetime": self._env_steps_lifetime,
            "episode_returns": self._episode_returns[-1000:],
            "episode_lens": self._episode_lens[-1000:],
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.iteration = state["iteration"]
        self._env_steps_lifetime = state["env_steps_lifetime"]
        self._episode_returns = list(state["episode_returns"])
        self._episode_lens = list(state.get("episode_lens", ()))

    def save_to_path(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        torch.save(self.get_state(),
                   os.path.join(path, "algorithm_state.pt"))
        return path

    def restore_from_path(self, path: str) -> None:
        self.set_state(torch.load(os.path.join(path, "algorithm_state.pt"),
                                  map_location="cpu", weights_only=True))

    def stop(self) -> None:
        """Release what the algorithm holds on the runtime (nothing
        unless a subclass started actors)."""
