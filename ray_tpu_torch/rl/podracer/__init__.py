"""Podracer RL architectures of the port (PAPERS.md: "Podracer
architectures for scalable deep reinforcement learning").

- :class:`Anakin`: the fused rollout -> GAE -> PPO update on one device
  or over shards in lockstep.
- :class:`Sebulba`: everything decoupled on the port's runtime: host
  env-runner actors, a batched inference server on
  ``ray_tpu_torch.serve`` (``PolicyInference``), an object-store replay
  queue (``ReplayActor``) and a learner actor that broadcasts
  version-tagged int8 weights (``quantize_params``) mid-flight.
"""

from ray_tpu_torch.rl.podracer.anakin import (
    Anakin,
    AnakinConfig,
    build_lockstep,
    build_step,
    init_shard,
    make_optimizer,
)
from ray_tpu_torch.rl.podracer.inference import (
    PolicyInference,
    broadcast_weights,
    build_inference_app,
    dequantize_params,
    quantize_params,
)
from ray_tpu_torch.rl.podracer.replay import (
    DEFAULT_CAPACITY,
    FragmentReplay,
    ReplayActor,
    create_replay_actor,
)
from ray_tpu_torch.rl.podracer.sebulba import (
    Sebulba,
    SebulbaConfig,
    _SebulbaActorImpl,
    _SebulbaLearnerImpl,
)

__all__ = ["Anakin", "AnakinConfig", "DEFAULT_CAPACITY", "FragmentReplay",
           "PolicyInference", "ReplayActor", "Sebulba", "SebulbaConfig",
           "_SebulbaActorImpl", "_SebulbaLearnerImpl", "broadcast_weights",
           "build_inference_app", "build_lockstep", "build_step",
           "create_replay_actor", "dequantize_params", "init_shard",
           "make_optimizer", "quantize_params"]
