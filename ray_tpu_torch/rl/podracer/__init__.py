"""Podracer RL architectures of the port: :class:`Anakin`, the fused
rollout -> GAE -> PPO update on one device or over shards in lockstep; Sebulba's fragment replay
(``FragmentReplay``) and its int8 weight push (``quantize_params``,
``dequantize_params``). Sebulba itself, its ``ReplayActor`` and its
``PolicyInference`` deployment come with the runtime copy, ROADMAP.md
Queue 1 item 9."""

from ray_tpu_torch.rl.podracer.anakin import (
    Anakin,
    AnakinConfig,
    build_lockstep,
    build_step,
    init_shard,
    make_optimizer,
)
from ray_tpu_torch.rl.podracer.inference import (
    dequantize_params,
    quantize_params,
)
from ray_tpu_torch.rl.podracer.replay import DEFAULT_CAPACITY, FragmentReplay

__all__ = ["Anakin", "AnakinConfig", "DEFAULT_CAPACITY", "FragmentReplay",
           "build_lockstep", "build_step", "dequantize_params", "init_shard",
           "make_optimizer", "quantize_params"]
