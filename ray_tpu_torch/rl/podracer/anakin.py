"""Anakin: the fused rollout -> GAE -> PPO update (port of
ray_tpu/rl/podracer/anakin.py, Podracer architecture A).

    per shard:  rollout (T steps x N envs)  ->  truncation bootstrap
                ->  GAE  ->  PPO loss  ->  grad
    then:       gradient mean across the shards  ->  global-norm clip
                ->  Adam on every shard

The modules and the optimizer states live on their devices for the whole
run; per update only the metrics move to the host (one transfer). The
reference compiles the update into one ``pmap``-ed program per device
and averages the gradients with ``lax.pmean``, or with the quantized
``quantized_pmean`` when ``grad_compression`` is set. The port runs one
shard per entry of ``device`` in lockstep from one process (the same
device may repeat: virtual shards), each with its own module, optimizer,
envs and draws, and averages the gradients across the shards on the
first shard's device (``quantized_pmean_lockstep`` under
``grad_compression``); every shard then takes the same step, so the
shards stay identical. The metrics are averaged the same way. It
launches each op of the update from Python.

``build_step`` returns the per-device step and ``build_lockstep`` the
step over shards; the tests and ``chip_smoke.py`` drive them with
replayed noise, as the reference's parity test drives its step under
``jax.vmap``. Anakin runs none of the kernels K1-K5, so it may put
shards on devices other than the current one.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.collective import quantized_pmean_lockstep
from ray_tpu_torch.rl.algorithms.ppo import ppo_loss
from ray_tpu_torch.rl.env import TensorEnv, make_tensor_env
from ray_tpu_torch.rl.env_runner import device_rollout, draw_rollout_noise
from ray_tpu_torch.rl.learner import clip_by_global_norm_, compute_gae
from ray_tpu_torch.rl.rl_module import RLModuleSpec, params_to_tree
from ray_tpu_torch.rl.sample_batch import (
    ACTIONS, ADVANTAGES, DONES, FINAL_OBS, LOGP, OBS, REWARDS, TRUNCATEDS,
    VALUE_TARGETS, VF_PREDS)
from ray_tpu_torch.util import flight_recorder
from ray_tpu_torch.util import metrics as metrics_mod


@dataclass
class AnakinConfig:
    env: str = "CartPole-v1"
    num_envs_per_device: int = 16
    rollout_len: int = 16
    hidden: Tuple[int, ...] = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_clip_param: float = 10.0
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: Optional[float] = 0.5
    # None | "int8" | "fp8": the quantized gradient mean across shards
    grad_compression: Optional[str] = None
    seed: int = 0


def make_optimizer(module: torch.nn.Module,
                   cfg: AnakinConfig) -> torch.optim.Optimizer:
    """Adam(lr, eps=1e-5); the global-norm clip is ``apply_gradients``'s."""
    return torch.optim.Adam(module.parameters(), lr=cfg.lr, eps=1e-5)


def _mean(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean of per-shard tensors, on the first one's device."""
    if len(tensors) == 1:
        return tensors[0]
    home = tensors[0].device
    return torch.stack([t.to(home) for t in tensors]).mean(dim=0)


def build_lockstep(env: TensorEnv, spec: RLModuleSpec, cfg: AnakinConfig):
    """The fused step over shards in lockstep.

    ``step(modules, optimizers, env_states, obs, noises) ->
    (env_states, obs, metrics, cols)``, each argument and result a list
    with one entry per shard but ``metrics`` (0-d tensors on the first
    shard's device, averaged over the shards). Each shard rolls out and
    takes its loss's gradients on its own device; the gradients are
    averaged across the shards (``lax.pmean``, or the quantized
    ``quantized_pmean`` under ``cfg.grad_compression``), and each shard
    clips the mean and steps its Adam in place.
    """
    if cfg.grad_compression not in (None, "int8", "fp8"):
        raise ValueError(f"grad_compression must be None, int8 or fp8, "
                         f"not {cfg.grad_compression!r}")

    def shard_grads(module, env_state, obs, noise):
        env_state, obs, cols = device_rollout(
            module, env, env_state, obs, noise, cfg.rollout_len)
        with torch.no_grad():
            # truncation bootstrapping (same treatment as
            # PPO._postprocess): time-limit ends fold the next state's
            # value into the reward
            v_final = module.compute_values(cols[FINAL_OBS])
            rewards = (cols[REWARDS] + cfg.gamma * v_final
                       * cols[TRUNCATEDS].float())
            adv, targets = compute_gae(
                rewards, cols[VF_PREDS], cols[DONES],
                cols["bootstrap_value"], gamma=cfg.gamma,
                lambda_=cfg.lambda_)
        flat = {k: cols[k].reshape((-1,) + cols[k].shape[2:])
                for k in (OBS, ACTIONS, LOGP, VF_PREDS)}
        flat[ADVANTAGES] = adv.reshape(-1)
        flat[VALUE_TARGETS] = targets.reshape(-1)
        loss, metrics, _ = ppo_loss(
            module, flat, clip_param=cfg.clip_param,
            vf_clip_param=cfg.vf_clip_param,
            vf_loss_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff)
        grads = torch.autograd.grad(loss, list(module.parameters()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = loss.detach()
        metrics["reward_mean"] = cols[REWARDS].mean()
        return env_state, obs, cols, grads, metrics

    def step(modules, optimizers, env_states, obs, noises):
        out = [shard_grads(*args) for args in zip(modules, env_states, obs,
                                                  noises)]
        per_leaf = list(zip(*(o[3] for o in out)))
        if cfg.grad_compression:
            means = [quantized_pmean_lockstep(gs, cfg.grad_compression)
                     for gs in per_leaf]
        else:
            mean = [_mean(gs) for gs in per_leaf]
            means = [[m.to(g.device) for g in gs]
                     for m, gs in zip(mean, per_leaf)]
        for i, (module, optimizer) in enumerate(zip(modules, optimizers)):
            params = list(module.parameters())
            for p, m in zip(params, means):
                p.grad = m[i] if len(modules) == 1 else m[i].clone()
            if cfg.grad_clip:
                clip_by_global_norm_([p.grad for p in params], cfg.grad_clip)
            optimizer.step()
        metrics = {k: _mean([o[4][k] for o in out]) for k in out[0][4]}
        return ([o[0] for o in out], [o[1] for o in out], metrics,
                [o[2] for o in out])

    return step


def build_step(env: TensorEnv, spec: RLModuleSpec, cfg: AnakinConfig):
    """The fused per-device step: :func:`build_lockstep` over one shard.

    ``step(module, optimizer, env_state, obs, noise) ->
    (env_state, obs, metrics, cols)`` updates ``module`` and
    ``optimizer`` in place. ``noise`` is the rollout's draws
    (``draw_rollout_noise``; moved to the device if made elsewhere);
    ``metrics`` are 0-d tensors on the device and ``cols`` the rollout's
    [T, N] columns.
    """
    lockstep = build_lockstep(env, spec, cfg)

    def step(module, optimizer, env_state, obs, noise):
        states, obs, metrics, cols = lockstep(
            [module], [optimizer], [env_state], [obs], [noise])
        return states[0], obs[0], metrics, cols[0]

    return step


def init_shard(env: TensorEnv, cfg: AnakinConfig,
               generator: Optional[torch.Generator], device):
    """``(env_state, obs)`` of ``num_envs_per_device`` fresh envs."""
    return env.reset(env.draw_reset((cfg.num_envs_per_device,), generator,
                                    device))


class Anakin:
    """Runs the fused step over the shards of ``device``: one device, or
    a list (which may repeat a device) with one shard on each entry."""

    def __init__(self, config: AnakinConfig, device=None):
        devices = (list(device) if isinstance(device, (list, tuple))
                   else [device])
        if not devices:
            raise ValueError("Anakin needs at least one device")
        self.config = config
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        env = make_tensor_env(config.env)
        if env is None:
            raise ValueError(
                f"no TensorEnv registered under {config.env!r} — Anakin "
                "needs a batched tensor env (see ray_tpu_torch.rl.env)")
        self.env = env
        self.spec = RLModuleSpec(env.observation_space, env.action_space,
                                 config.hidden)
        self.module = self.spec.init(config.seed, self.device)
        # replicated parameters: a copy of the first shard's on each shard
        self.modules = [self.module] + [copy.deepcopy(self.module).to(d)
                                        for d in self.devices[1:]]
        self.optimizers = [make_optimizer(m, config) for m in self.modules]
        self.optimizer = self.optimizers[0]
        self._step = build_lockstep(env, self.spec, config)
        # one generator draws every shard's envs and rollouts, in shard
        # order, so that each shard gets its own draws
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.env_states, self.obs_shards = [], []
        for d in self.devices:
            state, obs = init_shard(env, config, self.generator, self.device)
            self.env_states.append({k: v.to(d) for k, v in state.items()})
            self.obs_shards.append(obs.to(d))
        # (steps, shard) -> {"action", "reset"}: where the rollouts' draws
        # come from (env_runner's module docstring)
        self.noise: Callable[[int, int], Dict[str, torch.Tensor]] = \
            self.draw_noise
        self.env_steps = 0
        self.env_steps_per_sec = 0.0

    def draw_noise(self, steps: int, shard: int = 0
                   ) -> Dict[str, torch.Tensor]:
        noise = draw_rollout_noise(self.spec, self.env, steps,
                                   self.config.num_envs_per_device,
                                   self.generator, self.device)
        return {k: v.to(self.devices[shard]) for k, v in noise.items()}

    @property
    def env_state(self):
        return self.env_states[0]

    @property
    def obs(self):
        return self.obs_shards[0]

    @property
    def params(self):
        """The first shard's params as the reference's tree (host
        copy)."""
        return params_to_tree(self.module)

    def train(self, num_updates: int) -> Dict[str, Any]:
        """Run fused updates; returns the last update's metrics (the
        mean over the shards) and the rate. Only the metrics cross to the
        host."""
        cfg = self.config
        n = len(self.devices)
        steps_per_update = n * cfg.num_envs_per_device * cfg.rollout_len
        last_metrics: Dict[str, Any] = {}
        t_start = time.perf_counter()
        for i in range(num_updates):
            t0 = flight_recorder.clock_ns()
            noises = [self.noise(cfg.rollout_len, j) for j in range(n)]
            self.env_states, self.obs_shards, m, _cols = self._step(
                self.modules, self.optimizers, self.env_states,
                self.obs_shards, noises)
            last_metrics = dict(zip(m, torch.stack(list(m.values()))
                                    .tolist()))
            self.env_steps += steps_per_update
            rec = flight_recorder.RECORDER
            if rec is not None:
                rec.record("rl", "learn_step", t0,
                           flight_recorder.clock_ns() - t0,
                           {"arch": "anakin", "update": i,
                            "env_steps": steps_per_update})
            metrics_mod.record_batch([
                ("counter", "ray_tpu_rl_env_steps_total",
                 {"arch": "anakin"}, float(steps_per_update), None),
            ])
        wall = max(time.perf_counter() - t_start, 1e-9)
        self.env_steps_per_sec = num_updates * steps_per_update / wall
        out = dict(last_metrics)
        out.update({
            "num_updates": num_updates,
            "num_devices": n,
            "env_steps": self.env_steps,
            "env_steps_per_sec": self.env_steps_per_sec,
        })
        return out
