"""IMPALA — V-trace, its learner and the asynchronous loop (port of
ray_tpu/rl/algorithms/impala.py; reference: rllib/algorithms/impala/,
Espeholt et al. 2018).

``vtrace_returns`` corrects a stale behaviour policy's fragment with
truncated importance weights over time-major [T, N] columns; the
reference scans over T in reverse (``lax.scan(reverse=True)``), the
port loops over T on device tensors. ``IMPALALearner`` trains one pass
per fragment on the port's ``Learner``, with the reference's
``stop_gradient`` as ``detach()`` in the same places. ``IMPALA`` is
APPO's asynchronous loop over remote env runners with the V-trace
learner: fragments stay time-major and train whole, one update each,
without GAE or shuffled epochs, so the learner is one local learner.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rl.learner import Learner, mean_metrics
from ray_tpu_torch.rl.sample_batch import (
    ACTIONS, DONES, FINAL_OBS, LOGP, OBS, REWARDS, TRUNCATEDS)


def vtrace_returns(log_rhos, discounts, rewards, values, bootstrap_value,
                   *, clip_rho_threshold: float = 1.0,
                   clip_pg_rho_threshold: float = 1.0):
    """V-trace targets ``vs`` and policy-gradient advantages over
    time-major [T, N] columns (impala.py:27-58; Espeholt et al. 2018
    eq. 1), in f32 and in the reference's order of operations. Callers
    detach what the reference stops gradients through."""
    rhos = torch.exp(log_rhos)
    clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold)
    cs = torch.clamp(rhos, max=1.0)
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(bootstrap_value)
    out = []
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        out.append(acc)
    vs = torch.stack(out[::-1]) + values
    next_vs = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = torch.clamp(rhos, max=clip_pg_rho_threshold)
    pg_advantages = clipped_pg_rhos * (
        rewards + discounts * next_vs - values)
    return vs, pg_advantages


class IMPALAConfig(APPOConfig):
    def __init__(self):
        super().__init__()
        self.clip_rho_threshold = 1.0
        self.clip_pg_rho_threshold = 1.0
        self.lr = 5e-4
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5


class IMPALALearner(Learner):
    """The V-trace actor-critic loss over one time-major fragment."""

    def __init__(self, module_spec, *, gamma: float = 0.99,
                 clip_rho_threshold: float = 1.0,
                 clip_pg_rho_threshold: float = 1.0,
                 vf_loss_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, **kwargs):
        self.gamma = gamma
        self.clip_rho_threshold = clip_rho_threshold
        self.clip_pg_rho_threshold = clip_pg_rho_threshold
        self.vf_loss_coeff = vf_loss_coeff
        self.entropy_coeff = entropy_coeff
        super().__init__(module_spec, **kwargs)

    def loss(self, module, batch):
        dist, values = module(batch[OBS])  # [T, N]
        logp = dist.log_prob(batch[ACTIONS])
        log_rhos = logp - batch[LOGP]  # current vs behavior policy
        dones = batch[DONES].to(torch.float32)
        # truncated episodes bootstrap from the true next obs (time
        # limits are not terminations)
        v_final = module.compute_values(batch[FINAL_OBS]).detach()
        rewards = (batch[REWARDS].to(torch.float32)
                   + self.gamma * v_final
                   * batch[TRUNCATEDS].to(torch.float32))
        discounts = self.gamma * (1.0 - dones)
        # bootstrap with the learner's value of the fragment's true
        # next obs (v_final[-1]), as the reference does: the runner's
        # bootstrap_value came from the behaviour weights
        vs, pg_adv = vtrace_returns(
            log_rhos.detach(), discounts, rewards, values.detach(),
            v_final[-1], clip_rho_threshold=self.clip_rho_threshold,
            clip_pg_rho_threshold=self.clip_pg_rho_threshold)
        policy_loss = -(logp * pg_adv).mean()
        vf_loss = 0.5 * ((values - vs) ** 2).mean()
        entropy = dist.entropy().mean()
        total = (policy_loss + self.vf_loss_coeff * vf_loss
                 - self.entropy_coeff * entropy)
        return total, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_rho": torch.exp(log_rhos).mean(),
        }


class IMPALA(APPO):
    """APPO's asynchronous actor loop with the V-trace learner."""

    learner_cls = IMPALALearner

    def _learner_kwargs(self, config) -> Dict[str, Any]:
        return dict(
            module_spec=self.spec, lr=config.lr,
            grad_clip=config.grad_clip, seed=config.seed,
            gamma=config.gamma,
            clip_rho_threshold=config.clip_rho_threshold,
            clip_pg_rho_threshold=config.clip_pg_rho_threshold,
            vf_loss_coeff=config.vf_loss_coeff,
            entropy_coeff=config.entropy_coeff)

    def setup(self, config: IMPALAConfig) -> None:
        if config.num_learners > 1:
            # V-trace consumes whole time-major sequences; splitting a
            # fragment's rows across learner actors would cut them
            raise ValueError("IMPALA supports num_learners <= 1 "
                             "(fragments train whole, time-major)")
        super().setup(config)

    # -- fragment hooks: keep time-major, no GAE/epochs ---------------
    def _prepare_fragment(self, cols, module):
        return {key: np.asarray(value) for key, value in cols.items()}

    def _train_fragments(self, batches: List[dict]) -> Dict[str, Any]:
        learner = self.learner_group.local_learner
        all_metrics = []
        for batch in batches:
            self._env_steps_lifetime += int(batch["rewards"].size)
            all_metrics.append(learner.update(batch))
        return mean_metrics(all_metrics)


IMPALAConfig.algo_class = IMPALA
