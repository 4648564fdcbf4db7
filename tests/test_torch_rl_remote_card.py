"""Learner actors and Sebulba on the card, and what the CPU tests ship to
the port's workers.

This file imports no JAX and nothing of the JAX package: the bandit env
that ``tests/test_torch_podracer_sebulba.py`` ships to Sebulba's env
actors lives here, so a worker that unpickles it imports torch, numpy
and the port only. The ``cuda`` tests skip without a GPU:
``python -m pytest --noconftest -m cuda tests/test_torch_rl_remote_card.py``.
"""

import copy

import numpy as np
import pytest
import torch

from ray_tpu_torch.rl.env import Env
from ray_tpu_torch.rl.spaces import Box, Discrete


class BanditEnv(Env):
    """Trivial learnable env (tests/test_podracer.py's): action 0 pays
    +1, action 1 pays -1; a policy that learns anything at all drives
    returns from ~0 to +8."""

    observation_space = Box(-np.ones(3, np.float32), np.ones(3, np.float32))
    action_space = Discrete(2)
    _LEN = 8

    def __init__(self):
        self._t = 0

    def reset(self, *, seed=None):
        self._t = 0
        return np.ones(3, np.float32), {}

    def step(self, action):
        self._t += 1
        reward = 1.0 if int(action) == 0 else -1.0
        return (np.ones(3, np.float32), reward,
                self._t >= self._LEN, False, {})


def learner_batch(n, seed):
    """A PPO minibatch of ``n`` CartPole-shaped rows from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(2, size=n).astype(np.int32),
        "action_logp": np.full(n, -0.69, dtype=np.float32),
        "vf_preds": rng.normal(size=n).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }


def ddp_reference_steps(learner, batches, n):
    """The learner group's arithmetic in one process, on ``learner``'s
    device: per batch, the loss's gradients on each wraparound shard,
    their mean, then the clip and Adam's step (learner.py:126-146)."""
    from ray_tpu_torch.rl.learner import batch_to_device, clip_by_global_norm_
    params = list(learner.module.parameters())
    for batch in batches:
        size = len(batch["obs"])
        idx = np.arange(max(size, n)) % size
        total = [torch.zeros_like(p) for p in params]
        for chunk in np.array_split(idx, n):
            shard = batch_to_device({k: v[chunk] for k, v in batch.items()},
                                    learner.device)
            loss, _ = learner.loss(learner.module, shard)
            grads = torch.autograd.grad(loss, params)
            total = [t + g for t, g in zip(total, grads)]
        learner.optimizer.zero_grad(set_to_none=True)
        for p, t in zip(params, total):
            p.grad = t / n
        if learner.grad_clip:
            clip_by_global_norm_([p.grad for p in params], learner.grad_clip)
        learner.optimizer.step()
    return learner


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import ray_tpu_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, system_config={
        "flight_recorder_enabled": True, "flight_flush_interval_s": 0.05})
    yield torch.device("cuda", torch.cuda.current_device())
    from ray_tpu_torch import serve
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.mark.cuda
def test_learner_group_shares_the_card(card):
    """Two learner actors on half a card each: three updates, the ranks
    bit-equal, within 1e-5 of the same steps in this process."""
    import ray_tpu_torch
    from ray_tpu_torch.rl import RLModuleSpec
    from ray_tpu_torch.rl.algorithms.ppo import PPOLearner
    from ray_tpu_torch.rl.learner import LearnerGroup
    spec = RLModuleSpec(Box(-np.full(4, 2.0, np.float32),
                            np.full(4, 2.0, np.float32)), Discrete(2),
                        (64, 64))
    kw = dict(lr=1e-3, grad_clip=0.5, seed=0)
    group = LearnerGroup(PPOLearner, num_learners=2, module_spec=spec, **kw)
    try:
        local = PPOLearner(spec, device=card, **kw)
        group.set_state(copy.deepcopy(
            {"params": {k: v.cpu() for k, v in
                        local.module.state_dict().items()},
             "opt_state": local.optimizer.state_dict()}))
        batches = [learner_batch(256, seed=s) for s in range(3)]
        for b in batches:
            group.update(b)
        ddp_reference_steps(local, batches, 2)
        w0, w1 = ray_tpu_torch.get(
            [a.get_weights.remote() for a in group._actors])
        want = local.get_weights()
        for a, b, c in zip(_leaves(w0), _leaves(w1), _leaves(want)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, c, rtol=0, atol=1e-5)
    finally:
        group.shutdown()


@pytest.mark.cuda
def test_sebulba_learns_with_learner_and_replica_on_the_card(card):
    from ray_tpu_torch.rl.podracer import Sebulba, SebulbaConfig
    from ray_tpu_torch.util import flight_recorder as tfr
    cfg = SebulbaConfig(
        env_creator=BanditEnv, num_actors=2, num_envs_per_actor=2,
        rollout_len=8, hidden=(16,), lr=3e-2, entropy_coeff=0.0,
        fragments_per_step=2, weight_push_interval=1, max_staleness=50,
        seed=0)
    s = Sebulba(cfg)
    try:
        out = s.train(12, step_timeout_s=60.0)
    finally:
        s.shutdown()
    learner = out["learner"]
    assert learner["num_updates"] == 12
    assert learner["weight_pushes"] >= 2 and learner["push_failures"] == 0
    returns = out["episode_returns"]
    third = max(len(returns) // 3, 1)
    assert np.mean(returns[-third:]) > np.mean(returns[:third])
    names = {ev[4] for events in tfr.merged_journals().values()
             for ev in events if ev[3] == "rl"}
    assert {"infer_batch", "learn_step", "weight_push"} <= names


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]
