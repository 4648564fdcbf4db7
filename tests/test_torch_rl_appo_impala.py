"""APPO's and IMPALA's asynchronous loops on the port's runtime, on the
CPU: the reference's learning bars (tests/test_rl.py:546-581: APPO past
a mean return of 40 on CartPole in 12 iterations; :1030-1064: IMPALA's
best past 60 within 25), its two refusals, and a runner whose env
raises, which the loop kills and starts anew after two failures while
the other runner keeps sampling. No test here needs JAX.
"""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rl import APPOConfig, IMPALAConfig
from ray_tpu_torch.rl.env import CartPole


@pytest.fixture(scope="module")
def rt():
    """One runtime; runner processes on one torch thread."""
    old_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old_omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    runtime = ray_tpu_torch.init(num_cpus=4)
    yield runtime
    ray_tpu_torch.shutdown()
    torch.set_num_threads(old_threads)
    if old_omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old_omp


def test_appo_async_learns(rt):
    """Async runners + PPO's surrogate on stale fragments: better than
    a random CartPole policy (~22), with sampling in flight between
    steps."""
    config = (APPOConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                           rollout_fragment_length=64)
              .training(lr=3e-3, minibatch_size=256)
              .debugging(seed=0))
    algo = config.build_algo(device="cpu")
    try:
        result = {}
        for _ in range(12):
            result = algo.train()
        assert result.get("fragments_consumed", 0) >= 1
        assert result["fragments_in_flight"] >= 1  # sampling never stops
        assert np.isfinite(result["policy_loss"])
        assert result["episode_return_mean"] > 40, result
    finally:
        algo.stop()  # a failed assert must not leak runner actors


def test_impala_async_learns(rt):
    config = (IMPALAConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                           rollout_fragment_length=64,
                           prefer_tensor_env=False)
              .training(lr=5e-3, entropy_coeff=0.005)
              .debugging(seed=0))
    algo = config.build_algo(device="cpu")
    try:
        best = -1.0
        saw_rho = False
        for _ in range(25):
            result = algo.train()
            saw_rho = saw_rho or "mean_rho" in result
            if result["episodes_total"]:
                best = max(best, result["episode_return_mean"])
            if best > 60.0:
                break
        assert best > 60.0, f"IMPALA failed to learn: best={best}"
        assert saw_rho  # the V-trace loss actually ran
    finally:
        algo.stop()


def test_appo_requires_runners():
    with pytest.raises(ValueError, match="num_env_runners"):
        (APPOConfig().environment("CartPole-v1")
         .env_runners(num_env_runners=0).build_algo(device="cpu"))


def test_impala_rejects_multi_learner():
    config = (IMPALAConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=1)
              .learners(num_learners=2))
    with pytest.raises(ValueError, match="num_learners"):
        config.build_algo(device="cpu")


class _FailingEnv(CartPole):
    """CartPole whose steps raise while a budget file holds a count
    above zero, in the runner whose envs reset from seed ``doomed``;
    each raise spends one."""

    def __init__(self, budget_path, doomed):
        super().__init__()
        self.budget_path = budget_path
        self.doomed = doomed
        self.seed = None

    def reset(self, *, seed=None):
        if seed is not None:
            self.seed = seed
        return super().reset(seed=seed)

    def step(self, action):
        if self.seed == self.doomed:
            with open(self.budget_path) as f:
                left = int(f.read())
            if left > 0:
                with open(self.budget_path, "w") as f:
                    f.write(str(left - 1))
                raise RuntimeError("env exploded")
        return super().step(action)


def test_failing_runner_is_recreated(rt, tmp_path):
    """Runner 1's env raises on its first two samples: the loop kills
    that actor and starts a fresh one from its construction arguments
    (which samples, the budget spent); runner 0 feeds the learner all
    along."""
    budget = tmp_path / "budget"
    budget.write_text("2")
    path, doomed = str(budget), 1  # runner 1 resets its env from seed 1
    config = (APPOConfig()
              .environment(env_creator=lambda: _FailingEnv(path, doomed))
              .env_runners(num_env_runners=2, num_envs_per_env_runner=1,
                           rollout_fragment_length=16)
              .training(minibatch_size=16)
              .debugging(seed=0))
    algo = config.build_algo(device="cpu")
    try:
        first = algo.runners[1]
        consumed = 0
        for _ in range(6):
            result = algo.train()
            consumed += result["fragments_consumed"]
        assert budget.read_text() == "0"
        assert algo.runners[1] is not first  # killed and started anew
        assert algo.runners[0] is not None
        assert consumed >= 6 and np.isfinite(result["policy_loss"])
        # the new runner samples
        assert len(ray_tpu_torch.get(algo.runners[1].sample.remote())[0]
                   ["obs"]) == 16
        with pytest.raises(Exception):
            ray_tpu_torch.get(first.ping.remote(), timeout=30)
    finally:
        algo.stop()
