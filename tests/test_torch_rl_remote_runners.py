"""The port's remote env runners on its runtime, on the CPU.

The scenario of tests/test_rl.py:227-239 (PPO over two remote runners),
each remote runner's fragment against a local ``SingleAgentEnvRunner``
from the same seed and weights (bit for bit: both compute on the CPU),
the ``ObsNormalizer`` delta sync that must not double count (the
protocol of tests/test_rl.py:471-493, here through PPO's remote path),
``evaluate()`` reading the canonical state, and multi-agent PPO's
refusals in the reference's words. No test here needs JAX.
"""

import copy
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core import serialization
from ray_tpu_torch.rl import ObsNormalizer, PPOConfig
from ray_tpu_torch.rl.algorithms.ppo import _EnvRunnerActor
from ray_tpu_torch.rl.env import CartPole
from ray_tpu_torch.rl.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rl.rl_module import params_to_tree

T, N = 16, 2


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


def _config(runners=2, seed=0):
    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=runners, num_envs_per_env_runner=N,
                         rollout_fragment_length=T, prefer_tensor_env=False)
            .training(num_epochs=1, minibatch_size=32)
            .debugging(seed=seed))


def test_remote_runners_need_the_runtime():
    """Runs first, before the module's runtime starts."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    with pytest.raises(RuntimeError, match=r"init\(\) has not been called"):
        _config().build_algo(device="cpu")


def test_ppo_remote_env_runners(rt):
    algo = _config().build_algo(device="cpu")
    try:
        assert algo._remote and len(algo.runners) == 2
        result = algo.train()
        assert result["num_env_steps_sampled"] == 2 * N * T
        assert np.isfinite(result["policy_loss"])
        assert algo.train()["num_env_steps_sampled_lifetime"] == 4 * N * T
    finally:
        algo.stop()  # release the runner actors' CPUs
    assert algo.runners == []


def test_remote_runner_equals_local_runner(rt):
    """Remote runner i samples from seed + i on the CPU; a local runner
    from the same seed and weights gives the same fragment, bit for
    bit, twice in a row."""
    algo = _config(seed=5).build_algo(device="cpu")
    try:
        weights = algo.learner_group.get_weights()
        for i, blob in enumerate(algo._runner_blobs):
            assert serialization.loads(blob)["seed"] == 5 + i
            local = SingleAgentEnvRunner(
                env_creator=CartPole, module_spec=algo.spec, num_envs=N,
                rollout_len=T, seed=5 + i, device="cpu")
            local.set_weights(weights)
            ray_tpu_torch.get(algo.runners[i].set_weights.remote(weights))
            for _ in range(2):
                cols, metrics, delta = ray_tpu_torch.get(
                    algo.runners[i].sample.remote())
                want = local.sample()
                assert set(cols) == set(want)
                for key in want:
                    np.testing.assert_array_equal(cols[key], want[key],
                                                  err_msg=key)
                assert metrics == local.pop_metrics()
                assert delta == {}  # no connectors configured
    finally:
        algo.stop()


def test_remote_runner_actor_builds_its_own_connectors():
    """The actor class in this process: factories become a pipeline of
    its own, and the policy runs on the CPU."""
    algo_cfg = _config(runners=0).env_to_module([ObsNormalizer])
    spec = algo_cfg.module_spec()
    actor = _EnvRunnerActor(serialization.dumps(dict(
        env_creator=CartPole, module_spec=spec, num_envs=N, rollout_len=4,
        seed=0, connector_factories=[ObsNormalizer])))
    assert actor.runner.device == torch.device("cpu")
    cols, _metrics, delta = actor.sample()
    assert cols["obs"].shape == (4, N, 4)
    # the reset's N observations and 4 steps of N
    assert delta[0]["count"] == N + 4 * N
    assert actor.pop_connector_delta()[0]["mean"] is None


def test_obs_normalizer_delta_sync_does_not_double_count(rt, monkeypatch):
    """Three iterations over two remote runners: the canonical count is
    the number of observations the runners normalised, not a multiple
    of it; every runner holds the canonical state after the broadcast,
    and ``evaluate()`` starts from a copy of it."""
    algo = _config().env_to_module([ObsNormalizer]).evaluation(
        evaluation_duration=2, evaluation_num_envs=2).build_algo(
            device="cpu")
    try:
        for it in range(1, 4):
            algo.train()
            want = 2 * (N + it * T * N)
            assert algo._connector_state[0]["count"] == want
        # the fire-and-forget broadcast reaches every runner before its
        # next call (an actor runs its calls in order)
        states = ray_tpu_torch.get(
            [r.get_connector_state.remote() for r in algo.runners])
        for state in states:
            assert state[0]["count"] == algo._connector_state[0]["count"]
            np.testing.assert_array_equal(
                state[0]["mean"], algo._connector_state[0]["mean"])
        handed, seen = [], []
        original = SingleAgentEnvRunner.set_connector_state

        def record(runner, state):
            # the evaluation runner's own updates move the arrays it
            # was handed: keep them as they arrived
            handed.append(copy.deepcopy(state))
            seen.append(state)
            original(runner, state)

        monkeypatch.setattr(SingleAgentEnvRunner, "set_connector_state",
                            record)
        canonical = copy.deepcopy(algo._connector_state)
        out = algo.evaluate()
        assert out["episodes_this_eval"] >= 2
        assert len(handed) == 1
        assert handed[0][0]["count"] == canonical[0]["count"]
        for key in ("mean", "m2"):
            np.testing.assert_array_equal(handed[0][0][key],
                                          canonical[0][key])
        # a copy: evaluation moved its own arrays, not the canonical ones
        assert seen[0][0]["m2"] is not algo._connector_state[0]["m2"]
        np.testing.assert_array_equal(algo._connector_state[0]["m2"],
                                      canonical[0]["m2"])
    finally:
        algo.stop()


def test_remote_runners_with_learner_actors(rt):
    """Two runners and two learner actors: the GAE values come from a
    driver copy of the learners' weights."""
    algo = _config().learners(num_learners=2).build_algo(device="cpu")
    try:
        assert algo.learner_group.local_learner is None
        r = algo.train()
        assert r["num_env_steps_sampled"] == 2 * N * T
        assert np.isfinite(r["total_loss"])
        # the driver copy held the weights the step started from
        assert algo._value_module is not None
        algo.train()
        w = algo.learner_group.get_weights()
        assert not np.array_equal(
            params_to_tree(algo._value_module)["pi"][0]["w"],
            w["pi"][0]["w"])  # the learners stepped since
    finally:
        algo.stop()


def _rps(config):
    from ray_tpu_torch.rl import RepeatedRockPaperScissors
    return (config.environment(RepeatedRockPaperScissors)
            .multi_agent(policy_mapping_fn=lambda aid: "shared"))


@pytest.mark.parametrize("configure", [
    lambda c: c.env_runners(num_env_runners=2),
    lambda c: c.learners(num_learners=2),
    lambda c: c.env_to_module([ObsNormalizer]),
], ids=["remote_runners", "several_learners", "connectors"])
def test_multi_agent_refuses_in_the_reference_words(configure):
    with pytest.raises(NotImplementedError,
                       match="single-agent-only for now"):
        configure(_rps(PPOConfig())).build_algo(device="cpu")
