"""The port's PPO against ray_tpu.rl's PPO, on the CPU.

The device rollout and two PPO iterations on the device path are held
against the reference's ``JaxEnvRunner`` and ``PPO`` from the same
weights (``params_from_jax``) and the same draws: the reference's JAX
draws are replayed into the port through its runner's ``noise`` (the
one place a rollout takes its draws from), and both shuffle minibatches
with numpy from the same seed. Each test states its tolerance.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import PPOConfig as JaxPPOConfig
from ray_tpu.rl.env import CartPoleJax
from ray_tpu.rl.env_runner import JaxEnvRunner
from ray_tpu.rl.rl_module import RLModuleSpec as JaxSpec
from ray_tpu_torch.rl import (
    ObsNormalizer, PPOConfig, RLModuleSpec, params_from_jax)
from ray_tpu_torch.rl.env import CartPoleTensor
from ray_tpu_torch.rl.env_runner import device_rollout
from ray_tpu_torch.rl.learner import Learner
from ray_tpu_torch.rl.sample_batch import (
    ACTIONS, DONES, FINAL_OBS, LOGP, OBS, REWARDS, TRUNCATEDS, VF_PREDS)

# f32 on both sides; XLA and PyTorch differ in rounding only
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as the other RL files take. These ops are
    tiny: at the default (one thread per core) every op waits for a team
    of threads, and beside busy processes (six xdist workers) the
    12-iteration learning run slowed from about 3 s to past the 150 s
    watchdog."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@jax.jit
def _step_draws(key, gumbel_like):
    """One step of the reference's rollout key chain (env_runner.py:196,
    anakin.py:89): the action's Gumbel noise and every env's reset
    state, as ``CartPoleJax.reset`` draws it."""
    key, k_act, k_env = jax.random.split(key, 3)
    resets = jax.vmap(lambda k: jax.random.uniform(
        k, (4,), minval=-0.05, maxval=0.05))(
            jax.random.split(k_env, gumbel_like.shape[0]))
    return key, jax.random.gumbel(k_act, gumbel_like.shape), resets


def jax_rollout_noise(key, steps, num_envs, n_actions=2):
    """The reference's draws of a rollout started from ``key``, in the
    port's noise layout ({"action": [T, N, A], "reset": [T, N, 4]})."""
    like = jnp.zeros((num_envs, n_actions))
    acts, resets = [], []
    for _ in range(steps):
        key, g, r = _step_draws(key, like)
        acts.append(np.asarray(g))
        resets.append(np.asarray(r))
    return {"action": torch.from_numpy(np.stack(acts)),
            "reset": torch.from_numpy(np.stack(resets))}


def _port_spec(hidden):
    return RLModuleSpec(CartPoleTensor.observation_space,
                        CartPoleTensor.action_space, hidden)


def test_device_rollout_matches_jax_env_runner():
    """T 16, N 8, two envs started near the 500-step cap so truncation
    is crossed too."""
    T, N = 16, 8
    env = CartPoleJax()
    spec = JaxSpec(env.observation_space, env.action_space, (32, 32))
    runner = JaxEnvRunner(env, spec, num_envs=N, rollout_len=T, seed=0)
    params = spec.init(jax.random.PRNGKey(1))
    t0 = np.array([0, 0, 0, 0, 0, 0, 490, 495], np.int32)
    env_state = {"s": runner._env_state["s"], "t": jnp.asarray(t0)}
    key = jax.random.PRNGKey(7)
    _, obs_ref, cols_ref = runner._rollout(params, env_state, runner._obs,
                                           key)

    port_env = CartPoleTensor()
    state, obs = port_env.reset(torch.from_numpy(np.array(runner._obs)))
    state["t"] = torch.from_numpy(t0)
    module = params_from_jax(_port_spec((32, 32)), params, "cpu")
    state, obs, cols = device_rollout(module, port_env, state, obs,
                                      jax_rollout_noise(key, T, N), T)
    for k in (ACTIONS, DONES, TRUNCATEDS):
        np.testing.assert_array_equal(cols[k].numpy(),
                                      np.asarray(cols_ref[k]), err_msg=k)
    for k in (OBS, LOGP, VF_PREDS, REWARDS, FINAL_OBS, "bootstrap_value"):
        assert cols[k].shape == np.shape(cols_ref[k]), k
        np.testing.assert_allclose(cols[k].numpy(), np.asarray(cols_ref[k]),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_ref), atol=ATOL)
    assert np.asarray(cols_ref[TRUNCATEDS]).sum() >= 1
    assert np.asarray(cols_ref[DONES]).sum() > \
        np.asarray(cols_ref[TRUNCATEDS]).sum()


def _configure(cfg):
    return (cfg.environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=8,
                         rollout_fragment_length=32)
            .training(num_epochs=2, minibatch_size=64, lr=1e-3)
            .debugging(seed=0))


def test_ppo_device_path_matches_jax_ppo():
    """Two PPO iterations on the device path (rollout, truncation
    bootstrap, GAE, host minibatches, clipped Adam) from the reference's
    weights, env states and draws end at the reference's params."""
    ref = _configure(JaxPPOConfig()).build_algo()
    port = _configure(PPOConfig()).build_algo(device="cpu")
    port.learner_group.local_learner.set_weights(
        ref.learner_group.get_weights())
    jr, tr = ref.jax_runner, port.tensor_runner
    tr.env_state, tr.obs = tr.env.reset(
        torch.from_numpy(np.array(jr._env_state["s"])))
    # the reference splits its runner key once per sample_device
    key, noises = jr._key, []
    for _ in range(2):
        key, sub = jax.random.split(key)
        noises.append(jax_rollout_noise(sub, 32, 8))
    replay = iter(noises)
    tr.noise = lambda steps: next(replay)
    for _ in range(2):
        r_ref, r_port = ref.train(), port.train()
        for k in ("policy_loss", "vf_loss", "entropy", "mean_kl",
                  "total_loss"):
            np.testing.assert_allclose(r_port[k], r_ref[k], rtol=1e-4,
                                       atol=ATOL, err_msg=k)
        for k in ("num_env_steps_sampled_lifetime", "episodes_total"):
            assert r_port[k] == r_ref[k], k
        assert r_port["episode_return_mean"] == pytest.approx(
            r_ref["episode_return_mean"], nan_ok=True)
    got, want = (port.learner_group.get_weights(),
                 ref.learner_group.get_weights())
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray,
                                                           want))):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_ppo_learns_cartpole_with_its_own_generator():
    """tests/test_rl.py's headline run on the port's own draws: clearly
    better than the random policy (~22) within 12 iterations."""
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=16,
                         rollout_fragment_length=128)
            .training(lr=3e-3, num_epochs=4, minibatch_size=512)
            .debugging(seed=0)
            .build_algo(device="cpu"))
    result = None
    for _ in range(12):
        result = algo.train()
    assert result["num_env_steps_sampled_lifetime"] == 12 * 16 * 128
    assert result["env_steps_per_sec"] > 0
    assert result["episode_return_mean"] > 60, result


def test_ppo_python_env_runner_local():
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=2,
                         rollout_fragment_length=32,
                         prefer_tensor_env=False)
            .training(num_epochs=2, minibatch_size=32)
            .build_algo(device="cpu"))
    assert algo.tensor_runner is None
    result = algo.train()
    assert result["num_env_steps_sampled"] == 64
    assert math.isfinite(result["policy_loss"])


def test_ppo_continuous_pendulum_on_the_python_runner():
    """Pendulum has no tensor env: the local Python runner samples it
    through a DiagGaussian policy."""
    algo = (PPOConfig()
            .environment("Pendulum-v1")
            .env_runners(num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .training(num_epochs=1, minibatch_size=16)
            .build_algo(device="cpu"))
    assert algo.tensor_runner is None and algo.spec.is_continuous
    for i in range(2):
        result = algo.train()
        assert result["num_env_steps_sampled_lifetime"] == 32 * (i + 1)
        for k in ("policy_loss", "vf_loss", "entropy", "total_loss"):
            assert math.isfinite(result[k]), (k, result)


def test_ppo_evaluate_matches_reference():
    """Greedy evaluation on the Python runner from the same weights
    (numpy CartPole, the same env seeds) gives the reference's episodes."""
    def configure(cfg):
        return (cfg.environment("CartPole-v1")
                .evaluation(evaluation_duration=4, evaluation_num_envs=2)
                .debugging(seed=3))
    ref = configure(JaxPPOConfig()).build_algo()
    port = configure(PPOConfig()).build_algo(device="cpu")
    port.learner_group.local_learner.set_weights(
        ref.learner_group.get_weights())
    got, want = port.evaluate(), ref.evaluate()
    assert got == want


def test_ppo_checkpoint_round_trip(tmp_path):
    def build():
        return (PPOConfig()
                .environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=2,
                             rollout_fragment_length=16)
                .training(num_epochs=1, minibatch_size=16)
                .build_algo(device="cpu"))

    algo = build()
    algo.train()
    state = algo.learner_group.get_state()
    path = algo.save_to_path(str(tmp_path / "ckpt"))

    algo2 = build()
    algo2.restore_from_path(path)
    assert algo2.iteration == 1
    assert algo2._env_steps_lifetime == algo._env_steps_lifetime
    assert algo2._episode_returns == algo._episode_returns
    w_before, w_after = (algo.learner_group.get_weights(),
                         algo2.learner_group.get_weights())
    np.testing.assert_array_equal(w_before["pi"][0]["w"],
                                  w_after["pi"][0]["w"])
    opt2 = algo2.learner_group.get_state()["opt_state"]
    for i, moments in state["opt_state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(opt2["state"][i][k], moments[k],
                                       rtol=0, atol=0)
    assert math.isfinite(algo2.train()["policy_loss"])


@pytest.mark.parametrize("configure,match", [
    (lambda c: c.env_runners(num_env_runners=2), "Queue 1 item 9"),
    (lambda c: c.learners(num_learners=2), "Queue 1 item 4"),
    # connectors run on the local runner; their state sync between
    # remote runners waits for the runtime
    (lambda c: c.env_to_module([ObsNormalizer]).env_runners(
        num_env_runners=1), "connector-state sync"),
    # multi-agent PPO runs; with a connector it still refuses (item 9)
    (lambda c: c.multi_agent(policy_mapping_fn=lambda aid: "p0")
     .env_to_module([ObsNormalizer]), "multi-agent"),
], ids=["remote_runners", "several_learners", "connectors", "multi_agent"])
def test_unported_paths_refuse(configure, match):
    with pytest.raises(NotImplementedError, match=match):
        configure(PPOConfig().environment("CartPole-v1")).build_algo(
            device="cpu")


def test_learner_mesh_refuses():
    """Learner(mesh=) runs data-parallel now
    (tests/test_torch_sharded_rl.py); what is neither a mesh nor a
    process group still refuses."""
    with pytest.raises(ValueError, match="DeviceMesh or a process group"):
        Learner(_port_spec((8,)), mesh=object(), device="cpu")


def test_build_algo_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    config = PPOConfig().environment("CartPole-v1")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        config.build_algo()
    assert config.build_algo(device="cpu").device == torch.device("cpu")
