"""The port's multi-agent RL against ray_tpu.rl's, on the CPU.

The envs are numpy on both sides, so the same actions give the same
steps exactly. The runners and multi-agent PPO are held against the
reference's from the same weights (the reference's trees loaded per
module through ``set_weights``), with the reference's JAX action draws
replayed into the port's runner ``noise`` (``JaxMultiAgentDraws``: the
runner's key split once per module per policy query, in the reference's
order, and ``jax.random.gumbel`` of the acting batch). Integer columns,
episodes and env steps are exact; float columns within 1e-6, losses and
params within 1e-5. The learning bars run on the port alone
(tests/test_torch_rl_multi_agent_learns.py).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl import PPOConfig as JaxPPOConfig
from ray_tpu.rl import multi_agent as jma
from ray_tpu_torch.rl import (
    DQNConfig, ObsNormalizer, PPOConfig, RepeatedRockPaperScissors,
    TicTacToe)
from ray_tpu_torch.rl import multi_agent as tma
from ray_tpu_torch.rl.spaces import Box, Discrete

# f32 MLP outputs (logp, values); XLA and PyTorch differ in rounding only
COL_ATOL = 1e-6
# losses and params after PPO's updates
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: faster for these small ops than two, and
    it keeps each xdist worker to one core."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.partial(jax.jit, static_argnums=1)
def _query_draw(key, shape):
    key, sub = jax.random.split(key)
    return key, jax.random.gumbel(sub, shape)


class JaxMultiAgentDraws:
    """A reference runner's key chain (multi_agent.py:306, :451): one
    split per module per policy query; the acting batch's Gumbel noise
    from the sub key (``jax.random.categorical``)."""

    def __init__(self, key, specs):
        self.key, self.specs = key, specs

    def __call__(self, module_id, n):
        self.key, noise = _query_draw(
            self.key, (n, self.specs[module_id].act_dim))
        return torch.from_numpy(np.array(noise))


def _port_runner(cls, ref, **kw):
    """The port's runner beside ``ref`` (same env, mapping, seed), with
    ``ref``'s weights and draws."""
    env_cls = getattr(tma, type(ref.envs[0]).__name__)
    hidden = next(iter(ref.specs.values())).hidden
    port = cls(env_cls, tma.infer_module_specs(
        env_cls(), ref.mapping.__getitem__, hidden=hidden),
        ref.mapping.__getitem__, device="cpu", **kw)
    port.set_weights(ref.params)
    port.noise = JaxMultiAgentDraws(ref._key, port.specs)
    return port


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for mid in want:
        assert got[mid].keys() == want[mid].keys()
        for k in ("actions", "dones", "truncateds", "rewards", "obs",
                  "final_obs"):
            np.testing.assert_array_equal(got[mid][k], want[mid][k],
                                          err_msg=f"{mid} {k}")
        for k in ("action_logp", "vf_preds", "bootstrap_value"):
            np.testing.assert_allclose(got[mid][k], want[mid][k], rtol=0,
                                       atol=COL_ATOL, err_msg=f"{mid} {k}")


# -- the envs -------------------------------------------------------------

@pytest.mark.parametrize("name", ["RepeatedRockPaperScissors", "TicTacToe"])
def test_env_steps_match_reference(name):
    """300 steps under the same random actions (illegal moves included),
    with resets: every obs, reward and termination dict equal."""
    ref, port = getattr(jma, name)(), getattr(tma, name)()
    assert port.agents == ref.agents
    assert getattr(port, "turn_based", False) == getattr(ref, "turn_based",
                                                         False)
    for a in ref.agents:
        assert (port.action_spaces[a].n == ref.action_spaces[a].n)
        assert port.observation_spaces[a].shape == \
            ref.observation_spaces[a].shape
    rng = np.random.default_rng(0)

    def same(got, want):
        assert type(got) is type(want)
        if isinstance(want, dict):
            assert list(got) == list(want)
            for k in want:
                same(got[k], want[k])
        elif isinstance(want, tuple):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                same(a, b)
        else:
            np.testing.assert_array_equal(got, want)

    same(port.reset(seed=3), ref.reset(seed=3))
    obs = ref._obs() if name.startswith("Repeated") else None
    ends = 0
    for _ in range(300):
        agents = ref.agents if obs is not None else [
            ref.agents[ref.to_move]]
        actions = {a: int(rng.integers(ref.action_spaces[a].n))
                   for a in agents}
        want, got = ref.step(actions), port.step(actions)
        same(got, want)
        if want[2]["__all__"] or want[3]["__all__"]:
            ends += 1
            same(port.reset(), ref.reset())
    assert ends > 10


def test_infer_module_specs_matches_reference():
    env, jenv = RepeatedRockPaperScissors(), jma.RepeatedRockPaperScissors()
    mapping = {"player_0": "a", "player_1": "b"}.__getitem__
    got = tma.infer_module_specs(env, mapping, hidden=(8,))
    want = jma.infer_module_specs(jenv, mapping, hidden=(8,))
    assert list(got) == list(want) == ["a", "b"]
    for mid in want:
        assert got[mid].obs_dim == want[mid].obs_dim == 6
        assert got[mid].act_dim == want[mid].act_dim == 3
        assert got[mid].hidden == (8,)
    # explicit (obs_space, action_space) pairs win over the env's
    own = (Box(-2.0, 2.0, (6,)), Discrete(3))
    specs = tma.infer_module_specs(env, mapping, {"a": own, "b": None})
    assert specs["a"].obs_space is own[0]
    assert specs["b"].obs_space is env.observation_spaces["player_1"]
    # a configured policy no agent maps to
    with pytest.raises(ValueError, match="no agent mapped"):
        tma.infer_module_specs(env, lambda aid: "shared",
                               {"shared": None, "ghost": None})


def test_runner_refuses_unknown_modules():
    env = RepeatedRockPaperScissors()
    specs = tma.infer_module_specs(env, lambda aid: "a")
    with pytest.raises(ValueError, match="unknown module"):
        tma.MultiAgentEnvRunner(RepeatedRockPaperScissors, specs,
                                lambda aid: "b", device="cpu")


# -- tests/test_rl.py:584-626 and :895-930 on the port --------------------

def test_multi_agent_env_runner_shapes_and_zero_sum():
    env = RepeatedRockPaperScissors()
    mapping = {"player_0": "pol_a", "player_1": "pol_b"}
    specs = tma.infer_module_specs(env, mapping.__getitem__)
    runner = tma.MultiAgentEnvRunner(
        RepeatedRockPaperScissors, specs, mapping.__getitem__,
        num_envs=3, rollout_len=20, seed=0, device="cpu")
    out = runner.sample()
    assert set(out) == {"pol_a", "pol_b"}
    for batch in out.values():
        assert batch["obs"].shape == (20, 3, 6)
        assert batch["actions"].shape == (20, 3)
        assert batch["bootstrap_value"].shape == (3,)
    np.testing.assert_allclose(
        out["pol_a"]["rewards"] + out["pol_b"]["rewards"], 0.0)
    metrics = runner.pop_metrics()
    assert len(metrics["episode_returns"]) == 6
    assert set(metrics["module_returns"]) == {"pol_a", "pol_b"}


def test_multi_agent_shared_policy_self_play():
    env = RepeatedRockPaperScissors()
    specs = tma.infer_module_specs(env, lambda aid: "shared")
    runner = tma.MultiAgentEnvRunner(
        RepeatedRockPaperScissors, specs, lambda aid: "shared",
        num_envs=2, rollout_len=10, seed=0, device="cpu")
    out = runner.sample()
    assert set(out) == {"shared"}
    assert out["shared"]["obs"].shape == (10, 4, 6)  # 2 envs x 2 agents


def test_turn_based_runner_shapes_and_credit():
    env = TicTacToe()
    assert env.turn_based
    obs, _ = env.reset(seed=0)
    assert set(obs) == {"player_x"}
    mapping = {"player_x": "px", "player_o": "po"}
    specs = tma.infer_module_specs(env, mapping.__getitem__)
    runner = tma.TurnBasedEnvRunner(
        TicTacToe, specs, mapping.__getitem__, num_envs=3, rollout_len=6,
        seed=0, device="cpu")
    out = runner.sample()
    assert set(out) == {"px", "po"}
    for batch in out.values():
        assert batch["obs"].shape == (6, 3, 18)
        assert batch["actions"].shape == (6, 3)
        assert batch["rewards"].shape == (6, 3)
        assert batch["bootstrap_value"].shape == (3,)
    metrics = runner.pop_metrics()
    assert metrics["episode_returns"]
    np.testing.assert_allclose(metrics["episode_returns"], 0.0)
    assert out["px"]["dones"].any()
    out2 = runner.sample()
    assert out2["px"]["obs"].shape == (6, 3, 18)


# -- the runners against the reference's ----------------------------------

@pytest.mark.parametrize("mapping", [
    {"player_0": "pol_a", "player_1": "pol_b"},
    {"player_0": "shared", "player_1": "shared"}], ids=["split", "shared"])
def test_parallel_runner_matches_reference(mapping):
    """Two fragments of 15 steps (10-step episodes end inside them)."""
    ref = jma.MultiAgentEnvRunner(
        jma.RepeatedRockPaperScissors,
        jma.infer_module_specs(jma.RepeatedRockPaperScissors(),
                               mapping.__getitem__, hidden=(16,)),
        mapping.__getitem__, num_envs=3, rollout_len=15, seed=2)
    port = _port_runner(tma.MultiAgentEnvRunner, ref, num_envs=3,
                        rollout_len=15, seed=2)
    for _ in range(2):
        _assert_batches_equal(port.sample(), ref.sample())
        assert port.pop_metrics() == ref.pop_metrics()


def test_turn_based_runner_matches_reference():
    """Two samples of 6 closed transitions per stream over 3 tic-tac-toe
    envs: the deferred credit, the closes at episode end and the
    carried-over surplus all equal."""
    mapping = {"player_x": "px", "player_o": "po"}.__getitem__
    ref = jma.TurnBasedEnvRunner(
        jma.TicTacToe, jma.infer_module_specs(jma.TicTacToe(), mapping),
        mapping, num_envs=3, rollout_len=6, seed=1)
    port = _port_runner(tma.TurnBasedEnvRunner, ref, num_envs=3,
                        rollout_len=6, seed=1)
    for _ in range(2):
        _assert_batches_equal(port.sample(), ref.sample())
        assert port.env_steps_last_sample == ref.env_steps_last_sample
        assert port.pop_metrics() == ref.pop_metrics()
        for key in ref._closed:
            assert len(port._closed[key]) == len(ref._closed[key]), key
            assert (port._open[key] is None) == (ref._open[key] is None)


class _OnlyA(tma.MultiAgentEnv):
    """A turn-based env in which agent "b" never gets a turn."""

    agents = ["a", "b"]

    def __init__(self):
        self.observation_spaces = {x: Box(-1.0, 1.0, (2,))
                                   for x in self.agents}
        self.action_spaces = {x: Discrete(2) for x in self.agents}

    def reset(self, *, seed=None):
        return {"a": np.zeros(2, np.float32)}, {}

    def step(self, action_dict):
        return ({"a": np.zeros(2, np.float32)}, {"a": 0.0},
                {"__all__": False}, {"__all__": False}, {})


def test_turn_based_runner_stall_guard():
    """An agent that never acts trips the guard instead of looping."""
    specs = tma.infer_module_specs(_OnlyA(), lambda aid: "shared",
                                   hidden=(4,))
    runner = tma.TurnBasedEnvRunner(_OnlyA, specs, lambda aid: "shared",
                                    rollout_len=1, device="cpu")
    with pytest.raises(RuntimeError, match="stalled"):
        runner.sample()


# -- multi-agent PPO ------------------------------------------------------

def _rps(cfg):
    return (cfg.environment(_env(cfg, "RepeatedRockPaperScissors"))
            .multi_agent(
                policy_mapping_fn=lambda aid: ("learner" if aid == "player_0"
                                               else "opponent"),
                policies_to_train=["learner"])
            .env_runners(num_envs_per_env_runner=4,
                         rollout_fragment_length=20)
            .training(lr=0.02, num_epochs=2, minibatch_size=32,
                      entropy_coeff=0.0)
            .rl_module(hidden=(16, 16))
            .evaluation(evaluation_duration=4, evaluation_num_envs=2)
            .debugging(seed=0))


def _ttt(cfg):
    return (cfg.environment(_env(cfg, "TicTacToe"))
            .multi_agent(policy_mapping_fn=lambda aid: "shared")
            .env_runners(num_envs_per_env_runner=4,
                         rollout_fragment_length=8)
            .training(lr=0.01, num_epochs=2, minibatch_size=32)
            .rl_module(hidden=(16, 16))
            .debugging(seed=0))


def _env(cfg, name):
    return getattr(jma if isinstance(cfg, JaxPPOConfig) else tma, name)


def _ppo_pair(configure):
    ref = configure(JaxPPOConfig()).build_algo()
    port = configure(PPOConfig()).build_algo(device="cpu")
    assert type(port.ma_runner).__name__ == type(ref.ma_runner).__name__
    assert list(port.ma_specs) == list(ref.ma_specs)
    for mid, lrn in ref.ma_learners.items():
        port.ma_learners[mid].set_weights(lrn.get_weights())
    port.ma_runner.noise = JaxMultiAgentDraws(ref.ma_runner._key,
                                              port.ma_specs)
    return ref, port


def _assert_weights_close(got, want, atol):
    got, want = (jax.tree_util.tree_leaves(jax.tree.map(np.asarray, t))
                 for t in (got, want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("configure", [_rps, _ttt],
                         ids=["rps_frozen_opponent", "tictactoe_self_play"])
def test_ppo_iterations_match_reference(configure):
    """Two iterations: equal episodes and env steps, per-module metrics
    within 1e-5 (+ 1e-4 relative), params within 1e-5; a frozen module
    keeps its weights exactly and reports no training metrics."""
    ref, port = _ppo_pair(configure)
    frozen = {mid: lrn.get_weights() for mid, lrn in port.ma_learners.items()
              if mid not in port._to_train}
    for _ in range(2):
        want, got = ref.train(), port.train()
        assert got.keys() == want.keys()
        for k in ("num_env_steps_sampled", "episodes_total",
                  "episode_return_mean", "episode_len_mean"):
            assert got[k] == want[k], k
        for k in want:
            if "/" in k:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=ATOL, err_msg=k)
    for mid in frozen:
        assert not any(k.startswith(f"{mid}/") for k in got)
        _assert_weights_close(port.ma_learners[mid].get_weights(),
                              frozen[mid], 0.0)
    for mid, lrn in ref.ma_learners.items():
        _assert_weights_close(port.ma_learners[mid].get_weights(),
                              lrn.get_weights(), ATOL)


def test_ppo_evaluate_matches_reference():
    """The evaluation runner: exploration off (the mode, no draws), seed
    + 10_000, per-module means, after one iteration."""
    ref, port = _ppo_pair(_rps)
    ref.train()
    port.train()
    assert port.evaluate() == ref.evaluate()
    assert port._eval_runner.explore is False


def test_ppo_state_roundtrip(tmp_path):
    algo = _rps(PPOConfig()).build_algo(device="cpu")
    algo.train()
    path = algo.save_to_path(str(tmp_path / "ma"))
    again = _rps(PPOConfig()).build_algo(device="cpu")
    again.restore_from_path(path)
    assert again.iteration == 1
    assert again._env_steps_lifetime == algo._env_steps_lifetime == 80
    for mid, lrn in algo.ma_learners.items():
        _assert_weights_close(again.ma_learners[mid].get_weights(),
                              lrn.get_weights(), 0.0)
        opt = again.ma_learners[mid].get_state()["opt_state"]["state"]
        for i, moments in lrn.get_state()["opt_state"]["state"].items():
            torch.testing.assert_close(opt[i]["exp_avg"],
                                       moments["exp_avg"], rtol=0, atol=0)
    assert np.isfinite(again.train()["learner/total_loss"])


# -- the refusals ---------------------------------------------------------

# the reference's own refusal (ray_tpu/rl/algorithms/ppo.py:198-204)
@pytest.mark.parametrize("configure,match", [
    (lambda c: c.env_runners(num_env_runners=1),
     "num_env_runners, num_learners and env_to_module connectors are "
     "single-agent-only"),
    (lambda c: c.learners(num_learners=2), "single-agent-only for now"),
    (lambda c: c.env_to_module([ObsNormalizer]),
     "multi-agent PPO currently runs one local env runner"),
], ids=["remote_runners", "several_learners", "connectors"])
def test_multi_agent_unported_paths_refuse(configure, match):
    with pytest.raises(NotImplementedError, match=match):
        configure(_rps(PPOConfig())).build_algo(device="cpu")


def test_multi_agent_config_errors():
    with pytest.raises(ValueError, match="unknown ids"):
        _rps(PPOConfig()).multi_agent(policies_to_train=["ghost"]).build_algo(
            device="cpu")
    with pytest.raises(ValueError, match="does not support multi_agent"):
        (DQNConfig().environment("CartPole-v1")
         .multi_agent(policy_mapping_fn=lambda aid: "p").build_algo(
             device="cpu"))
    with pytest.raises(ValueError, match="MultiAgentEnv"):
        (PPOConfig().environment("CartPole-v1")
         .multi_agent(policy_mapping_fn=lambda aid: "p").build_algo(
             device="cpu"))
    config = PPOConfig().multi_agent(policies={"a", "b"})
    assert config.policies == {"a": None, "b": None}
    assert not config.is_multi_agent
