"""Sebulba on the port's runtime and Serve, on the CPU.

The scenarios of tests/test_podracer.py:67-92 and :235-294: a weight
push that reaches a saturated replica, and the end-to-end loop
(mid-flight weight refresh, staleness, learning, the five ``rl`` spans
in the port's flight journal); the failure and backpressure scenarios
are in ``test_torch_podracer_replay.py``. Beside them, the replica's
forward against the reference's ``spec.forward`` and the learner's
``_postprocess`` against the reference's, from the same parameters
(carried over through the ``rl_module`` converters), within 1e-5.
The env the actors run lives in the JAX-free
``tests/test_torch_rl_remote_card.py``; no test starts the reference's
runtime (its ``_SebulbaLearnerImpl`` is built with ``object.__new__``).
"""

import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rl.algorithms.ppo import PPOLearner as JaxPPOLearner
from ray_tpu.rl.podracer.sebulba import SebulbaConfig as JaxSebulbaConfig
from ray_tpu.rl.podracer.sebulba import \
    _SebulbaLearnerImpl as JaxLearnerImpl
from ray_tpu.rl.rl_module import RLModuleSpec as JaxSpec
from ray_tpu.rl.spaces import Box as JaxBox
from ray_tpu.rl.spaces import Discrete as JaxDiscrete
from ray_tpu_torch import serve
from ray_tpu_torch.core import serialization
from ray_tpu_torch.rl.algorithms.ppo import PPOLearner
from ray_tpu_torch.rl.podracer import (
    PolicyInference, Sebulba, SebulbaConfig)
from ray_tpu_torch.rl.podracer.sebulba import _SebulbaLearnerImpl
from ray_tpu_torch.rl.rl_module import RLModuleSpec, load_params
from ray_tpu_torch.serve.replica import Rejected, Replica
from ray_tpu_torch.util import flight_recorder as tfr
from test_torch_rl_remote_card import BanditEnv

# f32 on both sides; XLA and PyTorch round differently
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def podracer_cluster():
    """A fresh port runtime with the flight recorder on (fast journal
    flush, so the span assertions see worker spans promptly)."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, system_config={
        "flight_recorder_enabled": True,
        "flight_flush_interval_s": 0.05,
        "task_max_retries": 0,
    })
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _jax_spec(hidden=(16,)):
    return JaxSpec(JaxBox(-np.ones(3, np.float32), np.ones(3, np.float32)),
                   JaxDiscrete(2), hidden)


def _port_spec(hidden=(16,)):
    return RLModuleSpec(BanditEnv.observation_space, BanditEnv.action_space,
                        hidden)


def _jax_params(seed=0, hidden=(16,)):
    return jax.tree.map(np.asarray,
                        _jax_spec(hidden).init(jax.random.PRNGKey(seed)))


# --- in-process units ----------------------------------------------------

def test_weight_push_reaches_saturated_replica():
    """A replica pegged at max_ongoing_requests sheds data-plane
    requests with the Rejected sentinel, which only the router retries;
    the control-plane entry point applies a weight push anyway."""

    class _Policy:
        def __init__(self):
            self.version = -1

        def set_weights(self, version, payload):
            self.version = int(version)
            return int(version)

    rep = Replica("d", "d#0", serialization.dumps(_Policy),
                  serialization.dumps(((), {})), max_ongoing_requests=0)
    blob = serialization.dumps(((7, None), {}))
    assert isinstance(rep.handle_request("set_weights", blob), Rejected)
    assert rep.callable.version == -1
    assert rep.handle_control_request("set_weights", blob) == 7
    assert rep.callable.version == 7


def test_policy_inference_matches_the_reference_forward():
    """The replica's batched forward on carried-over parameters: its
    log-probs of the actions it drew and its values equal the
    reference's ``spec.forward`` within 1e-5; requests of 3 and 5 rows
    come back split in order; a weight push swaps in the int8-decoded
    tree under the new version."""
    from ray_tpu_torch.rl.podracer.inference import quantize_params
    params = _jax_params(seed=1)
    server = PolicyInference.func_or_class(
        serialization.dumps(_port_spec()), seed=0, device="cpu")
    module, version = server._weights
    load_params(module, params)
    rng = np.random.default_rng(0)
    blocks = [rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
              for n in (3, 5)]
    replies = server.infer.__wrapped__(server, blocks)
    dist, values = _jax_spec().forward(params, np.concatenate(blocks))
    actions = np.concatenate([r["actions"] for r in replies])
    logp = np.asarray(dist.log_prob(actions))
    np.testing.assert_allclose(
        np.concatenate([r["logp"] for r in replies]), logp, rtol=0,
        atol=ATOL)
    np.testing.assert_allclose(
        np.concatenate([r["values"] for r in replies]), np.asarray(values),
        rtol=0, atol=ATOL)
    assert [len(r["actions"]) for r in replies] == [3, 5]
    assert all(r["version"] == 0 and r["batch_rows"] == 8 for r in replies)
    # the draw comes from the replica's generator, seeded seed + 1
    again = PolicyInference.func_or_class(
        serialization.dumps(_port_spec()), seed=0, device="cpu")
    load_params(again._weights[0], params)
    np.testing.assert_array_equal(
        np.concatenate([r["actions"] for r in
                        again.infer.__wrapped__(again, blocks)]), actions)
    # a push: the int8 payload of a new tree, decoded under version 3
    new = _jax_params(seed=2)
    assert server.set_weights(3, quantize_params(new)) == 3
    assert server.get_version() == 3 and server._weights[0] is not module
    _, v_new = _jax_spec().forward(new, np.concatenate(blocks))
    got = server.infer.__wrapped__(server, blocks)
    np.testing.assert_allclose(
        np.concatenate([r["values"] for r in got]), np.asarray(v_new),
        rtol=0, atol=0.05)  # int8 blocks: per-block rounding
    assert got[0]["version"] == 3


def _fragment(T=8, N=2, seed=0):
    rng = np.random.default_rng(seed)
    dones = rng.random((T, N)) < 0.2
    return {
        "obs": rng.uniform(-1, 1, (T, N, 3)).astype(np.float32),
        "actions": rng.integers(2, size=(T, N)).astype(np.int64),
        "action_logp": rng.normal(size=(T, N)).astype(np.float32),
        "vf_preds": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": dones,
        "truncateds": dones & (rng.random((T, N)) < 0.5),
        "final_obs": rng.uniform(-1, 1, (T, N, 3)).astype(np.float32),
        "bootstrap_value": rng.normal(size=N).astype(np.float32),
        "version": 0,
    }


def test_learner_postprocess_matches_the_reference():
    """GAE over one fragment, truncation bootstrap included, against the
    reference learner's ``_postprocess`` (built with ``object.__new__``,
    so no JAX runtime starts), from the same parameters."""
    params = _jax_params(seed=3)
    ref = object.__new__(JaxLearnerImpl)
    ref.cfg = JaxSebulbaConfig(hidden=(16,), gamma=0.97, lambda_=0.9)
    ref.learner = JaxPPOLearner(_jax_spec(), seed=0)
    ref.learner.params = jax.tree.map(jax.numpy.asarray, params)
    port = object.__new__(_SebulbaLearnerImpl)
    port.cfg = SebulbaConfig(hidden=(16,), gamma=0.97, lambda_=0.9)
    port.learner = PPOLearner(_port_spec(), device="cpu")
    load_params(port.learner.module, params)
    fragment = _fragment()
    want = ref._postprocess(fragment)
    got = port._postprocess(fragment)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == np.asarray(want[key]).shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                   atol=ATOL, err_msg=key)


# --- end to end on the port's runtime ------------------------------------

def _merged_rl_spans(deadline_s=10.0, want=()):
    """Poll the port's merged journals until every wanted rl span name
    appears (worker journals flush on an interval)."""
    deadline = time.time() + deadline_s
    names = set()
    while time.time() < deadline:
        merged = tfr.merged_journals()
        names = {ev[4] for events in merged.values()
                 for ev in events if ev[3] == "rl"}
        if set(want) <= names:
            break
        time.sleep(0.1)
    return names


def test_sebulba_e2e_weight_refresh_and_learning(podracer_cluster):
    cfg = SebulbaConfig(
        env_creator=BanditEnv, num_actors=2, num_envs_per_actor=2,
        rollout_len=8, hidden=(16,), lr=3e-2, entropy_coeff=0.0,
        fragments_per_step=2, weight_push_interval=1,
        max_staleness=50, seed=0)
    s = Sebulba(cfg, device="cpu")
    try:
        out = s.train(12, step_timeout_s=60.0)
        want = {"rollout", "infer_batch", "replay_wait", "learn_step",
                "weight_push"}
        names = _merged_rl_spans(want=want)
    finally:
        s.shutdown()

    learner = out["learner"]
    assert learner["num_updates"] == 12
    # >= 2 mid-flight version-tagged refreshes, every one confirmed by
    # every replica (control-plane path, never shed)
    assert learner["weight_pushes"] >= 2
    assert learner["push_failures"] == 0
    all_versions = set()
    for actor_id, versions in out["versions_by_actor"].items():
        assert versions == sorted(versions), (
            f"actor {actor_id} saw versions go backwards: {versions}")
        all_versions.update(versions)
    assert len(all_versions) >= 3, sorted(all_versions)
    assert out["fragments"] >= 2 * cfg.num_actors
    assert out["env_steps_sampled"] >= out["fragments"] * 16
    assert learner["version_lag_max"] <= cfg.max_staleness
    assert out["replay"]["depth"] <= cfg.replay_capacity
    returns = out["episode_returns"]
    assert len(returns) >= 8
    third = max(len(returns) // 3, 1)
    assert np.mean(returns[-third:]) > np.mean(returns[:third]), returns
    assert want <= names, f"missing rl spans: {want - names}"
