"""The port's learner actors against the reference's learner-group
semantics, on the CPU.

A ``LearnerGroup(num_learners=2)`` runs two ``PPOLearner`` actors on the
port's runtime, joined in a gloo group. Each update splits the batch
with the reference's wraparound, each rank takes the gradients of its
own shard's loss (its advantage normalisation is the shard's, as in
the reference), the ranks average one flat vector through the host,
then clip and take Adam's step. The reference computes the same in
this process: its ``PPOLearner._grads_fn`` on each shard, the mean,
then ``_apply_fn``, from the same weights (carried into the actors
through ``set_state``). Tolerances are stated with each test.
"""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rl.algorithms.ppo import PPOLearner as JaxPPOLearner
from ray_tpu.rl.rl_module import RLModuleSpec as JaxSpec
from ray_tpu.rl.spaces import Box as JaxBox
from ray_tpu.rl.spaces import Discrete as JaxDiscrete
from ray_tpu_torch.rl import RLModuleSpec
from ray_tpu_torch.rl.algorithms.ppo import PPOLearner
from ray_tpu_torch.rl.learner import LearnerGroup
from ray_tpu_torch.rl.spaces import Box, Discrete

# f32 on both sides, three Adam steps; XLA and PyTorch round differently
ATOL = 1e-5
HIDDEN = (8,)
KW = dict(lr=1e-2, grad_clip=0.5, seed=0, clip_param=0.2,
          vf_clip_param=10.0, vf_loss_coeff=0.5, entropy_coeff=0.01)


@pytest.fixture(scope="module")
def rt():
    """One runtime; learner processes on one torch thread."""
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


@pytest.fixture(scope="module")
def group(rt):
    g = LearnerGroup(PPOLearner, num_learners=2, module_spec=_spec(),
                     device="cpu", **KW)
    yield g
    g.shutdown()


def _spaces(box, discrete):
    return (box(-np.full(4, 2.0, np.float32), np.full(4, 2.0, np.float32)),
            discrete(2))


def _spec():
    return RLModuleSpec(*_spaces(Box, Discrete), HIDDEN)


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(2, size=n).astype(np.int32),
        "action_logp": np.full(n, -0.69, dtype=np.float32),
        "vf_preds": rng.normal(size=n).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }


def _reference(seed=0):
    spec = JaxSpec(*_spaces(JaxBox, JaxDiscrete), HIDDEN)
    return JaxPPOLearner(spec, **{**KW, "seed": seed})


def _carry_in(group, ref):
    """The reference's weights and a fresh Adam state into every rank."""
    local = PPOLearner(_spec(), device="cpu", **KW)
    local.set_weights(jax.tree.map(np.asarray, ref.params))
    group.set_state(local.get_state())


def _reference_step(ref, batch, n):
    """The reference's DDP step: grads of each wraparound shard, their
    mean, then the clip and Adam (learner.py:126-146, :254-265)."""
    size = len(batch["obs"])
    idx = np.arange(max(size, n)) % size
    grads = [ref._grads_fn(ref.params, {k: v[c] for k, v in batch.items()})[0]
             for c in np.array_split(idx, n)]
    mean = jax.tree.map(lambda *g: sum(g) / n, *grads)
    ref.params, ref.opt_state = ref._apply_fn(ref.params, ref.opt_state,
                                              mean)


def _assert_weights(got, ref):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray,
                                                           ref.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def _rank_weights(group):
    return ray_tpu_torch.get([a.get_weights.remote() for a in group._actors])


@pytest.mark.parametrize("rows", [64, 63], ids=["even", "odd"])
def test_three_updates_match_the_reference_ddp(group, rows):
    """Three updates at world 2 (63 rows: shards of 32 and 31) within
    1e-5 of the reference's shard-grads-mean-Adam, every rank equal."""
    ref = _reference()
    _carry_in(group, ref)
    for step in range(3):
        batch = _batch(rows, seed=step)
        metrics = group.update(batch)
        _reference_step(ref, batch, 2)
        assert np.isfinite(metrics["total_loss"])
        assert set(metrics) >= {"policy_loss", "vf_loss", "entropy",
                                "mean_kl", "total_loss"}
    w0, w1 = _rank_weights(group)
    for a, b in zip(jax.tree_util.tree_leaves(w0),
                    jax.tree_util.tree_leaves(w1)):
        np.testing.assert_array_equal(a, b)  # one exchange, same bits
    _assert_weights(w0, ref)


def test_batch_smaller_than_the_group_wraps_around(group):
    """One row over two ranks: both train on it (the reference's
    wraparound), so the step equals two copies of that row's grads."""
    ref = _reference(seed=3)
    _carry_in(group, ref)
    batch = _batch(1, seed=7)
    group.update(batch)
    _reference_step(ref, batch, 2)
    _assert_weights(group.get_weights(), ref)


def test_metrics_are_the_mean_of_the_ranks(group):
    ref = _reference()
    _carry_in(group, ref)
    batch = _batch(16, seed=11)
    metrics = group.update(batch)
    want = [ref._grads_fn(ref.params, {k: v[c] for k, v in batch.items()})[1]
            for c in np.array_split(np.arange(16), 2)]
    for key in ("policy_loss", "vf_loss", "entropy", "total_loss"):
        np.testing.assert_allclose(
            metrics[key], np.mean([float(m[key]) for m in want]),
            rtol=0, atol=ATOL, err_msg=key)


def test_state_round_trip_and_shutdown(rt):
    g = LearnerGroup(PPOLearner, num_learners=2, module_spec=_spec(),
                     device="cpu", **KW)
    actors = list(g._actors)
    try:
        g.update(_batch(32, seed=0))
        state = g.get_state()
        assert state["opt_state"]["state"]  # Adam moments came back
        assert all(t.device.type == "cpu"
                   for t in state["params"].values())
        w = g.get_weights()
        g.update(_batch(32, seed=1))
        g.set_state(state)  # every rank back to the saved step
        for got in _rank_weights(g):
            for a, b in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(w)):
                np.testing.assert_array_equal(a, b)
        assert g.local_learner is None
    finally:
        g.shutdown()
    assert g._actors is None
    with pytest.raises(Exception):
        ray_tpu_torch.get(actors[0].ping.remote(), timeout=30)
