"""The port's V-trace and IMPALA learner against ray_tpu.rl's, on the CPU.

``vtrace_returns`` is held against a numpy transcription of the paper's
recursion (tests/test_rl.py:991) and against the reference's, the
learner's loss and gradients against ``jax.value_and_grad`` of the
reference's loss, and three clipped Adam updates against the reference
learner's, all on the same time-major batch made from a numpy seed,
from the reference's weights. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl.algorithms.impala import IMPALALearner as JaxIMPALALearner
from ray_tpu.rl.algorithms.impala import vtrace_returns as jax_vtrace
from ray_tpu.rl.rl_module import RLModuleSpec as JaxSpec
from ray_tpu.rl.spaces import Box as JaxBox
from ray_tpu.rl.spaces import Discrete as JaxDiscrete
from ray_tpu_torch.rl import (
    APPOConfig, IMPALAConfig, RLModuleSpec)
from ray_tpu_torch.rl.algorithms.impala import IMPALALearner, vtrace_returns
from ray_tpu_torch.rl.rl_module import params_to_tree
from ray_tpu_torch.rl.spaces import Box, Discrete

# f32 on both sides; XLA and PyTorch differ in rounding only
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: faster for these small ops than two, and
    it keeps each xdist worker to one core."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _vtrace_inputs(T=9, N=4, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        log_rhos=rng.normal(scale=0.4, size=(T, N)).astype(np.float32),
        discounts=(0.99 * (rng.random((T, N)) > 0.15)).astype(np.float32),
        rewards=rng.normal(size=(T, N)).astype(np.float32),
        values=rng.normal(size=(T, N)).astype(np.float32),
        bootstrap_value=rng.normal(size=N).astype(np.float32))


@pytest.mark.parametrize("rho_bar,pg_rho_bar", [(1.0, 1.0), (0.8, 1.5)])
def test_vtrace_matches_numpy_reference_and_jax(rho_bar, pg_rho_bar):
    """The numpy recursion within 2e-5 (the reference test's bar) and
    the reference's ``vtrace_returns`` within 1e-5."""
    x = _vtrace_inputs()
    rhos = np.exp(x["log_rhos"])
    clipped = np.minimum(rho_bar, rhos)
    cs = np.minimum(1.0, rhos)
    values, boot, disc = x["values"], x["bootstrap_value"], x["discounts"]
    next_values = np.concatenate([values[1:], boot[None]], axis=0)
    deltas = clipped * (x["rewards"] + disc * next_values - values)
    vs = np.zeros(values.shape)
    acc = np.zeros(values.shape[1])
    for t in reversed(range(values.shape[0])):
        acc = deltas[t] + disc[t] * cs[t] * acc
        vs[t] = acc + values[t]
    next_vs = np.concatenate([vs[1:], boot[None]], axis=0)
    pg_adv_ref = np.minimum(pg_rho_bar, rhos) * (
        x["rewards"] + disc * next_vs - values)

    kw = dict(clip_rho_threshold=rho_bar, clip_pg_rho_threshold=pg_rho_bar)
    got_vs, got_adv = vtrace_returns(
        *(torch.from_numpy(v) for v in x.values()), **kw)
    assert got_vs.dtype == torch.float32
    np.testing.assert_allclose(got_vs.numpy(), vs, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_adv.numpy(), pg_adv_ref, rtol=2e-5,
                               atol=2e-5)
    want_vs, want_adv = jax_vtrace(
        *(jnp.asarray(v) for v in x.values()), **kw)
    np.testing.assert_allclose(got_vs.numpy(), np.asarray(want_vs),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_adv.numpy(), np.asarray(want_adv),
                               rtol=0, atol=ATOL)


def _specs(continuous, hidden=(32, 32)):
    if continuous:
        low, high = -np.ones(2, np.float32), np.ones(2, np.float32)
        return (JaxSpec(JaxBox(-np.ones(3), np.ones(3)), JaxBox(low, high),
                        hidden),
                RLModuleSpec(Box(-np.ones(3), np.ones(3)), Box(low, high),
                             hidden))
    return (JaxSpec(JaxBox(-np.ones(3), np.ones(3)), JaxDiscrete(4), hidden),
            RLModuleSpec(Box(-np.ones(3), np.ones(3)), Discrete(4), hidden))


def _fragment(jspec, params, T=12, N=6, seed=3):
    """A time-major [T, N] fragment: behaviour log-probs near the
    current policy's, a few episode ends and truncations."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, N, 3)).astype(np.float32)
    if jspec.is_continuous:
        actions = rng.normal(size=(T, N, 2)).astype(np.float32)
    else:
        actions = rng.integers(0, 4, size=(T, N)).astype(np.int32)
    dist, _ = jspec.forward(params, jnp.asarray(obs))
    logp = np.asarray(dist.log_prob(jnp.asarray(actions)))
    dones = rng.random((T, N)) < 0.1
    return {
        "obs": obs, "actions": actions,
        "action_logp": (logp + rng.normal(scale=0.3, size=(T, N))
                        ).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": dones,
        "truncateds": dones & (rng.random((T, N)) < 0.5),
        "final_obs": rng.normal(size=(T, N, 3)).astype(np.float32),
        "bootstrap_value": rng.normal(size=N).astype(np.float32),
    }


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_impala_loss_and_grads_match_jax(continuous):
    """The V-trace loss, its metrics and every gradient leaf within
    1e-5 of jax.value_and_grad of the reference's loss."""
    jspec, tspec = _specs(continuous)
    ref = JaxIMPALALearner(jspec, seed=1, gamma=0.97,
                           clip_rho_threshold=0.9)
    batch = _fragment(jspec, ref.params)
    (loss_ref, m_ref), g_ref = jax.jit(jax.value_and_grad(
        ref.loss, has_aux=True))(ref.params, batch)

    learner = IMPALALearner(tspec, seed=0, gamma=0.97,
                            clip_rho_threshold=0.9, device="cpu")
    learner.set_weights(ref.get_weights())
    loss, metrics = learner.loss(learner.module, learner.to_device(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=0,
                               atol=ATOL)
    for k in ("policy_loss", "vf_loss", "entropy", "mean_rho"):
        np.testing.assert_allclose(metrics[k].item(), float(m_ref[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    grads = jax.tree.map(np.asarray, g_ref)
    for part in ("pi", "vf"):
        for layer, want in zip(getattr(learner.module, part).layers,
                               grads[part]):
            np.testing.assert_allclose(layer.w.grad.numpy(), want["w"],
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(layer.b.grad.numpy(), want["b"],
                                       rtol=0, atol=ATOL)
    if continuous:
        np.testing.assert_allclose(learner.module.log_std.grad.numpy(),
                                   grads["log_std"], rtol=0, atol=ATOL)


def test_impala_learner_updates_match_jax():
    """Three updates (global-norm clip 0.5, Adam) on one fragment end at
    the reference learner's params within 1e-5."""
    jspec, tspec = _specs(False)
    kw = dict(lr=5e-4, grad_clip=0.5, gamma=0.99)
    ref = JaxIMPALALearner(jspec, seed=2, **kw)
    learner = IMPALALearner(tspec, seed=0, device="cpu", **kw)
    learner.set_weights(ref.get_weights())
    batch = _fragment(jspec, ref.params, seed=5)
    for _ in range(3):
        m_ref = ref.update(batch)
        m = learner.update(batch)
        for k in ("total_loss", "policy_loss", "vf_loss", "mean_rho"):
            np.testing.assert_allclose(m[k].item(), float(m_ref[k]),
                                       rtol=0, atol=ATOL, err_msg=k)
    got = jax.tree_util.tree_leaves(params_to_tree(learner.module))
    want = jax.tree_util.tree_leaves(ref.get_weights())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("config", [APPOConfig, IMPALAConfig])
@pytest.mark.parametrize("runners", [0, 2])
def test_async_loops_refuse(config, runners):
    """APPO and IMPALA run over remote env runners: with none they
    refuse, as the reference does, and with runners but no runtime the
    runner actors cannot start (the loops themselves run in
    tests/test_torch_rl_appo_impala.py)."""
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    cfg = config().environment("CartPole-v1").env_runners(
        num_env_runners=runners)
    error, match = ((ValueError, "num_env_runners >= 1") if runners == 0
                    else (RuntimeError, r"init\(\) has not been called"))
    with pytest.raises(error, match=match):
        cfg.build_algo(device="cpu")

