"""The port's Anakin against ray_tpu.rl.podracer's, on the CPU.

Five fused updates of the port's ``build_step`` are held against the
reference's ``build_step`` under ``jax.vmap(..., axis_name="anakin")``
with one shard (the reference's own parity trick,
tests/test_podracer.py:97-170, at D = 1), from the same weights, env
states and draws. The ``Anakin`` class, its span and counter, the
refusals and the device rule are checked on the port alone.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl.env import CartPoleJax
from ray_tpu.rl.podracer import anakin as janakin
from ray_tpu.rl.rl_module import RLModuleSpec as JaxSpec
from ray_tpu_torch.rl import RLModuleSpec, params_from_jax
from ray_tpu_torch.rl.env import CartPoleTensor
from ray_tpu_torch.rl.podracer import (
    Anakin, AnakinConfig, build_step, make_optimizer)
from ray_tpu_torch.util import flight_recorder, metrics

# f32 on both sides; XLA and PyTorch differ in rounding only
ATOL = 1e-5


@jax.jit
def _step_draws(key, gumbel_like):
    """One step of the reference's rollout key chain (anakin.py:89)."""
    key, k_act, k_env = jax.random.split(key, 3)
    resets = jax.vmap(lambda k: jax.random.uniform(
        k, (4,), minval=-0.05, maxval=0.05))(
            jax.random.split(k_env, gumbel_like.shape[0]))
    return key, jax.random.gumbel(k_act, gumbel_like.shape), resets


def jax_rollout_noise(key, steps, num_envs, n_actions=2):
    like = jnp.zeros((num_envs, n_actions))
    acts, resets = [], []
    for _ in range(steps):
        key, g, r = _step_draws(key, like)
        acts.append(np.asarray(g))
        resets.append(np.asarray(r))
    return {"action": torch.from_numpy(np.stack(acts)),
            "reset": torch.from_numpy(np.stack(resets))}


def test_five_updates_match_reference_build_step_under_vmap():
    kw = dict(num_envs_per_device=8, rollout_len=16, hidden=(32, 32),
              lr=1e-3, seed=0)
    jcfg, tcfg = janakin.AnakinConfig(**kw), AnakinConfig(**kw)
    env = CartPoleJax()
    spec = JaxSpec(env.observation_space, env.action_space, jcfg.hidden)
    v_step = jax.jit(jax.vmap(janakin.build_step(env, spec, jcfg),
                              axis_name=janakin.AXIS_NAME))
    k_model, k_env, key_src = jax.random.split(jax.random.PRNGKey(0), 3)
    params = spec.init(k_model)

    def one_shard(tree):
        return jax.tree.map(lambda x: jnp.asarray(x)[None], tree)

    v_params = one_shard(params)
    v_opt = one_shard(janakin.make_optimizer(jcfg).init(params))
    v_env, v_obs = jax.vmap(
        lambda k: janakin.init_shard(env, spec, jcfg, k))(
            jax.random.split(k_env, 1))

    port_env = CartPoleTensor()
    tspec = RLModuleSpec(port_env.observation_space, port_env.action_space,
                         tcfg.hidden)
    module = params_from_jax(tspec, params, "cpu")
    optimizer = make_optimizer(module, tcfg)
    state, obs = port_env.reset(torch.from_numpy(np.array(v_env["s"][0])))
    step = build_step(port_env, tspec, tcfg)
    dones = 0
    for _ in range(5):
        keys = jax.random.split(key_src, 2)  # Anakin._next_keys at D 1
        key_src, shard_keys = keys[0], keys[1:]
        v_params, v_opt, v_env, v_obs, vm = v_step(
            v_params, v_opt, v_env, v_obs, shard_keys)
        state, obs, m, cols = step(
            module, optimizer, state, obs,
            jax_rollout_noise(shard_keys[0], tcfg.rollout_len,
                              tcfg.num_envs_per_device))
        assert set(m) == set(vm)
        for k in vm:
            np.testing.assert_allclose(m[k].item(), float(vm[k][0]),
                                       rtol=1e-4, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(obs.numpy(), np.asarray(v_obs[0]),
                                   atol=ATOL)
        np.testing.assert_array_equal(state["t"].numpy(),
                                      np.asarray(v_env["t"][0]))
        dones += int(cols["dones"].sum())
    assert dones > 0
    got = module.state_dict()
    want = jax.tree.map(lambda x: np.asarray(x[0]), v_params)
    for part in ("pi", "vf"):
        for i, layer in enumerate(want[part]):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    got[f"{part}.layers.{i}.{leaf}"].numpy(), layer[leaf],
                    atol=ATOL, rtol=0)


def _small():
    return AnakinConfig(num_envs_per_device=8, rollout_len=8, hidden=(16,))


def _env_steps_counter():
    return metrics._registry.counters.get(
        ("ray_tpu_rl_env_steps_total", (("arch", "anakin"),)), 0.0)


def test_anakin_trains_and_reports_span_and_counter():
    trainer = Anakin(_small(), device="cpu")
    before = _env_steps_counter()
    rec = flight_recorder.enable("anakin-test")
    try:
        out = trainer.train(3)
    finally:
        flight_recorder.disable()
    assert out["env_steps"] == trainer.env_steps == 3 * 8 * 8
    assert out["num_updates"] == 3 and out["num_devices"] == 1
    assert out["env_steps_per_sec"] > 0
    for k in ("policy_loss", "vf_loss", "entropy", "total_loss",
              "reward_mean"):
        assert math.isfinite(out[k]), (k, out)
    spans = [e for e in rec.snapshot() if e[3:5] == ("rl", "learn_step")]
    assert [e[5]["update"] for e in spans] == [0, 1, 2]
    assert all(e[5]["env_steps"] == 64 and e[5]["arch"] == "anakin"
               for e in spans)
    assert _env_steps_counter() - before == 3 * 64
    params = trainer.params
    assert params["pi"][0]["w"].shape == (4, 16)  # [in, out]
    assert params["vf"][-1]["w"].shape == (16, 1)


def test_anakin_same_seed_same_run():
    a, b = Anakin(_small(), device="cpu"), Anakin(_small(), device="cpu")
    out_a, out_b = a.train(2), b.train(2)
    assert out_a["total_loss"] == out_b["total_loss"]
    np.testing.assert_array_equal(a.params["pi"][0]["w"],
                                  b.params["pi"][0]["w"])
    assert Anakin(_small(), device=["cpu"]).device == torch.device("cpu")


def test_anakin_refuses_unported_paths():
    """Several devices and grad_compression, which used to raise, run
    now (tests/test_torch_sharded_rl.py holds them against the
    reference); an unknown compression and an env without a TensorEnv
    still refuse."""
    two = Anakin(_small(), device=["cpu", "cpu"])
    assert two.train(1)["num_devices"] == 2
    cfg = _small()
    cfg.grad_compression = "int8"
    assert math.isfinite(Anakin(cfg, device="cpu").train(1)["total_loss"])
    env = CartPoleTensor()
    spec = RLModuleSpec(env.observation_space, env.action_space, (8,))
    build_step(env, spec, cfg)
    cfg.grad_compression = "int4"
    with pytest.raises(ValueError, match="grad_compression"):
        build_step(env, spec, cfg)
    with pytest.raises(ValueError, match="no TensorEnv"):
        Anakin(AnakinConfig(env="Pendulum-v1"), device="cpu")


def test_anakin_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Anakin(_small())
