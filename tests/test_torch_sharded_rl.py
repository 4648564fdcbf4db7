"""Data-parallel RL in the port against the JAX package: ``PPOLearner``
over a data mesh in a gloo spawn at world 2, and Anakin over four
lockstep shards in this process.

- ``PPOLearner(mesh=)`` at data 2 (each rank takes its rows of the
  global batch; advantages normalised with the global batch's mean and
  std; gradients summed over data before the clip and Adam) against the
  reference's unsharded ``PPOLearner``, three updates from the same
  weights: ``total_loss`` to rtol 1e-5, the weights to rtol 1e-5 / atol
  1e-6 (tests/test_rl.py:165-195, where GSPMD splits the batch).
- Anakin's lockstep step over 4 CPU shards against the reference's
  ``build_step`` under ``jax.vmap(axis_name="anakin")`` at D 4, ten
  updates from the same weights, env states and draws: the metrics and
  the parameters within 1e-5, every shard identical
  (tests/test_podracer.py:95-172); with ``grad_compression="int8"`` the
  shards stay identical too, and the run holds the reference's
  quantized pmean.
- ``iter_device_batches(sharding=)`` stages each rank's rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl.algorithms.ppo import PPOLearner as JaxPPOLearner
from ray_tpu.rl.env import CartPoleJax
from ray_tpu.rl.podracer import anakin as janakin
from ray_tpu.rl.rl_module import RLModuleSpec as JaxSpec
from ray_tpu_torch.rl import RLModuleSpec, params_from_jax
from ray_tpu_torch.rl.env import CartPoleTensor
from ray_tpu_torch.rl.podracer import (
    Anakin, AnakinConfig, build_lockstep, make_optimizer)
from test_torch_rl_anakin import jax_rollout_noise
from test_torch_seq_parallel_card import GroupRun
from test_torch_sharded_vision_card import rl_worker

WORLD, N = 2, 64
SHARDS, UPDATES = 4, 10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(N, 4)).astype(np.float32),
        "actions": rng.integers(2, size=N).astype(np.int32),
        "action_logp": np.full(N, -0.69, dtype=np.float32),
        "vf_preds": rng.normal(size=N).astype(np.float32),
        "advantages": (rng.normal(size=N) * 3 + 1).astype(np.float32),
        "value_targets": rng.normal(size=N).astype(np.float32),
    }


@pytest.fixture(scope="module")
def learner_runs(tmp_path_factory):
    """(the port's ranks' results, the reference's per-update metrics
    and final weights); the spawn starts before the JAX side runs."""
    env = CartPoleJax()
    spec = JaxSpec(obs_space=env.observation_space,
                   action_space=env.action_space, hidden=(8,))
    ref = JaxPPOLearner(spec, seed=0, lr=1e-2, grad_clip=0.5)
    weights = jax.tree_util.tree_map(np.asarray, ref.get_weights())
    rng = np.random.default_rng(3)
    stream = [{"x": rng.normal(size=(8, 3)).astype(np.float32),
               "y": np.arange(8, dtype=np.int64) + 8 * i} for i in range(2)]
    run = GroupRun(rl_worker, WORLD, dict(weights=weights, batch=_batch(),
                                          stream=stream),
                   tmp_path_factory.mktemp("sharded_rl"))
    try:
        want = [{k: float(v) for k, v in ref.update(_batch()).items()}
                for _ in range(3)]
        yield run.join(), want, jax.tree_util.tree_map(
            np.asarray, ref.get_weights()), stream
    finally:
        run.close()


def test_ppo_learner_over_a_data_mesh_matches_the_unsharded_reference(
        learner_runs):
    results, want, want_weights, _stream = learner_runs
    for r in results:
        for got, ref in zip(r["metrics"], want):
            assert set(got) == set(ref)
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
        for part in ("pi", "vf"):
            for got, ref in zip(r["weights"][part], want_weights[part]):
                for leaf in ("w", "b"):
                    np.testing.assert_allclose(got[leaf], ref[leaf],
                                               rtol=1e-5, atol=1e-6)


def test_iter_device_batches_stages_each_ranks_rows(learner_runs):
    results, _want, _weights, stream = learner_runs
    for rank, r in enumerate(results):
        assert len(r["staged"]) == len(stream)
        for got, batch in zip(r["staged"], stream):
            for k, col in batch.items():
                np.testing.assert_array_equal(got[k],
                                              col[4 * rank:4 * (rank + 1)])


def _anakin(compression=None):
    kw = dict(num_envs_per_device=4, rollout_len=8, hidden=(16,), seed=0,
              grad_compression=compression)
    return janakin.AnakinConfig(**kw), AnakinConfig(**kw)


def _run_both(compression):
    """Ten updates of the reference's vmapped step and of the port's
    lockstep step over SHARDS shards -> per update (the reference's
    metrics, the port's), the final parameters of both, the port's
    modules."""
    jcfg, tcfg = _anakin(compression)
    env = CartPoleJax()
    spec = JaxSpec(env.observation_space, env.action_space, jcfg.hidden)
    v_step = jax.jit(jax.vmap(janakin.build_step(env, spec, jcfg),
                              axis_name=janakin.AXIS_NAME))
    k_model, k_env, k = jax.random.split(jax.random.PRNGKey(0), 3)
    params = spec.init(k_model)

    def replicated(tree):
        return jax.tree.map(lambda x: jnp.stack([jnp.asarray(x)] * SHARDS),
                            tree)

    v_params = replicated(params)
    v_opt = replicated(janakin.make_optimizer(jcfg).init(params))
    v_env, v_obs = jax.vmap(
        lambda key: janakin.init_shard(env, spec, jcfg, key))(
            jax.random.split(k_env, SHARDS))

    port_env = CartPoleTensor()
    tspec = RLModuleSpec(port_env.observation_space, port_env.action_space,
                         tcfg.hidden)
    modules = [params_from_jax(tspec, params, "cpu") for _ in range(SHARDS)]
    optimizers = [make_optimizer(m, tcfg) for m in modules]
    states, obs = [], []
    for i in range(SHARDS):
        s, o = port_env.reset(torch.from_numpy(np.array(v_env["s"][i])))
        states.append(s)
        obs.append(o)
    step = build_lockstep(port_env, tspec, tcfg)
    rows = []
    for _ in range(UPDATES):
        k, sub = jax.random.split(k)
        keys = jax.random.split(sub, SHARDS)
        v_params, v_opt, v_env, v_obs, vm = v_step(
            v_params, v_opt, v_env, v_obs, keys)
        states, obs, m, _cols = step(
            modules, optimizers, states, obs,
            [jax_rollout_noise(keys[i], tcfg.rollout_len,
                               tcfg.num_envs_per_device)
             for i in range(SHARDS)])
        rows.append(({k2: np.asarray(v) for k2, v in vm.items()},
                     {k2: v.item() for k2, v in m.items()}))
    return rows, jax.tree.map(np.asarray, v_params), modules


def _assert_shards_identical(modules):
    first = modules[0].state_dict()
    for m in modules[1:]:
        for name, t in m.state_dict().items():
            assert torch.equal(t, first[name]), name


def test_anakin_lockstep_matches_the_reference_vmapped_step():
    rows, v_params, modules = _run_both(None)
    for vm, m in rows:
        assert set(m) == set(vm)
        for k in vm:
            assert np.all(vm[k] == vm[k][0])  # the pmean'd metrics
            np.testing.assert_allclose(m[k], float(vm[k][0]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    _assert_shards_identical(modules)
    got = modules[0].state_dict()
    for part in ("pi", "vf"):
        for i, layer in enumerate(v_params[part]):
            for leaf in ("w", "b"):
                assert np.abs(layer[leaf] - layer[leaf][0]).max() == 0.0
                np.testing.assert_allclose(
                    got[f"{part}.layers.{i}.{leaf}"].numpy(),
                    layer[leaf][0], atol=1e-5, rtol=0)


def test_anakin_int8_gradient_mean_keeps_the_shards_identical():
    rows, v_params, modules = _run_both("int8")
    _assert_shards_identical(modules)
    for vm, m in rows:
        for k in vm:
            np.testing.assert_allclose(m[k], float(vm[k][0]), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    got = modules[0].state_dict()
    for part in ("pi", "vf"):
        for i, layer in enumerate(v_params[part]):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    got[f"{part}.layers.{i}.{leaf}"].numpy(),
                    layer[leaf][0], atol=1e-4, rtol=0)


def test_anakin_over_several_devices_reports_them_and_stays_replicated():
    cfg = AnakinConfig(num_envs_per_device=4, rollout_len=4, hidden=(8,),
                       grad_compression="fp8")
    trainer = Anakin(cfg, device=["cpu"] * 3)
    out = trainer.train(2)
    assert out["num_devices"] == 3
    assert out["env_steps"] == 2 * 3 * 4 * 4
    assert np.isfinite(out["total_loss"])
    _assert_shards_identical(trainer.modules)
    # each shard draws its own envs
    assert not torch.equal(trainer.obs_shards[0], trainer.obs_shards[1])
