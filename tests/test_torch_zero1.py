"""The port's ZeRO-1 and DDP optimizers (ray_tpu_torch.train.collective)
in one gloo spawn at world 4, against each other and against optax.

Five steps of ``Zero1Optimizer`` and ``DDPOptimizer`` (``make_optimizer``
with ``zero1=True`` / ``False``) from the same f32 tree with the same
grads (each rank's own, numpy seed 100 + rank) land within 1e-5 of each
other, and ZeRO-1's Adam state is world x (0.7-1.4) smaller
(tests/test_quantized_collectives.py:180). DDP's step is Adam's on the
ranks' mean gradient (within 1e-6 of the f64 update, 3e-6 of
``optax.adam``'s f32 one). With int8 on the wire both still keep every
rank the same. DDP keeps each leaf's
dtype; ZeRO-1 refuses a tree whose size changed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu_torch.train import collective as tcol
from test_torch_seq_parallel_card import GroupRun
from test_torch_sharded_vision_card import zero1_worker

WORLD, STEPS = 4, 5
N_PARAMS = 1003 + 59


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    run = GroupRun(zero1_worker, WORLD, dict(steps=STEPS),
                   tmp_path_factory.mktemp("zero1"))
    try:
        yield run.join()
    finally:
        run.close()


def _mean_grads():
    """The ranks' mean gradient at each step (the workers' seeds)."""
    rngs = [np.random.default_rng(100 + r) for r in range(WORLD)]
    for _ in range(STEPS):
        per_rank = [{"w": g.standard_normal((17, 59)).astype(np.float32),
                     "b": g.standard_normal(59).astype(np.float32)}
                    for g in rngs]
        yield {k: np.mean([p[k] for p in per_rank], axis=0)
               for k in ("w", "b")}


def _adam_references():
    """Adam(0.05) over the mean gradients from the workers' tree: in f64
    (the update ``optax.adam`` defines), and ``optax.adam`` itself."""
    import torch
    start = {"w": torch.linspace(-1.0, 1.0, 1003).reshape(17, 59).numpy(),
             "b": np.zeros(59, np.float32)}
    exact = {k: v.astype(np.float64) for k, v in start.items()}
    mu = {k: np.zeros_like(v) for k, v in exact.items()}
    nu = {k: np.zeros_like(v) for k, v in exact.items()}
    params = jax.tree_util.tree_map(jnp.asarray, start)
    opt = optax.adam(0.05)
    state = opt.init(params)
    for t, grads in enumerate(_mean_grads(), 1):
        for k, g in grads.items():
            g = g.astype(np.float64)
            mu[k] = 0.9 * mu[k] + 0.1 * g
            nu[k] = 0.999 * nu[k] + 0.001 * g * g
            exact[k] = exact[k] - 0.05 * (mu[k] / (1 - 0.9 ** t)) / (
                np.sqrt(nu[k] / (1 - 0.999 ** t)) + 1e-8)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return exact, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("compression", [None, "int8"])
def test_zero1_matches_ddp_and_shrinks_the_state(results, compression):
    for rank, r in enumerate(results):
        p_z1, p_ddp, z1_bytes, ddp_bytes = r[compression]
        if compression is None:
            # (with int8 they quantize different blocks: DDP each leaf's,
            # ZeRO-1 the flat vector's chunks)
            diff = max(float(np.abs(p_z1[k] - p_ddp[k]).max())
                       for k in p_z1)
            assert diff < 1e-5, (rank, diff)
        # Adam keeps two f32 moments: DDP for every parameter, ZeRO-1
        # for this rank's chunk
        assert ddp_bytes >= 2 * 4 * N_PARAMS
        ratio = ddp_bytes / max(z1_bytes, 1)
        assert WORLD * 0.7 < ratio < WORLD * 1.4, (rank, ratio)
        for k in p_z1:  # every rank holds the same parameters
            np.testing.assert_array_equal(p_z1[k],
                                          results[0][compression][0][k])
            np.testing.assert_array_equal(p_ddp[k],
                                          results[0][compression][1][k])


def test_ddp_adam_is_optax_adam_on_the_mean_gradient(results):
    """Within 1e-6 of the f64 Adam that optax.adam computes in f32;
    optax's own f32 result is 1.9e-6 from it after five steps at lr 0.05
    (torch's 1.7e-7), so against optax the bar is that gap and 1e-6."""
    exact, with_optax = _adam_references()
    for r in results:
        _z1, p_ddp, _b1, _b2 = r[None]
        for k in exact:
            np.testing.assert_allclose(p_ddp[k], exact[k], rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(p_ddp[k], with_optax[k], rtol=0,
                                       atol=3e-6)


def test_ddp_keeps_each_leafs_dtype(results):
    assert results[0]["dtypes"] == {"w": "torch.bfloat16",
                                    "b": "torch.float32"}


def test_zero1_refuses_a_tree_whose_size_changed(results):
    for r in results:
        assert "gradient tree size changed" in r["resized"]


def test_make_optimizer_needs_the_flags_until_the_runtime():
    import torch
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tcol.make_optimizer(torch.optim.Adam, {"w": torch.zeros(3)})
    with pytest.raises(NotImplementedError, match="item 9"):
        tcol.barrier()
    with pytest.raises(NotImplementedError, match="item 9"):
        tcol.broadcast_from_rank_zero(1)
