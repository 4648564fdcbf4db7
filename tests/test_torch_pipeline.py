"""The port's GPipe pipeline (ray_tpu_torch.parallel.pipeline) against
the JAX package's, at four stages.

The four scenarios of ``tests/test_parallel.py:107-180``: equal to the
sequential run (d 32, 16 rows, 4 microbatches), several rounds (d 16,
24 rows, 12 microbatches) with the grads of sum(out^2) with and without
remat, and both rejections. The JAX side runs ``pipeline`` on the
8-device CPU mesh (pipe 4, data 2) and ``jax.grad`` of the sequential
loss; the port runs over gloo at world 4 in spawned processes
(``GroupRun``), rank s holding stage s's weight and the microbatches
s, s + 4, ... of each batch. Tolerances: outputs 1e-5, grads 1e-4 (f32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.parallel.mesh import MeshSpec, make_mesh
from ray_tpu.parallel.pipeline import pipeline as jax_pipeline
from test_torch_seq_parallel_card import (
    GroupRun, pipeline_worker, unshard_microbatches)

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
WORLD = 4


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"])


def _sequential(w, x):
    for i in range(WORLD):
        x = _stage_fn({"w": w[i]}, x)
    return x


def _inputs():
    rng = np.random.default_rng(0)
    seq = dict(w=(rng.standard_normal((WORLD, 32, 32)) * 0.1).astype(
        np.float32), x=rng.standard_normal((16, 32)).astype(np.float32))
    multi = dict(w=(rng.standard_normal((WORLD, 16, 16)) * 0.1).astype(
        np.float32), x=rng.standard_normal((24, 16)).astype(np.float32))
    return dict(sequential=seq, multi_round=multi)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's run, started before the JAX side is computed."""
    inputs = _inputs()
    run = GroupRun(pipeline_worker, WORLD, inputs,
                   tmp_path_factory.mktemp("pipeline"))
    yield inputs, run
    run.close()


@pytest.fixture(scope="module")
def results(port):
    inputs, run = port
    mesh = make_mesh(MeshSpec(pipe=WORLD, data=2))
    want = {}
    for name, n_micro in (("sequential", 4), ("multi_round", 12)):
        w, x = (jnp.asarray(inputs[name][k]) for k in ("w", "x"))
        want[name] = dict(
            pipeline=np.asarray(jax.jit(functools.partial(
                jax_pipeline, _stage_fn, mesh=mesh,
                num_microbatches=n_micro))({"w": w}, x)),
            sequential=np.asarray(_sequential(w, x)))
    w, x = (jnp.asarray(inputs["multi_round"][k]) for k in ("w", "x"))
    want["grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
        lambda w_, x_: jnp.sum(_sequential(w_, x_) ** 2),
        argnums=(0, 1)))(w, x)]
    return want, run.join()


@pytest.mark.parametrize("name,n_micro", [("sequential", 4),
                                          ("multi_round", 12)])
def test_output_matches_jax_and_the_sequential_run(results, name, n_micro):
    want, got = results
    out = unshard_microbatches([r[name] for r in got], n_micro)
    np.testing.assert_allclose(out, want[name]["pipeline"], atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(out, want[name]["sequential"], atol=OUT_TOL,
                               rtol=OUT_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_multi_round_grads_match_jax(results, remat):
    want, got = results
    dw_want, dx_want = want["grads"]
    for stage, r in enumerate(got):
        dw, _dx = r[f"grad_remat_{remat}"]
        np.testing.assert_allclose(dw, dw_want[stage], atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    dx = unshard_microbatches([r[f"grad_remat_{remat}"][1] for r in got], 12)
    np.testing.assert_allclose(dx, dx_want, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_rejects_a_batch_the_microbatches_do_not_divide(results):
    _want, got = results
    for r in got:
        assert "not divisible by num_microbatches 8" in r["bad_microbatch"]


def test_rejects_microbatches_the_stages_do_not_divide(results):
    _want, got = results
    for r in got:
        assert "pipe size 4" in r["uneven_stages"]
