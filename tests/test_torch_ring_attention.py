"""The port's ring and Ulysses attention (ray_tpu_torch.parallel) against
the JAX package's.

The JAX side runs ``ring_attention`` / ``ulysses_attention`` on the
8-device CPU mesh (seq 4, data 2) at the shapes of
``tests/test_parallel.py:65-105`` (B2 S64 D16, H 4 or 8), and
``jax.grad`` of its ``reference_attention`` for the grads of
sum(out * g). The port runs over gloo at world 2 and 4 in spawned
processes (``GroupRun``, one spawn per world, both started before
the JAX side runs); each rank holds its contiguous sequence shard.
Tolerances: forward 2e-5, grads 1e-4 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel.mesh import MeshSpec, make_mesh
from ray_tpu.parallel.ring_attention import (
    reference_attention as jax_reference, ring_attention as jax_ring,
    ulysses_attention as jax_ulysses)
from ray_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_attention_lockstep)
from test_torch_seq_parallel_card import GroupRun, attention_worker

FWD_TOL, GRAD_TOL = 2e-5, 1e-4

# name: (kind, causal, heads, kv heads)
CASES = {
    "ring-causal": ("ring", True, 4, 4),
    "ring-full": ("ring", False, 4, 4),
    "ulysses-causal": ("ulysses", True, 8, 8),
    "ulysses-full": ("ulysses", False, 8, 8),
    "ring-gqa": ("ring", True, 4, 2),
    # KVH 2: scattered at world 2, repeated to H 8 first at world 4
    "ulysses-gqa": ("ulysses", True, 8, 2),
}
B, S, D = 2, 64, 16


def _inputs(h, kvh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, heads, D)).astype(np.float32)
            for heads in (h, kvh, kvh, h)]


def _jax_side(kind, causal, h, kvh, seed):
    """(q, k, v, g, JAX's sharded output, grads of sum(ref * g))."""
    q, k, v, g = _inputs(h, kvh, seed)
    mesh = make_mesh(MeshSpec(seq=4, data=2))
    rep = h // kvh

    def full(a):
        return jnp.repeat(jnp.asarray(a), rep, axis=2)

    fn = jax_ring if kind == "ring" else jax_ulysses
    # jitted: eager JAX takes seconds a case here
    out = jax.jit(lambda a, b, c: fn(a, b, c, mesh, causal=causal))(
        jnp.asarray(q), full(k), full(v))
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jax_reference(
        a, jnp.repeat(b, rep, axis=2), jnp.repeat(c, rep, axis=2),
        causal=causal) * g), argnums=(0, 1, 2)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (q, k, v, g, np.asarray(out), [np.asarray(x) for x in grads])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's gloo runs at world 2 and 4, started at once, before the
    JAX side is computed; each case's inputs come from its numpy seed."""
    cases = [dict(kind=kind, causal=causal, **dict(zip("qkvg", _inputs(
        h, kvh, seed=i)))) for i, (kind, causal, h, kvh)
        in enumerate(CASES.values())]
    started = {world: GroupRun(
        attention_worker, world,
        cases + [dict(kind="bad_heads", heads={2: 3, 4: 6}[world]),
                 dict(kind="gloo_cuda")],
        tmp_path_factory.mktemp(f"ring{world}")) for world in (2, 4)}
    yield started
    for run in started.values():
        run.close()


@pytest.fixture(scope="module")
def jax_cases():
    return {name: _jax_side(*spec, seed=i)
            for i, (name, spec) in enumerate(CASES.items())}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def port(request, runs, jax_cases):
    """world -> {case name: (output, dq, dk, dv) over the whole sequence},
    and the messages of the Ulysses head-count and gloo-on-CUDA errors."""
    world = request.param
    results = runs[world].join()
    out = {}
    for i, name in enumerate(CASES):
        out[name] = [np.concatenate([r[i][key] for r in results], axis=1)
                     for key in ("out", "dq", "dk", "dv")]
    out["bad_heads"] = [r[len(CASES)] for r in results]
    out["gloo_cuda"] = [r[len(CASES) + 1] for r in results]
    return world, out


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(port, jax_cases, name):
    _world, out = port
    want = jax_cases[name][4]
    np.testing.assert_allclose(out[name][0], want, atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_jax_reference(port, jax_cases, name):
    _world, out = port
    for got, want, what in zip(out[name][1:], jax_cases[name][5],
                               ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=what)


def test_ulysses_rejects_heads_the_group_does_not_divide(port):
    world, out = port
    heads = {2: 3, 4: 6}[world]
    assert out["bad_heads"] == [
        f"ulysses needs heads ({heads}) divisible by the group size "
        f"({world})"] * world


def test_gloo_group_refuses_cuda_tensors(port):
    world, out = port
    assert len(out["gloo_cuda"]) == world
    assert all("gloo" in msg and "nccl" in msg for msg in out["gloo_cuda"])


@pytest.mark.parametrize("name", ["ring-causal", "ring-full", "ring-gqa"])
def test_four_virtual_ranks_match_the_reference(jax_cases, name):
    """The per-rank step functions for four ranks in one process (no
    exchange): outputs against JAX's ring and the port's and JAX's plain
    attention, grads against ``jax.grad``."""
    torch.set_num_threads(1)
    causal = CASES[name][1]
    q, k, v, g, want, want_grads = jax_cases[name]

    def chunks(a):
        return [torch.from_numpy(c).contiguous()
                for c in np.split(a, 4, axis=1)]

    outs, dqs, dks, dvs = ring_attention_lockstep(
        chunks(q), chunks(k), chunks(v), causal, chunks(g))
    got = torch.cat(outs, dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)
    plain = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal).numpy()
    np.testing.assert_allclose(got, plain, atol=FWD_TOL, rtol=FWD_TOL)
    rep = q.shape[2] // k.shape[2]
    np.testing.assert_allclose(plain, np.asarray(jax_reference(
        jnp.asarray(q), jnp.repeat(k, rep, axis=2),
        jnp.repeat(v, rep, axis=2), causal=causal)), atol=FWD_TOL,
        rtol=FWD_TOL)
    for grads, w in zip((dqs, dks, dvs), want_grads):
        np.testing.assert_allclose(torch.cat(grads, dim=1).numpy(), w,
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
