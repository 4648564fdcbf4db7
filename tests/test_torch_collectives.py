"""The port's ring all-reduce and in-graph quantized reductions
(ray_tpu_torch.parallel.collective) against the JAX package's, in one
gloo spawn at world 4.

Without compression (``dist.all_reduce`` and the two halves) a sum of
integer-valued floats is exact, prod / max / min agree with numpy, and
the byte counter counts a ring's share. With int8 / fp8 and an
error-feedback key, two rounds of the ring on every rank equal
a numpy replay of the reference's ring over the same four inputs, built
from the reference's own ``_chunk_bounds``, ``_encode_chunk`` and
``_decode_chunk`` (ray_tpu/parallel/collective.py:507-575), residuals
included, and every rank returns the same tensor. The reference's bars
(tests/test_quantized_collectives.py): int8 error < 0.02 and fp8 < 0.15
of the largest sum (:153), error feedback's bias < naive / 3 and < 2e-3
over 50 rounds (:167), the reduce-scatter / all-gather round trip
(:195), int8 moving >= 3.5x fewer bytes than f32 by the port's counter
(:263). The in-graph reductions: ``quantized_psum`` / ``pmean`` /
``reduce_scatter`` (int8, fp8, with ``error=``) the same on every rank
and within 1e-6 of the reference's under ``jax.vmap`` with an axis name
(the 8-device bars of :389 hold), and the lockstep form equal to the
group form.
"""

import jax
import numpy as np
import pytest

from ray_tpu.parallel import collective as jc
from ray_tpu_torch.parallel import collective as tc
from test_torch_seq_parallel_card import GroupRun
from test_torch_sharded_vision_card import collectives_worker

WORLD, ROUNDS = 4, 50


@pytest.fixture(scope="module")
def inputs():
    rng = [np.random.default_rng(r) for r in range(WORLD)]
    return {
        "ints": [np.arange(r, r + 5000, dtype=np.float32)
                 for r in range(WORLD)],
        "g": [g.standard_normal(4097).astype(np.float32) for g in rng],
        "ef": [g.standard_normal(2048).astype(np.float32) for g in rng],
        "rt": [np.arange(1025, dtype=np.float32) * (r + 1)
               for r in range(WORLD)],
        "ones": [np.ones(65536, np.float32) for _ in range(WORLD)],
        "x": [g.standard_normal(1000).astype(np.float32) * (1 + r)
              for r, g in enumerate(rng)],
        "y": [g.standard_normal(4096).astype(np.float32) for g in rng],
    }


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    run = GroupRun(collectives_worker, WORLD, dict(inputs=inputs,
                                                   rounds=ROUNDS),
                   tmp_path_factory.mktemp("collectives"))
    try:
        yield run.join()
    finally:
        run.close()


def replay_reduce_scatter(xs, compression, residuals):
    """The reference's ring reduce-scatter over ``xs`` (one f32 array
    per rank) in numpy, hop by hop, with the ranks' error-feedback
    ``residuals`` (updated in place) -> (each rank's reduced chunk, the
    chunk bounds)."""
    world = len(xs)
    flats = []
    for r in range(world):
        flats.append(xs[r] + residuals[r])
        residuals[r][:] = 0.0
    bounds = jc._chunk_bounds(flats[0].size, world)
    stats = {"wire": 0, "raw": 0}
    acc = [[flats[r][bounds[i]:bounds[i + 1]].copy() for i in range(world)]
           for r in range(world)]
    for s in range(world - 1):
        sent = [jc._encode_chunk(acc[r][(r - 1 - s) % world], compression,
                                 residuals[r], bounds[(r - 1 - s) % world],
                                 stats) for r in range(world)]
        for r in range(world):
            i = (r - 2 - s) % world
            acc[r][i] = acc[r][i] + jc._decode_chunk(sent[(r - 1) % world])
    return [acc[r][r] for r in range(world)], bounds


def replay_ring(xs, compression, residuals):
    """The reference's ring all-reduce (sum) over ``xs`` in numpy: the
    reduce-scatter, then each rank's chunk quantized once by its owner
    and decoded by every rank -> the result every rank returns."""
    own, bounds = replay_reduce_scatter(xs, compression, residuals)
    stats = {"wire": 0, "raw": 0}
    wire = [jc._encode_chunk(own[r], compression, residuals[r], bounds[r],
                             stats) for r in range(len(xs))]
    return np.concatenate([jc._decode_chunk(p) for p in wire])


def test_exact_sum_and_mean(results, inputs):
    want = np.sum(inputs["ints"], axis=0)
    for r in results:
        np.testing.assert_array_equal(r["exact_sum"], want)
        np.testing.assert_array_equal(r["exact_mean"], want / WORLD)


@pytest.mark.parametrize("compression", ["int8", "fp8"])
def test_quantized_ring_equals_the_reference_ring_replayed(results, inputs,
                                                           compression):
    residuals = [np.zeros(4097, np.float32) for _ in range(WORLD)]
    for round_ in range(2):
        want = replay_ring(inputs["g"], compression, residuals)
        for rank, r in enumerate(results):
            np.testing.assert_array_equal(
                r[f"ring_{compression}"][round_], want,
                err_msg=f"rank {rank} round {round_}")
    for rank, r in enumerate(results):
        np.testing.assert_array_equal(r[f"residual_{compression}"],
                                      residuals[rank])


@pytest.mark.parametrize("compression,bound", [("int8", 0.02),
                                               ("fp8", 0.15)])
def test_quantized_allreduce_error_bounded(results, compression, bound):
    exact = results[0]["exact"]
    for r in results:
        got = r[f"ring_{compression}"][0]
        rel = np.abs(got - exact).max() / np.abs(exact).max()
        assert rel < bound, (compression, rel)
        np.testing.assert_array_equal(got, results[0][f"ring_{compression}"]
                                      [0])


def test_error_feedback_converges_where_naive_drifts(results):
    for r in results:
        assert r["ef_bias"] < r["naive_bias"] / 3, r
        assert r["ef_bias"] < 2e-3, r


def test_reduce_scatter_allgather_flat_roundtrip(results):
    offs = sorted((r["roundtrip"][1], r["roundtrip"][2]) for r in results)
    assert offs[0][0] == 0
    assert [o for o, _ in offs] == jc._chunk_bounds(1025, WORLD)[:-1]
    assert sum(size for _, size in offs) == 1025
    for r in results:
        full, _off, _size, truth = r["roundtrip"]
        assert np.abs(full - truth).max() < 1e-6


@pytest.mark.parametrize("op", ["prod", "max", "min"])
def test_uncompressed_ops(results, inputs, op):
    want = {"prod": np.prod, "max": np.max, "min": np.min}[op](
        np.stack(inputs["x"]), axis=0)
    for r in results:
        np.testing.assert_allclose(r["ops"][op], want, rtol=1e-6, atol=0)


def test_uncompressed_halves_count_a_rings_bytes(results):
    bounds = jc._chunk_bounds(1025, WORLD)
    sizes = [bounds[i + 1] - bounds[i] for i in range(WORLD)]
    for rank, r in enumerate(results):
        assert r["halves_bytes"] == {
            "reduce_scatter": 4 * (1025 - sizes[rank]),
            "allgather": 4 * (1025 - sizes[(rank + 1) % WORLD])}


@pytest.mark.parametrize("compression", ["int8", "fp8"])
def test_quantized_reduce_scatter_equals_the_reference_ring_replayed(
        results, inputs, compression):
    residuals = [np.zeros(4097, np.float32) for _ in range(WORLD)]
    own, _bounds = replay_reduce_scatter(inputs["g"], compression,
                                         residuals)
    for rank, r in enumerate(results):
        np.testing.assert_array_equal(r[f"rs_{compression}"],
                                      own[rank] / WORLD)


def test_int8_moves_fewer_bytes_by_the_counter(results):
    for r in results:
        assert r["bytes"]["float32"] > 0 and r["bytes"]["int8"] > 0
        assert r["bytes"]["float32"] / r["bytes"]["int8"] >= 3.5, r["bytes"]
        assert r["ratio"] >= 3.5


def test_reset_error_feedback_drops_the_residuals(results):
    assert all(r["after_reset"] is None for r in results)


def test_world1_moves_nothing_and_keeps_no_residual():
    import torch
    g = torch.linspace(-1, 1, 512)
    out = tc.allreduce(g, "sum", compression="int8", ef_key="solo")
    assert torch.equal(out, g)
    assert tc.error_feedback_residual(None, "solo") is None
    with pytest.raises(ValueError, match="sum/mean"):
        tc.allreduce(g, "max", compression="int8")
    with pytest.raises(ValueError, match="float"):
        tc.allreduce(torch.arange(4), "sum", compression="int8")


@pytest.fixture(scope="module")
def jax_side(inputs):
    """The reference's in-graph reductions over the four ranks' inputs
    under ``jax.vmap`` with an axis name (the same collective semantics
    as its shard_map over devices)."""
    xs, ys = np.stack(inputs["x"]), np.stack(inputs["y"])
    out = {}
    for dtype in ("int8", "fp8"):
        def run(fn, *args):
            return np.asarray(jax.jit(jax.vmap(fn, axis_name="d"))(*args))
        out[f"psum_{dtype}"] = run(
            lambda x: jc.quantized_psum(x, "d", dtype=dtype), xs)
        out[f"pmean_{dtype}"] = run(
            lambda x: jc.quantized_pmean(x, "d", dtype=dtype), xs)
        out[f"psum_ef_{dtype}"] = tuple(np.asarray(a) for a in jax.jit(
            jax.vmap(lambda x, e: jc.quantized_psum(x, "d", dtype=dtype,
                                                    error=e),
                     axis_name="d"))(xs, np.full_like(xs, 0.01)))
        out[f"qrs_{dtype}"] = run(
            lambda y: jc.quantized_reduce_scatter(y, "d", dtype=dtype), ys)
    return out


def _close(got, want, scale=None):
    """Within 1e-6 of ``scale`` (by default the largest of ``want``, at
    least 1): the sums' f32 rounding, in another order."""
    scale = max(np.abs(want).max(), 1.0) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_in_graph_reductions_match_the_reference_on_every_rank(
        results, inputs, jax_side, dtype):
    for rank, r in enumerate(results):
        _close(r[f"psum_{dtype}"], jax_side[f"psum_{dtype}"][rank])
        _close(r[f"pmean_{dtype}"], jax_side[f"pmean_{dtype}"][rank])
        s, e = r[f"psum_ef_{dtype}"]
        _close(s, jax_side[f"psum_ef_{dtype}"][0][rank])
        # residual = input - its dequantized code: XLA contracts it into
        # one multiply-add, so it differs by the rounding of the input's
        # magnitude
        _close(e, jax_side[f"psum_ef_{dtype}"][1][rank],
               scale=np.abs(inputs["x"][rank]).max() + 0.01)
        _close(r[f"qrs_{dtype}"], jax_side[f"qrs_{dtype}"][rank])
        # the same codes on every rank: the sums are the same bits
        np.testing.assert_array_equal(r[f"psum_{dtype}"],
                                      results[0][f"psum_{dtype}"])


@pytest.mark.parametrize("dtype,bound", [("int8", 0.02), ("fp8", 0.1)])
def test_in_graph_reductions_hold_the_reference_bars(results, inputs,
                                                     dtype, bound):
    truth = np.sum(inputs["x"], axis=0)
    got = results[0][f"psum_{dtype}"]
    assert np.abs(got - truth).max() / np.abs(truth).max() < bound
    _s, residual = results[0][f"psum_ef_{dtype}"]
    assert residual.shape == truth.shape and np.abs(residual).max() > 0
    if dtype == "int8":
        t2 = np.sum(inputs["y"], axis=0)
        shards = np.concatenate([r["qrs_int8"] for r in results])
        assert np.abs(shards - t2).max() / np.abs(t2).max() < 0.02


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_lockstep_form_equals_the_group_form(results, dtype):
    for r in results:
        if dtype == "int8":  # int32 sums: exact in any order
            np.testing.assert_array_equal(r[f"lockstep_{dtype}"],
                                          r[f"psum_{dtype}"])
        else:  # f32 sums in another order
            _close(r[f"lockstep_{dtype}"], r[f"psum_{dtype}"])
