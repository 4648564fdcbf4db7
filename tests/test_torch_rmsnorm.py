"""K4's launch plan and the plain RMSNorm at widths the kernel's vector
path does not take, on the CPU.

The plan (``rmsnorm._rms_plan``) is what the kernel reads: each column
of a row must fall to exactly one (chunk, slot, thread, element) under
the kernel's index formula, within the C entry's limits. The plain
version is what a CPU tensor runs and what the card's kernel is held
against; here it is held against the JAX ``rms_norm`` at widths that are
not a multiple of 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.rmsnorm import rms_norm as j_rms_norm
from ray_tpu_torch.ops import rmsnorm as trms


def _columns(plan, d):
    """Every column the kernel touches, by its formula in
    csrc/rmsnorm.cu: chunk k, slot v, thread t, element i ->
    k * span + (v * threads + t) * width + i, masked at d."""
    k, v, t, i = np.meshgrid(np.arange(plan.chunks), np.arange(plan.vecs),
                             np.arange(plan.threads), np.arange(plan.width),
                             indexing="ij")
    span = plan.threads * plan.vecs * plan.width
    cols = (k * span + (v * plan.threads + t) * plan.width + i).ravel()
    return cols[cols < d]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("d", [12, 64, 100, 4096, 4100, 8192, 16384])
def test_rms_plan_covers_each_column_once(d, dtype, aligned):
    """The grid is a block per row, so the plan holds for any row
    count."""
    plan = trms._rms_plan(d, dtype, aligned)
    cols = _columns(plan, d)
    assert np.array_equal(np.sort(cols), np.arange(d))
    # the C entry's limits: whole warps, at most 512 threads, 1, 2 or 4
    # slots a thread, no empty chunk, 16-byte slots
    assert plan.threads % 32 == 0 and plan.threads <= trms._MAX_THREADS
    assert plan.vecs in (1, 2, 4)
    span = plan.threads * plan.vecs * plan.width
    assert (plan.chunks - 1) * span < d <= plan.chunks * span
    assert plan.width * dtype.itemsize == 16
    assert plan.vector == (aligned and d % plan.width == 0)


@pytest.mark.parametrize("d", [20000, 100000])
def test_rms_plan_walks_wide_rows_in_chunks(d):
    plan = trms._rms_plan(d, torch.bfloat16, True)
    assert plan.chunks > 1 and plan.threads == trms._MAX_THREADS
    assert np.array_equal(np.sort(_columns(plan, d)), np.arange(d))


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, d)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("d", [12, 100])
@pytest.mark.parametrize("dtype,jdtype", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
    (torch.float16, jnp.float16)])
def test_rms_norm_ragged_width_matches_jax(d, dtype, jdtype):
    x, w = _inputs(d, d)
    xj, wj = jnp.asarray(x, jdtype), jnp.asarray(w, jdtype)
    want = np.asarray(j_rms_norm(xj, wj, 1e-5).astype(jnp.float32))
    # the same values in torch's type (both round the f32 inputs alike)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(dtype)
    got = trms.rms_norm(xt, wt, 1e-5)
    assert got.dtype == dtype and got.shape == (6, d)
    if dtype == torch.float32:
        # f32 on both sides: rounding of the mean and rsqrt only
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    else:
        # one rounding of the output to 16 bits on each side
        assert np.abs(got.float().numpy() - want).max() <= 2e-2
