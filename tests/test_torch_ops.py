"""The port's ops (ray_tpu_torch.ops) against the JAX package's.

Inputs come from a numpy seed and go through both functions on the CPU,
where each port wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode where the JAX package's own
tests do. Tests marked ``cuda`` hold each hand-written kernel against
its plain version on the card, and skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu.ops import quant_matmul as jqm
from ray_tpu.ops.rmsnorm import rms_norm as j_rms_norm
from ray_tpu.ops.rope import apply_rope as j_apply_rope
from ray_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.ops import quant_matmul as tqm
from ray_tpu_torch.ops import rmsnorm as trms
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies


def _rng(seed=0):
    return np.random.default_rng(seed)


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
    return j, t


# --- RMSNorm ---------------------------------------------------------------

def test_rms_norm_f32_matches_jax():
    x = _rng().standard_normal((4, 8, 64)).astype(np.float32)
    w = _rng(1).standard_normal(64).astype(np.float32)
    want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = trms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    # f32 on both sides: rounding of the mean and rsqrt only
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_rms_norm_bf16_matches_jax():
    xj, xt = _bf16(_rng().standard_normal((16, 128)))
    wj, wt = _bf16(1 + 0.1 * _rng(1).standard_normal(128))
    want = np.asarray(j_rms_norm(xj, wj, 1e-5).astype(jnp.float32))
    got = trms.rms_norm(xt, wt, 1e-5)
    assert got.dtype == torch.bfloat16
    # same f32 arithmetic, one bf16 rounding of the output: 1 ulp
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=8e-3)


def test_wrappers_take_the_plain_path_on_cpu():
    counted = (trms.rms_norm, tatt.flash_attention,
               tatt.flash_attention_bwd_dq, tatt.flash_attention_bwd_dkv,
               tqm.int8_matmul)
    for fn in counted:
        fn.launches = 0
    x = torch.randn(4, 64, requires_grad=True)
    trms.rms_norm(x, torch.ones(64)).sum().backward()
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    tatt.flash_attention(q, q, q).sum().backward()
    w8, s = tqm.quantize_int8(torch.randn(64, 32))
    tqm.int8_matmul(x, w8, s)
    assert [fn.launches for fn in counted] == [0] * 5
    assert q.grad is not None and x.grad is not None


# --- RoPE ------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,seq,theta", [(16, 64, 1e4),
                                                (128, 512, 5e5)])
def test_rope_frequencies_match_jax(head_dim, seq, theta):
    jc, js = j_rope_frequencies(head_dim, seq, theta)
    tc, ts = rope_frequencies(head_dim, seq, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_apply_rope_matches_jax_default_positions():
    x = _rng().standard_normal((2, 32, 3, 16)).astype(np.float32)
    jc, js = j_rope_frequencies(16, 64)
    tc, ts = rope_frequencies(16, 64)
    want = np.asarray(j_apply_rope(jnp.asarray(x), jc, js))
    got = apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_apply_rope_matches_jax_with_positions():
    x = _rng().standard_normal((2, 4, 1, 8)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3], [9, 17, 30, 31]])
    jc, js = j_rope_frequencies(8, 32)
    tc, ts = rope_frequencies(8, 32)
    want = np.asarray(j_apply_rope(jnp.asarray(x), jc, js,
                                   positions=jnp.asarray(pos)))
    got = apply_rope(torch.from_numpy(x), tc, ts,
                     positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # half-split rotation: channel i pairs with i + D/2
    x1, x2 = x[1, 1, 0, :4], x[1, 1, 0, 4:]
    c, s = tc[17].numpy(), ts[17].numpy()
    np.testing.assert_allclose(got[1, 1, 0].numpy(),
                               np.concatenate([x1 * c - x2 * s,
                                               x2 * c + x1 * s]), atol=1e-6)


# --- flash attention -------------------------------------------------------

@pytest.mark.parametrize("sq,sk", [(256, 256), (256, 512)])
def test_flash_attention_matches_jax_kernel(sq, sk):
    rng = _rng()
    q = rng.standard_normal((1, sq, 2, 128)).astype(np.float32)
    k = rng.standard_normal((1, sk, 2, 128)).astype(np.float32)
    v = rng.standard_normal((1, sk, 2, 128)).astype(np.float32)
    prev = jatt._INTERPRET
    jatt._INTERPRET = True
    try:
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        assert jatt._kernel_plan(jq, jk) is not None  # the Pallas kernel
        want = np.asarray(jatt.flash_attention(jq, jk, jv, True))
    finally:
        jatt._INTERPRET = prev
    got = tatt.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               True)
    # f32 inputs; the Pallas kernel rounds nothing to bf16 here, so the
    # difference is the order of the online-softmax sums
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2)


def _jax_forward_lse(q, k, v, causal):
    """The Pallas forward's lse [B, H, Sq] (interpret mode) for numpy
    q [B, Sq, H, D] and k/v with as many heads."""
    prev = jatt._INTERPRET
    jatt._INTERPRET = True
    try:
        jq, jk, jv = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
        plan = jatt._kernel_plan(jnp.asarray(q), jnp.asarray(k))
        assert plan is not None  # the Pallas kernel
        _, lse = jatt._flash_forward(jq, jk, jv, causal, *plan)
    finally:
        jatt._INTERPRET = prev
    return np.asarray(lse)[..., 0]


@pytest.mark.parametrize("sq,sk,kvh", [(256, 256, 2), (256, 512, 2),
                                       (256, 256, 1)])  # GQA: 2 heads, 1 KV
def test_flash_forward_lse_matches_jax_kernel(sq, sk, kvh):
    """K1's logsumexp (natural log, [B, H, Sq] f32) is the contract with
    K2/K3: its plain version against the Pallas forward's lse, with K/V
    repeated over each GQA group (jnp.repeat) on the JAX side."""
    rng = _rng(5)
    q = rng.standard_normal((1, sq, 2, 128)).astype(np.float32)
    k = rng.standard_normal((1, sk, kvh, 128)).astype(np.float32)
    v = rng.standard_normal((1, sk, kvh, 128)).astype(np.float32)
    want = _jax_forward_lse(q, *(np.repeat(a, 2 // kvh, axis=2)
                                 for a in (k, v)), True)
    _, lse = tatt._flash_forward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), True)
    assert tuple(lse.shape) == (1, 2, sq) and lse.dtype == torch.float32
    # f32 on both sides; only the order of the online-softmax sums differs
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-4)


def test_flash_attention_gqa_equals_repeated_kv():
    rng = _rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 12, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 12, 2, 16)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 12, 2, 16)).astype(
        np.float32))
    want = np.asarray(jatt._attention_reference(
        jnp.asarray(q.numpy()),
        jnp.repeat(jnp.asarray(k.numpy()), 2, axis=2),
        jnp.repeat(jnp.asarray(v.numpy()), 2, axis=2), True))
    got = tatt.flash_attention(q, k, v, True)
    # head h reads KV head h // 2, exactly what jnp.repeat builds
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_flash_attention_ragged_causal_offset():
    """Sq < Sk aligns the causal diagonal to the end (offset Sk - Sq)."""
    rng = _rng(4)
    q, k, v = (rng.standard_normal((1, s, 2, 16)).astype(np.float32)
               for s in (5, 13, 13))
    want = np.asarray(jatt._attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    got = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# --- weight-only int8 ------------------------------------------------------

def test_quantize_int8_bit_equal_to_jax():
    w = (_rng().standard_normal((256, 384)) * 0.05).astype(np.float32)
    jw8, js = jqm.quantize_int8(jnp.asarray(w))
    tw8, ts = tqm.quantize_int8(torch.from_numpy(w))
    assert tw8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw8.numpy(), np.asarray(jw8))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-7)


def test_int8_matmul_matches_jax_kernel():
    rng = _rng()
    w = (rng.standard_normal((1024, 1024)) * 0.05).astype(np.float32)
    xj, xt = _bf16(rng.standard_normal((5, 1024)))
    jw8, js = jqm.quantize_int8(jnp.asarray(w))
    prev = jqm._INTERPRET
    jqm._INTERPRET = True
    try:
        want = np.asarray(jqm.int8_matmul(xj, jw8, js, block_n=512,
                                          block_k=512), np.float32)
    finally:
        jqm._INTERPRET = prev
    tw8, ts = tqm.quantize_int8(torch.from_numpy(w))
    got = tqm.int8_matmul(xt, tw8, ts)
    assert got.dtype == torch.bfloat16 and got.shape == (5, 1024)
    rel = (np.max(np.abs(got.float().numpy() - want))
           / (np.max(np.abs(want)) + 1e-9))
    # same math (bf16 in, f32 sum, scale, bf16 out): bf16 rounding only
    assert rel < 2e-2, rel


@pytest.mark.parametrize("m,k,n", [(1, 64, 1000), (3, 96, 11008 // 16)])
def test_int8_matmul_takes_ragged_widths(m, k, n):
    """No block restriction: widths the Pallas kernel refuses work."""
    rng = _rng(5)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w8, s = tqm.quantize_int8(w)
    got = tqm.int8_matmul(x, w8, s)
    np.testing.assert_allclose(got.numpy(), (x @ (w8.float() * s)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_int8_matmul_rejects_mismatched_scale():
    w8, s = tqm.quantize_int8(torch.randn(64, 32))
    with pytest.raises(ValueError, match="scale"):
        tqm.int8_matmul(torch.randn(2, 64), w8, s[:16])


# --- flash attention backward ----------------------------------------------

def _qkv_do(sq, sk, h=2, kvh=2, d=128, seed=0):
    rng = _rng(seed)
    return (rng.standard_normal((1, sq, h, d)).astype(np.float32),
            rng.standard_normal((1, sk, kvh, d)).astype(np.float32),
            rng.standard_normal((1, sk, kvh, d)).astype(np.float32),
            rng.standard_normal((1, sq, h, d)).astype(np.float32))


def _jax_interpret(fn):
    prev = jatt._INTERPRET
    jatt._INTERPRET = True
    try:
        return fn()
    finally:
        jatt._INTERPRET = prev


@pytest.mark.parametrize("sq,sk", [(256, 256), (256, 512)])
def test_flash_backward_reference_matches_jax_kernels(sq, sk):
    """The plain version of K2 + K3 against the Pallas _dq_kernel and
    _dkv_kernel, fed the same o and lse."""
    q, k, v, do = _qkv_do(sq, sk)

    def run():
        jq, jk, jv, jdo = (jnp.asarray(a).transpose(0, 2, 1, 3)
                           for a in (q, k, v, do))
        plan = jatt._kernel_plan(jnp.asarray(q), jnp.asarray(k))
        assert plan is not None  # the Pallas kernels
        o, lse = jatt._flash_forward(jq, jk, jv, True, *plan)
        grads = jatt._flash_backward(jq, jk, jv, o, lse, jdo, True, *plan)
        return o, lse, grads

    o, lse, (jdq, jdk, jdv) = _jax_interpret(run)
    o_t = torch.from_numpy(np.array(o)).transpose(1, 2)
    lse_t = torch.from_numpy(np.array(lse)[..., 0])
    dq, dk, dv = tatt._flash_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), o_t, lse_t,
        torch.from_numpy(do), True)
    # f32 inputs: P and dS are not rounded on either side; the reference's
    # own bar for its kernels against autodiff
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want).transpose(0, 2, 1, 3), atol=5e-3)


@pytest.mark.parametrize("sq,sk", [(256, 256), (256, 512)])
def test_flash_attention_grads_match_jax_kernel(sq, sk):
    """Grads through _FlashAttention against jax.vjp of the JAX
    flash_attention, whose custom_vjp runs the Pallas kernels."""
    q, k, v, do = _qkv_do(sq, sk, seed=1)

    def run():
        args = tuple(jnp.asarray(a) for a in (q, k, v))
        assert jatt._kernel_plan(args[0], args[1]) is not None
        out, vjp = jax.vjp(lambda *a: jatt.flash_attention(*a, True), *args)
        return out, vjp(jnp.asarray(do))

    jout, jgrads = _jax_interpret(run)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tatt.flash_attention(tq, tk, tv, True)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-2)
    for got, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=5e-3)


def test_flash_attention_gqa_grads_match_jax_repeat():
    """dK/dV come back with the KV heads: the VJP of jnp.repeat sums the
    grads of each group's query heads."""
    q, k, v, do = _qkv_do(12, 12, h=4, kvh=2, d=16, seed=3)

    def ref(q_, k_, v_):
        return jatt._attention_reference(q_, jnp.repeat(k_, 2, axis=2),
                                         jnp.repeat(v_, 2, axis=2), True)

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tatt.flash_attention(tq, tk, tv, True).backward(torch.from_numpy(do))
    assert tk.grad.shape == (1, 12, 2, 16)
    for got, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-5)


def test_flash_attention_row_without_keys_has_zero_grads():
    """No live key: output 0, lse at K1's l == 0 guard, and the
    backward gives exactly 0 (P is masked to 0, not exp(0))."""
    q, _, _, do = _qkv_do(5, 0, d=16, seed=4)
    tq = torch.from_numpy(q).requires_grad_()
    tk = torch.zeros((1, 0, 2, 16), requires_grad=True)
    tv = torch.zeros((1, 0, 2, 16), requires_grad=True)
    out = tatt.flash_attention(tq, tk, tv, False)
    _, lse = tatt._flash_forward_reference(tq, tk, tv, False)
    assert torch.all(lse == tatt.NEG_INF)
    out.backward(torch.from_numpy(do))
    assert torch.equal(out.detach(), torch.zeros_like(out))
    assert torch.equal(tq.grad, torch.zeros_like(tq))
    assert tk.grad.shape == (1, 0, 2, 16)


def test_flash_backward_masked_pairs_add_nothing():
    """A causal pair above the diagonal gets P = 0 whatever its score, so
    perturbing a key changes no grad of the queries that cannot see it."""
    q, k, v, do = _qkv_do(6, 6, d=16, seed=5)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = tatt._flash_forward_reference(t[0], t[1], t[2], True)
    dq, _, _ = tatt._flash_backward_reference(t[0], t[1], t[2], o, lse,
                                              t[3], True)
    k2 = t[1].clone()
    k2[:, -1] += 100.0  # only the last query row sees the last key
    o2, lse2 = tatt._flash_forward_reference(t[0], k2, t[2], True)
    dq2, _, _ = tatt._flash_backward_reference(t[0], k2, t[2], o2, lse2,
                                               t[3], True)
    assert torch.isfinite(dq2).all()
    assert torch.equal(dq[:, :-1], dq2[:, :-1])


# --- RMSNorm backward ------------------------------------------------------

def test_rms_norm_grads_match_jax_vjp():
    x = _rng(6).standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * _rng(7).standard_normal(64)).astype(np.float32)
    g = _rng(8).standard_normal((3, 5, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_: j_rms_norm(x_, w_, 1e-5),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = trms.rms_norm(tx, tw, 1e-5)
    assert type(out.grad_fn).__name__ == "_RMSNormBackward"
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-5)
