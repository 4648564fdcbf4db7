"""The port's hand-written CUDA kernels against their plain versions.

The tests marked ``cuda`` launch each kernel on the card at small and
ragged shapes and hold it against its plain PyTorch version, as
chip_smoke.py does at the serving and training paths' shapes; without a
GPU they skip. This file imports no JAX, so it also runs on a machine without
it: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import dataclasses

import pytest
import torch

from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.ops import quant_matmul as tqm
from ray_tpu_torch.ops import rmsnorm as trms


@pytest.mark.parametrize("m,k,n,sms,want", [
    (8, 4096, 14336, 132, 3),      # decode w1/w3: split K to fill the card
    (8, 14336, 4096, 132, 9),      # decode w2
    (1024, 4096, 14336, 132, 1),   # prefill: enough tiles already
])
def test_int8_split_k_plan(m, k, n, sms, want):
    assert tqm._mm_plan(m, k, n, sms).splits == want


@pytest.mark.parametrize("m", [1, 3, 8, 16, 17, 32, 33, 64, 512, 1024])
@pytest.mark.parametrize("k", [64, 96, 4096, 14336])
@pytest.mark.parametrize("n", [1000, 4096, 11008, 14336])
def test_int8_plan_covers_every_k_once(m, k, n):
    plan = tqm._mm_plan(m, k, n, 132)
    depth = 64
    assert plan.block_m == (8 if m <= 8 else 16 if m <= 16 else
                            32 if m <= 32 else 128)
    assert plan.block_n == (128 if m <= 32 else 256)
    assert plan.tiles == -(-m // plan.block_m) * -(-n // plan.block_n)
    # the splits cut [0, k) into whole stages, none of them empty
    assert plan.k_per_split % depth == 0
    assert (plan.splits - 1) * plan.k_per_split < k \
        <= plan.splits * plan.k_per_split
    # split only while the grid holds fewer blocks than the SMs hold at
    # once (two decode blocks or one prefill block each), and keep four
    # stages per split
    per_sm = 2 if m <= 32 else 1
    if plan.splits > 1:
        assert (plan.splits - 1) * plan.tiles < per_sm * 132
        assert plan.k_per_split >= 4 * depth
    elif k >= 8 * depth:
        assert plan.tiles >= per_sm * 132


def _live_pairs(q_rows, k_cols, sq, sk, causal):
    """Live (query, key) pairs between query rows and key columns."""
    off = sk - sq
    return sum(1 for i in q_rows if i < sq for j in k_cols
               if j < sk and (not causal or j <= i + off))


# 72: the partials keep the tensors' head_dim, not the kernel's 128-wide
# tile
@pytest.mark.parametrize("d", [64, 72, 128])
@pytest.mark.parametrize("s", [1, 63, 200, 2048])
@pytest.mark.parametrize("h,kvh", [(8, 8), (8, 4), (8, 2), (28, 4),
                                   (32, 4), (32, 2)])  # groups 1-16
def test_flash_backward_plan(h, kvh, s, d):
    b = 2
    plan = tatt._bwd_plan(b, s, s, h, kvh, d, causal=True)
    n_q, n_k = -(-s // 128), -(-s // 128)
    assert plan.group == h // kvh
    assert plan.dq_blocks == n_q * h * b and plan.dkv_blocks == n_k * h * b
    assert sorted(plan.dq_order) == list(range(n_q))
    assert sorted(plan.dkv_order) == list(range(n_k))
    # heaviest first along the causal triangle
    dq_work = [_live_pairs(range(128 * t, 128 * t + 128), range(s), s, s,
                           True) if s <= 200 else (t + 1)
               for t in plan.dq_order]
    dkv_work = [_live_pairs(range(s), range(128 * t, 128 * t + 128), s, s,
                            True) if s <= 200 else (n_k - t)
                for t in plan.dkv_order]
    assert dq_work == sorted(dq_work, reverse=True)
    assert dkv_work == sorted(dkv_work, reverse=True)
    # K3 splits the group: one block per query head, f32 partials for a
    # group of more than one head
    if h == kvh:
        assert plan.scratch_shape is None and plan.scratch_bytes == 0
    else:
        assert plan.scratch_shape == (b, s, h, d)
        assert plan.scratch_bytes == 2 * 4 * b * s * h * d
    if (s, h, kvh, d) == (2048, 32, 4, 128):
        # K3 splits the GQA group: at least two blocks per SM of the H100
        assert tatt._bwd_plan(1, s, s, 32, 8, d).dkv_blocks >= 2 * 132


@pytest.mark.parametrize("s", [1, 63, 128, 200, 512, 2048])
@pytest.mark.parametrize("h,kvh", [(8, 8), (8, 4), (8, 2), (32, 8),
                                   (32, 4), (32, 2)])  # groups 1-16
@pytest.mark.parametrize("b", [1, 2])
def test_flash_forward_plan(h, kvh, s, b):
    plan = tatt._fwd_plan(b, s, h, causal=True)
    n_q = -(-s // 64)
    assert plan.tiles == n_q and plan.blocks == n_q * h * b
    # the kernel's block i takes query tile first + step * (i // (h b)):
    # every query tile once for each head and batch
    tiles = [plan.first + plan.step * (i // (h * b))
             for i in range(plan.blocks)]
    assert sorted(tiles) == sorted(list(range(n_q)) * h * b)
    assert tuple(tiles[::h * b]) == plan.order
    # heaviest first under the mask: a block's time is the key tiles it
    # runs (up to its last row's diagonal), whole tiles of 64 keys
    work = [-(-min(s, 64 * (t + 1)) // 64) for t in plan.order]
    assert work == sorted(work, reverse=True)
    assert work[0] == -(-s // 64)
    assert tatt._fwd_plan(b, s, h, causal=False).order == tuple(range(n_q))


def test_flash_forward_plan_fills_the_card_at_serving_buckets():
    """The engine's prefill buckets at Llama-3-8B's 32 heads: two 64-row
    blocks run on each SM, so from S 1024 the grid fills the H100's 132
    SMs twice over."""
    for s, blocks in ((32, 32), (128, 64), (512, 256), (1024, 512),
                      (2048, 1024)):
        plan = tatt._fwd_plan(1, s, 32)
        assert plan.blocks == blocks
        assert (plan.blocks >= 2 * 132) == (s >= 1024)


def test_flash_backward_plan_noncausal_keeps_order():
    plan = tatt._bwd_plan(1, 300, 300, 4, 1, 64, causal=False)
    assert plan.dq_order == (0, 1, 2) and plan.dkv_order == (0, 1, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,causal", [
    (1, 1, 128, True), (7, 7, 128, True), (64, 64, 128, True),
    (200, 200, 128, True), (5, 77, 128, True),   # offset Sk - Sq
    (70, 70, 64, True), (33, 90, 64, False)])
def test_flash_kernel_matches_plain_on_card(cuda_device, sq, sk, d, causal):
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(s, h):
        return torch.randn((2, s, h, d), generator=g,
                           device=cuda_device).bfloat16()

    q, k, v = rand(sq, 8), rand(sk, 2), rand(sk, 2)
    out, lse = tatt._flash_forward(q, k, v, causal)
    ref = tatt._attention_reference(q, k, v, causal)
    # bf16 output and bf16 P before P.V: about one bf16 step
    diff = out.float() - ref.float()
    assert diff.abs().max().item() <= 2e-2
    # and per query position, where long rows' small outputs would hide
    # an error from the max abs limit
    row_rel = (torch.linalg.vector_norm(diff, dim=(2, 3))
               / torch.linalg.vector_norm(ref.float(), dim=(2, 3)))
    assert row_rel.max().item() <= 1e-2
    # lse = logsumexp of the scaled, masked scores, in f32
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     tatt._repeat_kv(k, 8).float()) * d ** -0.5
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=cuda_device).tril(sk - sq)
        s = s.masked_fill(~mask, tatt.NEG_INF)
    assert torch.allclose(lse, torch.logsumexp(s, dim=-1), atol=1e-3)


def _check_fwd(q, k, v, causal):
    """K1's o within a bf16 step of the plain version, every query row
    within 1e-2 relative L2, and lse within 1e-3 of logsumexp."""
    h = q.shape[2]
    out, lse = tatt._flash_forward(q, k, v, causal)
    ref = tatt._attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    diff = out.float() - ref.float()
    assert diff.abs().max().item() <= 2e-2
    row_rel = (torch.linalg.vector_norm(diff, dim=(2, 3))
               / torch.linalg.vector_norm(ref.float(), dim=(2, 3)))
    assert row_rel.max().item() <= 1e-2
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                      tatt._repeat_kv(k, h).float()) * q.shape[-1] ** -0.5
    if causal:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril(k.shape[1] - q.shape[1])
        sc = sc.masked_fill(~mask, tatt.NEG_INF)
    assert (lse - torch.logsumexp(sc, dim=-1)).abs().max().item() <= 1e-3
    return out, lse


def _rand_qkv(dev, b, sq, sk, h, kvh, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((b, s, n, d), generator=g, device=dev).bfloat16()
                 for s, n in ((sq, h), (sk, kvh), (sk, kvh)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 7, 63, 64, 65, 127, 128, 129, 200, 2048])
def test_flash_forward_llama_heads_on_card(cuda_device, s, d):
    """H32 KVH8 at the serving buckets, ragged lengths and the training
    length."""
    _check_fwd(*_rand_qkv(cuda_device, 1, s, s, 32, 8, d), True)


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh", [(8, 8), (8, 4), (8, 2), (8, 1),
                                   (16, 1)])  # GQA groups 1-16
@pytest.mark.parametrize("sq,sk,causal", [(200, 200, True),
                                          (70, 300, True),  # Sq < Sk
                                          (130, 90, False)])
def test_flash_forward_gqa_groups_on_card(cuda_device, h, kvh, sq, sk,
                                         causal):
    for d in (64, 128):
        _check_fwd(*_rand_qkv(cuda_device, 2, sq, sk, h, kvh, d), causal)


@pytest.mark.cuda
def test_flash_forward_is_deterministic_on_card(cuda_device):
    q, k, v = _rand_qkv(cuda_device, 1, 700, 700, 32, 8, 128, seed=3)
    o1, l1 = tatt._flash_forward(q, k, v, True)
    o2, l2 = tatt._flash_forward(q, k, v, True)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.cuda
def test_flash_forward_reads_fused_projection_on_card(cuda_device):
    """q/k/v as strided slices of one fused [B, S, H + 2 KVH, D] tensor."""
    qkv = torch.randn((1, 300, 32 + 8 + 8, 128),
                      device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]
    assert not q.is_contiguous()
    _check_fwd(q, k, v, True)


@pytest.mark.cuda
def test_flash_attention_grads_match_plain_on_card(cuda_device):
    """Through _FlashAttention (K1, then K2/K3 from its o and lse) the
    grads match autograd of the plain version."""
    q, k, v = _rand_qkv(cuda_device, 1, 300, 300, 8, 2, 128, seed=4)
    do = torch.randn_like(q)
    grads = []
    for fn in (tatt.flash_attention, tatt._attention_reference):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, True).backward(do)
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        assert _rel_l2(got, ref).item() <= 2e-2


@pytest.mark.cuda
def test_flash_kernel_reads_strided_inputs(cuda_device):
    """q/k/v as views of one fused projection, as a model may pass."""
    qkv = torch.randn((1, 50, 3 * 4, 128), device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    assert not q.is_contiguous()
    out = tatt.flash_attention(q, k, v, True)
    ref = tatt._attention_reference(q, k, v, True)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_run(cuda_device):
    q = torch.randn((1, 8, 2, 32), device=cuda_device).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        tatt.flash_attention(q, q, q)
    q64 = torch.randn((1, 8, 2, 64), device=cuda_device)
    with pytest.raises(TypeError):
        tatt.flash_attention(q64, q64, q64)
    # K4 takes any width (d 12: the masked scalar path) but no int type
    x12 = torch.randn((2, 12), device=cuda_device)
    w12 = torch.randn(12, device=cuda_device)
    got = trms.rms_norm(x12, w12)
    assert (got - trms._rms_norm_reference(x12, w12, 1e-6)).abs().max() \
        <= 1e-4
    with pytest.raises(TypeError):
        trms.rms_norm(torch.ones((2, 12), dtype=torch.int32,
                                 device=cuda_device),
                      torch.ones(12, dtype=torch.int32, device=cuda_device))
    w8, s = tqm.quantize_int8(torch.randn((64, 32), device=cuda_device))
    with pytest.raises(TypeError):
        tqm.int8_matmul(torch.randn((2, 64), device=cuda_device), w8, s)


@pytest.mark.cuda
def test_kernel_launches_are_counted(cuda_device):
    tatt.flash_attention.launches = 0
    trms.rms_norm.launches = 0
    x = torch.randn((4, 64), device=cuda_device)
    trms.rms_norm(x, torch.ones(64, device=cuda_device))
    q = torch.randn((1, 8, 2, 64), device=cuda_device).bfloat16()
    tatt.flash_attention(q, q, q)
    assert (tatt.flash_attention.launches, trms.rms_norm.launches) == (1, 1)


def _check_rms(x, w):
    got = trms.rms_norm(x, w, 1e-5)
    ref = trms._rms_norm_reference(x, w, 1e-5)
    assert got.shape == x.shape and got.dtype == x.dtype
    # f32: the order of the sum and rsqrtf; 16 bits: one output rounding
    tol = 1e-4 if x.dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", [
    (1, 64, torch.float32), (8, 4096, torch.bfloat16),
    (37, 4096, torch.bfloat16), (2048, 4096, torch.bfloat16),
    (3, 12, torch.float32), (5, 4100, torch.bfloat16),
    (4, 4096, torch.float16), (8, 16384, torch.bfloat16),
    # rows past 2048 slots: the chunked path, vector and scalar
    (3, 40000, torch.float32), (2, 70001, torch.bfloat16)])
def test_rms_kernel_matches_plain_on_card(cuda_device, rows, d, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(rows + d)
    x = torch.randn((rows, d), generator=g, device=cuda_device).to(dtype)
    w = torch.randn((d,), generator=g, device=cuda_device).to(dtype)
    _check_rms(x, w)


@pytest.mark.cuda
def test_rms_kernel_reads_unaligned_rows(cuda_device):
    """x sliced one element into a buffer: not 16-byte aligned, so the
    plan takes the masked scalar path."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    buf = torch.randn((8 * 4096 + 1,), generator=g,
                      device=cuda_device).bfloat16()
    x = buf[1:].view(8, 4096)
    assert x.data_ptr() % 16
    w = torch.randn((4096,), generator=g, device=cuda_device).bfloat16()
    _check_rms(x, w)


@pytest.mark.cuda
def test_rms_kernel_refuses_a_plan_that_misses_columns(cuda_device):
    x = torch.randn((2, 4096), device=cuda_device).bfloat16()
    w = torch.ones(4096, device=cuda_device).bfloat16()
    out = torch.empty_like(x)
    plan = trms._rms_plan(4096, torch.bfloat16, True)
    entry = trms._rt_rms_norm()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(threads, vecs, chunks):
        return entry(x.data_ptr(), w.data_ptr(), out.data_ptr(), 2, 4096,
                     1e-5, 1, threads, vecs, 1, chunks, stream)

    assert launch(plan.threads, plan.vecs, plan.chunks) == 0
    assert launch(plan.threads // 2, plan.vecs, 1) != 0     # half a row
    assert launch(plan.threads, plan.vecs, 2) != 0          # empty chunk
    assert launch(48, 11, 1) != 0                          # no such plan
    assert launch(1024, 1, 1) != 0                         # > 512 threads
    torch.cuda.synchronize()


def _check_int8(x, w8, s):
    got = tqm.int8_matmul(x, w8, s)
    ref = tqm._int8_matmul_reference(x, w8, s)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    rel = ((got.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel < 2e-2
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (1, 64, 1000), (17, 4096, 512), (8, 100, 40),
    # every M boundary (decode 8 / 16 / 32 tokens, prefill 128) at K4096
    # N4096
    *[(m, 4096, 4096) for m in (1, 3, 8, 16, 17, 32, 33, 64, 512, 1024)],
    # every N at decode, every K at both block shapes
    *[(8, 4096, n) for n in (1000, 11008, 14336)],
    *[(m, k, 1000) for m in (17, 33) for k in (64, 96, 4096, 14336)],
    # the serving path's shapes
    (8, 14336, 4096), (1024, 4096, 14336), (64, 14336, 11008),
    (3, 96, 11008), (16, 64, 14336)])
def test_int8_kernel_matches_plain_on_card(cuda_device, m, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w8, s = tqm.quantize_int8(
        torch.randn((k, n), generator=g, device=cuda_device))
    x = torch.randn((m, k), generator=g, device=cuda_device).bfloat16()
    _check_int8(x, w8, s)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 4096, 4096), (24, 512, 1000),
                                   (100, 512, 1024)])
def test_int8_kernel_reads_unaligned_bases_on_card(cuda_device, m, k, n):
    """x and w8 as contiguous slices at offset 1: not 16-byte aligned, so
    the kernel stages them by plain loads."""
    w8, s = tqm.quantize_int8(torch.randn((k, n), device=cuda_device))
    wbuf = torch.empty(k * n + 1, dtype=torch.int8, device=cuda_device)
    wbuf[1:] = w8.reshape(-1)
    xbuf = torch.randn(m * k + 1, device=cuda_device).bfloat16()
    x, w8u = xbuf[1:].view(m, k), wbuf[1:].view(k, n)
    assert x.data_ptr() % 16 and w8u.data_ptr() % 16 and w8u.is_contiguous()
    _check_int8(x, w8u, s)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 14336, 4096), (3, 4096, 11008),
                                   (32, 4096, 4096), (512, 4096, 1000)])
def test_int8_kernel_is_deterministic_on_card(cuda_device, m, k, n):
    """Bit-equal across calls: split-K partials are summed in split order
    by a second launch, whichever block finishes first."""
    w8, s = tqm.quantize_int8(torch.randn((k, n), device=cuda_device))
    x = torch.randn((m, k), device=cuda_device).bfloat16()
    first = tqm.int8_matmul(x, w8, s)
    for _ in range(3):
        assert torch.equal(tqm.int8_matmul(x, w8, s), first)


def _rel_l2(got, ref, dim=None):
    """Relative L2 error, the reference's norm floored at an RMS of 1e-4
    per element: some rows are exactly 0 (dq of a query that sees one
    key), where the kernel's f32 rounding noise has no scale to be
    relative to."""
    diff = got.float() - ref.float()
    n = diff.numel() if dim is None else diff[0, 0].numel()
    floor = 1e-4 * n ** 0.5
    return (torch.linalg.vector_norm(diff, dim=dim)
            / torch.linalg.vector_norm(ref.float(), dim=dim).clamp_min(floor))


def _check_bwd(q, k, v, do, causal):
    o, lse = tatt._flash_forward(q, k, v, causal)
    delta = tatt._delta(o, do)
    dq = tatt.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tatt.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    rq = tatt._bwd_dq_reference(q, k, v, do, lse, delta, causal)
    rk, rv = tatt._bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        # P and dS rounded to bf16 as operands on both sides; the sums'
        # order and the bf16 outputs differ: about one bf16 step
        assert _rel_l2(got, ref).item() <= 2e-2
        # per row (query row of dq, key row of dk/dv), where a row with
        # few live pairs would hide in the whole tensor
        assert _rel_l2(got, ref, dim=(2, 3)).max().item() <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,h,kvh,causal,b", [
    (1, 1, 128, 4, 4, True, 2), (63, 63, 128, 8, 2, True, 2),
    (200, 200, 128, 8, 2, True, 2), (5, 77, 128, 4, 1, True, 2),  # Sq < Sk
    (70, 70, 64, 4, 2, True, 2), (33, 90, 64, 4, 4, False, 2),
    (200, 130, 128, 8, 2, False, 2), (128, 128, 64, 2, 1, True, 2),
    # GQA groups of 1, 4, 7, 8 and one above the portable cluster size
    (300, 300, 128, 3, 3, True, 2), (257, 257, 128, 8, 2, True, 2),
    (190, 190, 64, 7, 1, True, 2), (150, 150, 128, 16, 2, True, 1),
    (100, 260, 128, 16, 1, True, 1), (130, 130, 64, 11, 1, True, 1),
    (140, 140, 128, 12, 1, False, 1),
    # the training path's attention shape
    (2048, 2048, 128, 32, 8, True, 1)])
def test_flash_backward_kernels_match_plain_on_card(cuda_device, sq, sk, d,
                                                     h, kvh, causal, b):
    g = torch.Generator(device=cuda_device).manual_seed(1)

    def rand(s, heads):
        return torch.randn((b, s, heads, d), generator=g,
                           device=cuda_device).bfloat16()

    _check_bwd(rand(sq, h), rand(sk, kvh), rand(sk, kvh), rand(sq, h),
               causal)


@pytest.mark.cuda
def test_flash_backward_kernels_are_deterministic_on_card(cuda_device):
    """Two calls give bit-equal dQ, dK and dV (no float atomics; the GQA
    sum runs in a fixed head order)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, do = (torch.randn((1, 512, 8, 128), generator=g,
                         device=cuda_device).bfloat16() for _ in range(2))
    k, v = (torch.randn((1, 512, 2, 128), generator=g,
                        device=cuda_device).bfloat16() for _ in range(2))
    o, lse = tatt._flash_forward(q, k, v, True)
    first = tatt._flash_backward(q, k, v, o, lse, do, True)
    second = tatt._flash_backward(q, k, v, o, lse, do, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_backward_kernels_read_strided_inputs(cuda_device):
    """q/k/v as views of one fused projection, dO as a transposed view."""
    qkv = torch.randn((1, 90, 4 + 2 + 2, 128), device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    do = torch.randn((1, 4, 90, 128), device=cuda_device).bfloat16() \
        .transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    _check_bwd(q, k, v, do, True)


@pytest.mark.cuda
def test_flash_backward_row_without_keys_is_zero_on_card(cuda_device):
    q = torch.randn((1, 5, 2, 64), device=cuda_device).bfloat16()
    k = torch.zeros((1, 0, 2, 64), device=cuda_device).bfloat16()
    q.requires_grad_()
    out = tatt.flash_attention(q, k, k.clone().requires_grad_(), False)
    out.backward(torch.randn_like(out))
    assert torch.equal(out.detach(), torch.zeros_like(out))
    assert torch.equal(q.grad, torch.zeros_like(q))


@pytest.mark.cuda
def test_training_grads_reach_every_parameter_on_card(cuda_device):
    """The graph survives the kernels: a 1-layer model's loss backward
    leaves a finite grad on every parameter, through K1/K2/K3 and K4."""
    cfg = dataclasses.replace(
        tl.LlamaConfig.tiny(dtype=torch.bfloat16, attention="flash",
                            remat=True, ce_chunk_tokens=16),
        dim=256, n_heads=2, n_kv_heads=1, n_layers=1)
    params = tl.unstack_layers(tl.llama_init(0, cfg, device=cuda_device))
    leaves = [params["embedding"], params["final_norm"], params["lm_head"],
              *params["layers"][0].values()]
    for t in leaves:
        t.requires_grad_(True)
    counts = (tatt.flash_attention.launches,
              tatt.flash_attention_bwd_dq.launches,
              tatt.flash_attention_bwd_dkv.launches, trms.rms_norm.launches)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    loss = tl.llama_loss(params, toks, toks, cfg)
    loss.backward()
    assert torch.isfinite(loss)
    for t in leaves:
        assert t.grad is not None and torch.isfinite(t.grad).all()
    after = (tatt.flash_attention.launches,
             tatt.flash_attention_bwd_dq.launches,
             tatt.flash_attention_bwd_dkv.launches, trms.rms_norm.launches)
    # remat: K1 in the forward and again in the recompute; K4 2L+1 and 2L
    assert [a - b for a, b in zip(after, counts)] == [2, 1, 1, 5]


@pytest.mark.cuda
def test_training_wrappers_refuse_what_they_cannot_run(cuda_device):
    q = torch.randn((1, 8, 2, 96), device=cuda_device).bfloat16()
    q.requires_grad_()
    with pytest.raises(ValueError, match="head_dim"):
        tatt.flash_attention(q, q, q)
    q32 = torch.randn((1, 8, 2, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(TypeError):
        tatt.flash_attention(q32, q32, q32)
    lse = torch.zeros((1, 2, 8), device=cuda_device)
    qb = q32.detach().bfloat16()
    with pytest.raises(ValueError, match="lse"):
        tatt.flash_attention_bwd_dq(qb, qb, qb, qb, lse.double(), lse, True)
    w8, s = tqm.quantize_int8(torch.randn((64, 32), device=cuda_device))
    x = torch.randn((2, 64), device=cuda_device).bfloat16()
    with pytest.raises(RuntimeError, match="backward"):
        tqm.int8_matmul(x.requires_grad_(), w8, s)


@pytest.mark.cuda
def test_int8_serving_of_an_f32_model_on_the_card(cuda_device):
    """The tiny f32 config served with int8 FFN weights: ``_ffn`` hands
    K5 x in bf16 and casts its result back, so the card serves it (the
    wrapper refuses f32 x). Every request finishes with its tokens; the
    stream need not equal the CPU's f32 one."""
    from ray_tpu_torch.llm import engine as te
    config = te.EngineConfig(model=tl.LlamaConfig.tiny(), max_batch=2,
                             max_seq=64, quantization="int8")
    params = tl.llama_init(0, config.model, device="cpu")
    streams = []
    for dev in ("cpu", cuda_device):
        on_dev = {k: ({n: t.to(dev) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in params.items()}
        engine = te.ContinuousBatchingEngine(config, params=on_dev,
                                             device=dev)
        before = tqm.int8_matmul.launches
        streams.append(engine.generate([[1, 2, 3], [7, 8]], max_tokens=8))
    # three FFN products a layer in 2 prefills and 7 decode steps
    assert tqm.int8_matmul.launches - before == 3 * 2 * (2 + 7)
    assert all(len(o) == 8 and all(0 <= t < 256 for t in o)
               for o in streams[1])
    print("int8 f32 tiny, card:", streams[1], "cpu:", streams[0])


def _tiny_server(dev, **engine_kw):
    """The port's LLMServer over the tiny f32 config (byte vocab), on
    ``dev``, with weights made on the CPU from seed 0."""
    from ray_tpu_torch.llm import engine as te
    from ray_tpu_torch.serve import llm as ts
    cfg = tl.LlamaConfig.tiny(vocab_size=258, max_seq_len=64)
    params = tl.llama_init(0, cfg, device="cpu")
    on_dev = {k: ({n: t.to(dev) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in params.items()}
    return ts.LLMServer(ts.LLMConfig(model_id="tiny", engine=te.EngineConfig(
        model=cfg, max_batch=4, max_seq=64, **engine_kw), max_tokens=8),
        params=on_dev, device=dev)


def _close(got, want, tol):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            if k != "id":
                _close(got[k], want[k], tol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (got, want)
    else:
        assert got == want


@pytest.mark.cuda
def test_llm_server_on_the_card_equals_the_cpu(cuda_device):
    """Greedy, logprobs, penalties, guided JSON, embeddings and score
    through the tiny f32 LLMServer on the card and on the CPU: the same
    texts and usage, logprobs and embeddings within 1e-4."""
    bodies = [
        ("completions", {"prompt": "hello", "max_tokens": 8,
                         "logprobs": 3}),
        ("completions", {"prompt": "hello", "max_tokens": 10,
                         "presence_penalty": 1.0, "stop": ["M"]}),
        ("chat_completions", {"messages": [{"role": "user",
                                            "content": "hi"}],
                              "max_tokens": 20,
                              "response_format": {"type": "json_object"}}),
        ("embeddings", {"input": ["abc", "hello world"]}),
        ("score", {"text_1": "abc", "text_2": ["abd", "xyz"]}),
    ]
    out = {}
    for dev in ("cpu", cuda_device):
        server = _tiny_server(dev)
        try:
            out[str(dev)] = [getattr(server, m)(dict(b)) for m, b in bodies]
        finally:
            server.stop()
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        assert "error" not in got, got
        _close(got, want, 1e-4)


@pytest.mark.cuda
def test_embed_on_a_request_thread_while_the_stepper_decodes(cuda_device):
    """``embeddings`` on the caller's threads while the stepper decodes
    other requests: every embedding equals the one made with the server
    idle, and the decoded texts equal those made alone."""
    import concurrent.futures as cf
    server = _tiny_server(cuda_device)
    try:
        texts = ["abc", "hello world", "x" * 40]
        alone = [server.embeddings({"input": t}) for t in texts]
        solo = server.completions({"prompt": "go", "max_tokens": 40})
        before = trms.rms_norm.launches
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            decodes = [pool.submit(server.completions,
                                   {"prompt": "go", "max_tokens": 40})
                       for _ in range(2)]
            embeds = [pool.submit(server.embeddings, {"input": t})
                      for t in texts * 3]
            for fut, want in zip(embeds, alone * 3):
                _close(fut.result(), want, 1e-5)
            for fut in decodes:
                assert fut.result()["choices"] == solo["choices"]
        assert trms.rms_norm.launches > before
    finally:
        server.stop()


@pytest.mark.cuda
def test_stepper_thread_launches_on_the_engine_device(cuda_device):
    """The stepper thread makes the engine's device current before it
    steps (a new thread starts on device 0), so its launches land
    there; on a machine with several cards the engine takes the last."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    server = _tiny_server(dev)
    seen = []
    step = server.engine.step

    def spy():
        seen.append(torch.cuda.current_device())
        return step()

    server.engine.step = spy
    try:
        out = server.completions({"prompt": "hi", "max_tokens": 4})
        assert out["choices"][0]["finish_reason"] == "length"
        assert seen and set(seen) == {dev.index}
        assert server.embeddings({"input": "abc"})["data"]
    finally:
        server.stop()


def test_launch_counts_lose_nothing_across_threads():
    """A server's stepper and request threads count launches at once:
    8 threads x 20000 counts with a short switch interval lose none."""
    import sys
    import threading
    from ray_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = 0

    def count():
        for _ in range(20000):
            _build.count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 8 * 20000


# --- the vision and diffusion models' shapes, and the MoE FFN ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,causal", [
    (8, 197, 12, False),   # ViT-B/16 at 224^2 with its class token
    (4, 256, 12, False),   # DiT-B/2 on 32 x 32 x 4 latents
    (8, 77, 8, True),      # the CLIP text tower
    (2, 77, 8, False), (2, 197, 12, True), (64, 197, 12, False)])
def test_flash_kernels_at_vision_shapes_on_card(cuda_device, b, s, h,
                                                causal):
    """K1-K3 with no GQA group (H = KVH), head_dim 64, ragged lengths."""
    q, k, v = _rand_qkv(cuda_device, b, s, s, h, h, 64, seed=5)
    _check_fwd(q, k, v, causal)
    _check_bwd(q, k, v, torch.randn_like(q), causal)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kvh,causal", [
    (32, 256, 16, 16, False),   # DiT-XL/2 at 256^2
    (8, 1024, 16, 16, False),   # DiT-XL/2 at 512^2
    (4, 197, 16, 16, False), (4, 197, 16, 16, True),   # ragged S
    (4, 256, 16, 4, False), (4, 197, 16, 4, True),     # GQA group 4
    (2, 63, 4, 1, True), (2, 1, 4, 4, False)])
def test_flash_kernels_at_head_dim_72_on_card(cuda_device, b, s, h, kvh,
                                              causal):
    """K1-K3 at DiT-XL/2's head_dim (1152 / 16) against their plain
    versions, with the head_dim 64 and 128 rows' tolerances. The tiles
    are 128 columns wide, TMA fills columns 72-127 with zeros and the
    stores write only the 72 of each head: a head's padding written into
    its neighbour would show as an error in every head but the last."""
    q, k, v = _rand_qkv(cuda_device, b, s, s, h, kvh, 72, seed=6)
    out, _ = _check_fwd(q, k, v, causal)
    assert out.shape == (b, s, h, 72)
    _check_bwd(q, k, v, torch.randn_like(q), causal)


@pytest.mark.cuda
def test_dit_xl_layer_through_flash_on_card(cuda_device):
    """One DiT-XL/2 layer (1152 wide, 16 heads of 72) at 32 x 32 x 4
    latents, bf16 with remat, through the flash path: exactly K1 twice
    (forward and recompute), K2 and K3 once; the loss within 1e-2 and
    every grad within 1e-1 relative L2 of attention="reference" from the
    same weights and draws."""
    from ray_tpu_torch.models import dit as td
    from ray_tpu_torch.scripts.bench_train import parameters
    cfg = td.DiTConfig.xl_2(n_layers=1, n_classes=10)
    assert cfg.head_dim == 72 and cfg.attention == "flash" and cfg.remat
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = td.dit_init(0, cfg, device=cuda_device)
    for tree, name in ((params["layers"], "mod_w"),
                       (params["layers"], "mod_b"),
                       (params, "final_mod_w"), (params, "final_mod_b"),
                       (params, "final_w")):
        tree[name] = (0.02 * torch.randn(tree[name].shape, generator=g,
                                         device=cuda_device)).bfloat16()
    x0 = torch.randn((2, 32, 32, 4), generator=g, device=cuda_device)
    noise = td.draw_dit_noise(g, x0.shape, cuda_device)
    labels = torch.arange(2, device=cuda_device)
    kernels = (tatt.flash_attention, tatt.flash_attention_bwd_dq,
               tatt.flash_attention_bwd_dkv)
    out = {}
    for attention in ("flash", "reference"):
        leaves = [t.detach().clone().requires_grad_() for t in
                  parameters(params)]
        it = iter(leaves)

        def rebuild(tree):
            if isinstance(tree, dict):
                return {k: rebuild(v) for k, v in tree.items()}
            return next(it)

        before = [fn.launches for fn in kernels]
        loss = td.dit_loss(rebuild(params), noise, x0,
                           dataclasses.replace(cfg, attention=attention),
                           labels)
        loss.backward()
        torch.cuda.synchronize()
        out[attention] = (loss.item(), [t.grad for t in leaves],
                          [fn.launches - n for fn, n in zip(kernels, before)])
    assert out["flash"][2] == [2, 1, 1]
    assert out["reference"][2] == [0, 0, 0]
    assert abs(out["flash"][0] - out["reference"][0]) \
        <= 1e-2 * abs(out["reference"][0])
    for got, ref in zip(out["flash"][1], out["reference"][1]):
        assert got is not None and torch.isfinite(got).all()
        assert _rel_l2(got, ref).item() <= 1e-1


@pytest.mark.cuda
def test_flash_attention_refuses_uninstantiated_head_dim_on_card(
        cuda_device):
    """A head_dim with no kernel instance (96) raises on the card,
    forward and under autograd, naming the three it takes; the flash
    path never falls back to the plain version. A DiT at that head_dim
    runs there only with attention="reference"."""
    from ray_tpu_torch.models import dit as td
    q = torch.randn((2, 16, 4, 96), device=cuda_device).bfloat16()
    with pytest.raises(ValueError, match="head_dim 64, 72 or 128, not 96"):
        tatt.flash_attention(q, q, q, False)
    with pytest.raises(ValueError, match="head_dim 64, 72 or 128, not 96"):
        tatt.flash_attention(q.clone().requires_grad_(), q, q, False)
    cfg = td.DiTConfig.xl_2(n_layers=1, n_heads=12, input_size=8)
    assert cfg.head_dim == 96 and cfg.attention == "flash"
    params = td.dit_init(0, cfg, device=cuda_device)
    x = torch.zeros((1, 8, 8, 4), device=cuda_device)
    t = torch.full((1,), 0.5, device=cuda_device)
    before = tatt.flash_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        td.dit_forward(params, x, t, cfg)
    assert tatt.flash_attention.launches == before
    out = td.dit_forward(params, x, t, dataclasses.replace(
        cfg, attention="reference"))
    assert out.shape == x.shape and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["vit", "clip", "dit"])
def test_vision_models_flash_matches_reference_on_card(cuda_device, family):
    """One model, bf16 on the card, with attention="flash" (K1-K3) and
    "reference" from the same weights: the loss within 1e-2 and every
    grad within 1e-1 relative L2; the kernels launch K1 2L (remat), K2
    and K3 L times."""
    from ray_tpu_torch.models import dit as td
    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.scripts.bench_train import parameters
    g = torch.Generator(device=cuda_device).manual_seed(0)
    bf16 = dict(dtype=torch.bfloat16, remat=True)
    if family == "vit":
        cfg = tv.ViTConfig.tiny(dim=128, n_heads=2, n_classes=10,
                                pool="cls", **bf16)
        params = tv.vit_init(0, cfg, device=cuda_device)
        images = torch.randn((4, 16, 16, 3), generator=g, device=cuda_device)
        labels = torch.arange(4, device=cuda_device)

        def loss_fn(p, c):
            return tv.vit_loss(p, images, labels, c)
    elif family == "clip":
        cfg = tv.CLIPConfig.tiny(
            vision=tv.ViTConfig.tiny(dim=128, n_heads=2, **bf16),
            text=tv.CLIPTextConfig.tiny(dim=128, n_heads=2, **bf16))
        params = tv.clip_init(0, cfg, device=cuda_device)
        images = torch.randn((4, 16, 16, 3), generator=g, device=cuda_device)
        tokens = torch.randint(0, 128, (4, 16), generator=g,
                               device=cuda_device)

        def loss_fn(p, c):
            return tv.clip_loss(p, images, tokens, c)
    else:
        cfg = td.DiTConfig.tiny(dim=128, n_heads=2, n_classes=4, **bf16)
        params = td.dit_init(0, cfg, device=cuda_device)
        # adaLN-Zero: every modulation and the output projection start
        # at zero, where most grads are zero; draw them instead
        for tree, name in ((params["layers"], "mod_w"),
                           (params["layers"], "mod_b"),
                           (params, "final_mod_w"), (params, "final_mod_b"),
                           (params, "final_w")):
            tree[name] = (0.05 * torch.randn(
                tree[name].shape, generator=g,
                device=cuda_device)).bfloat16()
        x0 = torch.randn((4, 8, 8, 3), generator=g, device=cuda_device)
        noise = td.draw_dit_noise(g, x0.shape, cuda_device)
        labels = torch.arange(4, device=cuda_device)

        def loss_fn(p, c):
            return td.dit_loss(p, noise, x0, c, labels)

    def with_attention(attention):
        if family == "clip":
            return dataclasses.replace(
                cfg, vision=dataclasses.replace(cfg.vision,
                                                attention=attention),
                text=dataclasses.replace(cfg.text, attention=attention))
        return dataclasses.replace(cfg, attention=attention)

    out = {}
    for attention in ("flash", "reference"):
        leaves = [t.detach().clone().requires_grad_() for t in
                  parameters(params)]
        it = iter(leaves)

        def rebuild(tree):
            if isinstance(tree, dict):
                return {k: rebuild(v) for k, v in tree.items()}
            return next(it)

        before = [fn.launches for fn in (
            tatt.flash_attention, tatt.flash_attention_bwd_dq,
            tatt.flash_attention_bwd_dkv)]
        loss = loss_fn(rebuild(params), with_attention(attention))
        loss.backward()
        after = [fn.launches for fn in (
            tatt.flash_attention, tatt.flash_attention_bwd_dq,
            tatt.flash_attention_bwd_dkv)]
        out[attention] = (loss.item(), [t.grad for t in leaves],
                          [a - b for a, b in zip(after, before)])
    n_layers = 4 if family == "clip" else 2
    assert out["flash"][2] == [2 * n_layers, n_layers, n_layers]
    assert out["reference"][2] == [0, 0, 0]
    assert abs(out["flash"][0] - out["reference"][0]) \
        <= 1e-2 * abs(out["reference"][0])
    for got, ref in zip(out["flash"][1], out["reference"][1]):
        assert torch.isfinite(got).all()
        assert _rel_l2(got, ref).item() <= 1e-1


@pytest.mark.cuda
def test_moe_ffn_on_card_matches_cpu(cuda_device):
    """The MoE layer in f32 on the card and the CPU (TF32 off): the same
    routing and dispatch, outputs within 1e-5."""
    from ray_tpu_torch.parallel import moe as tmoe
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 24, 32), generator=g)
    router = torch.randn((32, 4), generator=g)
    w1, w3 = (torch.randn((4, 32, 64), generator=g) / 32 ** 0.5
              for _ in range(2))
    w2 = torch.randn((4, 64, 32), generator=g) / 8
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = tmoe.top_k_gating(x[0].to(cuda_device), router.to(cuda_device),
                                2)
        y, aux = tmoe.moe_ffn(*(t.to(cuda_device) for t in
                                (x, router, w1, w3, w2)),
                              capacity_factor=1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want = tmoe.top_k_gating(x[0], router, 2)
    assert torch.equal(got[1].cpu(), want[1])
    y_cpu, aux_cpu = tmoe.moe_ffn(x, router, w1, w3, w2, capacity_factor=1.0)
    assert (y.cpu() - y_cpu).abs().max().item() <= 1e-5
    assert abs(aux.item() - aux_cpu.item()) <= 1e-6
