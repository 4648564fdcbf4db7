"""Times K1-K5 at the serving and training paths' shapes.

    python -m ray_tpu_torch.scripts.bench_kernels [--tag NAME]
        [--only k1|k4|k5|heads]

Run from the root of a checkout (it uses ``chip_smoke.py``'s cold-L2
CUDA-graph timer, call timer and bounds). K1 (``flash_attention``, B1
H32 KVH8 D128, causal) is timed at S 128, 512, 1024 and 2048 beside
SDPA's forward; K5 (``int8_matmul``) at the FFN shapes of decode and
prefill, beside its bytes or operations bound; K4 (``rms_norm``) at
8-2048 rows of 4096 in bf16 beside ``F.rms_norm`` (device time and call
time), its bytes bound and ``floor_ms``, the device time of one graph
node (a 1-element ``fill_``), with a host-side breakdown of the 8-row
call: the host clock per call and a cProfile of the wrapper. Each row
also times K4 and ``F.rms_norm`` behind the residual add that precedes
them in the model (``after_add_ms``, beside the add's own ``add_ms``).
In a tree with this K4 (its C entry and plan), K4 is also timed under
the other plans of K4_SWEEP and its host time is taken apart (a parent
tree skips both). ``heads``: K1, K2 and K3 (full mask, H = KVH 16) at
DiT-XL/2's attention shapes, B32 S256 and B8 S1024, at head_dim 64, 72
and 128, each beside its own bound, with ``_delta`` (the backward's
rowsum(dO O)): what the D 72 instance's 128-wide tiles cost against the
true width. Each row is checked
against the plain version and printed as one JSON line tagged with
``--tag``, so that two trees (say a parent and a change) can be run in
turns within one call and compared. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import cProfile
import functools
import json
import os
import pstats
import sys
import time

K1_SEQS = (128, 512, 1024, 2048)
# (batch, seq) of DiT-XL/2's attention at 256^2 and 512^2, 16 heads
HEADS_SHAPES = ((32, 256), (8, 1024))
HEAD_DIMS = (64, 72, 128)
K4_ROWS = (8, 32, 128, 512, 1024, 2048)
# K4 plans timed beside the chosen one at d 4096 in bf16: (threads per
# row, slots per thread)
K4_SWEEP = ((512, 1), (256, 2), (128, 4))
K5_SHAPES = ((8, 4096, 14336), (8, 14336, 4096), (3, 4096, 11008),
             (16, 4096, 14336), (32, 4096, 14336), (32, 14336, 4096),
             (64, 4096, 14336), (512, 4096, 14336), (512, 14336, 4096),
             (1024, 4096, 14336))


def bench_k1(cs, dev, gen, emit):
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att
    for s in K1_SEQS:
        q, k, v = (torch.randn((1, s, n, 128), generator=gen,
                               device=dev).bfloat16() for n in (32, 8, 8))
        out = att.flash_attention(q, k, v, True)
        ref = att._attention_reference(q, k, v, True)
        torch.cuda.synchronize()
        emit(kernel="K1", seq=s,
             max_abs_err=(out.float() - ref.float()).abs().max().item(),
             ms=cs.time_ms(att.flash_attention, q, k, v, True))
        qt, kt, vt = (t.transpose(1, 2) for t in
                      (q, att._repeat_kv(k, 32), att._repeat_kv(v, 32)))
        emit(kernel="SDPA", seq=s, ms=cs.time_ms(
            lambda *a: F.scaled_dot_product_attention(*a, is_causal=True),
            qt, kt, vt))


def bench_heads(cs, dev, gen, emit):
    import torch
    from ray_tpu_torch.ops import attention as att
    h = 16
    for b, s in HEADS_SHAPES:
        for d in HEAD_DIMS:
            q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                       device=dev).bfloat16()
                           for _ in range(4))
            o, lse = att._flash_forward(q, k, v, False)
            delta = att._delta(o, do)
            args = (q, k, v, do, lse, delta, False)
            ref = att._attention_reference(q, k, v, False)
            torch.cuda.synchronize()
            pairs = b * h * s * s
            qkv_bytes = 2 * b * s * h * d
            rows = (
                ("K1", att.flash_attention, (q, k, v, False),
                 4 * qkv_bytes + 4 * b * h * s, 4.0 * d * pairs),
                ("K2", att.flash_attention_bwd_dq, args,
                 5 * qkv_bytes + 8 * b * h * s, 6.0 * d * pairs),
                ("K3", att.flash_attention_bwd_dkv, args,
                 6 * qkv_bytes + 8 * b * h * s, 8.0 * d * pairs),
                ("delta", att._delta, (o, do), 2 * qkv_bytes + 4 * b * h * s,
                 2.0 * b * s * h * d))
            for name, fn, fn_args, nbytes, flops in rows:
                bms, by = cs.bound_ms(nbytes, flops,
                                      cs.F32_FLOPS if name == "delta"
                                      else cs.BF16_TENSOR_FLOPS)
                fields = dict(kernel=name, shape=[b, s, h, h, d],
                              ms=cs.time_ms(fn, *fn_args), bound_ms=bms,
                              bound_by=by)
                if name == "K1":
                    fields["max_abs_err"] = (o.float()
                                             - ref.float()).abs().max().item()
                emit(**fields)
            del q, k, v, do, o, lse, delta, args, ref
            torch.cuda.empty_cache()


def host_us(fn, iters: int = 2000) -> float:
    """Host time of one call, launch included (the device keeps up:
    nothing waits on it inside the loop)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return t * 1e6


def profile_us(fn, iters: int = 2000, top: int = 10):
    """cProfile of ``iters`` calls: the functions with the most own
    time, in us per call (cProfile's own cost inflates each)."""
    import torch
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(iters):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[2], f"{os.path.basename(k[0])}:{k[1]}({k[2]})")
                   for k, v in stats.items()), reverse=True)[:top]
    return [[name, t / iters * 1e6] for t, name in rows]


def bench_k4(cs, dev, gen, emit):
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import rmsnorm
    d, eps = 4096, 1e-5
    one = torch.zeros(1, device=dev)
    floor = cs.graph_ms([functools.partial(one.fill_, 1.0)])
    this_k4 = hasattr(rmsnorm, "_rt_rms_norm")
    for n in K4_ROWS:
        x = torch.randn((n, d), generator=gen, device=dev).bfloat16()
        w = (1 + 0.1 * torch.randn((d,), generator=gen,
                                   device=dev)).bfloat16()
        out = rmsnorm.rms_norm(x, w, eps)
        ref = rmsnorm._rms_norm_reference(x, w, eps)
        torch.cuda.synchronize()
        bms, by = cs.bound_ms(2 * (2 * n * d + d), 4.0 * n * d, cs.F32_FLOPS)
        r = torch.randn((n, d), generator=gen, device=dev).bfloat16()
        emit(kernel="K4", shape=[n, d],
             max_abs_err=(out.float() - ref.float()).abs().max().item(),
             ms=cs.time_ms(rmsnorm.rms_norm, x, w, eps),
             add_ms=cs.time_ms(torch.add, x, r),
             after_add_ms=cs.time_ms(
                 lambda x, r, w: rmsnorm.rms_norm(torch.add(x, r), w, eps),
                 x, r, w),
             library_after_add_ms=cs.time_ms(
                 lambda x, r, w: F.rms_norm(torch.add(x, r), (d,), w, eps),
                 x, r, w),
             call_ms=cs.call_ms(lambda: rmsnorm.rms_norm(x, w, eps)),
             library_ms=cs.time_ms(F.rms_norm, x, (d,), w, eps),
             library_call_ms=cs.call_ms(lambda: F.rms_norm(x, (d,), w, eps)),
             bound_ms=bms, bound_by=by, floor_ms=floor)
        if n == K4_ROWS[0]:
            emit(kernel="K4_host", shape=[n, d],
                 call_us=host_us(lambda: rmsnorm.rms_norm(x, w, eps)),
                 library_call_us=host_us(lambda: F.rms_norm(x, (d,), w, eps)),
                 empty_like_us=host_us(lambda: torch.empty_like(x)),
                 profile_us=profile_us(lambda: rmsnorm.rms_norm(x, w, eps)))
            if this_k4:
                host_split(emit, x, w, eps)
        if this_k4:
            sweep_k4(cs, emit, x, w, eps)


def sweep_k4(cs, emit, x, w, eps):
    """K4 under each plan of K4_SWEEP, launched through this tree's C
    entry, beside the plan rmsnorm._rms_plan picks."""
    import torch
    from ray_tpu_torch.ops import _build, rmsnorm
    n, d = x.shape
    entry = rmsnorm._rt_rms_norm()

    def run(threads, vecs, x, w, out):
        rc = entry(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, d, eps, 1,
                   threads, vecs, 1, 1, _build.stream_ptr(x.device))
        _build.check(rc, "rt_rms_norm")

    def after_add(threads, vecs, x, r, w, out):
        run(threads, vecs, torch.add(x, r), w, out)

    plan = rmsnorm._rms_plan(d, x.dtype, True)
    r = torch.randn_like(x)
    add_ms = cs.time_ms(torch.add, x, r)
    for threads, vecs in K4_SWEEP:
        out = torch.empty_like(x)
        run(threads, vecs, x, w, out)
        ref = rmsnorm._rms_norm_reference(x, w, eps)
        torch.cuda.synchronize()
        emit(kernel="K4_plan", shape=[n, d], plan=[threads, vecs],
             chosen=(threads, vecs) == (plan.threads, plan.vecs),
             max_abs_err=(out.float() - ref.float()).abs().max().item(),
             ms=cs.time_ms(functools.partial(run, threads, vecs), x, w, out),
             after_add_ms=cs.time_ms(
                 functools.partial(after_add, threads, vecs), x, r, w, out),
             add_ms=add_ms)


def host_split(emit, x, w, eps):
    """The 8-row call's host time taken apart, for this tree's wrapper:
    the C entry alone with rows 0 (ctypes, no launch) and with the
    launch, and the wrapper with the C entry replaced by a no-op."""
    import torch
    from ray_tpu_torch.ops import _build, rmsnorm
    n, d = x.shape
    entry = rmsnorm._rt_rms_norm()
    out = torch.empty_like(x)
    plan = rmsnorm._rms_plan(d, x.dtype, True)
    stream = _build.stream_ptr(x.device)
    args = [x.data_ptr(), w.data_ptr(), out.data_ptr(), n, d, eps, 1,
            plan.threads, plan.vecs, 1, plan.chunks, stream]
    ctypes_only = host_us(lambda: entry(*args[:3], 0, *args[4:]))
    with_launch = host_us(lambda: entry(*args))
    rmsnorm._entry = lambda *a: 0
    try:
        wrapper_only = host_us(lambda: rmsnorm.rms_norm(x, w, eps))
    finally:
        rmsnorm._entry = entry
    emit(kernel="K4_host_split", shape=[n, d], ctypes_us=ctypes_only,
         ctypes_launch_us=with_launch, wrapper_no_launch_us=wrapper_only,
         stream_ptr_us=host_us(lambda: _build.stream_ptr(x.device)),
         current_stream_us=host_us(
             lambda: torch.cuda.current_stream(x.device).cuda_stream))


def bench_k5(cs, dev, gen, emit):
    import torch
    from ray_tpu_torch.ops import quant_matmul as qm
    for m, k, n in K5_SHAPES:
        w8, scale = qm.quantize_int8(
            torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        got = qm.int8_matmul(x, w8, scale)
        ref = qm._int8_matmul_reference(x, w8, scale)
        torch.cuda.synchronize()
        rel = ((got.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        bms, by = cs.bound_ms(m * k * 2 + k * n + n * 4 + m * n * 2,
                              2.0 * m * k * n, cs.BF16_TENSOR_FLOPS)
        emit(kernel="K5", shape=[m, k, n], rel_max_err=rel, bound_ms=bms,
             bound_by=by, ms=cs.time_ms(qm.int8_matmul, x, w8, scale),
             call_ms=cs.call_ms(lambda: qm.int8_matmul(x, w8, scale)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--only", choices=("k1", "k4", "k5", "heads"),
                    default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs  # the timer and bounds of the smoke run
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def emit(**fields):
        print(json.dumps({"tag": args.tag, **fields}), flush=True)

    if args.only in (None, "k1"):
        bench_k1(cs, dev, gen, emit)
    if args.only in (None, "k4"):
        bench_k4(cs, dev, gen, emit)
    if args.only in (None, "k5"):
        bench_k5(cs, dev, gen, emit)
    if args.only in (None, "heads"):
        bench_heads(cs, dev, gen, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
