"""Times K1 and K5 at the serving and training paths' shapes.

    python -m ray_tpu_torch.scripts.bench_kernels [--tag NAME] [--only k1|k5]

Run from the root of a checkout (it uses ``chip_smoke.py``'s cold-L2
CUDA-graph timer, call timer and bounds). K1 (``flash_attention``, B1
H32 KVH8 D128, causal) is timed at S 128, 512, 1024 and 2048 beside
SDPA's forward; K5 (``int8_matmul``) at the FFN shapes of decode and
prefill, beside its bytes or operations bound. Each row is checked
against the plain version and printed as one JSON line tagged with
``--tag``, so that two trees (say a parent and a change) can be run in
turns within one call and compared. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

K1_SEQS = (128, 512, 1024, 2048)
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
    ap.add_argument("--only", choices=("k1", "k5"), default=None)
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
    if args.only in (None, "k5"):
        bench_k5(cs, dev, gen, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
