#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line: (1) the device, (2) the build of
every kernel from ``ray_tpu_torch/ops/csrc`` with nvcc, (3) each kernel
held against its plain PyTorch version on the card at the serving and
training paths' shapes, with its device time from a cold L2 (CUDA-graph
replay over copies of the inputs that overflow the L2), the time of a
call from Python, its plain version's time, the time of one PyTorch
call for the same function where there is one, and its bound,
(4) ``ContinuousBatchingEngine`` serving Llama-3-8B at full width and
depth in bf16 from random seeded weights, (5) the same engine with int8
FFN weights, (6) a 2-layer full-width prefill on the card against the
plain f32 version on the CPU, (7) training Llama-3-8B at full width and
depth (loss, backward, fused AdamW; remat and chunked cross-entropy) for
a warm-up and three timed steps on one fixed batch, (8) a 2-layer
full-width loss and its grads on the card against the plain f32
version on the CPU, (9) the kernel list. The backward is also timed whole, as the model
calls it (delta, K2, K3 and K3's group sum), against SDPA's backward. Every kernel's launch count is
zeroed just before each engine phase and each training step and read
just after; a kernel of the path that never launched fails the run, and
a training step must launch exactly K1 2L, K2 L, K3 L, K4 4L + 1 and K5
0 times. The last line is the device summary; any failed check exits
non-zero before it.

Needs a CUDA GPU and nvcc (CUDA_HOME or /usr/local/cuda); without a GPU,
or without the ``ray_tpu_torch`` package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is
# the larger of its bytes over the memory rate and its operations over
# the rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
COLD_BYTES = 4 * 50_000_000  # four times the H100's L2

SEED = 0
PROMPT_LENS = (17, 100, 300, 700)
NEW_TOKENS = 32
MAX_BATCH = 8
MAX_SEQ = 2048


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, flops: float, flops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def graph_ms(calls, reps: int = 5) -> float:
    """Device time of one of ``calls`` (functions of no argument, each
    over its own inputs). At least 20 calls, taking turns over
    ``calls``, are captured in one CUDA graph, which takes the host's
    launch cost out; the graph is replayed ``reps`` times between CUDA
    events and the median replay is divided by its calls."""
    import torch
    n_calls = max(20, len(calls))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls[:3]:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            calls[i % len(calls)]()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n_calls)
    del graph
    return sorted(times)[len(times) // 2]


def n_cold_copies(nbytes: int) -> int:
    """Copies of inputs of ``nbytes`` that fill COLD_BYTES."""
    return max(1, -(-COLD_BYTES // nbytes))


def time_ms(fn, *args, reps: int = 5) -> float:
    """Device time of one call ``fn(*args)`` with a cold L2, as the
    serving path finds its weights (each layer's were last read a whole
    step earlier): ``graph_ms`` over enough copies of the tensor
    arguments to fill COLD_BYTES, four times the 50 MB L2, so no call
    finds its inputs where an earlier one left them."""
    import torch

    def copy(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    arg_sets = [args] + [tuple(copy(a) for a in args)
                         for _ in range(n_cold_copies(nbytes) - 1)]
    return graph_ms([functools.partial(fn, *a) for a in arg_sets], reps)


def call_ms(fn, iters: int = 50) -> float:
    """Time of one call issued from Python, launch cost included:
    ``iters`` calls back to back between two CUDA events (inputs that
    fit the L2 stay warm there)."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_flash_attention(dev, gen):
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att
    b, h, kvh, d = 1, 32, 8, 128
    rows = []
    for s in (8, 128, 200, 512, 2048):
        q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
        out, lse = att._flash_forward(q, k, v, True)
        ref, ref_lse = att._flash_forward_reference(q, k, v, True)
        torch.cuda.synchronize()
        # lse is what K2 and K3 rebuild P from: every row within 1e-3
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= 1e-3, f"K1 S={s}: lse err {lse_err} > 1e-3")
        diff = out.float() - ref.float()
        err = diff.abs().max().item()
        # long rows have small outputs (about (e/i)^0.5 at row i), which
        # the max abs limit barely sees: hold every query position's
        # relative L2 error as well
        row_rel = (torch.linalg.vector_norm(diff, dim=(2, 3))
                   / torch.linalg.vector_norm(ref.float(), dim=(2, 3)))
        worst_row_rel = row_rel.max().item()
        rel_l2 = (torch.linalg.vector_norm(diff)
                  / torch.linalg.vector_norm(ref.float())).item()
        check(torch.isfinite(out).all().item(), f"K1 S={s}: non-finite")
        check(err <= 2e-2, f"K1 S={s}: max abs err {err} > 2e-2")
        check(worst_row_rel <= 1e-2,
              f"K1 S={s}: a row's relative L2 err {worst_row_rel} > 1e-2")
        qt, kt, vt = (t.transpose(1, 2) for t in
                      (q, att._repeat_kv(k, h), att._repeat_kv(v, h)))
        pairs = sum(min(i + 1, s) for i in range(s))
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kvh * d) + 4 * b * h * s
        bms, by = bound_ms(nbytes, 4.0 * b * h * d * pairs, BF16_TENSOR_FLOPS)
        rows.append(dict(
            shape=[b, s, h, kvh, d], max_abs_err=err, rel_l2_err=rel_l2,
            worst_row_rel_l2_err=worst_row_rel, lse_max_abs_err=lse_err,
            ms=time_ms(att.flash_attention, q, k, v, True),
            call_ms=call_ms(lambda: att.flash_attention(q, k, v, True)),
            plain_ms=time_ms(att._attention_reference, q, k, v, True),
            library_ms=time_ms(
                lambda *a: F.scaled_dot_product_attention(*a, is_causal=True),
                qt, kt, vt),
            bound_ms=bms, bound_by=by))
        emit("kernel_check", kernel="flash_attention", **rows[-1])
    return rows


def sdpa_backward_ms(q, k, v, do):
    """Device time of the backward of one causal
    ``F.scaled_dot_product_attention`` call on K/V repeated to every
    query head -> (ms, name of SDPA's backward node). Each cold copy of
    the inputs gets its own forward; ``graph_ms`` then captures calls of
    the autograd node that forward left, made directly (not through the
    autograd engine), so they run on the capturing stream."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att
    h = q.shape[2]
    base = [t.transpose(1, 2) for t in (q, att._repeat_kv(k, h),
                                        att._repeat_kv(v, h), do)]
    calls = []
    for _ in range(n_cold_copies(sum(t.numel() * t.element_size()
                                     for t in base))):
        qt, kt, vt = (t.clone().requires_grad_() for t in base[:3])
        node = F.scaled_dot_product_attention(qt, kt, vt,
                                              is_causal=True).grad_fn
        check("Attention" in node.name(),
              f"SDPA's output has no attention backward: {node.name()}")
        calls.append(functools.partial(node, base[3].clone()))
    return graph_ms(calls), node.name()


def rel_l2(diff, ref, dim=None):
    """Relative L2 error, the reference's norm floored at an RMS of 1e-4
    per element: dq of a query that sees one key is exactly 0, and the
    kernel's f32 rounding noise there has no scale to be relative to."""
    import torch
    n = diff.numel() if dim is None else diff[0, 0].numel()
    return (torch.linalg.vector_norm(diff, dim=dim)
            / torch.linalg.vector_norm(ref.float(), dim=dim).clamp_min(
                1e-4 * n ** 0.5))


def check_flash_backward(dev, gen):
    """K2 and K3 against their plain versions, from K1's o and lse and a
    seeded dO, at the training path's attention shapes."""
    import torch
    from ray_tpu_torch.ops import attention as att
    b, h, kvh, d = 1, 32, 8, 128
    rows = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": [],
            "backward": []}
    for s in (200, 512, 2048):
        q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
        do = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
        o, lse = att._flash_forward(q, k, v, True)
        delta = att._delta(o, do)
        args = (q, k, v, do, lse, delta, True)
        got = {"flash_attention_bwd_dq": (att.flash_attention_bwd_dq(*args),),
               "flash_attention_bwd_dkv": att.flash_attention_bwd_dkv(*args)}
        want = {"flash_attention_bwd_dq": (att._bwd_dq_reference(*args),),
                "flash_attention_bwd_dkv": att._bwd_dkv_reference(*args)}
        torch.cuda.synchronize()
        pairs = sum(min(i + 1, s) for i in range(s))
        in_bytes = 2 * (2 * b * s * h * d + 2 * b * s * kvh * d) + 8 * b * h * s
        library, library_op = sdpa_backward_ms(q, k, v, do)
        for name, flops, out_bytes, fn, plain in (
                ("flash_attention_bwd_dq", 6.0 * d * pairs * b * h,
                 2 * b * s * h * d, att.flash_attention_bwd_dq,
                 att._bwd_dq_reference),
                ("flash_attention_bwd_dkv", 8.0 * d * pairs * b * h,
                 4 * b * s * kvh * d, att.flash_attention_bwd_dkv,
                 att._bwd_dkv_reference)):
            errs = {}
            for tname, g_t, w_t in zip(("dq",) if name.endswith("dq")
                                       else ("dk", "dv"),
                                       got[name], want[name]):
                diff = g_t.float() - w_t.float()
                rel = rel_l2(diff, w_t).item()
                # per query row of dq, per key row of dk/dv
                worst = rel_l2(diff, w_t, dim=(2, 3)).max().item()
                check(bool(torch.isfinite(g_t).all()),
                      f"{name} S={s} {tname}: non-finite")
                check(rel <= 2e-2, f"{name} S={s} {tname}: relative L2 "
                      f"{rel} > 2e-2")
                check(worst <= 5e-2, f"{name} S={s} {tname}: a row's "
                      f"relative L2 {worst} > 5e-2")
                errs[tname] = dict(max_abs_err=diff.abs().max().item(),
                                   rel_l2_err=rel, worst_row_rel_l2_err=worst)
            bms, by = bound_ms(in_bytes + out_bytes, flops, BF16_TENSOR_FLOPS)
            rows[name].append(dict(
                shape=[b, s, h, kvh, d],
                max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                errors=errs, ms=time_ms(fn, *args),
                call_ms=call_ms(lambda: fn(*args)),
                plain_ms=time_ms(plain, *args),
                library_ms=library if name.endswith("dq") else None,
                library_op=library_op if name.endswith("dq") else None,
                bound_ms=bms, bound_by=by))
            emit("kernel_check", kernel=name, **rows[name][-1])
        rows["backward"].append(check_whole_backward(
            (q, k, v, o, lse, do), library, library_op,
            in_bytes - 4 * b * h * s + 2 * b * s * h * d
            + 2 * b * s * h * d + 2 * 2 * b * s * kvh * d,
            14.0 * d * pairs * b * h))
        del got, want, q, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    return rows


def check_whole_backward(args, library, library_op, nbytes, flops):
    """The backward as the model calls it (``_flash_backward``: delta,
    K2, K3 and K3's group sum) against its plain version and against
    SDPA's backward, which computes its own delta; with ``_delta``'s own
    time. ``nbytes``: q, k, v, o, do, lse in and dq, dk, dv out;
    ``flops``: K2's and K3's products, 14 D per live pair and head."""
    import torch
    from ray_tpu_torch.ops import attention as att
    got = att._flash_backward(*args, True)
    want = att._flash_backward_reference(*args, True)
    torch.cuda.synchronize()
    errs = {}
    for tname, g_t, w_t in zip(("dq", "dk", "dv"), got, want):
        diff = g_t.float() - w_t.float()
        errs[tname] = rel_l2(diff, w_t).item()
        check(errs[tname] <= 2e-2, f"_flash_backward {tname}: relative L2 "
              f"{errs[tname]} > 2e-2")
    q, k, v, o, lse, do = args
    bms, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
    row = dict(shape=[q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                      q.shape[3]], rel_l2_err=errs,
               ms=time_ms(att._flash_backward, *args, True),
               delta_ms=time_ms(att._delta, o, do),
               call_ms=call_ms(lambda: att._flash_backward(*args, True)),
               library_ms=library, library_op=library_op,
               bound_ms=bms, bound_by=by)
    row["over_library"] = row["ms"] / library
    emit("kernel_check", kernel="flash_backward", **row)
    return row


def check_rms_norm(dev, gen):
    """K4 at the decode, prefill-bucket and training row counts (bf16, d
    4096; the 8-row row is the headline), timed beside ``F.rms_norm``
    and ``floor_ms``, the device time of one graph node (a 1-element
    ``fill_``): the 8-row bytes bound is below any launch. Then f32,
    fp16, a ragged width (the masked scalar path) and d 16384, for
    correctness only."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import rmsnorm
    d, eps = 4096, 1e-5
    one = torch.zeros(1, device=dev)
    floor = graph_ms([functools.partial(one.fill_, 1.0)])

    def inputs(n, dd, dtype):
        x = torch.randn((n, dd), generator=gen, device=dev).to(dtype)
        w = (1 + 0.1 * torch.randn((dd,), generator=gen,
                                   device=dev)).to(dtype)
        out = rmsnorm.rms_norm(x, w, eps)
        ref = rmsnorm._rms_norm_reference(x, w, eps)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        check(bool(torch.isfinite(out).all()) and out.shape == x.shape,
              f"K4 {n}x{dd} {dtype}: non-finite or misshapen")
        check(err <= tol, f"K4 {n}x{dd} {dtype}: max abs err {err} > {tol}")
        return x, w, err

    rows = []
    for n in (8, 512, 1024, 2048):
        x, w, err = inputs(n, d, torch.bfloat16)
        bms, by = bound_ms(2 * (2 * n * d + d), 4.0 * n * d, F32_FLOPS)
        rows.append(dict(
            shape=[n, d], dtype="bfloat16", max_abs_err=err,
            ms=time_ms(rmsnorm.rms_norm, x, w, eps),
            call_ms=call_ms(lambda: rmsnorm.rms_norm(x, w, eps)),
            plain_ms=time_ms(rmsnorm._rms_norm_reference, x, w, eps),
            library_ms=time_ms(F.rms_norm, x, (d,), w, eps),
            library_call_ms=call_ms(lambda: F.rms_norm(x, (d,), w, eps)),
            floor_ms=floor, bound_ms=bms, bound_by=by))
        emit("kernel_check", kernel="rms_norm", **rows[-1])
    for n, dd, dtype in ((8, d, torch.float32), (8, d, torch.float16),
                         (5, 4100, torch.bfloat16),
                         (8, 16384, torch.bfloat16)):
        _, _, err = inputs(n, dd, dtype)
        rows.append(dict(shape=[n, dd], dtype=str(dtype)[6:],
                         max_abs_err=err))
        emit("kernel_check", kernel="rms_norm", **rows[-1])
    return rows


def check_int8_matmul(dev, gen):
    import torch
    from ray_tpu_torch.ops import quant_matmul as qm
    rows = []
    for m, k, n in ((8, 4096, 14336), (8, 14336, 4096), (512, 4096, 14336),
                    (1024, 4096, 14336), (3, 4096, 11008)):
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        w8, scale = qm.quantize_int8(w)
        del w
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        out = qm.int8_matmul(x, w8, scale)
        ref = qm._int8_matmul_reference(x, w8, scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs().max().item()
        rel = diff / (ref.float().abs().max().item() + 1e-9)
        check(out.shape == (m, n), f"K5 {m}x{k}x{n}: shape {out.shape}")
        check(rel < 2e-2, f"K5 {m}x{k}x{n}: relative max err {rel} >= 2e-2")
        bms, by = bound_ms(m * k * 2 + k * n + n * 4 + m * n * 2,
                           2.0 * m * k * n, BF16_TENSOR_FLOPS)
        library_ms, library_note = int8_library_ms(x, w8, scale, ref)
        rows.append(dict(
            shape=[m, k, n], max_abs_err=diff, rel_max_err=rel,
            ms=time_ms(qm.int8_matmul, x, w8, scale),
            call_ms=call_ms(lambda: qm.int8_matmul(x, w8, scale)),
            plain_ms=time_ms(qm._int8_matmul_reference, x, w8, scale),
            library_ms=library_ms, library_note=library_note,
            bound_ms=bms, bound_by=by))
        emit("kernel_check", kernel="int8_matmul", **rows[-1])
    return rows


def int8_library_ms(x, w8, scale, ref):
    """Time of ``torch._weight_int8pack_mm`` (x @ (w8 [N, K] int8 * scale
    [N]), the same per-output-channel function) -> (ms, None), or (None,
    why) when the card's PyTorch refuses it or computes something else."""
    import torch
    w_nk = w8.t().contiguous()
    for sc in (scale, scale.to(x.dtype)):
        try:
            out = torch._weight_int8pack_mm(x, w_nk, sc)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as exc:
            why = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
            continue
        rel = ((out.float() - ref.float()).abs().max()
               / (ref.float().abs().max() + 1e-9)).item()
        if rel >= 2e-2:
            why = f"_weight_int8pack_mm differs from the reference: {rel}"
            continue
        return time_ms(torch._weight_int8pack_mm, x, w_nk, sc), None
    return None, why


# ---------------------------------------------------------------------------
# phases 4-5: the engine at full Llama-3-8B width and depth
# ---------------------------------------------------------------------------

def _counted():
    from ray_tpu_torch.ops import attention, int8_matmul, rms_norm
    return {"flash_attention": attention.flash_attention,
            "flash_attention_bwd_dq": attention.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": attention.flash_attention_bwd_dkv,
            "rms_norm": rms_norm, "int8_matmul": int8_matmul}


def reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counted().items()}


class FirstTokenClock:
    """A stream queue that keeps the time of the first token pushed."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.ttft = None

    def put_nowait(self, item) -> None:
        if self.ttft is None and item is not None:
            self.ttft = time.perf_counter() - self.t_start


def run_engine(dev, quantization, prompts):
    import torch
    from ray_tpu_torch.llm import (
        ContinuousBatchingEngine, EngineConfig, GenerationRequest)
    from ray_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(
        EngineConfig(model=cfg, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                     seed=SEED, quantization=quantization), device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    reset_counts()
    t_start = time.perf_counter()
    clocks = [FirstTokenClock(t_start) for _ in prompts]
    requests = [engine.add_request(GenerationRequest(
        prompt_ids=list(p), max_tokens=NEW_TOKENS, stream_queue=clock))
        for p, clock in zip(prompts, clocks)]
    engine.step()  # admits (prefills) every request, then one decode
    t_admitted = time.perf_counter()
    steps = 1
    while engine.has_work():
        engine.step()
        steps += 1
    t_end = time.perf_counter()
    sampled = engine.generate([list(prompts[0])], max_tokens=NEW_TOKENS,
                              temperature=1.0, top_k=50)[0]
    counts = read_counts()

    vocab = cfg.vocab_size
    for i, r in enumerate(requests):
        check(r.finish_reason == "length"
              and len(r.output_ids) == NEW_TOKENS,
              f"request {i}: {r.finish_reason}, {len(r.output_ids)} tokens")
        check(all(0 <= t < vocab for t in r.output_ids),
              f"request {i}: token out of vocab")
    check(len(sampled) == NEW_TOKENS
          and all(0 <= t < vocab for t in sampled),
          "sampled request did not finish with its tokens")
    # after the first step every request has 2 tokens; the rest come
    # one per decode step
    decode_tokens = len(requests) * (NEW_TOKENS - 2)
    fields = dict(
        quantization=quantization, init_s=t_init,
        ttft_s=[clock.ttft for clock in clocks],
        first_step_s=t_admitted - t_start,
        decode_tokens_per_s=decode_tokens / (t_end - t_admitted),
        decode_step_ms=(t_end - t_admitted) / (steps - 1) * 1e3,
        steps=steps, launches=counts,
        greedy_heads=[r.output_ids[:4] for r in requests],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    outs = [r.output_ids for r in requests]
    del engine, requests
    gc.collect()
    torch.cuda.empty_cache()
    return fields, counts, outs


# ---------------------------------------------------------------------------
# phase 6: the card against the CPU on one prefill
# ---------------------------------------------------------------------------

def to_card(tree, dev, dtype):
    if isinstance(tree, dict):
        return {k: to_card(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_card(v, dev, dtype) for v in tree]
    return tree.to(device=dev, dtype=dtype)


def end_to_end_vs_cpu(dev):
    import numpy as np
    import torch
    from ray_tpu_torch.models import LlamaConfig, llama_init, llama_prefill
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params_cpu = llama_init(SEED, cpu_cfg, device="cpu")
    params_gpu = to_card(params_cpu, dev, cfg.dtype)
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, 32))
    tokens = torch.from_numpy(ids)
    reset_counts()
    logits_gpu, ks, _vs = llama_prefill(params_gpu, tokens.to(dev), cfg)
    counts = read_counts()
    logits_cpu, _, _ = llama_prefill(params_cpu, tokens, cpu_cfg)
    g = logits_gpu[0, -1].float().cpu()
    c = logits_cpu[0, -1]
    check(tuple(logits_gpu.shape) == (1, 32, cfg.vocab_size),
          f"logits shape {tuple(logits_gpu.shape)}")
    check(bool(torch.isfinite(logits_gpu).all()), "non-finite logits")
    rel = (torch.linalg.vector_norm(g - c)
           / torch.linalg.vector_norm(c)).item()
    check(rel <= 5e-2, f"card vs CPU relative L2 {rel} > 5e-2")
    check(counts["flash_attention"] == cfg.n_layers
          and counts["rms_norm"] == 2 * cfg.n_layers + 1,
          f"prefill launches {counts}")
    return dict(rel_l2_last_logits=rel, argmax_equal=bool(
        g.argmax() == c.argmax()), launches=counts,
        kv_shape=list(ks.shape))


# ---------------------------------------------------------------------------
# phase 7: training Llama-3-8B at full width and depth
# ---------------------------------------------------------------------------

def expected_train_counts(n_layers: int):
    """Launches of one training step with remat: K1 in the forward and
    again in each block's recompute, K2/K3 once per layer, K4 twice per
    block in the forward and again in the recompute, plus the final
    norm; the FFN is dense."""
    return {"flash_attention": 2 * n_layers,
            "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers,
            "rms_norm": 4 * n_layers + 1, "int8_matmul": 0}


def run_train(dev):
    """bench_train's configuration and step, one warm-up step and
    bench_train.STEPS timed ones, each ended by ``loss.item()``."""
    import torch
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.scripts import bench_train as bt
    cfg = LlamaConfig.llama3_8b(ce_chunk_tokens=bt.CE_CHUNK)
    t_phase = time.perf_counter()
    params, step, tokens, targets = bt.setup(cfg, bt.BATCH, bt.SEQ, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats(dev)

    want = expected_train_counts(cfg.n_layers)
    losses, step_ms, counts = [], [], None
    for i in range(1 + bt.STEPS):
        reset_counts()
        t0 = time.perf_counter()
        loss = step(tokens, targets).item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_counts = read_counts()
        losses.append(loss)
        check(step_counts == want,
              f"train step {i} launches {step_counts} != {want}")
        counts = step_counts if counts is None else {
            k: counts[k] + step_counts[k] for k in counts}
        if i == 0:
            leaves = bt.parameters(params)
            check(all(t.grad is not None and bool(torch.isfinite(t.grad).all())
                      for t in leaves),
                  "a parameter got no grad, or a non-finite one, on step 1")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    timed_ms = sum(step_ms[1:]) / bt.STEPS
    tokens_per_s = bt.BATCH * bt.SEQ / (timed_ms / 1e3)
    fields = dict(
        n_layers=cfg.n_layers, batch=bt.BATCH, seq=bt.SEQ,
        ce_chunk_tokens=cfg.ce_chunk_tokens, remat=cfg.remat,
        init_s=t_init, losses=losses, step_ms=step_ms,
        timed_step_ms=timed_ms, tokens_per_s=tokens_per_s,
        mfu=tokens_per_s * cfg.flops_per_token() / bt.H100_BF16_DENSE_FLOPS,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        launches_per_step=want, launches=counts)
    del step, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    fields["seconds"] = time.perf_counter() - t_phase
    return fields, counts


# ---------------------------------------------------------------------------
# phase 8: the card against the CPU on one training loss and its grads
# ---------------------------------------------------------------------------

def train_vs_cpu(dev):
    import numpy as np
    import torch
    from ray_tpu_torch.models import (
        LlamaConfig, llama_init, llama_loss, unstack_layers)
    from ray_tpu_torch.scripts.bench_train import parameters
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params_cpu = unstack_layers(llama_init(SEED, cpu_cfg, device="cpu"))
    params_gpu = to_card(params_cpu, dev, cfg.dtype)
    ids = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, 65)))
    tokens, targets = ids[:, :-1], ids[:, 1:]

    def loss_and_grads(params, c, device):
        for t in parameters(params):
            t.requires_grad_(True)
        loss = llama_loss(params, tokens.to(device), targets.to(device), c)
        loss.backward()
        grads = {
            "embedding": params["embedding"].grad,
            "lm_head": params["lm_head"].grad,
            **{name: torch.stack([lp[name].grad for lp in params["layers"]])
               for name in ("wq", "wk", "w2")}}
        return loss.item(), {k: g.float().cpu() for k, g in grads.items()}

    reset_counts()
    loss_gpu, grads_gpu = loss_and_grads(params_gpu, cfg, dev)
    counts = read_counts()
    want = expected_train_counts(cfg.n_layers)
    check(counts == want, f"card loss+grad launches {counts} != {want}")
    loss_cpu, grads_cpu = loss_and_grads(params_cpu, cpu_cfg, "cpu")
    rel_loss = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    check(rel_loss <= 1e-2, f"card vs CPU loss {loss_gpu} vs {loss_cpu}")
    rel_grads = {}
    for name, g in grads_gpu.items():
        c = grads_cpu[name]
        check(bool(torch.isfinite(g).all()), f"card grad {name} non-finite")
        rel_grads[name] = (torch.linalg.vector_norm(g - c)
                           / torch.linalg.vector_norm(c)).item()
        check(rel_grads[name] <= 1e-1,
              f"card vs CPU grad {name} relative L2 {rel_grads[name]} > 1e-1")
    del params_gpu, params_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss_card=loss_gpu, loss_cpu=loss_cpu, rel_loss=rel_loss,
                rel_l2_grads=rel_grads, launches=counts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ray_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: ray_tpu_torch not found ({exc})",
              file=sys.stderr)
        return 2
    # plain versions compute in full f32 (no TF32) on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.build(verbose=True)  # the ptxas report, when a build runs
    _build.lib()
    emit("build", seconds=time.perf_counter() - t0)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    checks = {"flash_attention": check_flash_attention(dev, gen),
              **check_flash_backward(dev, gen),
              "rms_norm": check_rms_norm(dev, gen),
              "int8_matmul": check_int8_matmul(dev, gen)}

    rng = __import__("numpy").random.default_rng(SEED)
    prompts = [rng.integers(0, 128256, n).tolist() for n in PROMPT_LENS]
    bf16, counts_bf16, outs_bf16 = run_engine(dev, None, prompts)
    emit("engine_bf16", **bf16)
    check(counts_bf16["flash_attention"] > 0 and counts_bf16["rms_norm"] > 0,
          f"bf16 engine did not launch K1/K4: {counts_bf16}")
    int8, counts_int8, outs_int8 = run_engine(dev, "int8", prompts)
    int8["first_token_agrees_with_bf16"] = [
        a[0] == b[0] for a, b in zip(outs_bf16, outs_int8)]
    emit("engine_int8", **int8)
    check(counts_int8["int8_matmul"] > 0,
          f"int8 engine did not launch K5: {counts_int8}")

    emit("end_to_end_vs_cpu", **end_to_end_vs_cpu(dev))

    train, counts_train = run_train(dev)
    emit("train", **train)
    emit("train_vs_cpu", **train_vs_cpu(dev))

    sources = {
        "flash_attention": ("ray_tpu_torch/ops/csrc/attention.cu",
                            "ray_tpu/ops/attention.py:171", -1),
        "flash_attention_bwd_dq": ("ray_tpu_torch/ops/csrc/attention_bwd.cu",
                                   "ray_tpu/ops/attention.py:315", -1),
        "flash_attention_bwd_dkv": (
            "ray_tpu_torch/ops/csrc/attention_bwd.cu",
            "ray_tpu/ops/attention.py:345", -1),
        "rms_norm": ("ray_tpu_torch/ops/csrc/rmsnorm.cu",
                     "ray_tpu/ops/rmsnorm.py:41", 0),
        "int8_matmul": ("ray_tpu_torch/ops/csrc/quant_matmul.cu",
                        "ray_tpu/ops/quant_matmul.py:109", 0),
    }
    kernels = []
    for kname, (src, replaces, headline) in sources.items():
        row = checks[kname][headline]
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=(counts_bf16[kname] + counts_int8[kname]
                      + counts_train[kname]),
            max_abs_err=max(r["max_abs_err"] for r in checks[kname]),
            ms=row["ms"], call_ms=row["call_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"],
            shapes=checks[kname]))
    # the whole backward as the model calls it, beside K2's row (whose
    # library_ms is SDPA's whole backward)
    kernels[1]["whole_backward"] = checks["backward"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
