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
FFN weights, then the engine's scheduling features on the same weights
(one set, built once): multi-LoRA (``engine_lora``), multi-step decode
(``engine_multi_step``), speculative decoding with the target as its
own draft (``engine_spec``), prefix caching (``engine_prefix``) and
chunked prefill in int8 (``engine_chunked``), with exact stream gates
where the arithmetic allows them; the verify step, a LoRA bank decode
and a suffix prefill against decode and prefill on a 2-layer model
(``features_vs_decode``); and every feature of the tiny f32 config on
the card and the CPU, int8 included (``features_tiny_f32``). Then (6) a
2-layer full-width prefill on the card against the plain f32 version on
the CPU, (7) training Llama-3-8B at full width and depth (loss,
backward, fused AdamW; remat and chunked cross-entropy) for a warm-up
and three timed steps on one fixed batch, (8) a 2-layer full-width loss
and its grads on the card against the plain f32 version on the CPU,
(9) the kernel list, with each kernel's launches summed over phases
4-8. The backward is also timed whole, as the model calls it (delta,
K2, K3 and K3's group sum), against SDPA's backward. Every kernel's
launch count is zeroed just before each engine phase, each feature
phase and each training step and read just after; a kernel of the path
that never launched fails the run, and a training step must launch
exactly K1 2L, K2 L, K3 L, K4 4L + 1 and K5 0 times. Each feature phase
prints its seconds. The last line is the device summary; any failed check
exits non-zero before it.

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


def run_engine(dev, quantization, prompts, params):
    """The engine on ``params`` (the shared Llama-3-8B bf16 weights;
    ``init_s`` is the engine's own set-up: int8 quantization and the
    caches)."""
    import torch
    from ray_tpu_torch.llm import (
        ContinuousBatchingEngine, EngineConfig, GenerationRequest)
    from ray_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(
        EngineConfig(model=cfg, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                     seed=SEED, quantization=quantization), params=params,
        device=dev)
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
# the engine's scheduling features at full Llama-3-8B width and depth
# ---------------------------------------------------------------------------

def full_config():
    """The served model: Llama-3-8B at full width and depth."""
    from ray_tpu_torch.models import LlamaConfig
    return LlamaConfig.llama3_8b()


def run_phase(name, required, fn, *args):
    """One phase: every launch count zeroed just before ``fn(*args)`` and
    read just after; a kernel in ``required`` that never launched fails
    the run. Emits the phase's fields, seconds and launches."""
    reset_counts()
    t0 = time.perf_counter()
    fields = fn(*args)
    counts = read_counts()
    for kname in required:
        check(counts[kname] > 0, f"{name}: {kname} never launched: {counts}")
    emit(name, seconds=time.perf_counter() - t0, launches=counts, **fields)
    return counts


def serve(engine, specs):
    """Serve requests built from dicts, all admitted at once; returns
    them finished."""
    from ray_tpu_torch.llm import GenerationRequest
    requests = [engine.add_request(GenerationRequest(**spec))
                for spec in specs]
    while any(not r.done for r in requests):
        engine.step()
    return requests


def agreement(a, b):
    """Share of positions where two token streams agree."""
    return sum(x == y for x, y in zip(a, b)) / max(len(a), len(b), 1)


def with_random_b(lora, seed, std):
    """A LoRA adapter whose B factors are N(0, std^2) from ``seed`` (a
    fresh adapter, B = 0, is the identity)."""
    import torch
    gen = torch.Generator(device=lora["B_q"].device)
    gen.manual_seed(seed)
    out = dict(lora)
    for part in ("B_q", "B_v"):
        out[part] = (torch.randn(lora[part].shape, generator=gen,
                                 device=lora[part].device) * std).to(
                                     lora[part].dtype)
    return out


def make_engine(dev, params, **kw):
    from ray_tpu_torch.llm import ContinuousBatchingEngine, EngineConfig
    draft_params = kw.pop("draft_params", None)
    return ContinuousBatchingEngine(
        EngineConfig(model=full_config(), max_batch=MAX_BATCH,
                     max_seq=MAX_SEQ, seed=SEED, **kw),
        params=params, draft_params=draft_params, device=dev)


def free():
    """Give the memory of the tensors just dropped back to the card."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def engine_lora(dev, params):
    """Base, two adapters of rank 8 and 16 (random B) and a fresh one in
    ONE batch on one 300-token prompt; then each request alone."""
    from ray_tpu_torch.models import lora_init
    cfg = full_config()
    engine = make_engine(dev, params, max_loras=3, lora_rank=16)
    engine.register_adapter("ada", with_random_b(
        lora_init(SEED + 1, cfg, rank=8, device=dev), SEED + 2, 0.05))
    engine.register_adapter("bob", with_random_b(
        lora_init(SEED + 3, cfg, rank=16, device=dev), SEED + 4, 0.05))
    engine.register_adapter("zero", lora_init(SEED + 5, cfg, rank=16,
                                              device=dev))
    prompt = __import__("numpy").random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, 300).tolist()
    specs = [dict(prompt_ids=list(prompt), max_tokens=NEW_TOKENS,
                  adapter=a) for a in (None, "ada", "bob", "zero")]
    mixed = [r.output_ids for r in serve(engine, specs)]
    alone = [serve(engine, [spec])[0].output_ids for spec in specs]
    del engine
    free()
    base, ada, bob, zero = mixed
    check(all(len(o) == NEW_TOKENS for o in mixed), "a LoRA request did "
          f"not finish with its tokens: {[len(o) for o in mixed]}")
    check(zero == base, "the fresh adapter's stream differs from base")
    check(mixed == alone, "a stream of the mixed batch differs from the "
          "same request served alone")
    check(ada != base and bob != base, "an adapter's stream equals base")
    return dict(heads=[o[:4] for o in mixed],
                agreement_with_base=[agreement(o, base) for o in mixed])


def engine_multi_step(dev, params, prompts, outs_bf16, bf16):
    """multi_step=4 on phase 4's prompts: the same greedy streams, with
    one crossing to the host per four decode steps."""
    engine = make_engine(dev, params, multi_step=4)
    specs = [dict(prompt_ids=list(p), max_tokens=NEW_TOKENS)
             for p in prompts]
    from ray_tpu_torch.llm import GenerationRequest
    requests = [engine.add_request(GenerationRequest(**s)) for s in specs]
    engine.step()  # admits every request, then one 4-step burst
    t_admitted, emitted = time.perf_counter(), engine.total_generated
    while engine.has_work():
        engine.step()
    t_end = time.perf_counter()
    outs = [r.output_ids for r in requests]
    decode_tokens = engine.total_generated - emitted
    del engine
    free()
    check(outs == outs_bf16, "multi-step greedy streams differ from the "
          "single-step ones")
    return dict(ms_per_token=(t_end - t_admitted) / decode_tokens * 1e3,
                single_step_ms_per_token=1e3 / bf16["decode_tokens_per_s"],
                note="host clock, information only")


def engine_spec(dev, params, prompts, outs_bf16):
    """draft_model = the target (the same tensors, a second cache),
    spec_tokens=4, on phase 4's prompts."""
    engine = make_engine(dev, params, draft_model=full_config(),
                         draft_params=params, spec_tokens=4)
    requests = serve(engine, [dict(prompt_ids=list(p), max_tokens=NEW_TOKENS)
                              for p in prompts])
    stats = engine.stats()
    forwards = engine._step_counter - len(prompts)  # less the prefills
    del engine
    free()
    check(all(r.finish_reason == "length"
              and len(r.output_ids) == NEW_TOKENS for r in requests),
          "a speculative request did not finish with its tokens")
    # a request's decode tokens over every target forward of the run, in
    # some of which it had already finished: a lower bound per request
    per_forward = (NEW_TOKENS - 1) / forwards
    check(per_forward > 1.0, f"{per_forward} tokens per target forward: "
          "no draft was ever accepted")
    return dict(tokens_per_target_forward=per_forward,
                target_forwards=forwards,
                acceptance=stats["spec_accepted"] / stats["spec_proposed"],
                agreement_with_dense=[agreement(r.output_ids, o) for r, o
                                      in zip(requests, outs_bf16)])


def engine_prefix(dev, params):
    """A 512-token system prompt, each time followed by another 64-token
    suffix, served one request after another, with and without the
    prefix cache."""
    import numpy as np
    vocab = full_config().vocab_size
    rng = np.random.default_rng(SEED + 7)
    system = rng.integers(0, vocab, 512).tolist()
    prompts = [system + rng.integers(0, vocab, 64).tolist()
               for _ in range(3)]
    outs = {}
    for cached in (True, False):
        engine = make_engine(dev, params, enable_prefix_caching=cached,
                             prefix_cache_min_tokens=8)
        outs[cached] = [serve(engine, [dict(prompt_ids=list(p),
                                            max_tokens=NEW_TOKENS)])[0]
                        for p in prompts]
        if cached:
            stats = engine.stats()
        del engine
        free()
    check(all(r.finish_reason == "length" for r in outs[True]),
          "a prefix-cached request did not finish")
    check(stats["prefix_hits"] >= 2, f"prefix cache stats {stats}")
    return dict(prefix_hits=stats["prefix_hits"],
                prefix_misses=stats["prefix_misses"],
                first_token_agrees=[a.output_ids[0] == b.output_ids[0]
                                    for a, b in zip(outs[True], outs[False])],
                agreement_with_no_cache=[
                    agreement(a.output_ids, b.output_ids)
                    for a, b in zip(outs[True], outs[False])])


def engine_chunked(dev, params, prompts, outs_int8):
    """int8, chunked_prefill_tokens=128: the four prompts join while one
    request is decoding. Each chunk step must launch K5 on the verify
    step's 8 x 128-row products, three per layer."""
    from ray_tpu_torch.llm import GenerationRequest
    from ray_tpu_torch.ops import int8_matmul
    engine = make_engine(dev, params, quantization="int8",
                         chunked_prefill_tokens=128)
    chunk_launches = []
    chunk_step = engine._prefill_chunk_step

    def counted(*args):
        before = int8_matmul.launches
        chunk_step(*args)
        chunk_launches.append(int8_matmul.launches - before)

    engine._prefill_chunk_step = counted
    first = engine.add_request(GenerationRequest(
        prompt_ids=list(range(1, 65)), max_tokens=NEW_TOKENS))
    while not first.output_ids:
        engine.step()
    joined = [engine.add_request(GenerationRequest(
        prompt_ids=list(p), max_tokens=NEW_TOKENS)) for p in prompts]
    first_during = len(first.output_ids)
    while engine.has_work():
        engine.step()
    del engine, chunk_step
    free()
    requests = [first] + joined
    check(all(r.finish_reason == "length"
              and len(r.output_ids) == NEW_TOKENS for r in requests),
          "a chunked-prefill request did not finish with its tokens")
    n_layers = full_config().n_layers
    check(chunk_launches and all(n == 3 * n_layers for n in chunk_launches),
          f"K5 launches per chunk step {chunk_launches}")
    return dict(chunk_steps=len(chunk_launches),
                k5_per_chunk_step=3 * n_layers,
                decoding_tokens_before_join=first_during,
                agreement_with_blocking=[agreement(r.output_ids, o) for r, o
                                         in zip(joined, outs_int8)])


def rel_l2_of(a, b):
    import torch
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def features_vs_decode(dev):
    """2 layers at full width, bf16, on the card: the verify step against
    four decode steps, a LoRA bank decode against a LoRA prefill, and a
    suffix prefill over a cached prefix against a full prefill."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import (
        llama_decode_step, llama_init, llama_init_cache, llama_prefill,
        llama_verify_step, lora_init)
    cfg = dataclasses.replace(full_config(), n_layers=2)
    params = llama_init(SEED, cfg, dev)
    ids = torch.from_numpy(np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, 320)).to(dev)

    def seated(n, rows=512):
        _, ks, vs = llama_prefill(params, ids[None, :n], cfg)
        ck, cv = llama_init_cache(cfg, 1, rows, dev)
        ck[:, :, :n] = ks
        cv[:, :, :n] = vs
        return ck, cv

    ck, cv = seated(300)
    verify, _, _ = llama_verify_step(params, ids[None, 300:304], ck, cv,
                                     torch.tensor([300], device=dev), cfg)
    ck, cv = seated(300)
    decode = torch.stack([llama_decode_step(
        params, ids[300 + i:301 + i], ck, cv,
        torch.tensor([300 + i], device=dev), cfg)[0][0] for i in range(4)])
    rel_verify = rel_l2_of(verify[0], decode)

    lora = with_random_b(lora_init(SEED + 1, cfg, rank=16, device=dev),
                         SEED + 2, 0.05)
    full, _, _ = llama_prefill(params, ids[None, :301], cfg, lora=lora)
    _, ks, vs = llama_prefill(params, ids[None, :300], cfg, lora=lora)
    ck, cv = llama_init_cache(cfg, 1, 512, dev)
    ck[:, :, :300] = ks
    cv[:, :, :300] = vs
    bank = {part: torch.stack([torch.zeros_like(lora[part]), lora[part]])
            for part in ("A_q", "A_v")}
    for part in ("B_q", "B_v"):
        folded = lora[part] * float(lora["scale"])
        bank[part] = torch.stack([torch.zeros_like(folded), folded])
    bank["scale"] = torch.tensor(1.0, dtype=cfg.dtype, device=dev)
    bank_decode, _, _ = llama_decode_step(
        params, ids[300:301], ck, cv, torch.tensor([300], device=dev), cfg,
        lora_bank=bank, lora_idx=torch.tensor([1], device=dev))
    rel_lora = rel_l2_of(bank_decode[0], full[0, 300])
    no_lora, _, _ = llama_prefill(params, ids[None, :301], cfg)

    _, pks, pvs = llama_prefill(params, ids[None, :256], cfg)
    base_k = torch.zeros((2, 1, 512) + tuple(pks.shape[3:]),
                         dtype=pks.dtype, device=dev)
    base_v = torch.zeros_like(base_k)
    base_k[:, :, :256] = pks
    base_v[:, :, :256] = pvs
    suffix, _, _ = llama_verify_step(params, ids[None, 256:320], base_k,
                                     base_v, torch.tensor([256], device=dev),
                                     cfg)
    whole, _, _ = llama_prefill(params, ids[None, :320], cfg)
    rel_suffix = rel_l2_of(suffix[0, -1], whole[0, 319])
    del params
    free()
    for what, rel in (("verify step vs decode steps", rel_verify),
                      ("LoRA bank decode vs LoRA prefill", rel_lora),
                      ("suffix prefill vs full prefill", rel_suffix)):
        check(rel <= 5e-2, f"{what}: relative L2 {rel} > 5e-2")
    return dict(rel_l2_verify_vs_decode=rel_verify,
                rel_l2_bank_decode_vs_lora_prefill=rel_lora,
                rel_l2_lora_vs_base=rel_l2_of(full[0, 300], no_lora[0, 300]),
                rel_l2_suffix_vs_full_prefill=rel_suffix)


def features_tiny_f32(dev):
    """LlamaConfig.tiny() (f32, reference attention) on the card and on
    the CPU: every feature's greedy streams equal the port's CPU streams,
    and those that keep the output (all but an adapter's) equal the
    card's dense stream. Then the same config with int8 FFN weights."""
    import torch
    from ray_tpu_torch.llm import ContinuousBatchingEngine, EngineConfig
    from ray_tpu_torch.models import LlamaConfig, llama_init, lora_init
    cfg = LlamaConfig.tiny()
    draft_cfg = dataclasses.replace(cfg, dim=32, n_layers=1, n_heads=2,
                                    n_kv_heads=1, hidden_dim=64)
    cpu = {"params": llama_init(SEED, cfg, device="cpu"),
           "draft": llama_init(SEED + 1, draft_cfg, device="cpu")}
    card = {k: to_card(v, dev, torch.float32) for k, v in cpu.items()}
    adapters = {"ada": with_random_b(lora_init(SEED + 2, cfg, rank=4,
                                               device="cpu"), SEED + 3, 0.5),
                "zero": lora_init(SEED + 4, cfg, rank=8, device="cpu")}
    prompts = [[1, 5, 9, 13], [2, 4, 6], list(range(30, 50))]
    system = list(range(100, 116))
    prefix_prompts = [system + [1, 2, 3], system + [7, 8],
                      system + [40, 41, 42], system + [1, 2, 3]]
    cases = {
        "dense": ({}, prompts),
        "dense_prefix_prompts": ({}, prefix_prompts),
        "lora": (dict(max_loras=2, lora_rank=8), prompts[:1] * 3),
        "multi_step": (dict(multi_step=4), prompts),
        "spec_random_draft": (dict(draft_model=draft_cfg, spec_tokens=4),
                              prompts),
        "spec_draft_is_target": (dict(draft_model=cfg, spec_tokens=4),
                                 prompts),
        "prefix": (dict(enable_prefix_caching=True,
                        prefix_cache_min_tokens=8), prefix_prompts),
        "chunked": (dict(chunked_prefill_tokens=8), prompts),
        "int8": (dict(quantization="int8"), prompts),
    }

    def run(name, where):
        kw, case_prompts = cases[name]
        tree = card if where == "card" else cpu
        draft = kw.get("draft_model")
        engine = ContinuousBatchingEngine(
            EngineConfig(model=cfg, max_batch=4, max_seq=64, seed=SEED,
                         **kw), params=tree["params"],
            draft_params=(None if draft is None else tree["params"]
                          if draft is cfg else tree["draft"]),
            device=dev if where == "card" else "cpu")
        if name == "lora":
            for aname, lora in adapters.items():
                engine.register_adapter(aname, lora)
            specs = [dict(prompt_ids=list(p), max_tokens=16, adapter=a)
                     for p, a in zip(case_prompts, (None, "ada", "zero"))]
            return [r.output_ids for r in serve(engine, specs)]
        if name.startswith("prefix") or name.endswith("prefix_prompts"):
            # one after another, so that later prompts hit
            return [engine.generate([p], max_tokens=16)[0]
                    for p in case_prompts]
        return engine.generate(case_prompts, max_tokens=16)

    streams = {(name, where): run(name, where)
               for name in cases for where in ("card", "cpu")}
    free()
    for name in cases:
        if name == "int8":
            continue
        check(streams[(name, "card")] == streams[(name, "cpu")],
              f"tiny f32 {name}: the card's streams differ from the CPU's")
        if name.startswith("dense"):
            continue
        dense = streams[("dense_prefix_prompts" if name == "prefix"
                         else "dense", "card")]
        got = streams[(name, "card")]
        if name == "lora":
            check(got[0] == got[2] == dense[0] and got[1] != dense[0],
                  "tiny f32 lora: base or fresh adapter differs from "
                  "dense, or the adapter changes nothing")
        else:
            check(got == dense, f"tiny f32 {name}: streams differ from "
                  "the card's dense stream")
    int8 = streams[("int8", "card")]
    check(all(len(o) == 16 for o in int8), "tiny f32 int8 did not finish")
    return dict(cases=sorted(cases),
                int8_agreement_with_cpu=[
                    agreement(a, b) for a, b in
                    zip(int8, streams[("int8", "cpu")])])


def run_features(dev, params, prompts, bf16, outs_bf16, outs_int8):
    """The feature phases; returns their launch counts summed."""
    phases = [
        ("engine_lora", ("flash_attention", "rms_norm"),
         engine_lora, (dev, params)),
        ("engine_multi_step", ("flash_attention", "rms_norm"),
         engine_multi_step, (dev, params, prompts, outs_bf16, bf16)),
        ("engine_spec", ("flash_attention", "rms_norm"),
         engine_spec, (dev, params, prompts, outs_bf16)),
        ("engine_prefix", ("flash_attention", "rms_norm"),
         engine_prefix, (dev, params)),
        ("engine_chunked", ("rms_norm", "int8_matmul"),
         engine_chunked, (dev, params, prompts, outs_int8)),
        ("features_vs_decode", ("flash_attention", "rms_norm"),
         features_vs_decode, (dev,)),
        ("features_tiny_f32", ("rms_norm", "int8_matmul"),
         features_tiny_f32, (dev,)),
    ]
    total = {name: 0 for name in _counted()}
    for name, required, fn, args in phases:
        counts = run_phase(name, required, fn, *args)
        total = {k: total[k] + counts[k] for k in total}
    return total


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
    cfg = dataclasses.replace(full_config(), n_layers=2)
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
    cfg = dataclasses.replace(full_config(), n_layers=2)
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
    # one set of Llama-3-8B bf16 weights for every full-width engine
    from ray_tpu_torch.models import LlamaConfig, llama_init
    t0 = time.perf_counter()
    params = llama_init(SEED, full_config(), dev)
    torch.cuda.synchronize()
    emit("weights", seconds=time.perf_counter() - t0)
    bf16, counts_bf16, outs_bf16 = run_engine(dev, None, prompts, params)
    emit("engine_bf16", **bf16)
    check(counts_bf16["flash_attention"] > 0 and counts_bf16["rms_norm"] > 0,
          f"bf16 engine did not launch K1/K4: {counts_bf16}")
    int8, counts_int8, outs_int8 = run_engine(dev, "int8", prompts, params)
    int8["first_token_agrees_with_bf16"] = [
        a[0] == b[0] for a, b in zip(outs_bf16, outs_int8)]
    emit("engine_int8", **int8)
    check(counts_int8["int8_matmul"] > 0,
          f"int8 engine did not launch K5: {counts_int8}")
    counts_features = run_features(dev, params, prompts, bf16, outs_bf16,
                                   outs_int8)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    prefill_vs_cpu = end_to_end_vs_cpu(dev)
    emit("end_to_end_vs_cpu", **prefill_vs_cpu)

    train, counts_train = run_train(dev)
    emit("train", **train)
    grads_vs_cpu = train_vs_cpu(dev)
    emit("train_vs_cpu", **grads_vs_cpu)

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
                      + counts_features[kname] + counts_train[kname]
                      + prefill_vs_cpu["launches"][kname]
                      + grads_vs_cpu["launches"][kname]),
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
