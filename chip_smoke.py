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
(3b, ``seq_parallel``) sequence and pipeline parallelism at Llama-3-8B
width: the ring's per-rank steps for 4 virtual ranks at B1 S8192 (K1-K3
exactly 10 times causal and 16 full) against flash attention over the
whole sequence and the plain f32 version, beside flash's own error and
time; ring and Ulysses attention through a world-1 NCCL group, equal to
flash; a 2-layer full-width Llama's loss and grads through them; and
``pipeline`` over 4 microbatches of a 2-block stage with remat,
(3c, ``sharded``) sharded parameters through a world-1 mesh with all
six axes: a 2-layer Llama-3-8B-width model cut by ``shard_pytree`` under
ddp, fsdp, tp and fsdp_tp, and a 2-layer Mixtral-8x7B-width one under
ep with flash and with ring attention, each loss and grad bit-equal to
the unsharded run and each run launching K1-K4 exactly as a training
step does,
(3d, ``sharded_vision``) ViT-B/16, CLIP and DiT-XL/2 at full width and
depth through the same world-1 mesh under the four modes, each loss and
grad bit-equal to the unsharded run with K1-K3 launched as in the
unsharded step, then three fsdp_tp training steps of each in turns with
unsharded ones (host clock and CUDA events),
(3e, ``grad_sync``) DDP and ZeRO-1 on DiT-XL/2's f32 parameters (675 M)
from the same state and gradients, within 1e-5 of each other after three
steps, each step's ms beside a fused AdamW step's, and Anakin's lockstep
step over 4 virtual shards on the card against the CPU,
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
the card and the CPU, int8 included (``features_tiny_f32``). Then the
OpenAI surface: ``LLMServer`` on the same weights answering completions
(logprobs, stop strings, streaming, n 2), guided chat, embeddings and
score from 4 threads at once (``server_openai``), with the engine's
metrics and flight-recorder spans checked after it (``telemetry``);
penalties, guided decoding, logit bias and logprobs co-batched with a
plain request on a dense, a multi-step and an int8 chunked engine, each
batched path counted (``engine_extras``); prefill_only -> host ->
add_prefilled between two engines (``engine_disagg``); the extras on the
tiny f32 config on the card against the CPU (``extras_tiny_f32``); and
the tokenize -> engine -> detokenize batch stages (``batch_stages``).
Then (5b) the LLM surface on Serve, as replicas of the port's runtime
behind its HTTP proxy, each replica's launches counted in its own
process and read back through ``__ray_call__``: ``serve_llm``, the
OpenAI app of Llama-3-8B at full width and depth on the whole card,
phase 4's four prompts (printable ASCII after the byte tokenizer's BOS,
so that they travel as text) one at a time over HTTP with every served
token id held to phase 4's, an SSE stream, chat, n 2, the model list, an
unknown model, a ``traceparent`` request whose proxy, router, replica
and engine spans reach the trace store, and a 15 s open-loop poisson
``loadgen`` run through the proxy with no error (K1 and K4, no K2, K3
or K5); ``serve_multiplex``, two 4-layer full-width models (bf16, and
int8 for K5) behind one replica holding one at a time, A, B, A with each
eviction stopping its engine, the per-model counters, the 404 of an
unknown id, and one local-testing-mode call in this process equal to the
replica's; ``serve_prefix``, two 4-layer replicas on half the card each
behind the prefix-aware router in tests/test_serve.py:456's affinity
scenario; ``serve_disagg``, Llama-3-8B split into a prefill and a decode
replica on half the card each, the four prompts' texts, usage and ids
equal to ``serve_llm``'s, one stream, the K/V block's size and hand-off
time; and the card's free memory back after Serve's and the runtime's
shutdown. The gRPC proxy is held on the CPU only (no ``grpc`` there).
Then (6) a 2-layer full-width prefill on the card against the plain f32
version on the CPU, (7) training Llama-3-8B at full width and depth (loss,
backward, fused AdamW; remat and chunked cross-entropy) for a warm-up
and three timed steps on one fixed batch, then three more on the
same state with ring attention through a world-1 NCCL group, then three
through the fsdp_tp mesh path in turns with three more of its own, timed
by the host clock and CUDA events, (8) a
2-layer full-width loss and its grads on the card against the plain
f32 version on the CPU,
then (``train_checkpoint``) a 2-layer full-width training run that
streams its batches through ``iter_device_batches``, traces steps 1-2
with ``StepProfiler``, saves its whole state with ``save_pytree`` and a
background ``save_sharded_state`` overlapping its next step, and resumes
in fresh parameters with losses, parameters and moments equal to the
uninterrupted run's bit for bit; the sharded state reshards to 2 and
back; ViT-sized batches are staged beside a matmul loop; and
``python -m ray_tpu_torch.devtools.check --only podracer`` exits 0,
(9) RL, which runs none of the kernels: three of Anakin's fused
updates (rollout, GAE, PPO loss, clipped Adam) at bench.py's size on
the card against the CPU from the same weights and draws
(``rl_vs_cpu``), Anakin at 16 and 4096 envs timed over 20 updates with
a profiled window for device busy time and launches (``rl_anakin``),
PPO learning CartPole past a return of 60 on its device path, then
Pendulum on the local Python runner (``rl_ppo``), three updates each of
the IMPALA learner, DQN, SAC, CQL, IQL and MARWIL on the card against
the CPU from the same weights, batches and draws
(``rl_offpolicy_vs_cpu``, ``scripts/rl_offpolicy.py``), and DQN, SAC,
PPO through ObsNormalizer + FrameStack(4), CQL and IQL timed: env-steps/s,
ms per update, returns (``rl_offpolicy``), three chained DreamerV3 train
steps at its default widths on the card against the CPU from the same
weights, batches and draws, every sampled index equal
(``rl_dreamer_vs_cpu``, ``scripts/rl_dreamer.py``), DreamerV3 on
CartPole: ms per train step, launches, idle share, the parts of a step,
env-steps/s (``rl_dreamer``), and multi-agent PPO on rock-paper-scissors
against a frozen opponent and on tic-tac-toe self-play, gated on the
reference tests' learning bars (``rl_multi_agent``), RL on the port's
runtime (``rl_remote``): PPO on CartPole through 2 remote CPU env
runners with its learner on the card, each runner's first fragment bit
for bit a local CPU runner's from the same seed and weights; a
``LearnerGroup`` of 2 learner actors on half the card each, 3 updates,
the ranks bit-equal and within 1e-5 of the same steps in this process;
APPO and IMPALA's asynchronous loops, 4 iterations each; and Sebulba
(``rl_sebulba``): the bandit scenario with its learner actor and one
inference replica sharing the card, 12 updates, weight pushes,
staleness, replay depth, learning and the five ``rl`` flight-recorder
spans checked, (10) the vision,
diffusion and MoE models: ViT-B/16 training at batch 64
(``vision_train``), a CLIP step with its causal text tower
(``clip_step``), DiT-B/2 training and DDIM sampling with guidance
(``dit_train``, ``dit_sample``), the same for DiT-XL/2 at full width and
depth with its default flash attention at head_dim 72 (``dit_xl_train``,
``dit_xl_sample``), 2-layer full-width ViT, DiT-B/2 and DiT-XL/2 loss
and grads on the card against the CPU (``vision_vs_cpu``) and the engine
at Mixtral-8x7B width, 8 of its 32 layers (``engine_moe``, with a
1-layer prefill and the tiny MoE config against the CPU); phase 3 also
holds K1 at their attention shapes (head_dim 64, H = KVH, S 197, 256
and 77) and K2/K3 at the non-causal ones, and K1-K3 at head_dim 72
(DIT_XL_ATTENTION: DiT-XL/2 at 256^2 and 512^2, a ragged S full and
causal, a GQA group), (10b, ``trainer``) the port's runtime:
``ray_tpu_torch.init()`` counts the card, and ``TorchTrainer`` trains
the 2-layer full-width Llama of ``train_checkpoint`` for three AdamW
steps through ``make_optimizer``'s DDP over a world-1 NCCL group in a
worker process the runtime spawned, equal to the same steps in this
process with K1-K4 launched as a training step does, then once more
with a worker that saves a checkpoint after step 1 and dies, rebuilt by
``FailureConfig(max_failures=1)`` and resumed, its final parameters
bit-equal to the uninterrupted run's, (10c, ``mpmd_pipeline``) the
MPMD pipeline trainer: Llama-3-8B width, 4 of its 32 blocks, split by
parameter count into two stage actors that share the card
(``PipelineRunner``, [embed, block, block] / [block, block, norm +
head]), batch 4 x 2048 in 4 microbatches, three 1F1B SGD steps over
shm channels whose losses and fetched parameters equal the same steps
in this process bit for bit, each stage's launches exact (reported from
its own process); one GPipe step and one step over TCP channels equal
to the first; stage 0 dying mid-step raising ``DAGExecutionError`` that
names it; a bf16 device object actor -> driver, actor -> actor and
driver -> actor bit for bit; and the card's free memory back once every
process is shut down, (11) the kernel list, with each
kernel's launches summed over phases 3b-10c (the trainer's, the
pipeline's and the Serve replicas' from their worker processes). The
backward is also timed whole, as the model calls it (delta, K2, K3 and
K3's group sum), against SDPA's backward. Every kernel's launch count
is zeroed just before each engine phase, each feature phase, each
training step and each RL phase and read just after; a kernel of the
path that never launched fails the run, a training step must launch
exactly K1 2L, K2 L, K3 L, K4 4L + 1 and K5 0 times (the vision and
diffusion encoders K1 2L, K2 L, K3 L and no K4), and an RL phase
none. Each feature, RL and model phase prints its seconds; a request
that ends in error, or a response that carries one, fails the run. The last line is the device summary; any
failed check exits non-zero before it.

Needs a CUDA GPU and nvcc (CUDA_HOME or /usr/local/cuda); without a GPU,
or without the ``ray_tpu_torch`` package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
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

def live_pairs(s: int, causal: bool) -> int:
    """(query, key) pairs a self-attention of length s computes."""
    return s * (s + 1) // 2 if causal else s * s


def flash_forward_row(dev, gen, b, s, h, kvh, d, causal):
    """K1 at q [b, s, h, d], k/v [b, s, kvh, d] against its plain
    version, timed beside SDPA's forward -> the row."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
    out, lse = att._flash_forward(q, k, v, causal)
    ref, ref_lse = att._flash_forward_reference(q, k, v, causal)
    torch.cuda.synchronize()
    what = f"K1 B={b} S={s} H={h} causal={causal}"
    # lse is what K2 and K3 rebuild P from: every row within 1e-3
    lse_err = (lse - ref_lse).abs().max().item()
    check(lse_err <= 1e-3, f"{what}: lse err {lse_err} > 1e-3")
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
    check(torch.isfinite(out).all().item(), f"{what}: non-finite")
    check(err <= 2e-2, f"{what}: max abs err {err} > 2e-2")
    check(worst_row_rel <= 1e-2,
          f"{what}: a row's relative L2 err {worst_row_rel} > 1e-2")
    qt, kt, vt = (t.transpose(1, 2) for t in
                  (q, att._repeat_kv(k, h), att._repeat_kv(v, h)))
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kvh * d) + 4 * b * h * s
    bms, by = bound_ms(nbytes, 4.0 * b * h * d * live_pairs(s, causal),
                       BF16_TENSOR_FLOPS)
    row = dict(
        shape=[b, s, h, kvh, d], causal=causal, max_abs_err=err,
        rel_l2_err=rel_l2, worst_row_rel_l2_err=worst_row_rel,
        lse_max_abs_err=lse_err,
        ms=time_ms(att.flash_attention, q, k, v, causal),
        call_ms=call_ms(lambda: att.flash_attention(q, k, v, causal)),
        plain_ms=time_ms(att._attention_reference, q, k, v, causal),
        library_ms=time_ms(
            lambda *a: F.scaled_dot_product_attention(*a, is_causal=causal),
            qt, kt, vt),
        bound_ms=bms, bound_by=by)
    emit("kernel_check", kernel="flash_attention", **row)
    return row


def check_flash_attention(dev, gen):
    return [flash_forward_row(dev, gen, 1, s, 32, 8, 128, True)
            for s in (8, 128, 200, 512, 2048)]


def sdpa_backward_ms(q, k, v, do, causal=True):
    """Device time of the backward of one
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
                                              is_causal=causal).grad_fn
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
    rows = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": [],
            "backward": []}
    for s in (200, 512, 2048):
        flash_backward_rows(dev, gen, 1, s, 32, 8, 128, True, rows)
    return rows


def flash_backward_rows(dev, gen, b, s, h, kvh, d, causal, rows):
    """K2 and K3 at q [b, s, h, d], k/v [b, s, kvh, d] against their
    plain versions, and the whole backward against SDPA's; the rows are
    appended to ``rows`` (kernel name -> list)."""
    import torch
    from ray_tpu_torch.ops import attention as att
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
    do = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    o, lse = att._flash_forward(q, k, v, causal)
    delta = att._delta(o, do)
    args = (q, k, v, do, lse, delta, causal)
    got = {"flash_attention_bwd_dq": (att.flash_attention_bwd_dq(*args),),
           "flash_attention_bwd_dkv": att.flash_attention_bwd_dkv(*args)}
    want = {"flash_attention_bwd_dq": (att._bwd_dq_reference(*args),),
            "flash_attention_bwd_dkv": att._bwd_dkv_reference(*args)}
    torch.cuda.synchronize()
    pairs = live_pairs(s, causal)
    in_bytes = 2 * (2 * b * s * h * d + 2 * b * s * kvh * d) + 8 * b * h * s
    library, library_op = sdpa_backward_ms(q, k, v, do, causal)
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
            what = f"{name} B={b} S={s} H={h} causal={causal} {tname}"
            check(bool(torch.isfinite(g_t).all()), f"{what}: non-finite")
            check(rel <= 2e-2, f"{what}: relative L2 {rel} > 2e-2")
            check(worst <= 5e-2, f"{what}: a row's relative L2 {worst} "
                  "> 5e-2")
            errs[tname] = dict(max_abs_err=diff.abs().max().item(),
                               rel_l2_err=rel, worst_row_rel_l2_err=worst)
        bms, by = bound_ms(in_bytes + out_bytes, flops, BF16_TENSOR_FLOPS)
        rows[name].append(dict(
            shape=[b, s, h, kvh, d], causal=causal,
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
        14.0 * d * pairs * b * h, causal))
    del got, want, q, k, v, do, o, lse, delta, args
    torch.cuda.empty_cache()


def check_whole_backward(args, library, library_op, nbytes, flops,
                         causal=True):
    """The backward as the model calls it (``_flash_backward``: delta,
    K2, K3 and K3's group sum) against its plain version and against
    SDPA's backward, which computes its own delta; with ``_delta``'s own
    time. ``nbytes``: q, k, v, o, do, lse in and dq, dk, dv out;
    ``flops``: K2's and K3's products, 14 D per live pair and head."""
    import torch
    from ray_tpu_torch.ops import attention as att
    got = att._flash_backward(*args, causal)
    want = att._flash_backward_reference(*args, causal)
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
                      q.shape[3]], causal=causal, rel_l2_err=errs,
               ms=time_ms(att._flash_backward, *args, causal),
               delta_ms=time_ms(att._delta, o, do),
               call_ms=call_ms(lambda: att._flash_backward(*args, causal)),
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


def run_engine(dev, quantization, prompts, params, cfg=None):
    """The engine on ``params`` (by default the shared Llama-3-8B bf16
    weights, ``cfg`` Llama-3-8B; ``init_s`` is the engine's own set-up:
    int8 quantization and the caches)."""
    import torch
    from ray_tpu_torch.llm import (
        ContinuousBatchingEngine, EngineConfig, GenerationRequest)
    from ray_tpu_torch.models import LlamaConfig
    cfg = cfg or LlamaConfig.llama3_8b()
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
    kw.setdefault("max_batch", MAX_BATCH)
    return ContinuousBatchingEngine(
        EngineConfig(model=full_config(), max_seq=MAX_SEQ, seed=SEED, **kw),
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


# ---------------------------------------------------------------------------
# the OpenAI serving surface, sampling extras, disaggregation, telemetry
# ---------------------------------------------------------------------------

class Capture:
    """Every GenerationRequest an engine admits (``add_request`` and
    ``add_prefilled``), each with its host-clock TTFT, and the slots
    each step served: wraps the engine's own methods in place."""

    def __init__(self, engine):
        self.requests, self.ttft, self.steps = [], {}, []
        add, adopt, emit, step = (engine.add_request, engine.add_prefilled,
                                  engine._emit, engine.step)

        def add_request(request):
            self.requests.append(request)
            return add(request)

        def add_prefilled(request, *args):
            self.requests.append(request)
            return adopt(request, *args)

        def _emit(slot, token):
            request = slot.request
            emit(slot, token)
            if len(request.output_ids) == 1 and \
                    request.request_id not in self.ttft:
                self.ttft[request.request_id] = (time.perf_counter()
                                                 - request._t_submit)

        def counted_step():
            served = step()
            self.steps.append(served)
            return served

        engine.add_request, engine.add_prefilled = add_request, add_prefilled
        engine._emit, engine.step = _emit, counted_step


def text_of(body):
    """A response's text, from a completion or a chat completion."""
    choice = body["choices"][0]
    return choice.get("text", (choice.get("message") or {}).get("content"))


def request_kind(r):
    """Which of server_openai's requests an engine request is."""
    if r.temperature > 0.0:
        return "n2"
    if r.guided is not None:
        return "stop_strings" if r.stream_queue is not None else "chat_json"
    if r.logprobs is not None:
        return "greedy_logprobs"
    return "stream"


def check_response(what, body):
    check(isinstance(body, dict) and "error" not in body,
          f"{what}: error response {str(body)[:300]}")
    for choice in body.get("choices", []):
        check(choice["finish_reason"] in ("stop", "length"),
              f"{what}: finish_reason {choice['finish_reason']}")


def server_openai(dev, params, shared):
    """The port's LLMServer on the Llama-3-8B weights, answering OpenAI
    requests from 4 threads at once: greedy completions of 64 tokens
    with logprobs 5, guided completions cut by stop strings, guided chat
    (json_object), the first request streamed, n 2, embeddings of ~300
    and ~700 bytes (twice) and score. The flight recorder is on."""
    import concurrent.futures as cf
    import numpy as np
    from ray_tpu_torch.llm.engine import EngineConfig
    from ray_tpu_torch.llm.guided import json_object_constraint
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer
    from ray_tpu_torch.util import flight_recorder, metrics
    rng = np.random.default_rng(SEED + 9)
    words = ["alpha", "beta", "gamma", "delta", "kernel", "warp", "tile",
             "cache", "token", "batch", "serve", "hopper"]

    def text(n):
        out = ""
        while len(out) < n:
            out += words[int(rng.integers(len(words)))] + " "
        return out[:n]

    prompt = text(200)
    json_object = {"type": "json_object"}
    jobs = {
        "greedy_logprobs": ("completions", {"prompt": prompt,
                                            "max_tokens": 64,
                                            "logprobs": 5}),
        "stop_strings": ("completions", {"prompt": text(120),
                                         "max_tokens": 48,
                                         "response_format": json_object,
                                         "stop": [":", ")"]}),
        "chat_json": ("chat_completions", {
            "messages": [{"role": "user", "content": text(150)}],
            "max_tokens": 64, "response_format": json_object}),
        "stream": ("completions", {"prompt": prompt, "max_tokens": 64,
                                   "stream": True, "stream_options":
                                   {"include_usage": True}}),
        "n2": ("completions", {"prompt": text(90), "max_tokens": 32,
                               "n": 2, "temperature": 0.8}),
        "embeddings": ("embeddings", {"input": [text(300), text(700)]}),
        "score": ("score", {"text_1": text(100),
                            "text_2": [text(100), text(200)]}),
    }
    counters = ("ray_tpu_engine_ttft_seconds",
                "ray_tpu_engine_tokens_generated_total")

    def registry():
        ttft = metrics.histogram_snapshot(counters[0])
        with metrics._registry.lock:
            tokens = metrics._registry.counters.get((counters[1], ()), 0.0)
        return (ttft[3] if ttft else 0), tokens

    server = LLMServer(LLMConfig(
        model_id="llama3-8b", engine=EngineConfig(
            model=full_config(), max_batch=MAX_BATCH, max_seq=MAX_SEQ,
            seed=SEED), max_tokens=64), params=params, device=dev)
    cap = Capture(server.engine)
    before = registry()
    generated_before = server.engine.total_generated
    recorder = flight_recorder.enable(label="chip_smoke", capacity=65536)

    def run(name):
        method, body = jobs[name]
        t0 = time.perf_counter()
        out = getattr(server, method)(dict(body))
        if body.get("stream"):
            out = list(out)
        return out, time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            futures = {name: pool.submit(run, name) for name in jobs}
            results = {name: f.result() for name, f in futures.items()}
        wall = time.perf_counter() - t0
        again = server.embeddings(dict(jobs["embeddings"][1]))
    finally:
        server.stop()  # joins the stepper: no step runs after this
        flight_recorder.disable()
    server.engine.flush_metrics()
    after = registry()
    spans = [e for e in recorder.snapshot() if e[4] == "engine_step"]
    shared["telemetry"] = dict(
        requests=len(cap.requests),
        ttft_count=after[0] - before[0],
        tokens_counted=after[1] - before[1],
        tokens_emitted=sum(len(r.output_ids) for r in cap.requests),
        total_generated=server.engine.total_generated - generated_before,
        steps_serving=sum(1 for n in cap.steps if n),
        spans=len(spans), span_tokens=sum(e[5]["tokens"] for e in spans),
        dropped_spans=recorder.capacity < len(recorder.snapshot()) + 1)
    del server
    free()

    bodies = {name: out for name, (out, _s) in results.items()}
    for name, body in bodies.items():
        if name != "stream":
            check_response(name, body)
    for r in cap.requests:
        check(r.error is None and r.finish_reason in ("stop", "length",
                                                      "abort"),
              f"request {r.request_id}: {r.finish_reason} {r.error}")
    events = [json.loads(c[len("data: "):]) for c in bodies["stream"][:-1]]
    check(bodies["stream"][-1] == "data: [DONE]\n\n"
          and all("error" not in e for e in events),
          "the stream did not end with [DONE], or carried an error")
    streamed = "".join(e["choices"][0]["text"] for e in events
                       if e["choices"])
    greedy = bodies["greedy_logprobs"]
    check(streamed == text_of(greedy),
          "the streamed text differs from the non-streamed one")
    check(events[-1]["usage"]["completion_tokens"]
          == greedy["usage"]["completion_tokens"],
          "the streamed request's usage differs from the non-streamed one")
    constraint = json_object_constraint(ByteTokenizer().token_strings())
    for name in ("stop_strings", "chat_json"):
        body = bodies[name]
        guided = text_of(body)
        if name == "chat_json" and body["choices"][0]["finish_reason"] \
                == "stop":
            check(constraint.matches(guided), f"{name}: {guided!r} is not "
                  "the grammar's")
        else:
            check(constraint.valid_prefix(guided), f"{name}: {guided!r} is "
                  "no prefix of the grammar")
    lp_request = next(r for r in cap.requests if r.logprobs == 5)
    check(len(lp_request.logprob_data) == len(lp_request.output_ids),
          "logprobs entries are missing")
    ties = 0
    for e in lp_request.logprob_data:
        vals = [v for _, v in e["top"]]
        check(len(vals) == 5 and vals == sorted(vals, reverse=True)
              and all(math.isfinite(v) and v <= 1e-6 for v in vals),
              f"logprobs top list not sorted, or not logprobs: {vals}")
        if vals[0] - vals[1] > 1e-6:
            check(e["top"][0][0] == e["id"] and e["logprob"] == vals[0],
                  f"greedy id {e['id']} is not the top logprob {e['top']}")
        else:
            ties += 1
    emb = [np.asarray(d["embedding"]) for d in bodies["embeddings"]["data"]]
    width = full_config().dim  # 4096
    check(all(v.shape == (width,) and np.isfinite(v).all() for v in emb),
          f"embeddings are not {width}-wide and finite")
    check(all(np.array_equal(a, np.asarray(d["embedding"])) for a, d in
              zip(emb, again["data"])), "a repeat embeddings call differs")
    scores = [d["score"] for d in bodies["score"]["data"]]
    check(all(-1.0 - 1e-5 <= x <= 1.0 + 1e-5 for x in scores),
          f"scores {scores}")
    completion_tokens = sum(body["usage"]["completion_tokens"]
                            for name, body in bodies.items()
                            if name in ("greedy_logprobs", "stop_strings",
                                        "chat_json", "n2"))
    completion_tokens += events[-1]["usage"]["completion_tokens"]
    return dict(
        wall_s=wall, requests_s={name: s for name, (_o, s)
                                 in results.items()},
        ttft_s=[[request_kind(r), cap.ttft.get(r.request_id)]
                for r in cap.requests],
        completion_tokens=completion_tokens,
        tokens_per_s=completion_tokens / wall,
        finish_reasons={name: [c["finish_reason"] for c in body["choices"]]
                        for name, body in bodies.items()
                        if name not in ("stream", "embeddings", "score")},
        guided_texts={name: text_of(bodies[name])
                      for name in ("stop_strings", "chat_json")},
        logprob_ties=ties, scores=scores,
        note="host clock; the byte tokenizer decodes only ids < 256, so "
             "unguided texts are mostly empty")


def telemetry(shared):
    """The registry and the flight recorder after server_openai: one
    TTFT observation per request served, the tokens counter equal to the
    tokens emitted, and one engine_step span per step that served a
    slot."""
    t = shared["telemetry"]
    check(t["ttft_count"] == t["requests"],
          f"TTFT count {t['ttft_count']} != {t['requests']} requests")
    check(t["tokens_counted"] == t["tokens_emitted"] == t["total_generated"],
          f"tokens counter {t['tokens_counted']} != emitted "
          f"{t['tokens_emitted']} / {t['total_generated']}")
    check(not t["dropped_spans"] and t["spans"] == t["steps_serving"],
          f"{t['spans']} engine_step spans for {t['steps_serving']} steps")
    check(t["span_tokens"] == t["total_generated"],
          f"spans carry {t['span_tokens']} tokens of {t['total_generated']}")
    return t


def _extras_specs(prompts, guided, bias=(1000, 2000)):
    """A plain greedy request beside a penalized, a guided, a
    logit-biased (``bias``: an id favoured, an id banned) and a logprobs
    one. The plain request runs on after the others, so that the fused
    paths serve it."""
    return [
        dict(prompt_ids=list(prompts[0]), max_tokens=3 * NEW_TOKENS),
        dict(prompt_ids=list(prompts[1]), max_tokens=NEW_TOKENS,
             presence_penalty=1.0, frequency_penalty=0.5),
        dict(prompt_ids=list(prompts[0][:64]), max_tokens=48,
             guided=guided),
        dict(prompt_ids=list(prompts[2]), max_tokens=NEW_TOKENS,
             logit_bias={bias[0]: 5.0, bias[1]: -100.0}),
        dict(prompt_ids=list(prompts[3]), max_tokens=NEW_TOKENS, logprobs=5),
    ]


def engine_extras(dev, params, prompts, outs_bf16, outs_int8):
    """The extras co-batched with a plain greedy request on a dense
    engine, a multi_step 4 engine and an int8 chunked_prefill_tokens 128
    engine. Every batched path is counted: no multi-step burst serves a
    dynamic-bias or logprobs request, and no fused chunk step a logprobs
    one (as in the reference, a chunk step may serve a dynamic-bias
    request: it emits one token per slot, and the row is rebuilt before
    the next step)."""
    from ray_tpu_torch.llm.guided import json_object_constraint
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    grammar = json_object_constraint(ByteTokenizer().token_strings())
    out = {}
    for name, kw, ref in (
            ("dense", {}, outs_bf16),
            ("multi_step", dict(multi_step=4), outs_bf16),
            ("int8_chunked", dict(quantization="int8",
                                  chunked_prefill_tokens=128), outs_int8)):
        engine = make_engine(dev, params, **kw)
        paths = {"multi": 0, "chunk": 0, "dense": 0, "chunk_dynamic": 0}

        def spy(path, fn, slots_of):
            def wrapped(*args):
                slots = slots_of(*args)
                paths[path] += 1
                for s in slots:
                    r = s.request
                    dynamic = engine._has_dynamic_bias(r)
                    check(r.logprobs is None or path == "dense",
                          f"{name}: a logprobs request took the {path} path")
                    check(not dynamic or path != "multi",
                          f"{name}: a dynamic-bias request took a burst")
                    paths["chunk_dynamic"] += dynamic and path == "chunk"
                return fn(*args)
            return wrapped

        engine._multi_step = spy("multi", engine._multi_step,
                                 lambda active, k: active)
        engine._prefill_chunk_step = spy(
            "chunk", engine._prefill_chunk_step, lambda p, d: p + d)
        engine._dense_step = spy("dense", engine._dense_step,
                                 lambda active: active)
        requests = serve(engine, _extras_specs(prompts, grammar))
        del engine
        free()
        for r in requests:
            check(r.finish_reason in ("stop", "length") and r.error is None,
                  f"{name}: request {r.request_id} {r.finish_reason}")
        plain, penalized, guided, biased, logprobs = requests
        check(len(logprobs.logprob_data) == len(logprobs.output_ids),
              f"{name}: logprobs missing")
        check(2000 not in biased.output_ids, f"{name}: a banned id came out")
        check(all(t < 256 or t == 257 for t in guided.output_ids),
              f"{name}: the guided request left the byte vocabulary")
        if "multi_step" in kw:
            check(paths["multi"] > 0, f"{name}: no multi-step burst ran")
        if "chunked_prefill_tokens" in kw:
            check(paths["chunk"] > 0, f"{name}: no chunk step ran")
        out[name] = dict(
            paths=paths, finish=[r.finish_reason for r in requests],
            tokens=[len(r.output_ids) for r in requests],
            guided_text=ByteTokenizer().decode(guided.output_ids),
            plain_agreement=agreement(plain.output_ids[:NEW_TOKENS],
                                      ref[0]))
    return out


def engine_disagg(dev, params, prompts, outs_bf16):
    """prefill_only on a prefill engine -> the K/V to the host as bf16
    tensors -> add_prefilled on a decode engine, for phase 4's four
    prompts; the host round trip of the 700-token prompt's K/V is timed
    (to the card and back, synchronised)."""
    import torch
    from ray_tpu_torch.llm import GenerationRequest
    pre = make_engine(dev, params, max_batch=1)
    dec = make_engine(dev, params)
    blocks, prefill_ms = [], []
    for p in prompts:
        t0 = time.perf_counter()
        blocks.append(pre.prefill_only(list(p)))
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    ks, vs = blocks[-1][:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = (ks.to(dev), vs.to(dev))
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = tuple(t.cpu() for t in on_card)
    d2h_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(a, b) for a, b in zip(back, (ks, vs))),
          "the K/V block changed on its round trip")
    del on_card, back
    requests = [dec.add_prefilled(GenerationRequest(
        prompt_ids=list(p), max_tokens=NEW_TOKENS), *block)
        for p, block in zip(prompts, blocks)]
    while any(not r.done for r in requests):
        dec.step()
    del pre, dec, blocks
    free()
    for r, want in zip(requests, outs_bf16):
        check(r.finish_reason == "length"
              and len(r.output_ids) == NEW_TOKENS,
              f"adopted request {r.request_id}: {r.finish_reason}, "
              f"{len(r.output_ids)} tokens")
        check(r.output_ids[0] == want[0],
              "an adopted request's first token differs from engine_bf16's")
    return dict(kv_shape=list(ks.shape), kv_dtype=str(ks.dtype),
                kv_mb=2 * ks.numel() * ks.element_size() / 1e6,
                kv_to_card_ms=h2d_ms, kv_to_host_ms=d2h_ms,
                prefill_only_ms=prefill_ms,
                agreement_with_colocated=[agreement(r.output_ids, o) for
                                          r, o in zip(requests, outs_bf16)])


def extras_tiny_f32(dev):
    """LlamaConfig.tiny(vocab 258) in f32 on the card and on the CPU:
    penalties, guided JSON, logit bias, logprobs, disaggregation and the
    LLMServer give the same greedy outputs, logprobs and embeddings
    within 1e-4; then the same extras on int8 FFN weights (K5)."""
    import numpy as np
    import torch
    from ray_tpu_torch.llm import (
        ContinuousBatchingEngine, EngineConfig, GenerationRequest)
    from ray_tpu_torch.llm.guided import json_object_constraint
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models import LlamaConfig, llama_init
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer
    cfg = LlamaConfig.tiny(vocab_size=258, max_seq_len=64)
    cpu_params = llama_init(SEED, cfg, device="cpu")
    # one grammar for every run (a build takes seconds; its mask cache
    # is shared, each request keeps its own state)
    guided = json_object_constraint(ByteTokenizer().token_strings())
    tiny_prompts = [[1, 5, 9, 13], [2, 4, 6], list(range(30, 50)), [7, 7]]
    out = {}

    def specs():
        return _extras_specs(tiny_prompts, guided, bias=(65, 66))

    def run(where, quantization=None):
        card = where == "card"
        params = to_card(cpu_params, dev, torch.float32) if card \
            else cpu_params
        device = dev if card else "cpu"
        engine = ContinuousBatchingEngine(EngineConfig(
            model=cfg, max_batch=4, max_seq=64, seed=SEED,
            quantization=quantization), params=params, device=device)
        reqs = serve(engine, [dict(s, max_tokens=min(s["max_tokens"], 16))
                              for s in specs()])
        block = engine.prefill_only([3, 1, 4, 1, 5])
        adopted = engine.add_prefilled(GenerationRequest(
            prompt_ids=[3, 1, 4, 1, 5], max_tokens=8), *block)
        while not adopted.done:
            engine.step()
        emb = engine.embed(list(range(1, 41)))
        del engine
        if quantization:
            return [r.output_ids for r in reqs]
        server = LLMServer(LLMConfig(model_id="tiny", engine=EngineConfig(
            model=cfg, max_batch=4, max_seq=64, seed=SEED), max_tokens=8),
            params=params, device=device)
        try:
            bodies = [server.completions({"prompt": "hello",
                                          "max_tokens": 8}),
                      server.chat_completions({
                          "messages": [{"role": "user", "content": "hi"}],
                          "max_tokens": 16,
                          "response_format": {"type": "json_object"}})]
        finally:
            server.stop()
        return dict(streams=[r.output_ids for r in reqs],
                    logprobs=reqs[4].logprob_data,
                    adopted=adopted.output_ids, embed=emb,
                    texts=[text_of(b) for b in bodies])

    card, cpu = run("card"), run("cpu")
    free()
    for key in ("streams", "adopted", "texts"):
        check(card[key] == cpu[key],
              f"tiny f32 extras: the card's {key} differ from the CPU's")
    check(len(card["logprobs"]) == len(cpu["logprobs"]) > 0,
          "tiny f32 logprobs: entries missing")
    lp_err = max(abs(x - y) for a, b in zip(card["logprobs"],
                                             cpu["logprobs"])
                 for x, y in zip([a["logprob"]] + [v for _, v in a["top"]],
                                 [b["logprob"]] + [v for _, v in b["top"]]))
    check(lp_err <= 1e-4, f"tiny f32 logprobs differ by {lp_err}")
    emb_err = float(np.abs(card["embed"] - cpu["embed"]).max())
    check(emb_err <= 1e-4, f"tiny f32 embed differs by {emb_err}")
    int8 = {where: run(where, "int8") for where in ("card", "cpu")}
    check(all(len(o) > 0 for o in int8["card"]), "tiny int8 extras: a "
          "request emitted nothing")
    out.update(logprobs_max_abs_err=lp_err, embed_max_abs_err=emb_err,
               texts=card["texts"],
               int8_agreement_with_cpu=[agreement(a, b) for a, b in
                                        zip(int8["card"], int8["cpu"])])
    return out


def batch_stages(dev, params, card):
    """TokenizeStage -> EngineStage -> DetokenizeStage over 16 prompts
    in batches of 8, with throughput_summary over the rows beside the
    card's name and power limit."""
    from ray_tpu_torch.llm.batch import (
        DetokenizeStage, EngineStage, ProcessorConfig, TokenizeStage,
        throughput_summary)
    from ray_tpu_torch.llm.engine import EngineConfig
    config = ProcessorConfig(engine=EngineConfig(
        model=full_config(), max_batch=MAX_BATCH, max_seq=MAX_SEQ,
        seed=SEED), batch_size=8, max_tokens=NEW_TOKENS)
    tok, detok = TokenizeStage(None), DetokenizeStage(None)
    engine = EngineStage(config, params=params, device=dev)
    prompts = [f"question {i}: " + "why is the sky blue? " * (1 + i % 5)
               for i in range(16)]
    rows = []
    for i in range(0, len(prompts), config.batch_size):
        batch = detok(engine(tok({"prompt": prompts[i:i + 8]})))
        rows += [{k: batch[k][j] for k in batch} for j in range(8)]
    del engine
    free()
    check(len(rows) == 16 and all(
        0 < len(r["generated_ids"]) <= NEW_TOKENS for r in rows),
        "a batch row came back without its tokens")
    summary = throughput_summary(rows)
    return dict(summary, card=card, rows=len(rows),
                tokens=[int(r["num_generated_tokens"]) for r in rows])


def run_features(dev, params, prompts, bf16, outs_bf16, outs_int8, card):
    """The feature phases; returns their launch counts summed."""
    shared = {}  # server_openai's records, read by telemetry
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
        ("server_openai", ("flash_attention", "rms_norm"),
         server_openai, (dev, params, shared)),
        ("telemetry", (), telemetry, (shared,)),
        ("engine_extras", ("flash_attention", "rms_norm", "int8_matmul"),
         engine_extras, (dev, params, prompts, outs_bf16, outs_int8)),
        ("engine_disagg", ("flash_attention", "rms_norm"),
         engine_disagg, (dev, params, prompts, outs_bf16)),
        ("extras_tiny_f32", ("rms_norm", "int8_matmul"),
         extras_tiny_f32, (dev,)),
        ("batch_stages", ("flash_attention", "rms_norm"),
         batch_stages, (dev, params, card)),
    ]
    total = {name: 0 for name in _counted()}
    for name, required, fn, args in phases:
        counts = run_phase(name, required, fn, *args)
        total = {k: total[k] + counts[k] for k in total}
    return total


# ---------------------------------------------------------------------------
# the LLM surface on Serve: replicas of the port's runtime on the card
# ---------------------------------------------------------------------------

SERVE_LAYERS = 4  # serve_multiplex and serve_prefix: 4 of Llama-3-8B's 32
SERVE_READY_S = 300.0  # a deployment's replicas up and healthy
LOADGEN_S = 15.0  # the open-loop run through the proxy
LOADGEN_IN_FLIGHT = 4.0  # its rate: this many single-request latencies
SERVE_FREED_SLACK = 512 << 20  # card memory the serve phases may leave
# the object store's arena: a 700-token prompt's K/V block is 134 MB in
# bf16, and the default 256 MiB arena would spill blocks to disk
SERVE_ARENA_BYTES = 4 << 30
# fractional-GPU workers warmed before the first deployment: the
# multiplex replica, the two prefix replicas, prefill and decode (a
# fresh process spends ~8 s importing torch on the card machine)
SERVE_WARM_GPU_WORKERS = 5
SPAN_NAMES = ("http_request", "route", "handle_request_streaming",
              "engine_generate")


def serve_config(model_id, n_layers=None, quantization=None, seed=SEED,
                 **fields):
    """An LLMConfig of Llama-3-8B (``n_layers`` of its 32 when given),
    serving NEW_TOKENS greedy tokens by default."""
    from ray_tpu_torch.llm.engine import EngineConfig
    from ray_tpu_torch.serve.llm import LLMConfig
    model = full_config()
    if n_layers is not None:
        model = dataclasses.replace(model, n_layers=n_layers)
    return LLMConfig(model_id=model_id, engine=EngineConfig(
        model=model, max_batch=MAX_BATCH, max_seq=MAX_SEQ, seed=seed,
        quantization=quantization), max_tokens=NEW_TOKENS, **fields)


def replica_launches(replica, reset=False):
    """(In a replica's process, through ``__ray_call__``.) Its launch
    count of each kernel wrapper, zeroed after the read with ``reset``."""
    fns = _counted()
    out = {name: fn.launches for name, fn in fns.items()}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return out


def replica_capture(replica):
    """(In a replica's process.) Keep every request its engine admits
    from now on (``add_request`` and ``add_prefilled``)."""
    server = replica.callable
    if hasattr(server, "_smoke_kept"):
        return True
    engine, kept = server.engine, []
    add, adopt = engine.add_request, engine.add_prefilled

    def add_request(request):
        kept.append(request)
        return add(request)

    def add_prefilled(request, *args):
        kept.append(request)
        return adopt(request, *args)

    engine.add_request, engine.add_prefilled = add_request, add_prefilled
    server._smoke_kept = kept
    return True


def replica_captured(replica):
    """(In a replica's process.) [(prompt ids, output ids, finish reason,
    error)] of the kept requests in admission order; the list empties."""
    kept = replica.callable._smoke_kept
    out = [(list(r.prompt_ids), list(r.output_ids), r.finish_reason,
            r.error) for r in kept]
    kept.clear()
    return out


def replica_track_loads(replica):
    """(In a multiplex replica's process.) Keep every LLMServer its LRU
    loader hands out, so that evicted ones can be read after."""
    mux = replica.callable
    load, servers = mux._load, []

    def tracked(model_id):
        server = load(model_id)
        if all(s is not server for s in servers):
            servers.append(server)
        return server

    mux._load, mux._smoke_servers = tracked, servers
    return True


def replica_loaded(replica):
    """(In a multiplex replica's process.) [(model id, stopped, stepper
    alive)] of each server loaded, in load order; the list empties."""
    servers = replica.callable._smoke_servers
    out = [(s.config.model_id, s._stopped, s._stepper.is_alive())
           for s in servers]
    servers.clear()
    return out


def warm_worker():
    """(A task in a fresh worker.) Import torch and the port's LLM
    surface, make a CUDA context and a cuBLAS handle: the pooled worker
    then hosts a replica without a fresh process's start."""
    import torch
    import ray_tpu_torch.serve.llm  # noqa: F401
    if torch.cuda.is_available():
        x = torch.ones(8, 8, device="cuda")
        (x @ x).sum().item()
    return os.getpid()


def on_replicas(deployment_name, fn, *args):
    """``fn(replica, *args)`` in each replica's process of a deployment;
    {replica id: result}."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    _version, replicas = ray_tpu_torch.get(
        controller.get_replicas.remote(deployment_name))
    return {rid: ray_tpu_torch.get(h.__ray_call__.remote(fn, *args),
                                   timeout=120)
            for rid, h in replicas}


def replica_counts(*deployment_names):
    """The launches the replicas of these deployments made, summed."""
    total = {name: 0 for name in _counted()}
    for dep in deployment_names:
        for counts in on_replicas(dep, replica_launches).values():
            total = add_counts(total, counts)
    return total


def http(port, path, body=None, headers=None, timeout=300):
    """(status, response headers, body text) of one request to the
    proxy; an HTTP error's too."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read().decode()


def http_ok(what, port, path, body=None, **kw):
    """A JSON answer with status 200 and no error in it."""
    status, _headers, raw = http(port, path, body, **kw)
    check(status == 200, f"{what}: HTTP {status} {raw[:300]}")
    out = json.loads(raw)
    check_response(what, out)
    return out


def sse_events(what, headers, raw):
    """An SSE body's JSON events; it must end with [DONE] and carry no
    error."""
    check(headers.get("Content-Type", "").startswith("text/event-stream"),
          f"{what}: not an event stream")
    check(raw.endswith("data: [DONE]\n\n"), f"{what}: no [DONE]")
    events = [json.loads(e[len("data: "):]) for e in raw.split("\n\n")
              if e.startswith("data: {")]
    check(events and all("error" not in e for e in events),
          f"{what}: an event carries an error")
    return events


def strip_ids(obj):
    """A response without its random completion and tool-call ids."""
    if isinstance(obj, dict):
        return {k: strip_ids(v) for k, v in obj.items()
                if not (k == "id" and isinstance(v, str) and
                        v.startswith(("cmpl-", "chatcmpl-", "call_")))}
    if isinstance(obj, list):
        return [strip_ids(v) for v in obj]
    return obj


def stream_rows(served, wants):
    """Each served greedy stream against its expected ids: equal token
    for token, or (a batch composition that moves a row) the first
    token equal, with where the first difference is and the agreement."""
    rows = []
    for (_ids, out, finish, error), want in zip(served, wants):
        check(error is None and finish in ("length", "stop"),
              f"a served request ended with {finish}: {error}")
        check(out[0] == want[0], "a served request's first token differs")
        diff = next((i for i, (a, b) in enumerate(zip(out, want))
                     if a != b), None)
        rows.append(dict(exact=diff is None and (
            len(out) == len(want) or finish == "stop"),
            first_difference=diff, agreement=agreement(out, want),
            tokens=len(out), finish=finish))
    return rows


def serve_llm(rt, port, texts, prompts, outs_bf16, shared):
    """Llama-3-8B (full width and depth, bf16, weights from the config's
    seed) as one replica on the whole card behind the HTTP proxy:
    phase 4's prompts one at a time, an SSE stream, chat, n 2, the
    model list, an unknown model, a traced request and an open-loop
    loadgen run."""
    import os
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.serve import loadgen
    from ray_tpu_torch.serve.llm import build_openai_app
    name = "llama3-8b"
    t0 = time.perf_counter()
    serve.run(build_openai_app(config=serve_config(name)), name="llm",
              route_prefix="/v1", timeout_s=SERVE_READY_S)
    start_s = time.perf_counter() - t0
    on_replicas(name, replica_launches, True)
    on_replicas(name, replica_capture)
    bodies, request_s = [], []
    for i, text in enumerate(texts):
        t1 = time.perf_counter()
        bodies.append(http_ok(f"prompt {i}", port, "/v1/completions",
                              {"prompt": text, "max_tokens": NEW_TOKENS}))
        request_s.append(time.perf_counter() - t1)
    (served,) = on_replicas(name, replica_captured).values()
    check(len(served) == len(texts), f"{len(served)} requests served")
    tok = ByteTokenizer()
    for (ids, out, _finish, _err), prompt, body in zip(served, prompts,
                                                        bodies):
        check(ids == list(prompt), "a served prompt's ids are not phase 4's")
        check(body["usage"] == {"prompt_tokens": len(ids),
                                "completion_tokens": len(out),
                                "total_tokens": len(ids) + len(out)},
              f"usage {body['usage']}")
        check(body["choices"][0]["text"] == tok.decode(
            [t for t in out if t != tok.eos_id]), "text is not the ids'")
    rows = stream_rows(served, outs_bf16)
    shared["bodies"], shared["outs"] = bodies, [s[1] for s in served]

    status, headers, raw = http(port, "/v1/completions", {
        "prompt": texts[0], "max_tokens": NEW_TOKENS, "stream": True,
        "stream_options": {"include_usage": True}})
    check(status == 200, f"stream: HTTP {status}")
    events = sse_events("stream", headers, raw)
    check("".join(e["choices"][0]["text"] for e in events if e["choices"])
          == bodies[0]["choices"][0]["text"]
          and events[-1]["usage"] == bodies[0]["usage"],
          "the streamed text or usage differs from the non-streamed one")
    chat = http_ok("chat", port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": texts[1]}],
        "max_tokens": 16})
    check(chat["object"] == "chat.completion", "chat: not a chat answer")
    n2 = http_ok("n2", port, "/v1/completions", {
        "prompt": texts[0], "max_tokens": 16, "n": 2, "temperature": 0.8})
    check(len(n2["choices"]) == 2, "n 2: not two choices")
    models = http_ok("models", port, "/v1/models")
    check(models["data"] == [{"id": name, "object": "model"}],
          f"models {models}")
    # one model behind LLMServer: an unknown id is the reference's
    # invalid request (the multi-model surface's 404 is serve_multiplex's)
    status, _headers, raw = http(port, "/v1/completions",
                                 {"model": "nope", "prompt": "x"})
    unknown = json.loads(raw)
    check(status == 200 and unknown["error"]["type"]
          == "invalid_request_error" and "nope" in
          unknown["error"]["message"], f"unknown model: {status} {raw}")

    trace_id = os.urandom(16).hex()
    status, headers, raw = http(
        port, "/v1/completions", {"prompt": texts[0], "max_tokens": 4},
        headers={"traceparent": f"00-{trace_id}-{os.urandom(8).hex()}-01"})
    check(status == 200 and trace_id in (headers.get("traceparent") or ""),
          "the traced request's traceparent did not come back")
    deadline = time.monotonic() + 15
    while True:  # the replica's spans arrive by control-plane calls
        spans = rt.gcs.spans_for_trace(trace_id)
        names = {s[3] for s in spans}
        if set(SPAN_NAMES) <= names or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    check(set(SPAN_NAMES) <= names, f"trace spans {sorted(names)}")
    by_name = {s[3]: s for s in spans}
    check(by_name["route"][2] == by_name["http_request"][1]
          and by_name["engine_generate"][2]
          == by_name["handle_request_streaming"][1],
          "the trace's parent links are not the proxy's -> router's, "
          "replica's -> engine's")

    on_replicas(name, replica_captured)  # from here on: loadgen's only
    latency = min(request_s)  # a warm request (the first pays start-up)
    cfg = loadgen.LoadgenConfig(
        rate=LOADGEN_IN_FLIGHT / latency, duration_s=LOADGEN_S,
        arrival="poisson", prefix_groups=4, concurrency=32,
        timeout_s=120.0, seed=SEED)
    report = loadgen.run_load(cfg, loadgen.http_sender(
        f"http://127.0.0.1:{port}/v1/completions", timeout_s=120.0))
    (load_served,) = on_replicas(name, replica_captured).values()
    check(report.errors == 0 and report.ok + report.shed
          == report.offered, f"loadgen: {report.to_dict()}")
    bad = [(finish, err) for _i, _o, finish, err in load_served
           if err is not None or finish not in ("length", "stop")]
    check(len(load_served) == report.ok and not bad,
          f"loadgen: {len(load_served)} requests on the replica for "
          f"{report.ok} answers, ended badly: {bad[:3]}")
    counts = add_counts(replica_counts(name), read_counts())
    check(counts["flash_attention"] > 0 and counts["rms_norm"] > 0,
          f"serve_llm: the replica did not launch K1/K4: {counts}")
    check(counts["flash_attention_bwd_dq"] == 0
          and counts["flash_attention_bwd_dkv"] == 0
          and counts["int8_matmul"] == 0,
          f"serve_llm: K2/K3/K5 launched: {counts}")
    serve.delete("llm")
    return dict(
        start_s=start_s, request_s=request_s, rows=rows,
        exact_rows=sum(r["exact"] for r in rows),
        tokens_per_s=[len(o) / s for o, s in
                      zip(shared["outs"], request_s)],
        stream_events=len(events), spans=sorted(names),
        loadgen=dict(rate=cfg.rate, duration_s=cfg.duration_s,
                     offered=report.offered, completed=report.ok,
                     shed=report.shed, errors=report.errors,
                     p50_ms=report.p50_ms, p99_ms=report.p99_ms,
                     achieved_rps=report.achieved_rps),
        note="host clock; the byte tokenizer decodes only ids < 256"), \
        counts


def serve_multiplex(rt, port, texts):
    """Two Llama-3-8B-width models (4 of 32 layers) behind one
    multiplexed replica that holds one at a time: A in bf16, B with int8
    FFN weights (K5); requests to A, B, A, each eviction stopping the
    evicted engine; the per-model counters, the model list and an
    unknown id's 404; and one call of A in local testing mode in this
    process, equal to the replica's."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_openai_app
    from ray_tpu_torch.util import metrics
    a = serve_config("mux-a", SERVE_LAYERS)
    b = serve_config("mux-b", SERVE_LAYERS, quantization="int8",
                     seed=SEED + 1)

    def build():
        return build_openai_app([a, b], max_models_per_replica=1,
                                name="mux", num_gpus=0.5)

    def counters():
        with metrics._registry.lock:
            return {(n, m): metrics._registry.counters.get(
                (n, (("model", m),)), 0.0)
                for n in ("ray_tpu_serve_llm_requests_total",
                          "ray_tpu_serve_llm_generated_tokens_total")
                for m in ("mux-a", "mux-b")}

    t0 = time.perf_counter()
    serve.run(build(), name="mux", route_prefix="/mux",
              timeout_s=SERVE_READY_S)
    start_s = time.perf_counter() - t0
    on_replicas("mux", replica_launches, True)
    on_replicas("mux", replica_track_loads)
    before = counters()
    order = [("mux-a", texts[1]), ("mux-b", texts[1]), ("mux-a", texts[2])]
    answers, request_s = [], []
    for model, text in order:
        t1 = time.perf_counter()
        answers.append(http_ok(model, port, "/mux/completions", {
            "model": model, "prompt": text, "max_tokens": 16}))
        request_s.append(time.perf_counter() - t1)
        check(answers[-1]["model"] == model, "answered by another model")
    status, _headers, raw = http(port, "/mux/completions",
                                 {"model": "nope", "prompt": "x"})
    check(status == 404 and json.loads(raw)["error"]["code"]
          == "model_not_found", f"unknown model: {status} {raw}")
    models = http_ok("models", port, "/mux/models")
    check({m["id"] for m in models["data"]} == {"mux-a", "mux-b"},
          f"models {models}")
    (loaded,) = on_replicas("mux", replica_loaded).values()
    check(loaded == [("mux-a", True, False), ("mux-b", True, False),
                     ("mux-a", False, True)],
          f"evictions did not stop the evicted engines: {loaded}")
    deadline = time.monotonic() + 10
    while True:  # counters reach the driver by control-plane calls
        delta = {k: v - before[k] for k, v in counters().items()}
        if delta[("ray_tpu_serve_llm_requests_total", "mux-a")] >= 2 or \
                time.monotonic() > deadline:
            break
        time.sleep(0.1)
    tokens = {m: sum(ans["usage"]["completion_tokens"] for (mm, _t), ans
                     in zip(order, answers) if mm == m)
              for m in ("mux-a", "mux-b")}
    check(delta == {
        ("ray_tpu_serve_llm_requests_total", "mux-a"): 2,
        ("ray_tpu_serve_llm_requests_total", "mux-b"): 1,
        ("ray_tpu_serve_llm_generated_tokens_total", "mux-a"):
            tokens["mux-a"],
        ("ray_tpu_serve_llm_generated_tokens_total", "mux-b"):
            tokens["mux-b"]}, f"per-model counters {delta}")
    counts = replica_counts("mux")
    for kname in ("flash_attention", "rms_norm", "int8_matmul"):
        check(counts[kname] > 0,
              f"serve_multiplex: the replica never launched {kname}")
    serve.delete("mux")

    t1 = time.perf_counter()
    local = serve.run(build(), local_testing_mode=True)
    reset_counts()
    body = local.remote({"__path__": "/v1/completions", "model": "mux-a",
                         "prompt": texts[2], "max_tokens": 16}
                        ).result(timeout_s=300)
    local_counts = read_counts()
    local._instance._load("mux-a").stop()
    # @serve.multiplexed keeps its LRU in its module, one a process: a
    # replica's goes with its process, this process's model goes here
    from ray_tpu_torch.serve import multiplex
    multiplex._caches.clear()
    del local
    free()
    local_s = time.perf_counter() - t1
    check(strip_ids(body) == strip_ids(answers[2]),
          "the local testing mode's answer differs from the replica's")
    return dict(start_s=start_s, request_s=request_s, loaded=loaded,
                counters=[[list(k), v] for k, v in delta.items()],
                local_mode_s=local_s, local_launches=local_counts), \
        add_counts(counts, local_counts)


def serve_prefix(rt, port, texts):
    """Two Llama-3-8B-width replicas (4 of 32 layers) on half the card
    each behind the prefix-aware router: tests/test_serve.py:456's
    affinity scenario, six then four prompts sharing a 234-character
    prefix, and one unrelated prompt."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.serve.llm import build_openai_app
    cfg = serve_config("pfx", SERVE_LAYERS, num_replicas=2,
                       prefix_routing=True)
    t0 = time.perf_counter()
    serve.run(build_openai_app(config=cfg, num_gpus=0.5), name="pfx",
              route_prefix="/pfx", timeout_s=SERVE_READY_S)
    start_s = time.perf_counter() - t0
    on_replicas("pfx", replica_launches, True)
    on_replicas("pfx", replica_capture)
    handle = serve.get_deployment_handle("pfx", app_name="pfx")
    base = "System: you are terse. Document: " + texts[3][:200]
    prompts = ([base + f" q{i}" for i in range(6)]
               + [base + f" late{i}" for i in range(4)] + ["zzz different"])
    for p in prompts:
        out = handle.remote({"__path__": "/v1/completions", "prompt": p,
                             "max_tokens": 4}).result(timeout_s=300)
        check_response("prefix", out)
    tok = ByteTokenizer()
    where = {}
    for rid, served in on_replicas("pfx", replica_captured).items():
        for ids, _out, finish, err in served:
            check(err is None, f"prefix: {err}")
            where[tok.decode(ids)] = rid
    late = {where[p] for p in prompts[6:10]}
    check(len(late) == 1, f"shared-prefix prompts spread over {late}")
    (sticky,) = late
    shared = sum(where[p] == sticky for p in prompts[:10]) / 10
    counts = replica_counts("pfx")
    check(counts["flash_attention"] > 0 and counts["rms_norm"] > 0,
          f"serve_prefix: no K1/K4 in the replicas: {counts}")
    serve.delete("pfx")
    return dict(start_s=start_s, shared_prefix_on_one_replica=shared,
                replicas_used=len(set(where.values()))), counts


def serve_disagg(rt, port, texts, shared):
    """Llama-3-8B (full width and depth) split into a prefill and a
    decode replica on half the card each behind the disaggregating
    router: phase 4's prompts through the proxy equal serve_llm's (text,
    usage, ids), one streamed request, and the K/V block's size and
    hand-off."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.disagg import build_disagg_app
    cfg = serve_config("dis")
    t0 = time.perf_counter()
    serve.run(build_disagg_app(cfg), name="dis", route_prefix="/dis",
              timeout_s=SERVE_READY_S)
    start_s = time.perf_counter() - t0
    for dep in ("dis-prefill", "dis-decode"):
        on_replicas(dep, replica_launches, True)
    on_replicas("dis-decode", replica_capture)
    bodies, request_s = [], []
    for i, text in enumerate(texts):
        t1 = time.perf_counter()
        bodies.append(http_ok(f"disagg {i}", port, "/dis/v1/completions",
                              {"prompt": text, "max_tokens": NEW_TOKENS}))
        request_s.append(time.perf_counter() - t1)
    for body, want in zip(bodies, shared["bodies"]):
        check(body["choices"][0]["text"] == want["choices"][0]["text"]
              and body["usage"] == want["usage"],
              "a disaggregated answer differs from serve_llm's")
    (served,) = on_replicas("dis-decode", replica_captured).values()
    rows = stream_rows(served, shared["outs"])
    check(all(r["exact"] for r in rows),
          f"disaggregated ids differ from serve_llm's: {rows}")
    status, headers, raw = http(port, "/dis/v1/completions", {
        "prompt": texts[3], "max_tokens": NEW_TOKENS, "stream": True})
    check(status == 200, f"disagg stream: HTTP {status}")
    events = sse_events("disagg stream", headers, raw)
    check("".join(e["choices"][0]["text"] for e in events)
          == bodies[3]["choices"][0]["text"]
          and events[-1]["usage"] == bodies[3]["usage"],
          "the disaggregated stream differs from the non-streamed answer")
    prefill = serve.get_deployment_handle("dis-prefill", app_name="dis")
    t1 = time.perf_counter()
    block = prefill.prefill.remote(texts[3]).result(timeout_s=300)
    fetch_ms = (time.perf_counter() - t1) * 1e3
    counts = {dep: replica_counts(dep) for dep in ("dis-prefill",
                                                    "dis-decode")}
    check(counts["dis-prefill"]["flash_attention"] > 0
          and counts["dis-prefill"]["rms_norm"] > 0,
          f"the prefill replica did not launch K1/K4: {counts}")
    check(counts["dis-decode"]["rms_norm"] > 0,
          f"the decode replica did not launch K4: {counts}")
    serve.delete("dis")
    return dict(
        start_s=start_s, request_s=request_s, rows=rows,
        kv_shape=list(block["ks"].shape), kv_dtype=block["ks"].dtype,
        kv_mb=(block["ks"].nbytes + block["vs"].nbytes) / 1e6,
        kv_handoff_ms=events[-1].get("kv_handoff_ms"),
        prefill_to_driver_ms=fetch_ms, launches_by_replica=counts), \
        add_counts(counts["dis-prefill"], counts["dis-decode"])


def run_serve(dev, card, texts, prompts, outs_bf16):
    """The Serve phases on one port runtime and one HTTP proxy; the card's
    free memory must come back once Serve and the runtime are shut
    down. Returns the launches, the replicas' and this process's."""
    import torch
    import ray_tpu_torch
    from ray_tpu_torch import serve
    free()
    free_before = torch.cuda.mem_get_info(dev)[0]
    total = {name: 0 for name in _counted()}
    shared = {}
    t0 = time.perf_counter()
    rt = ray_tpu_torch.init(object_store_memory=SERVE_ARENA_BYTES)
    try:
        serve.start(proxy=True, http_options=serve.HTTPOptions(port=0))
        port = serve._proxy.port
        # a warm pool: the replicas after serve_llm's (which takes the
        # whole card, 1.0 of it) start in pooled workers, the disagg
        # router in the CPU one
        warm = [ray_tpu_torch.remote(num_gpus=0.01)(warm_worker).remote()
                for _ in range(SERVE_WARM_GPU_WORKERS)]
        warm.append(ray_tpu_torch.remote(warm_worker).remote())
        pids = ray_tpu_torch.get(warm, timeout=SERVE_READY_S)
        emit("serve_start", seconds=time.perf_counter() - t0,
             warm_workers=len(set(pids)))
        phases = [("serve_llm", serve_llm,
                   (rt, port, texts, prompts, outs_bf16, shared)),
                  ("serve_multiplex", serve_multiplex, (rt, port, texts)),
                  ("serve_prefix", serve_prefix, (rt, port, texts)),
                  ("serve_disagg", serve_disagg, (rt, port, texts, shared))]
        for name, fn, args in phases:
            reset_counts()
            t0 = time.perf_counter()
            fields, counts = fn(*args)
            emit(name, seconds=time.perf_counter() - t0, card=card,
                 launches=counts, **fields)
            total = add_counts(total, counts)
    finally:
        _stop_runtime()
    t0 = time.perf_counter()
    deadline = time.monotonic() + 60
    while True:  # replica processes exit after the runtime's shutdown
        free_after = torch.cuda.mem_get_info(dev)[0]
        if free_after >= free_before - SERVE_FREED_SLACK or \
                time.monotonic() > deadline:
            break
        time.sleep(0.5)
    emit("serve_memory", free_before_gb=free_before / 1e9,
         free_after_gb=free_after / 1e9,
         wait_s=time.perf_counter() - t0)
    check(free_after >= free_before - SERVE_FREED_SLACK,
          f"the card's free memory did not come back: {free_before} -> "
          f"{free_after} bytes")
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
# phase 3b: sequence and pipeline parallelism at Llama-3-8B width
# ---------------------------------------------------------------------------

# Llama-3-8B's attention (H 32, KVH 8, D 128) at B1 S8192: 4 virtual ranks
# of 2048 positions each
SEQ_SHAPE = (1, 8192, 32, 8, 128)
SEQ_RANKS = 4
SEQ_LLAMA_TOKENS = 2048
PIPE_MICRO, PIPE_SEQ = 4, 1024
ATTENTION_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv")


@contextlib.contextmanager
def nccl_world1(dev):
    """A world-1 NCCL default group (a HashStore: no port is bound); the
    sequence-parallel entry points take it as their group."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        yield
    finally:
        dist.destroy_process_group()


def attention_counts(n_each: int):
    return {k: (n_each if k in ATTENTION_KERNELS else 0)
            for k in _counted()}


def seq_inputs(dev, gen):
    """q, k, v, dO at SEQ_SHAPE, bf16."""
    import torch
    b, s, h, kvh, d = SEQ_SHAPE
    return [torch.randn((b, s, heads, d), generator=gen, device=dev)
            .bfloat16() for heads in (h, kvh, kvh, h)]


def reference_f32(q, k, v, do, causal):
    """The plain f32 attention and its grads, one KV head's group of
    query heads at a time (a [B, H / KVH, S, S] f32 score block each)."""
    import torch
    from ray_tpu_torch.parallel.ring_attention import reference_attention
    g = q.shape[2] // k.shape[2]
    parts = []
    for j in range(k.shape[2]):
        qs = q[:, :, j * g:(j + 1) * g].float().requires_grad_()
        ks = k[:, :, j:j + 1].float().requires_grad_()
        vs = v[:, :, j:j + 1].float().requires_grad_()
        o = reference_attention(qs, ks, vs, causal=causal)
        o.backward(do[:, :, j * g:(j + 1) * g].float())
        parts.append((o.detach(), qs.grad, ks.grad, vs.grad))
        del o
    return [torch.cat(ts, dim=2) for ts in zip(*parts)]


def attention_errors(got, ref):
    """Errors of (out, dq, dk, dv) against ``ref``: the output's max abs
    and worst query row's relative L2, each grad's relative L2 and worst
    row's (phase 3's measures)."""
    import torch
    errs = {}
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        diff = g.float() - r.float()
        errs[name] = dict(max_abs_err=diff.abs().max().item(),
                          rel_l2_err=rel_l2(diff, r).item(),
                          worst_row_rel_l2_err=rel_l2(
                              diff, r, dim=(2, 3)).max().item())
        check(bool(torch.isfinite(g).all()), f"{name} non-finite")
    return errs


def ring_virtual(dev, gen, causal):
    """The ring's per-rank steps for SEQ_RANKS virtual ranks on the card
    (``ring_attention_lockstep``: each block handed on where the ring
    sends it): output and grads against ``flash_attention`` over the
    whole sequence and against the plain f32 version, beside flash's own
    error; K1-K3 launch n(n + 1) / 2 times causal, n^2 full; the ring's
    time beside flash's."""
    import torch
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.parallel.ring_attention import (
        ring_attention_lockstep)
    n = SEQ_RANKS
    q, k, v, do = seq_inputs(dev, gen)
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(n, dim=1)]
                       for t in (q, k, v, do))
    reset_counts()
    parts = ring_attention_lockstep(qs, ks, vs, causal, dos)
    torch.cuda.synchronize()
    counts = read_counts()
    want = attention_counts(n * (n + 1) // 2 if causal else n * n)
    what = f"ring over {n} virtual ranks, causal={causal}"
    check(counts == want, f"{what}: launches {counts} != {want}")
    ring = [torch.cat(ts, dim=1) for ts in parts]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = att.flash_attention(*leaves, causal)
    o.backward(do)
    flash = [o.detach()] + [t.grad for t in leaves]
    del o, leaves
    ref = reference_f32(q, k, v, do, causal)
    errs = {"ring_vs_f32": attention_errors(ring, ref),
            "flash_vs_f32": attention_errors(flash, ref),
            "ring_vs_flash": attention_errors(ring, flash)}
    # phase 3's gates for K1 (the output) and K2/K3 (the grads)
    for against in ("ring_vs_f32", "ring_vs_flash"):
        out = errs[against]["out"]
        check(out["max_abs_err"] <= 2e-2
              and out["worst_row_rel_l2_err"] <= 1e-2,
              f"{what}: output {against} {out}")
        for name in ("dq", "dk", "dv"):
            e = errs[against][name]
            check(e["rel_l2_err"] <= 2e-2
                  and e["worst_row_rel_l2_err"] <= 5e-2,
                  f"{what}: {name} {against} {e}")
    del ref, flash, ring, parts
    free()
    timing = dict(
        ring_fwd_ms=call_ms(lambda: ring_attention_lockstep(
            qs, ks, vs, causal), iters=20),
        flash_fwd_ms=call_ms(lambda: att.flash_attention_fwd(
            q, k, v, causal), iters=20),
        ring_fwd_bwd_ms=call_ms(lambda: ring_attention_lockstep(
            qs, ks, vs, causal, dos), iters=10),
        flash_fwd_bwd_ms=call_ms(lambda: att._flash_backward(
            q, k, v, *att.flash_attention_fwd(q, k, v, causal), do, causal),
            iters=10))
    return dict(shape=list(SEQ_SHAPE), ranks=n, causal=causal,
                launches=counts, errors=errs, **timing), counts


def ring_world1(dev, gen):
    """``ring_attention`` and ``ulysses_attention`` through a world-1
    NCCL group at SEQ_SHAPE, causal: output and grads bit-equal to
    ``flash_attention``'s; K1-K3 once each."""
    import torch
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.parallel.ring_attention import (
        ring_attention, ulysses_attention)
    q, k, v, do = seq_inputs(dev, gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = att.flash_attention(*leaves, True)
    o.backward(do)
    flash = [o.detach()] + [t.grad for t in leaves]
    fields, counts = {}, None
    with nccl_world1(dev):
        for name, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention)):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            reset_counts()
            o = fn(*leaves)
            o.backward(do)
            torch.cuda.synchronize()
            c = read_counts()
            check(c == attention_counts(1), f"{name} at world 1: {c}")
            got = [o.detach()] + [t.grad for t in leaves]
            equal = [torch.equal(a, b) for a, b in zip(got, flash)]
            check(all(equal), f"{name} at world 1 differs from flash: "
                  f"{equal} (out, dq, dk, dv)")
            fields[name] = dict(bit_equal_to_flash=True, launches=c)
            counts = add_counts(counts, c)
    return fields, counts


def llama_seq_parallel(dev):
    """A 2-layer full-width Llama-3-8B (bf16, remat, CE chunk 1024) at 1 x
    SEQ_LLAMA_TOKENS: loss and grads with ring and Ulysses attention
    through a world-1 NCCL group against flash's; each launches K1 2L,
    K2 L, K3 L, K4 4L + 1. Then ``pipeline`` at world 1: its two blocks
    as one stage over PIPE_MICRO microbatches with remat, output and
    grads against the microbatches run one after another."""
    import torch
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.pipeline import pipeline
    from ray_tpu_torch.scripts import bench_train as bt
    cfg = dataclasses.replace(full_config(), n_layers=2,
                              ce_chunk_tokens=bt.CE_CHUNK)
    params = tl.unstack_layers(tl.llama_init(SEED, cfg, dev))
    leaves = bt.parameters(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tokens, targets = (torch.randint(0, cfg.vocab_size,
                                     (1, SEQ_LLAMA_TOKENS), generator=gen,
                                     device=dev) for _ in range(2))
    fields, counts, results = {}, None, {}
    want = expected_train_counts(cfg.n_layers)
    with nccl_world1(dev):
        for attention in ("flash", "ring", "ulysses"):
            c = dataclasses.replace(cfg, attention=attention)
            reset_counts()
            loss = tl.llama_loss(params, tokens, targets, c)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            step_counts = read_counts()
            check(step_counts == want,
                  f"llama {attention}: launches {step_counts} != {want}")
            results[attention] = (loss.item(), grads)
            if attention != "flash":
                counts = add_counts(counts, step_counts)
        loss_f, grads_f = results["flash"]
        for attention in ("ring", "ulysses"):
            loss_a, grads_a = results[attention]
            rel_loss = abs(loss_a - loss_f) / abs(loss_f)
            rel_grads = max(
                (torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float())).item()
                for a, b in zip(grads_a, grads_f))
            check(math.isfinite(loss_a) and rel_loss <= 1e-5
                  and rel_grads <= 1e-3,
                  f"llama {attention} vs flash: loss {loss_a} vs {loss_f}, "
                  f"grads relative L2 {rel_grads}")
            fields[f"llama_{attention}"] = dict(
                loss=loss_a, flash_loss=loss_f, rel_loss=rel_loss,
                max_rel_l2_grads=rel_grads, bit_equal_to_flash=(
                    loss_a == loss_f and all(
                        torch.equal(a, b)
                        for a, b in zip(grads_a, grads_f))),
                launches=want)
        del results, grads_f, grads_a
        free()

        cos, sin = tl.rope_frequencies(cfg.head_dim, PIPE_SEQ,
                                       cfg.rope_theta, device=dev)
        layers = params["layers"]

        def stage(p, x):
            for lp in p:
                x = tl._block(lp, x, cos, sin, cfg)[0]
            return x

        x = torch.randn((PIPE_MICRO, PIPE_SEQ, cfg.dim), generator=gen,
                        device=dev).to(cfg.dtype)
        layer_leaves = bt.parameters(layers)
        xp = x.clone().requires_grad_()
        reset_counts()
        t0 = time.perf_counter()
        out = pipeline(stage, layers, xp, num_microbatches=PIPE_MICRO,
                       remat=True)
        (out.float().square().sum() / out.numel()).backward()
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        pipe_counts = read_counts()
        per_micro = dict(expected_train_counts(cfg.n_layers),
                         rms_norm=4 * cfg.n_layers)  # no final norm
        want_pipe = {k: PIPE_MICRO * n for k, n in per_micro.items()}
        check(pipe_counts == want_pipe,
              f"pipeline launches {pipe_counts} != {want_pipe}")
        counts = add_counts(counts, pipe_counts)
        g_pipe = [t.grad.clone() for t in layer_leaves] + [xp.grad]
        for t in layer_leaves:
            t.grad = None
        xs = x.clone().requires_grad_()
        t0 = time.perf_counter()
        seq_out = []
        for i in range(PIPE_MICRO):
            y = stage(layers, xs[i:i + 1])
            (y.float().square().sum() / out.numel()).backward()
            seq_out.append(y.detach())
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        g_seq = [t.grad for t in layer_leaves] + [xs.grad]
        out_equal = torch.equal(out.detach(), torch.cat(seq_out))
        rel = max((torch.linalg.vector_norm(a.float() - b.float())
                   / torch.linalg.vector_norm(b.float())).item()
                  for a, b in zip(g_pipe, g_seq))
        check(out_equal, "pipeline output differs from the sequential run")
        check(rel <= 1e-2, f"pipeline grads relative L2 {rel} > 1e-2")
        fields["pipeline"] = dict(
            microbatches=PIPE_MICRO, seq=PIPE_SEQ, stage_layers=2,
            remat=True, output_bit_equal=out_equal, max_rel_l2_grads=rel,
            seconds=pipe_s, sequential_seconds=seq_s, launches=pipe_counts)
    del params, leaves
    free()
    return fields, counts


def seq_parallel(dev, gen):
    """Phase 3b: ring attention over virtual ranks, ring and Ulysses
    through a world-1 group, a 2-layer Llama through them, the pipeline
    -> (fields, the launches of the main-path runs; comparison runs are
    not counted)."""
    fields, counts = {}, None
    for causal in (True, False):
        row, c = ring_virtual(dev, gen, causal)
        fields["ring_virtual_" + ("causal" if causal else "full")] = row
        counts = add_counts(counts, c)
    row, c = ring_world1(dev, gen)
    fields["world1_group"] = row
    counts = add_counts(counts, c)
    row, c = llama_seq_parallel(dev)
    fields.update(row)
    counts = add_counts(counts, c)
    return fields, counts


# ---------------------------------------------------------------------------
# phase 3c: sharded parameters and expert parallelism through a world-1 mesh
# ---------------------------------------------------------------------------

SHARD_MODES = ("ddp", "fsdp", "tp", "fsdp_tp")
# (sharding mode, attention) of the Mixtral-width runs
MOE_SHARD_RUNS = (("ep", "flash"), ("ep", "ring"))
SHARD_TOKENS = 2048


def world1_mesh(dev):
    """A world-1 mesh with all six axes, over the current default group."""
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(), dev)
    check(tuple(mesh.mesh_dim_names) == AXIS_ORDER
          and tuple(mesh.shape) == (1,) * 6,
          f"world-1 mesh {mesh.mesh_dim_names} {mesh.shape}")
    return mesh


def loss_and_grads(params, tokens, targets, cfg, **kw):
    """-> (loss, the grads of every leaf, the launches of the run)."""
    import torch
    from ray_tpu_torch.models.llama import llama_loss
    from ray_tpu_torch.scripts import bench_train as bt
    reset_counts()
    loss = llama_loss(params, tokens, targets, cfg, **kw)
    grads = torch.autograd.grad(loss, bt.parameters(params))
    torch.cuda.synchronize()
    return loss, grads, read_counts()


def sharded_runs(dev, mesh, cfg, runs):
    """A 2-layer model of ``cfg``'s width at 1 x SHARD_TOKENS, bf16, remat,
    CE chunk 1024: the unsharded flash loss and grads (a comparison run,
    not counted), then each (mode, attention) of ``runs`` on the shards
    ``shard_pytree`` cuts under the mode's rules through ``mesh``: the
    loss and every grad bit-equal to the unsharded run's, each run
    launching exactly K1 2L, K2 L, K3 L, K4 4L + 1 -> (fields, the
    launches of the sharded runs)."""
    import torch
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.sharding import shard_pytree
    from ray_tpu_torch.scripts import bench_train as bt
    cfg = dataclasses.replace(cfg, n_layers=2, ce_chunk_tokens=bt.CE_CHUNK)
    params = tl.llama_init(SEED, cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tokens, targets = (torch.randint(0, cfg.vocab_size, (1, SHARD_TOKENS),
                                     generator=gen, device=dev)
                       for _ in range(2))
    ref = tl.unstack_layers(params)
    for t in bt.parameters(ref):
        t.requires_grad_(True)
    want_loss, want_grads, _ = loss_and_grads(ref, tokens, targets, cfg)
    del ref
    want = expected_train_counts(cfg.n_layers)
    fields, counts = {}, None
    for mode, attention in runs:
        rules = tl.llama_sharding_rules(mode)
        local = tl.unstack_layers(shard_pytree(params, mesh, rules))
        for t in bt.parameters(local):
            t.requires_grad_(True)
        c = dataclasses.replace(cfg, attention=attention)
        t0 = time.perf_counter()
        loss, grads, run_counts = loss_and_grads(local, tokens, targets, c,
                                                 mesh=mesh, rules=rules)
        seconds = time.perf_counter() - t0
        what = f"{mode} {attention} at world 1"
        check(run_counts == want, f"{what}: launches {run_counts} != {want}")
        check(bool(torch.isfinite(loss)), f"{what}: loss {loss.item()}")
        equal = [torch.equal(g, w) for g, w in zip(grads, want_grads)]
        check(torch.equal(loss, want_loss) and all(equal),
              f"{what}: loss {loss.item()} vs {want_loss.item()}, "
              f"{equal.count(False)} of {len(equal)} grads differ")
        fields[f"{mode}_{attention}"] = dict(
            loss=loss.item(), bit_equal_to_unsharded=True, leaves=len(grads),
            seconds=seconds, launches=run_counts)
        counts = add_counts(counts, run_counts)
        del local, grads, loss
    del params, want_grads
    free()
    return fields, counts


def sharded(dev):
    """Phase 3c: Llama-3-8B width under ddp, fsdp, tp and fsdp_tp, and
    Mixtral-8x7B width (8 experts, 2.8 GB of expert stacks a layer) under
    ep with flash and with ring attention, all through a world-1 mesh
    over a world-1 NCCL group, where every collective is the identity:
    any difference from the unsharded run is a bug."""
    from ray_tpu_torch.models import LlamaConfig
    fields, counts = {}, None
    with nccl_world1(dev):
        mesh = world1_mesh(dev)
        for name, cfg, runs in (
                ("llama3_8b", full_config(),
                 [(mode, "flash") for mode in SHARD_MODES]),
                ("mixtral_8x7b", LlamaConfig.mixtral_8x7b(),
                 MOE_SHARD_RUNS)):
            fields[name], c = sharded_runs(dev, mesh, cfg, runs)
            counts = add_counts(counts, c)
    return fields, counts


# ---------------------------------------------------------------------------
# phase 3d: ViT, CLIP and DiT on sharded parameters through a world-1 mesh
# ---------------------------------------------------------------------------

# setup_vision's models (ViT-B/16 at 64, CLIP at 32, DiT-XL/2 at 32) and
# the name of the unsharded phase each one's timed steps take turns with
VISION_SHARD_MODELS = {"vit": "vision_train", "clip": "clip_step",
                       "dit_xl": "dit_xl_train"}
VISION_MESH_STEPS = 3


def vision_loss_and_grads(model, dev, **kw):
    """``setup_vision(model, dev, **kw)``'s loss and the grads of every
    leaf (no update; DiT's adaLN-Zero leaves drawn N(0, ADALN_STD^2), or
    most grads would be zero) -> (loss, grads, launches)."""
    import torch
    from ray_tpu_torch.scripts import bench_train as bt
    if model.startswith("dit"):
        kw["adaln_std"] = ADALN_STD
    _cfg, params, step = bt.setup_vision(model, dev, **kw)
    reset_counts()
    loss = step.loss_fn()
    grads = torch.autograd.grad(loss, bt.parameters(params))
    torch.cuda.synchronize()
    return loss.detach(), grads, read_counts()


def vision_steps_in_turns(model, dev, mesh):
    """A warm-up, then VISION_MESH_STEPS fsdp_tp mesh steps in turns with
    as many unsharded ones of ``setup_vision(model)`` (its own parameters
    and AdamW each), every step launching what the unsharded step
    launches and giving its loss; host ms (ended by ``loss.item()``) and
    CUDA-event ms -> (fields, launches summed over the steps)."""
    import torch
    from ray_tpu_torch.scripts import bench_train as bt
    steps = {"unsharded": bt.setup_vision(model, dev)[2],
             "fsdp_tp": bt.setup_vision(model, dev, mesh=mesh,
                                        mode="fsdp_tp")[2]}
    rows = {name: [] for name in steps}
    counts, want = None, None
    for i in range(1 + VISION_MESH_STEPS):
        for name, fn in steps.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            reset_counts()
            t0 = time.perf_counter()
            start.record()
            loss = fn()
            end.record()
            loss = loss.item()
            host_ms = (time.perf_counter() - t0) * 1e3
            step_counts = read_counts()
            want = want or step_counts
            check(step_counts == want, f"{model} {name} step {i} launches "
                  f"{step_counts} != {want}")
            counts = add_counts(counts, step_counts)
            if i:
                rows[name].append((loss, host_ms, start.elapsed_time(end)))
    losses = [r[0] for pair in zip(rows["unsharded"], rows["fsdp_tp"])
              for r in pair]
    # at world 1 the two runs take the same steps from the same state
    check(all(math.isfinite(x) for x in losses)
          and losses[0::2] == losses[1::2],
          f"{model}: losses in turns (unsharded, fsdp_tp, ...): {losses}")
    fields = dict(steps=VISION_MESH_STEPS, mode="fsdp_tp",
                  turns_with=VISION_SHARD_MODELS[model],
                  losses_in_turns=losses, launches_per_step=want)
    for i, clock in ((1, "host"), (2, "event")):
        means = {name: sum(r[i] for r in rs) / len(rs)
                 for name, rs in rows.items()}
        fields[f"{clock}_ms"] = {name: [r[i] for r in rs]
                                 for name, rs in rows.items()}
        fields[f"{clock}_mean_ms"] = means
        fields[f"{clock}_ratio_mesh_to_unsharded"] = (
            means["fsdp_tp"] / means["unsharded"])
    del steps
    free()
    return fields, counts


def sharded_vision(dev):
    """Phase 3d: ViT-B/16, CLIP and DiT-XL/2 at full width and depth
    (``bench_train.setup_vision``: seed 0's weights, seed 1's batch),
    bf16, remat, through a world-1 mesh over a world-1 NCCL group: each
    model's loss and grads under ddp, fsdp, tp and fsdp_tp bit-equal to
    the unsharded run's, each run launching K1-K3 as the unsharded run
    does (K1 2L, K2 L, K3 L); then VISION_MESH_STEPS fsdp_tp training
    steps of each in turns with unsharded ones -> (fields, launches of
    the sharded runs and of every timed step)."""
    import torch
    fields, counts = {}, None
    with nccl_world1(dev):
        mesh = world1_mesh(dev)
        for model in VISION_SHARD_MODELS:
            want_loss, want_grads, want_counts = vision_loss_and_grads(
                model, dev)
            n_layers = want_counts["flash_attention_bwd_dq"]
            check(n_layers > 0 and want_counts
                  == expected_encoder_counts(n_layers),
                  f"{model}: unsharded launches {want_counts}")
            runs = {}
            for mode in SHARD_MODES:
                t0 = time.perf_counter()
                loss, grads, run_counts = vision_loss_and_grads(
                    model, dev, mesh=mesh, mode=mode)
                seconds = time.perf_counter() - t0
                what = f"{model} {mode} at world 1"
                check(run_counts == want_counts,
                      f"{what}: launches {run_counts} != {want_counts}")
                equal = [torch.equal(g, w)
                         for g, w in zip(grads, want_grads)]
                check(bool(torch.isfinite(loss))
                      and torch.equal(loss, want_loss) and all(equal),
                      f"{what}: loss {loss.item()} vs {want_loss.item()}, "
                      f"{equal.count(False)} of {len(equal)} grads differ")
                runs[mode] = dict(loss=loss.item(),
                                  bit_equal_to_unsharded=True,
                                  leaves=len(grads), seconds=seconds,
                                  launches=run_counts)
                counts = add_counts(counts, run_counts)
                del grads
            del want_grads
            free()
            timed, c = vision_steps_in_turns(model, dev, mesh)
            counts = add_counts(counts, c)
            fields[model] = dict(runs=runs, timed_steps=timed)
    return fields, counts


# ---------------------------------------------------------------------------
# phase 3e: gradient sync (DDP, ZeRO-1, Anakin over virtual shards)
# ---------------------------------------------------------------------------

GRAD_SYNC_STEPS = 3
GRAD_SYNC_ATOL = 1e-5
ANAKIN_SHARDS = 4


def timed_call(fn):
    """(``fn()``, host ms, CUDA-event ms) of one call."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_map(fn, v) for v in node]
    return fn(node)


def ddp_and_zero1(dev):
    """DDPOptimizer and Zero1Optimizer (Adam, lr 1e-4) over a world-1
    NCCL group on DiT-XL/2's parameters in f32, from the same state and
    the same gradients (one bf16 loss-and-grad of
    ``setup_vision("dit_xl")``'s batch with its adaLN-Zero leaves drawn
    N(0, ADALN_STD^2), cast to f32), GRAD_SYNC_STEPS steps each: the
    parameters within GRAD_SYNC_ATOL of each other; each step's host and
    CUDA-event ms beside a fused AdamW step's over the same f32 leaves
    -> (fields, launches of the bf16 loss and grads)."""
    import torch
    from ray_tpu_torch.scripts import bench_train as bt
    from ray_tpu_torch.train.collective import DDPOptimizer, Zero1Optimizer
    _cfg, params, step = bt.setup_vision("dit_xl", dev,
                                         adaln_std=ADALN_STD)
    leaves16 = bt.parameters(params)
    reset_counts()
    loss = step.loss_fn()
    grads16 = torch.autograd.grad(loss, leaves16)
    torch.cuda.synchronize()
    counts = read_counts()
    by_id = {id(t): g for t, g in zip(leaves16, grads16)}
    grads = _tree_map(lambda t: by_id[id(t)].float(), params)
    start = _tree_map(lambda t: t.detach().float(), params)
    n_params = sum(t.numel() for t in leaves16)
    del step, by_id, grads16, leaves16, params, loss
    free()
    adam = functools.partial(torch.optim.Adam, lr=1e-4, eps=1e-8)
    ms = {"ddp": [], "zero1": [], "fused_adamw": []}
    stepped = {}
    for name, cls in (("ddp", DDPOptimizer), ("zero1", Zero1Optimizer)):
        opt, p = cls(adam, start), start
        for _ in range(GRAD_SYNC_STEPS):
            p, *row = timed_call(functools.partial(opt.step, p, grads))
            ms[name].append(row)
        stepped[name] = (opt, p)
    (ddp, p_ddp), (zero1, p_z1) = stepped["ddp"], stepped["zero1"]
    diff = max((a - b).abs().max().item() for a, b in zip(
        bt.parameters(p_ddp), bt.parameters(p_z1)))
    moved = max((a - b).abs().max().item() for a, b in zip(
        bt.parameters(p_ddp), bt.parameters(start)))
    state_bytes = {"ddp": ddp.optimizer_state_bytes(),
                   "zero1": zero1.optimizer_state_bytes()}
    check(diff <= GRAD_SYNC_ATOL and moved > 0,
          f"grad_sync: ZeRO-1 {diff} from DDP (> {GRAD_SYNC_ATOL}), "
          f"DDP moved the parameters by {moved}")
    del ddp, zero1, p_ddp, p_z1, stepped
    free()
    leaves = [t.clone() for t in bt.parameters(start)]
    for t, g in zip(leaves, bt.parameters(grads)):
        t.grad = g
    fused = torch.optim.AdamW(leaves, lr=1e-4, eps=1e-8, weight_decay=0.0,
                              fused=True)
    for _ in range(GRAD_SYNC_STEPS):
        ms["fused_adamw"].append(timed_call(fused.step)[1:])
    del fused, leaves, start, grads
    free()
    fields = dict(model="DiT-XL/2", params=n_params,
                  flat_gb=n_params * 4 / 1e9, steps=GRAD_SYNC_STEPS,
                  tolerance=GRAD_SYNC_ATOL, max_abs_diff_zero1_vs_ddp=diff,
                  max_abs_update=moved, optimizer_state_bytes=state_bytes)
    for i, clock in ((0, "host"), (1, "event")):
        fields[f"{clock}_ms"] = {k: [r[i] for r in v] for k, v in ms.items()}
    return fields, counts


def anakin_shards_vs_cpu(dev):
    """ANAKIN_SHARDS virtual shards of Anakin's lockstep step at 16 envs
    each, RL_UPDATES_VS_CPU updates on the card and on the CPU from the
    same weights and the same draws (each shard its own, made once with
    a CPU generator): the card's shards identical to each other, and
    within RL_ATOL of the CPU's parameters and losses."""
    import copy
    import torch
    from ray_tpu_torch.rl.env import CartPoleTensor
    from ray_tpu_torch.rl.env_runner import draw_rollout_noise
    from ray_tpu_torch.rl.podracer import build_lockstep, make_optimizer
    from ray_tpu_torch.rl.rl_module import RLModuleSpec
    cfg = anakin_config(16)
    env = CartPoleTensor()
    spec = RLModuleSpec(env.observation_space, env.action_space, cfg.hidden)
    gen = torch.Generator().manual_seed(SEED)
    n, t = cfg.num_envs_per_device, cfg.rollout_len
    states = [env.draw_reset((n,), gen, "cpu") for _ in range(ANAKIN_SHARDS)]
    noises = [[draw_rollout_noise(spec, env, t, n, gen, "cpu")
               for _ in range(ANAKIN_SHARDS)]
              for _ in range(RL_UPDATES_VS_CPU)]
    base = spec.init(cfg.seed, "cpu")

    def run(device):
        modules = [copy.deepcopy(base).to(device)
                   for _ in range(ANAKIN_SHARDS)]
        optimizers = [make_optimizer(m, cfg) for m in modules]
        step = build_lockstep(env, spec, cfg)
        shards = [env.reset(s.to(device)) for s in states]
        st, ob = [x[0] for x in shards], [x[1] for x in shards]
        losses = []
        for noise in noises:
            st, ob, m, _cols = step(modules, optimizers, st, ob, noise)
            losses.append(m["total_loss"].item())
        return [{k: v.detach().cpu() for k, v in m.state_dict().items()}
                for m in modules], losses

    card, cpu = run(dev), run(torch.device("cpu"))
    identical = all(torch.equal(v, card[0][0][k]) for sd in card[0][1:]
                    for k, v in sd.items())
    param_err = max((card[0][0][k] - cpu[0][0][k]).abs().max().item()
                    for k in cpu[0][0])
    loss_err = max(abs(a - b) for a, b in zip(card[1], cpu[1]))
    check(identical, "grad_sync: Anakin's shards on the card differ")
    check(param_err <= RL_ATOL and loss_err <= RL_ATOL,
          f"grad_sync: Anakin's shards {param_err} (params), {loss_err} "
          f"(losses) from the CPU's > {RL_ATOL}")
    return dict(shards=ANAKIN_SHARDS, envs_per_shard=n,
                updates=RL_UPDATES_VS_CPU, tolerance=RL_ATOL,
                shards_identical=identical, max_abs_err_params=param_err,
                max_abs_err_losses=loss_err, losses_card=card[1],
                losses_cpu=cpu[1])


def grad_sync(dev):
    """Phase 3e: DDP and ZeRO-1 at DiT-XL/2 width through a world-1 NCCL
    group (``ddp_and_zero1``), then Anakin over virtual shards on the card
    against the CPU -> (fields, launches)."""
    with nccl_world1(dev):
        fields, counts = ddp_and_zero1(dev)
    fields["anakin"] = anakin_shards_vs_cpu(dev)
    return fields, counts


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
        launches_per_step=want)
    fields["ring_steps"], ring_counts = ring_train_steps(
        dev, cfg, params, step, tokens, targets)
    fields["mesh_steps"], mesh_counts = mesh_train_steps(
        dev, cfg, params, step, tokens, targets)
    counts = add_counts(add_counts(counts, ring_counts), mesh_counts)
    fields["launches"] = counts
    del step, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    fields["seconds"] = time.perf_counter() - t_phase
    return fields, counts


RING_STEPS = 3


def ring_train_steps(dev, cfg, params, step, tokens, targets):
    """Phase 3b's training part, on phase 7's parameters, AdamW and batch
    after its timed steps: RING_STEPS steps with ring attention through a
    world-1 NCCL group, each launching what a phase 7 step launches; the
    first ring loss within 1e-3 relative of a flash loss from the same
    parameters -> (fields, launches summed over the ring steps)."""
    import torch
    from ray_tpu_torch.models.llama import llama_loss
    from ray_tpu_torch.scripts import bench_train as bt
    with torch.no_grad():
        flash_loss = llama_loss(params, tokens, targets, cfg).item()
    ring_cfg = dataclasses.replace(cfg, attention="ring")
    want = expected_train_counts(cfg.n_layers)
    losses, step_ms, counts = [], [], None
    with nccl_world1(dev):
        ring_step = bt.make_train_step(ring_cfg, params,
                                       optimizer=step.optimizer)
        for i in range(RING_STEPS):
            reset_counts()
            t0 = time.perf_counter()
            losses.append(ring_step(tokens, targets).item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_counts = read_counts()
            check(step_counts == want,
                  f"ring train step {i} launches {step_counts} != {want}")
            counts = add_counts(counts, step_counts)
    rel = abs(losses[0] - flash_loss) / abs(flash_loss)
    check(all(math.isfinite(x) for x in losses) and rel <= 1e-3,
          f"ring loss {losses[0]} vs flash loss {flash_loss} from the same "
          "parameters")
    check(losses[-1] < losses[0], f"ring loss did not fall: {losses}")
    return dict(steps=RING_STEPS, flash_loss=flash_loss, losses=losses,
                rel_loss_first=rel, step_ms=step_ms,
                mean_step_ms=sum(step_ms) / RING_STEPS,
                launches_per_step=want), counts


MESH_STEPS = 3


def mesh_train_steps(dev, cfg, params, step, tokens, targets):
    """After the ring steps, on the same parameters, AdamW and batch:
    MESH_STEPS steps through the fsdp_tp mesh path (a world-1 mesh, whose
    local shards are the whole tensors) in turns with MESH_STEPS more of
    phase 7's steps, each launching what a phase 7 step launches; each
    step's host ms (ended by ``loss.item()``) and CUDA-event ms, the
    means and the mesh path's ratio to phase 7's -> (fields, launches
    summed over the steps)."""
    import torch
    from ray_tpu_torch.models.llama import llama_sharding_rules
    from ray_tpu_torch.scripts import bench_train as bt
    want = expected_train_counts(cfg.n_layers)
    rows = {"phase7": [], "mesh": []}
    counts = None
    with nccl_world1(dev):
        mesh = world1_mesh(dev)
        steps = {"phase7": step, "mesh": bt.make_train_step(
            cfg, params, optimizer=step.optimizer, mesh=mesh,
            rules=llama_sharding_rules("fsdp_tp"))}
        for i in range(MESH_STEPS):
            for name, fn in steps.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                reset_counts()
                t0 = time.perf_counter()
                start.record()
                loss = fn(tokens, targets)
                end.record()
                loss = loss.item()
                host_ms = (time.perf_counter() - t0) * 1e3
                step_counts = read_counts()
                check(step_counts == want,
                      f"{name} step {i} launches {step_counts} != {want}")
                rows[name].append((loss, host_ms, start.elapsed_time(end)))
                counts = add_counts(counts, step_counts)
    losses = [r[0] for pair in zip(rows["phase7"], rows["mesh"])
              for r in pair]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"losses in turns (phase 7, mesh, ...): {losses}")
    fields = dict(steps=MESH_STEPS, mode="fsdp_tp", losses_in_turns=losses,
                  launches_per_step=want)
    for i, clock in ((1, "host"), (2, "event")):
        means = {name: sum(r[i] for r in rs) / len(rs)
                 for name, rs in rows.items()}
        fields[f"{clock}_ms"] = {name: [r[i] for r in rs]
                                 for name, rs in rows.items()}
        fields[f"{clock}_mean_ms"] = means
        fields[f"{clock}_ratio_mesh_to_phase7"] = means["mesh"] / means[
            "phase7"]
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


# ---------------------------------------------------------------------------
# phase 8b: a Llama training run that streams its batches, traces a window,
# saves, and resumes exactly
# ---------------------------------------------------------------------------

# Llama-3-8B at full width, depth cut from 32 layers to 2: the phase moves
# the whole training state through the disk (1.49 B parameters, ~8.9 GB
# with bf16 moments; ~48 GB at 32 layers)
CKPT_LAYERS = 2
CKPT_STEPS = 3  # before the save, and again after it
CKPT_WINDOW = (1, 2)  # StepProfiler's start_step and num_steps
# the kernel symbol of each wrapper, as the profiler's trace names it
KERNEL_SYMBOLS = {"flash_attention": "flash_fwd_kernel",
                  "flash_attention_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel",
                  "rms_norm": "rms_norm_kernel"}
# ViT-B/16's input at batch 64 in bf16 (NHWC), staged while matmuls keep
# the card busy
STAGING_BATCHES, STAGING_SHAPE, STAGING_MATMULS = 20, (64, 224, 224, 3), 8


def tree_bytes(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (dict, list, tuple)):
        items = tree.values() if isinstance(tree, dict) else tree
        return sum(tree_bytes(v) for v in items)
    return 0


def tree_diff(a, b, path="$"):
    """The first path where trees ``a`` and ``b`` differ (tensors
    bitwise, after moving ``a``'s to ``b``'s device), or None."""
    import torch
    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            return path
        pairs = [(a[k], b[k], f"{path}.{k}") for k in b]
    elif isinstance(b, (list, tuple)):
        if not isinstance(a, (list, tuple)) or len(a) != len(b):
            return path
        pairs = [(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))]
    elif isinstance(b, torch.Tensor):
        same = isinstance(a, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a.to(b.device), b)
        return None if same else path
    else:
        return None if a == b else path
    for x, y, where in pairs:
        found = tree_diff(x, y, where)
        if found is not None:
            return found
    return None


def trace_events(path, cat):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("cat") == cat]


def event_stream(event):
    return event.get("args", {}).get("stream", event.get("tid"))


def overlap_us(spans, others):
    """Microseconds of ``spans`` ([(t0, t1)]) covered by any of
    ``others``."""
    total = 0.0
    for t0, t1 in spans:
        for u0, u1 in others:
            total += max(0.0, min(t1, u1) - max(t0, u0))
    return total


def ckpt_steps(step, batches, first, prof, want, staged):
    """CKPT_STEPS steps on staged batches, each ended by ``loss.item()``
    and launching exactly ``want`` -> (losses, ms, summed launches)."""
    losses, step_ms, counts = [], [], None
    for i in range(first, first + CKPT_STEPS):
        if prof is not None:
            prof.on_step(i)
        batch = next(batches)
        reset_counts()
        t0 = time.perf_counter()
        losses.append(step(batch["tokens"], batch["targets"]).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_counts = read_counts()
        check(step_counts == want,
              f"train_checkpoint step {i} launches {step_counts} != {want}")
        counts = add_counts(counts, step_counts)
        staged.append(batch)
    return losses, step_ms, counts


def check_window_trace(path, want):
    """The StepProfiler window's trace: each kernel of K1-K4 exactly
    twice a step's launches (the window's two steps and nothing else),
    and host-to-device copies on a stream other than the compute
    stream's."""
    kernels = trace_events(path, "kernel")
    found = {k: sum(sym in e["name"] for e in kernels)
             for k, sym in KERNEL_SYMBOLS.items()}
    n_steps = CKPT_WINDOW[1]
    check(found == {k: n_steps * want[k] for k in KERNEL_SYMBOLS},
          f"the window's trace holds {found}, not {n_steps} steps' worth")
    compute = {event_stream(e) for e in kernels
               if KERNEL_SYMBOLS["flash_attention"] in e["name"]}
    copies = [e for e in trace_events(path, "gpu_memcpy")
              if "HtoD" in e["name"]]
    side = [e for e in copies if event_stream(e) not in compute]
    check(len(side) > 0 and all("Pinned" in e["name"] for e in side),
          f"no pinned host-to-device copy off the compute stream "
          f"{compute}: {[(e['name'], event_stream(e)) for e in copies]}")
    return dict(trace_kernels=found, trace_launches_per_step=len(kernels)
                / n_steps, trace_busy_ms_per_step=sum(
                    e["dur"] for e in kernels) / n_steps / 1e3,
                trace_side_stream_copies=len(side),
                trace_compute_stream_copies=len(copies) - len(side),
                trace_bytes=os.path.getsize(path))


def staging_rate(dev, root):
    """STAGING_BATCHES ViT-B/16 inputs (f32 on the host, bf16 on the
    card) through ``iter_device_batches`` while STAGING_MATMULS bf16
    8192^3 matmuls a batch keep the card busy, traced: the copies' device
    GB/s and their overlap with the matmuls, the staged GB/s over the
    host clock to the last matmul and to the producer's end (the host
    cast and pinned copy), the consumer's wait."""
    import numpy as np
    import torch
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.train.profiler import profile
    rng = np.random.default_rng(SEED)
    sources = [{"images": rng.standard_normal(STAGING_SHAPE,
                                              dtype=np.float32)}
               for _ in range(STAGING_BATCHES)]
    a = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    a @ a  # cuBLAS set up before the window
    staged = []
    with profile(os.path.join(root, "staging"), device=dev) as trace:
        t0 = time.perf_counter()
        t0_monotonic = time.monotonic()  # the producer's clock
        it = iter_device_batches(iter(sources),
                                 dtypes={"images": torch.bfloat16},
                                 device=dev, prefetch=2)
        for batch in it:
            for _ in range(STAGING_MATMULS):
                a @ a
            staged.append(batch)
        torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t0
    for batch, src in zip(staged, sources):
        check(torch.equal(batch["images"].cpu(), torch.from_numpy(
            src["images"]).to(torch.bfloat16)),
              "a staged ViT batch differs from its numpy source")
    check(len(staged) == STAGING_BATCHES, f"{len(staged)} staged batches")
    copies = [e for e in trace_events(trace.path, "gpu_memcpy")
              if "HtoD" in e["name"]]
    kernels = trace_events(trace.path, "kernel")
    copy_spans = [(e["ts"], e["ts"] + e["dur"]) for e in copies]
    kernel_spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
    copy_us = sum(t1 - t0 for t0, t1 in copy_spans)
    copy_bytes = sum(e.get("args", {}).get("bytes", 0) for e in copies)
    nbytes = STAGING_BATCHES * staged[0]["images"].nbytes
    check(len(copies) > 0 and all("Pinned" in e["name"] for e in copies),
          f"staging copies: {[e['name'] for e in copies]}")
    return dict(batches=STAGING_BATCHES, batch_shape=list(STAGING_SHAPE),
                batch_mb=nbytes / STAGING_BATCHES / 1e6,
                copies_traced=len(copies), copy_bytes_traced=copy_bytes,
                h2d_gb_per_s=copy_bytes / copy_us / 1e3,
                h2d_ms_per_copy=copy_us / len(copies) / 1e3,
                copy_overlap_share=overlap_us(copy_spans, kernel_spans)
                / copy_us,
                matmul_ms_per_batch=sum(e["dur"] for e in kernels)
                / STAGING_BATCHES / 1e3,
                staged_gb_per_s=nbytes / wall_s / 1e9, wall_s=wall_s,
                producer_gb_per_s=nbytes / (it.producer_done_time
                                            - t0_monotonic) / 1e9,
                consumer_wait_s=it.wait_seconds_total)


def train_checkpoint(dev):
    """Run A trains CKPT_STEPS steps on staged batches (StepProfiler
    tracing CKPT_WINDOW), saves its whole state with ``save_pytree``,
    starts a background ``save_sharded_state`` at world 1 that overlaps
    its next step, and trains CKPT_STEPS more. Run B builds fresh
    parameters from another seed, loads the saved state into them on the
    card and trains the same last steps on the same batches: its losses,
    parameters and moments must equal A's exactly. The sharded shard
    must equal the loaded state, and reshard to 2 and back to itself.
    Then ViT-sized staging (``staging_rate``) and the devtools check.
    -> (fields, launches summed over the steps)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.models import LlamaConfig, llama_init, unstack_layers
    from ray_tpu_torch.scripts import bench_train as bt
    from ray_tpu_torch.train import (
        load_pytree, load_sharded_state, reshard_states, save_pytree,
        save_sharded_state)
    from ray_tpu_torch.train.profiler import StepProfiler
    cfg = dataclasses.replace(
        LlamaConfig.llama3_8b(ce_chunk_tokens=bt.CE_CHUNK),
        n_layers=CKPT_LAYERS)
    want = expected_train_counts(cfg.n_layers)
    rng = np.random.default_rng(SEED)
    sources = [{k: rng.integers(0, cfg.vocab_size, (bt.BATCH, bt.SEQ))
                for k in ("tokens", "targets")}
               for _ in range(2 * CKPT_STEPS)]
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    fields = dict(n_layers=cfg.n_layers, batch=bt.BATCH, seq=bt.SEQ,
                  disk_free_bytes=shutil.disk_usage(root).free)
    try:
        # run A
        params_a = unstack_layers(llama_init(SEED, cfg, dev))
        step_a = bt.make_train_step(cfg, params_a)
        batches_a = iter_device_batches(iter(sources), device=dev,
                                        prefetch=2)
        prof = StepProfiler(os.path.join(root, "window"), *CKPT_WINDOW,
                            device=dev)
        staged = []
        losses_a, ms_a, counts = ckpt_steps(step_a, batches_a, 0, prof,
                                            want, staged)
        prof.on_step(CKPT_STEPS)  # the window ends before the save
        check(len(prof.paths) == 1 and os.listdir(
            os.path.join(root, "window")) == [os.path.basename(
                prof.paths[0])], f"window traces: {prof.paths}")
        fields.update(check_window_trace(prof.paths[0], want))

        def state(step, params):
            return {"params": params, "optimizer": step.optimizer.state_dict(),
                    "step": CKPT_STEPS}

        nbytes = tree_bytes(state(step_a, params_a))
        check(fields["disk_free_bytes"] > 2.2 * nbytes,
              f"{fields['disk_free_bytes']} bytes free under {root}; the "
              f"phase writes two copies of {nbytes}")
        t0 = time.perf_counter()
        save_pytree(state(step_a, params_a), os.path.join(root, "full"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        writer = save_sharded_state(os.path.join(root, "sharded"), 0, 1,
                                    state(step_a, params_a),
                                    step=CKPT_STEPS, background=True)
        snapshot_s = time.perf_counter() - t0
        losses_a2, ms_a2, counts_a2 = ckpt_steps(step_a, batches_a,
                                                 CKPT_STEPS, prof, want,
                                                 staged)
        t0 = time.perf_counter()
        writer.join()
        join_wait_s = time.perf_counter() - t0
        background_write_s = snapshot_s + sum(ms_a2) / 1e3 + join_wait_s

        # run B
        params_b = unstack_layers(llama_init(SEED + 1, cfg, dev))
        check(not torch.equal(params_b["embedding"], params_a["embedding"]),
              "run B's fresh parameters equal run A's")
        step_b = bt.make_train_step(cfg, params_b)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loaded = load_pytree(os.path.join(root, "full"), target={
            "params": params_b, "optimizer": None, "step": None})
        step_b.optimizer.load_state_dict(loaded["optimizer"])
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        check(loaded["step"] == CKPT_STEPS, f"loaded step {loaded['step']}")
        del loaded

        t0 = time.perf_counter()
        shards = load_sharded_state(os.path.join(root, "sharded"))
        shard_load_s = time.perf_counter() - t0
        check(shards is not None and len(shards) == 1,
              "load_sharded_state found no world-1 shard set")
        where = tree_diff(shards[0], state(step_b, params_b))
        check(where is None, f"the sharded state differs at {where}")
        moments = {i: {k: s[k] for k in ("exp_avg", "exp_avg_sq")}
                   for i, s in shards[0]["optimizer"]["state"].items()}
        tensors = {"params": shards[0]["params"], "moments": moments}
        t0 = time.perf_counter()
        halves = reshard_states([tensors], 2)
        back = reshard_states(halves, 1)
        reshard_s = time.perf_counter() - t0
        check(len(halves) == 2 and halves[0]["params"]["embedding"].shape[0]
              + halves[1]["params"]["embedding"].shape[0] == cfg.vocab_size,
              "reshard to 2 did not split axis 0")
        where = tree_diff(back[0], tensors)
        check(where is None, f"reshard 1 -> 2 -> 1 differs at {where}")
        del shards, moments, tensors, halves, back
        gc.collect()

        batches_b = iter_device_batches(iter(sources[CKPT_STEPS:]),
                                        device=dev, prefetch=2)
        staged_b = []
        losses_b, ms_b, counts_b = ckpt_steps(step_b, batches_b, CKPT_STEPS,
                                              None, want, staged_b)
        for batch, src in zip(staged + staged_b, sources + sources[
                CKPT_STEPS:]):
            check(all(torch.equal(batch[k].cpu(), torch.from_numpy(src[k]))
                      for k in src), "a staged batch differs from its source")
        check(len(staged) == 2 * CKPT_STEPS and len(staged_b) == CKPT_STEPS,
              "batches went missing")
        params_equal = all(torch.equal(a, b) for a, b in zip(
            bt.parameters(params_a), bt.parameters(params_b)))
        max_diff = max((a.detach().float() - b.detach().float()).abs().max()
                       .item() for a, b in zip(bt.parameters(params_a),
                                               bt.parameters(params_b)))
        moments_where = tree_diff(step_b.optimizer.state_dict()["state"],
                                  step_a.optimizer.state_dict()["state"])
        fields.update(
            losses_a=losses_a + losses_a2, losses_b=losses_b,
            step_ms_a=ms_a + ms_a2, step_ms_b=ms_b,
            window_steps=list(range(CKPT_WINDOW[0],
                                    sum(CKPT_WINDOW))),
            step_ms_outside_window=[ms_a[0], *ms_a2],
            state_gb=nbytes / 1e9, save_s=save_s,
            save_gb_per_s=nbytes / save_s / 1e9,
            sharded_snapshot_s=snapshot_s, sharded_join_wait_s=join_wait_s,
            sharded_write_s_upper=background_write_s,
            load_s=load_s, load_gb_per_s=nbytes / load_s / 1e9,
            sharded_load_s=shard_load_s, reshard_s=reshard_s,
            consumer_wait_s_a=batches_a.wait_seconds_total,
            consumer_wait_s_b=batches_b.wait_seconds_total,
            staged_batches_equal=True, resumed_losses_equal=(
                losses_b == losses_a2),
            resumed_params_equal=params_equal,
            resumed_max_abs_param_diff=max_diff,
            resumed_moments_differ_at=moments_where,
            launches_per_step=want)
        check(losses_b == losses_a2 and params_equal and moments_where is None,
              f"resumed run differs: losses {losses_b} vs {losses_a2}, "
              f"params equal {params_equal} (max diff {max_diff}), "
              f"moments differ at {moments_where}")
        del step_a, step_b, params_a, params_b, staged, staged_b
        free()
        fields["staging_vit"] = staging_rate(dev, root)
        free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.check", "--only",
         "podracer"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    fields["devtools_check"] = proc.stdout.strip().splitlines()
    check(proc.returncode == 0, f"devtools check --only podracer: rc "
          f"{proc.returncode}: {proc.stdout}{proc.stderr}")
    return fields, add_counts(counts, add_counts(counts_a2, counts_b))


# ---------------------------------------------------------------------------
# phase 10b: TorchTrainer on the port's runtime — a worker process the
# runtime spawned trains the 2-layer full-width Llama through K1-K4
# ---------------------------------------------------------------------------

TRAINER_STEPS = 3
TRAINER_CRASH_STEP = 2  # the first attempt saves after step 1, dies in 2


def trainer_state(cfg, dev, batch, seq):
    """The 2-layer full-width Llama of ``train_checkpoint`` (seed SEED,
    layers unstacked) and ``TRAINER_STEPS`` of its batches, from the same
    numpy seed -> (params, [(tokens, targets)])."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import llama_init, unstack_layers
    rng = np.random.default_rng(SEED)
    sources = [{k: rng.integers(0, cfg.vocab_size, (batch, seq))
                for k in ("tokens", "targets")}
               for _ in range(2 * CKPT_STEPS)]
    batches = [tuple(torch.from_numpy(src[k]).to(dev)
                     for k in ("tokens", "targets"))
               for src in sources[:TRAINER_STEPS]]
    return unstack_layers(llama_init(SEED, cfg, dev)), batches


def digest(params):
    """blake2b of every parameter's bytes, in a fixed order: two runs
    whose digests are equal ended bit for bit equal."""
    import hashlib
    import torch
    from ray_tpu_torch.scripts import bench_train as bt
    out = []
    for t in bt.parameters(params):
        t = t.detach()
        bits = t.view(torch.int16) if t.element_size() == 2 else \
            t.view(torch.int32)
        out.append(hashlib.blake2b(bits.cpu().numpy().tobytes(),
                                   digest_size=16).hexdigest())
    return out


def trainer_steps(cfg, params, batches, first, opt=None, on_step=None):
    """AdamW steps ``first...`` through ``make_optimizer``'s DDP (``opt``,
    or a new one; over the default group: the worker's or the caller's
    world-1 NCCL group), each loss read back with ``.item()`` and its
    launch counts zeroed before and read after -> (params, optimizer,
    losses, ms, counts). ``on_step(i, params, opt)`` runs after step i."""
    import torch
    from ray_tpu_torch.models import llama_loss
    from ray_tpu_torch.scripts import bench_train as bt
    from ray_tpu_torch.train.collective import make_optimizer
    if opt is None:
        opt = make_optimizer(bt.make_adamw, params, zero1=False)
    losses, ms, counts = [], [], []
    for i in range(first, len(batches)):
        tokens, targets = batches[i]
        leaves = bt.parameters(params)
        reset_counts()
        t0 = time.perf_counter()
        for t in leaves:
            t.requires_grad_(True)
        loss = llama_loss(params, tokens, targets, cfg)
        grads = iter(torch.autograd.grad(loss, leaves))
        params = opt.step(params, _tree_map(lambda _: next(grads), params))
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        del grads, loss
        if on_step is not None:
            on_step(i, params, opt)
    return params, opt, losses, ms, counts


def trainer_loop(config):
    """TorchTrainer's train loop (one rank): a world-1 NCCL group unless
    the gang made one, then the steps of ``trainer_steps``. With
    ``crash_marker`` set it saves its state after step 1 (of 0, 1, 2)
    and, on the first attempt, dies as step 2 begins; an attempt that finds the checkpoint
    resumes from it. Reports each step's loss, ms and launches, then the
    final parameters' digest."""
    import tempfile
    import torch
    import torch.distributed as dist
    import ray_tpu_torch.train as train
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.scripts import bench_train as bt
    from ray_tpu_torch.train.collective import make_optimizer
    torch.set_num_threads(1)
    ctx = train.get_context()
    dev = ctx.device
    made_group = False
    if dev.type == "cuda":
        _build.lib()  # built by the driver in this checkout: loaded here
    if dev.type == "cuda" and not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
        made_group = True
    cfg = config["cfg"]
    params, batches = trainer_state(cfg, dev, config["batch"],
                                    config["seq"])
    first, opt = 0, None
    resume = train.get_checkpoint()
    if resume is not None:
        # built as the saved run built its optimizer: a state_dict is
        # positional
        loaded = train.load_pytree(resume.path, target={
            "params": params, "optimizer": None, "step": None})
        params, first = loaded["params"], loaded["step"]
        opt = make_optimizer(bt.make_adamw, params, zero1=False)
        opt.optimizer.load_state_dict(loaded["optimizer"])
        del loaded
    marker = config.get("crash_marker")

    def on_step(i, p, opt):
        if marker is None or i != TRAINER_CRASH_STEP - 1:
            return
        with tempfile.TemporaryDirectory() as d:
            train.save_pytree({"params": p, "optimizer": opt.optimizer.state_dict(),
                         "step": i + 1}, d)
            train.report({"saved_after_step": i},
                         checkpoint=train.Checkpoint(d))

    def crash_guard(i, p, opt):
        on_step(i, p, opt)
        if (marker is not None and i + 1 == TRAINER_CRASH_STEP
                and not os.path.exists(marker)):
            open(marker, "w").close()
            os._exit(1)

    params, _opt, losses, ms, counts = trainer_steps(
        cfg, params, batches, first, opt, crash_guard)
    for i, (loss, t, c) in enumerate(zip(losses, ms, counts)):
        train.report({"step": first + i, "loss": loss, "ms": t,
                      "launches": c})
    train.report({"digest": digest(params), "first": first,
                  "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "device": str(dev)})
    if made_group:
        dist.destroy_process_group()


def trainer(dev):
    """TorchTrainer at world 1 on the card: three AdamW steps of the
    2-layer full-width Llama in a worker the runtime spawned, equal to
    the same steps in this process, with K1-K4 launched as a training
    step does; then a run whose first attempt dies after a checkpoint
    and resumes (FailureConfig(max_failures=1)), ending bit for bit
    where the uninterrupted run ends. -> (fields, launches)."""
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.scripts import bench_train as bt
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)
    cfg = dataclasses.replace(
        LlamaConfig.llama3_8b(ce_chunk_tokens=bt.CE_CHUNK),
        n_layers=CKPT_LAYERS)
    want = expected_train_counts(cfg.n_layers)
    use_gpu = dev.type == "cuda"
    fields = dict(n_layers=cfg.n_layers, batch=bt.BATCH, seq=bt.SEQ,
                  steps=TRAINER_STEPS)

    # the same steps in this process first, then the card is freed
    t0 = time.perf_counter()
    params, batches = trainer_state(cfg, dev, bt.BATCH, bt.SEQ)
    ctx = nccl_world1(dev) if use_gpu else contextlib.nullcontext()
    with ctx:
        params, opt, losses_in, ms_in, counts_in = trainer_steps(
            cfg, params, batches, 0)
    digest_in = digest(params)
    del params, opt, batches
    free()
    fields["in_process"] = dict(seconds=time.perf_counter() - t0,
                                losses=losses_in, step_ms=ms_in)
    total = None
    for i, c in enumerate(counts_in):
        check(c == want, f"trainer: in-process step {i} launches {c} != "
              f"{want}")
        total = add_counts(total, c)

    t0 = time.perf_counter()
    rt = ray_tpu_torch.init()
    fields["init_s"] = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
        if use_gpu:
            listed = subprocess.run(
                ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
                capture_output=True, text=True,
                check=True).stdout.strip().splitlines()
            check(gpus == len(listed),
                  f"trainer: cluster GPU {gpus} != nvidia-smi's {listed}")
        fields["cluster_gpus"] = gpus

        def fit(name, **config):
            trainer = TorchTrainer(
                trainer_loop, train_loop_config={
                    "cfg": cfg, "batch": bt.BATCH, "seq": bt.SEQ, **config},
                scaling_config=ScalingConfig(num_workers=1,
                                             use_gpu=use_gpu),
                run_config=RunConfig(
                    name=name, storage_path=root,
                    failure_config=FailureConfig(max_failures=1)))
            t_fit = time.perf_counter()
            result = trainer.fit()
            check(result.error is None, f"trainer {name}: {result.error!r}")
            reports = [m for m, _ in result.all_reports[0]]
            steps = [m for m in reports if "loss" in m]
            return dict(seconds=time.perf_counter() - t_fit,
                        states=trainer.state_history, steps=steps,
                        final=reports[-1])

        run = fit("uninterrupted")
        losses = [m["loss"] for m in run["steps"]]
        rel = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(losses, losses_in))
        fields["worker"] = dict(seconds=run["seconds"], losses=losses,
                                step_ms=[m["ms"] for m in run["steps"]],
                                visible=run["final"]["visible"],
                                device=run["final"]["device"],
                                states=run["states"])
        fields["max_rel_loss_diff"] = rel
        check(len(losses) == TRAINER_STEPS and (
            losses == losses_in or rel <= 1e-6),
            f"trainer: worker losses {losses} vs in-process {losses_in}")
        check(run["final"]["digest"] == digest_in,
              "trainer: the worker's final params differ from the "
              "in-process run's")
        for m in run["steps"]:
            check(m["launches"] == want, f"trainer: worker step "
                  f"{m['step']} launches {m['launches']} != {want}")
            total = add_counts(total, m["launches"])
        if use_gpu:
            check(run["final"]["visible"] == "0",
                  f"trainer: worker CUDA_VISIBLE_DEVICES "
                  f"{run['final']['visible']!r}")

        resumed = fit("resumed", crash_marker=os.path.join(root, "crashed"))
        check("RESTARTING" in resumed["states"] and
              os.path.exists(os.path.join(root, "crashed")),
              f"trainer: no restart after the crash: {resumed['states']}")
        check(resumed["final"]["first"] == TRAINER_CRASH_STEP,
              f"trainer: resumed from step {resumed['final']['first']}")
        fields["resumed"] = dict(
            seconds=resumed["seconds"], states=resumed["states"],
            losses=[m["loss"] for m in resumed["steps"]],
            step_ms=[m["ms"] for m in resumed["steps"]],
            bit_equal=resumed["final"]["digest"] == run["final"]["digest"])
        check(resumed["final"]["digest"] == run["final"]["digest"],
              "trainer: the resumed run's final params differ from the "
              "uninterrupted run's")
        check([m["loss"] for m in resumed["steps"]] ==
              losses[TRAINER_CRASH_STEP:],
              f"trainer: resumed losses {resumed['steps']} vs {losses}")
        for m in resumed["steps"]:
            check(m["launches"] == want, f"trainer: resumed step launches "
                  f"{m['launches']} != {want}")
            total = add_counts(total, m["launches"])
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    fields["launches"] = total
    return fields, total


# ---------------------------------------------------------------------------
# phase 10c: the MPMD pipeline trainer and device objects on the runtime
# ---------------------------------------------------------------------------

PIPE_BLOCKS = 4  # decoder blocks, of Llama-3-8B's 32
PIPE_STAGES, PIPE_MICRO = 2, 4
PIPE_BATCH, PIPE_SEQ = 4, 2048
PIPE_STEPS = 3
PIPE_LR = 0.5
PIPE_RECV_S = 60.0  # a stage's wait on a channel before it stalls
# The runtime's shm arena: each stage's parameters cross it twice (the
# actor's argument, and every in-band fetch), and a DAG channel keeps
# its last few values until the next ones push them out.
PIPE_ARENA_BYTES = 24 << 30
PIPE_FREED_SLACK = 256 << 20  # card memory a dead stage may leave
DEVOBJ_SHAPE = (4096, 4096)  # a bf16 weight-sized tensor, 32 MiB
DEVOBJ_REPS = 5


def pipe_config():
    """Llama-3-8B at full width, PIPE_BLOCKS of its blocks, the dense
    cross entropy, no remat: 1F1B keeps at most two microbatches' blocks
    alive on a stage, and the first ``torch.utils.checkpoint`` call in a
    process imports ``torch._dynamo`` (7.8 s on the card machine, paid
    by every fresh stage process in its first step)."""
    from ray_tpu_torch.models import LlamaConfig
    return dataclasses.replace(LlamaConfig.llama3_8b(),
                               n_layers=PIPE_BLOCKS, remat=False)


def pipe_expected_counts(blocks: int, final_norm: bool):
    """Launches of one pipeline step of a stage holding ``blocks``
    blocks (and the final norm when it holds the head), over PIPE_MICRO
    microbatches: per microbatch and block K1 in the forward, K2/K3 in
    the backward, K4 twice in the forward; the final norm's K4 once; no
    int8 FFN."""
    m = PIPE_MICRO
    return {"flash_attention": blocks * m,
            "flash_attention_bwd_dq": blocks * m,
            "flash_attention_bwd_dkv": blocks * m,
            "rms_norm": (2 * blocks + final_norm) * m, "int8_matmul": 0}


def pipe_setup(runner, first_reports):
    """Where a runner's set-up went (host clock): to the stages'
    processes beginning to build, their build, the channels and the
    DAG's compile."""
    t = runner.timings
    start = t["started_at"]
    return dict(
        ship_s=t["actors_submitted_at"] - start,
        to_stage_start_s=[r["init"]["started_at"] - start
                          for r in first_reports],
        stage_init_s=[r["init"]["seconds"] for r in first_reports],
        built_s=t["stages_built_at"] - start,
        compiled_s=t["compiled_at"] - start)


def pipe_sequential(layers, apply_layer, loss_fn, tokens, targets, dev):
    """The pipeline's arithmetic in this process on the card, from the
    same layers: per step each microbatch forward through every layer
    and backward, grads accumulating in ``.grad`` in microbatch order,
    then ``p - lr * g / m`` -> (losses, step ms, launch counts per
    step, host copies of the parameters after step 1 and at the end)."""
    import torch
    from ray_tpu_torch.train.pipeline.executor import tree_leaves
    params = [{k: v.detach().clone() for k, v in lp.items()}
              for lp in layers]
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    losses, ms, counts, snaps = [], [], [], []
    for step in range(PIPE_STEPS):
        reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        total = 0.0
        for xm, ym in zip(torch.tensor_split(tokens, PIPE_MICRO),
                          torch.tensor_split(targets, PIPE_MICRO)):
            h = xm
            for lp in params:
                h = apply_layer(lp, h)
            loss = loss_fn(h, ym)
            loss.backward()
            total += float(loss.detach())
        with torch.no_grad():
            for p in leaves:
                g = p.grad * (1.0 / PIPE_MICRO)
                p.sub_(PIPE_LR * g)
                p.grad = None
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        losses.append(total / PIPE_MICRO)
        if step in (0, PIPE_STEPS - 1):
            snaps.append([t.detach().to("cpu", copy=True) for t in leaves])
    del params, leaves
    return losses, ms, counts, snaps


def same_bits(fetched, snap) -> bool:
    """Every fetched parameter (per-layer dicts of CPU tensors, in model
    order) equal bit for bit to the host copy ``snap``."""
    import torch
    from ray_tpu_torch.train.pipeline.executor import tree_leaves
    got = tree_leaves(fetched)
    return len(got) == len(snap) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(a.view(torch.int16), b.view(torch.int16))
        for a, b in zip(got, snap))


def pipe_steps(runner, tokens, targets, n):
    """``n`` steps -> (losses, step ms on the host clock, reports)."""
    losses, ms, reports = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out = runner.step(tokens, targets, timeout=300.0)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(out["loss"])
        reports.append(out["reports"])
    return losses, ms, reports


def pipe_report_fields(reports, want):
    """Check each stage's launches in each step against ``want`` (by
    stage) and summarise the steps: measured bubble per stage, wall and
    compute ms, edge bytes -> (fields, launches summed)."""
    total = None
    for step, reps in enumerate(reports):
        for rep in reps:
            check(rep["launches"] == want[rep["stage"]],
                  f"mpmd_pipeline: step {step} stage {rep['stage']} "
                  f"launches {rep['launches']} != {want[rep['stage']]}")
            total = add_counts(total, rep["launches"])
    return dict(
        bubble=[[rep["bubble"] for rep in reps] for reps in reports],
        stage_wall_ms=[[rep["wall_s"] * 1e3 for rep in reps]
                       for reps in reports],
        stage_compute_ms=[[rep["compute_s"] * 1e3 for rep in reps]
                          for reps in reports],
        max_live=[rep["max_live"] for rep in reports[-1]],
        edge_bytes=[rep["edge_bytes"] for rep in reports[-1]]), total


class DevObjProducer:
    """Makes a seeded bf16 tensor on the card and puts it as a device
    object (chip_smoke's ``device_objects`` check)."""

    def make(self, shape, seed):
        import hashlib
        import torch
        from ray_tpu_torch.experimental import device_objects
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.tensor = torch.randn(shape, generator=gen, device="cuda",
                                  dtype=torch.float32).to(torch.bfloat16)
        self.ref = device_objects.put(self.tensor)
        bits = self.tensor.view(torch.int16).cpu().numpy().tobytes()
        return self.ref, hashlib.blake2b(bits, digest_size=16).hexdigest()

    def same_storage(self):
        from ray_tpu_torch.experimental import device_objects
        return device_objects.get(self.ref).data_ptr() == \
            self.tensor.data_ptr()


class DevObjConsumer:
    """Fetches a device object onto its card: its bits' digest, dtype,
    device and the fetch's ms."""

    def fetch(self, ref):
        import hashlib
        import torch
        from ray_tpu_torch.experimental import device_objects
        t0 = time.perf_counter()
        t = device_objects.get(ref)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        bits = t.view(torch.int16).cpu().numpy().tobytes()
        return (hashlib.blake2b(bits, digest_size=16).hexdigest(),
                str(t.dtype), t.device.type, ms)


def device_objects_check(dev):
    """A bf16 CUDA tensor actor -> driver, actor -> actor and driver ->
    actor, each bit for bit, with each route's ms (median of
    DEVOBJ_REPS fetches: the owner's device-to-host copy, the store, the
    host-to-device copy); a get in the owner's process is the live
    tensor."""
    import hashlib
    import torch
    import ray_tpu_torch
    from ray_tpu_torch.experimental import device_objects

    def digest(t):
        bits = t.view(torch.int16).cpu().numpy().tobytes()
        return hashlib.blake2b(bits, digest_size=16).hexdigest()

    producer, consumer = (ray_tpu_torch.remote(num_gpus=0.5)(cls).remote()
                          for cls in (DevObjProducer, DevObjConsumer))
    try:
        t0 = time.perf_counter()
        ref, want = ray_tpu_torch.get(producer.make.remote(DEVOBJ_SHAPE,
                                                           SEED))
        made_s = time.perf_counter() - t0  # the actors' start included
        to_driver = []
        for _ in range(DEVOBJ_REPS):
            t0 = time.perf_counter()
            got = device_objects.get(ref, device=dev)
            torch.cuda.synchronize(dev)
            to_driver.append((time.perf_counter() - t0) * 1e3)
        check(got.dtype == torch.bfloat16 and got.device.type == "cuda"
              and digest(got) == want,
              "device_objects: actor -> driver not bit-exact")
        a2a = [ray_tpu_torch.get(consumer.fetch.remote(ref))
               for _ in range(DEVOBJ_REPS)]
        check(all(r[:3] == (want, "torch.bfloat16", "cuda") for r in a2a),
              f"device_objects: actor -> actor {a2a[0][:3]} != {want}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        mine = torch.randn(DEVOBJ_SHAPE, generator=gen, device=dev
                           ).to(torch.bfloat16)
        mine_ref = device_objects.put(mine)
        d2a = [ray_tpu_torch.get(consumer.fetch.remote(mine_ref))
               for _ in range(DEVOBJ_REPS)]
        check(all(r[:3] == (digest(mine), "torch.bfloat16", "cuda")
                  for r in d2a), "device_objects: driver -> actor not "
              "bit-exact")
        check(device_objects.get(mine_ref).data_ptr() == mine.data_ptr(),
              "device_objects: a driver get is not the live tensor")
        check(ray_tpu_torch.get(producer.same_storage.remote()),
              "device_objects: an actor's own get is not the live tensor")
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        return dict(shape=list(DEVOBJ_SHAPE), dtype="bfloat16", made_s=made_s,
                    nbytes=mine.numel() * mine.element_size(),
                    actor_to_driver_ms=med(to_driver),
                    actor_to_actor_ms=med([r[3] for r in a2a]),
                    driver_to_actor_ms=med([r[3] for r in d2a]),
                    bit_exact=True, same_storage=True)
    finally:
        ray_tpu_torch.kill(producer)
        ray_tpu_torch.kill(consumer)


def mpmd_pipeline(dev, smi):
    """Llama-3-8B width, PIPE_BLOCKS blocks, trained by two stage actors
    sharing the card (``PipelineRunner``, 1F1B, shm channels) for
    PIPE_STEPS SGD steps, each stage's launches exactly
    ``pipe_expected_counts``, losses and parameters bit-equal to the
    same steps in this process; one GPipe step and one step over TCP
    channels equal to this process's first step; a stage that dies
    mid-step surfacing as ``DAGExecutionError`` naming it; device
    objects; and the card's memory back to its level before the
    runners once every process is shut down. -> (fields, launches
    summed over this process's and the stages' steps)."""
    import functools as ft
    import numpy as np
    import torch
    import ray_tpu_torch
    from ray_tpu_torch.dag import DAGExecutionError
    from ray_tpu_torch.models import (llama_apply_layer, llama_init,
                                      llama_logits_loss,
                                      llama_pipeline_layers)
    from ray_tpu_torch.train.pipeline import (LayeredModel, PipelineRunner,
                                              partition_model,
                                              bubble_fraction)
    t_phase = time.perf_counter()

    def progress(what):  # on stderr: where a failed run got to
        print(f"mpmd_pipeline +{time.perf_counter() - t_phase:.1f}s "
              f"{what}", file=sys.stderr, flush=True)

    cfg = pipe_config()
    apply_layer = ft.partial(llama_apply_layer, config=cfg)
    layers = llama_pipeline_layers(llama_init(SEED, cfg, dev))
    plans = partition_model(LayeredModel(layers, None, None), PIPE_STAGES)
    rng = np.random.default_rng(SEED)
    tokens, targets = (rng.integers(0, cfg.vocab_size,
                                    (PIPE_BATCH, PIPE_SEQ))
                       for _ in range(2))
    stage_blocks = [sum("wq" in lp for lp in p.layer_params) for p in plans]
    want = [pipe_expected_counts(b, p.is_last)
            for b, p in zip(stage_blocks, plans)]
    fields = dict(
        n_layers=PIPE_BLOCKS, stages=PIPE_STAGES, microbatches=PIPE_MICRO,
        batch=PIPE_BATCH, seq=PIPE_SEQ, steps=PIPE_STEPS, lr=PIPE_LR,
        split=[[p.start, p.stop] for p in plans],
        stage_params=[sum(t.numel() for lp in p.layer_params
                          for t in lp.values()) for p in plans],
        expected_launches=want,
        theoretical_bubble=bubble_fraction(PIPE_STAGES, PIPE_MICRO),
        card=smi)

    t0 = time.perf_counter()
    seq_losses, seq_ms, seq_counts, (snap1, snap_end) = pipe_sequential(
        layers, apply_layer, llama_logits_loss,
        torch.from_numpy(tokens).to(dev), torch.from_numpy(targets).to(dev),
        dev)
    check(all(math.isfinite(x) for x in seq_losses),
          f"mpmd_pipeline: driver losses {seq_losses}")
    total = None
    for c in seq_counts:
        check(c == add_counts(want[0], want[1]),
              f"mpmd_pipeline: driver step launches {c}")
        total = add_counts(total, c)
    fields["sequential"] = dict(seconds=time.perf_counter() - t0,
                                losses=seq_losses, step_ms=seq_ms)
    progress(f"sequential {fields['sequential']}")
    free()
    base_free = torch.cuda.mem_get_info(dev)[0]

    model = LayeredModel(layers, apply_layer, llama_logits_loss)
    t0 = time.perf_counter()
    ray_tpu_torch.init(object_store_memory=PIPE_ARENA_BYTES)
    try:
        # 1F1B over shm channels: the main run
        t_init = time.perf_counter()
        runner = PipelineRunner(model, num_stages=PIPE_STAGES,
                                num_microbatches=PIPE_MICRO, lr=PIPE_LR,
                                recv_timeout_s=PIPE_RECV_S)
        init_s = time.perf_counter() - t_init
        progress(f"1f1b_shm runner made in {init_s:.1f}s")
        try:
            losses, ms, reports = pipe_steps(runner, tokens, targets,
                                             PIPE_STEPS)
            t_fetch = time.perf_counter()
            after_end = runner.fetch_params(timeout=300.0)
            fetch_s = time.perf_counter() - t_fetch
        finally:
            runner.shutdown()
        check(losses == seq_losses, f"mpmd_pipeline: 1F1B losses {losses} "
              f"!= this process's {seq_losses}")
        check(same_bits(after_end, snap_end),
              "mpmd_pipeline: 1F1B parameters differ from this process's")
        del after_end
        rep_fields, counts = pipe_report_fields(reports, want)
        total = add_counts(total, counts)
        fields["1f1b_shm"] = dict(init_s=init_s, fetch_s=fetch_s,
                                  setup=pipe_setup(runner, reports[0]),
                                  losses=losses, step_ms=ms,
                                  bit_equal=True, **rep_fields)
        progress(f"1f1b_shm {fields['1f1b_shm']}")

        # one GPipe step, then one 1F1B step over TCP whose runner then
        # loses stage 0 mid-step
        for name, kw in (("gpipe_shm", dict(schedule="gpipe")),
                         ("1f1b_tcp", dict(transport="tcp"))):
            t_init = time.perf_counter()
            runner = PipelineRunner(
                model, num_stages=PIPE_STAGES, num_microbatches=PIPE_MICRO,
                lr=PIPE_LR, recv_timeout_s=PIPE_RECV_S, **kw)
            init_s = time.perf_counter() - t_init
            progress(f"{name} runner made in {init_s:.1f}s")
            try:
                one = pipe_steps(runner, tokens, targets, 1)
                progress(f"{name} step {one[:2]}")
                after1 = runner.fetch_params(timeout=300.0)
                failure = None
                if name == "1f1b_tcp":
                    runner.inject_failure(0)
                    t_fail = time.perf_counter()
                    try:
                        runner.execute_async(tokens, targets).get(None)
                    except DAGExecutionError as exc:
                        failure = dict(message=str(exc)[:300],
                                       seconds=time.perf_counter() - t_fail)
                    check(failure is not None and
                          "pipeline stage 0 died" in failure["message"],
                          f"mpmd_pipeline: stage 0's death gave {failure}")
            finally:
                runner.shutdown()
            check(one[0] == losses[:1], f"mpmd_pipeline: {name} loss "
                  f"{one[0]} != 1F1B's {losses[:1]}")
            check(same_bits(after1, snap1),
                  f"mpmd_pipeline: {name} parameters differ from this "
                  "process's after step 1")
            del after1
            rep_fields, counts = pipe_report_fields(one[2], want)
            total = add_counts(total, counts)
            fields[name] = dict(init_s=init_s, losses=one[0], step_ms=one[1],
                                setup=pipe_setup(runner, one[2][0]),
                                bit_equal=True, **rep_fields)
            if failure is not None:
                fields[name]["failure"] = failure
            progress(f"{name} done")

        t_dev = time.perf_counter()
        fields["device_objects"] = device_objects_check(dev)
        fields["device_objects"]["seconds"] = time.perf_counter() - t_dev

        # every stage and actor process is gone: the card has its memory
        # back
        deadline = time.monotonic() + 30.0
        while True:
            now_free = torch.cuda.mem_get_info(dev)[0]
            if now_free >= base_free - PIPE_FREED_SLACK or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.5)
        fields["card_free_gb"] = dict(before=base_free / 1e9,
                                      after_shutdown=now_free / 1e9)
        check(now_free >= base_free - PIPE_FREED_SLACK,
              f"mpmd_pipeline: {base_free - now_free} bytes of the card "
              "still held after shutdown()")

        progress(f"card memory {fields['card_free_gb']}")
    finally:
        ray_tpu_torch.shutdown()
    fields["runtime_s"] = time.perf_counter() - t0
    for kname in ("flash_attention", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv", "rms_norm"):
        check(total[kname] > 0, f"mpmd_pipeline: {kname} never launched")
    fields["launches"] = total
    return fields, total


# ---------------------------------------------------------------------------
# phase 9: RL — Anakin's fused update and PPO (no kernel of K1-K5)
# ---------------------------------------------------------------------------

RL_UPDATES_VS_CPU = 3
# columns and params after three f32 updates, card against CPU (TF32
# off): measured 6.0e-7 and 3.0e-8 on an H100 (PERF.md)
RL_ATOL = 1e-5
RL_WARMUP, RL_TIMED, RL_PROFILED = 2, 20, 5
# rl_offpolicy: iterations of DQN, SAC and the connector PPO; updates of
# CQL and IQL on RL_OFF_EPISODES Pendulum episodes; updates per timing
RL_OFF_ITERS, RL_OFF_UPDATES, RL_OFF_EPISODES, RL_OFF_TIMED = 6, 300, 20, 50


def anakin_config(num_envs: int):
    """bench.py's Anakin configuration (bench.py:287-288): CartPole,
    rollout 16, hidden (64, 64), at ``num_envs`` envs."""
    from ray_tpu_torch.rl.podracer import AnakinConfig
    return AnakinConfig(num_envs_per_device=num_envs, rollout_len=16,
                        hidden=(64, 64), seed=SEED)


def rl_vs_cpu(dev):
    """Three fused Anakin updates at 16 envs on the card and on the CPU,
    from the same weights (``spec.init`` draws on the CPU) and the same
    draws (made once with a CPU generator and handed to both)."""
    import torch
    from ray_tpu_torch.rl.env import CartPoleTensor
    from ray_tpu_torch.rl.env_runner import draw_rollout_noise
    from ray_tpu_torch.rl.podracer import build_step, make_optimizer
    from ray_tpu_torch.rl.rl_module import RLModuleSpec
    cfg = anakin_config(16)
    env = CartPoleTensor()
    spec = RLModuleSpec(env.observation_space, env.action_space, cfg.hidden)
    gen = torch.Generator().manual_seed(SEED)
    states = env.draw_reset((cfg.num_envs_per_device,), gen, "cpu")
    noises = [draw_rollout_noise(spec, env, cfg.rollout_len,
                                 cfg.num_envs_per_device, gen, "cpu")
              for _ in range(RL_UPDATES_VS_CPU)]

    def run(device):
        module = spec.init(cfg.seed, device)
        optimizer = make_optimizer(module, cfg)
        step = build_step(env, spec, cfg)
        state, obs = env.reset(states.to(device))
        cols, losses = [], []
        for noise in noises:
            state, obs, m, c = step(module, optimizer, state, obs, noise)
            cols.append({k: v.cpu() for k, v in c.items()})
            losses.append(m["total_loss"].item())
        params = {k: v.detach().cpu() for k, v in module.state_dict().items()}
        return cols, params, losses

    card, cpu = run(dev), run(torch.device("cpu"))
    col_err = 0.0
    for got, want in zip(card[0], cpu[0]):
        for k in ("actions", "dones", "truncateds"):
            check(torch.equal(got[k], want[k]),
                  f"rl_vs_cpu: the card's {k} differ from the CPU's")
        for k in ("obs", "action_logp", "vf_preds", "rewards", "final_obs",
                  "bootstrap_value"):
            col_err = max(col_err, (got[k] - want[k]).abs().max().item())
    param_err = max((card[1][k] - cpu[1][k]).abs().max().item()
                    for k in cpu[1])
    check(col_err <= RL_ATOL and param_err <= RL_ATOL,
          f"rl_vs_cpu: columns {col_err}, params {param_err} > {RL_ATOL}")
    return dict(updates=RL_UPDATES_VS_CPU, envs=cfg.num_envs_per_device,
                rollout_len=cfg.rollout_len, tolerance=RL_ATOL,
                max_abs_err_columns=col_err, max_abs_err_params=param_err,
                dones=int(sum(c["dones"].sum() for c in card[0])),
                losses_card=card[2], losses_cpu=cpu[2])


def anakin_window(dev, num_envs: int):
    """bench.py's protocol (bench.py:286-291): RL_WARMUP updates, then
    RL_TIMED timed ones (host clock and CUDA events), then RL_PROFILED
    under torch.profiler for device busy time and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.rl.podracer import Anakin
    from ray_tpu_torch.scripts.profile_engine import _kernel_table
    cfg = anakin_config(num_envs)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)  # earlier phases' leftovers
    trainer = Anakin(cfg, device=dev)
    trainer.train(RL_WARMUP)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    out = trainer.train(RL_TIMED)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / RL_TIMED
    steps = cfg.num_envs_per_device * cfg.rollout_len
    check(out["env_steps"] == (RL_WARMUP + RL_TIMED) * steps,
          f"anakin {num_envs}: env steps {out['env_steps']}")
    losses = [out[k] for k in ("total_loss", "policy_loss", "vf_loss",
                               "entropy")]
    check(all(math.isfinite(x) for x in losses),
          f"anakin {num_envs}: non-finite losses {out}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train(RL_PROFILED)
        torch.cuda.synchronize()
    busy_ms, launches, table = _kernel_table(prof, RL_PROFILED, 6)
    check(launches > 0, f"anakin {num_envs}: the profiler saw no kernel")
    return dict(
        envs=num_envs, rollout_len=cfg.rollout_len,
        env_steps_per_update=steps,
        env_steps_per_sec=out["env_steps_per_sec"],
        ms_per_update_host=host_ms,
        ms_per_update_events=start.elapsed_time(end) / RL_TIMED,
        device_busy_ms_per_update=busy_ms,
        launches_per_update=launches,
        # busy over the unprofiled update: the profiler stretches the
        # host's side only
        idle_share=1.0 - busy_ms / host_ms,
        peak_mem_mb=(torch.cuda.max_memory_allocated(dev) - held) / 1e6,
        last_metrics={k: out[k] for k in ("total_loss", "policy_loss",
                                          "vf_loss", "entropy",
                                          "reward_mean")},
        top_kernels=table)


def rl_anakin(dev, card):
    return dict(card=card, windows=[anakin_window(dev, n)
                                    for n in (16, 4096)])


def rl_ppo(dev):
    """PPO's device path in tests/test_rl.py:96-112's configuration,
    gated on that test's bar, then two iterations of Pendulum-v1 on the
    local Python runner (the DiagGaussian path)."""
    from ray_tpu_torch.rl import PPOConfig
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=16,
                         rollout_fragment_length=128)
            .training(lr=3e-3, num_epochs=4, minibatch_size=512)
            .debugging(seed=SEED)
            .build_algo(device=dev))
    results = [algo.train() for _ in range(12)]
    last = results[-1]
    check(last["num_env_steps_sampled_lifetime"] == 12 * 16 * 128,
          f"ppo env steps {last['num_env_steps_sampled_lifetime']}")
    check(last["episode_return_mean"] > 60,
          f"ppo did not learn CartPole: {last['episode_return_mean']}")
    pendulum = PPOConfig().environment("Pendulum-v1").debugging(
        seed=SEED).build_algo(device=dev)
    check(pendulum.tensor_runner is None, "Pendulum took a tensor env")
    pend = [pendulum.train() for _ in range(2)]
    for r in pend:
        check(all(math.isfinite(r[k]) for k in ("total_loss", "policy_loss",
                                                "vf_loss", "entropy")),
              f"pendulum: non-finite losses {r}")
    return dict(
        return_curve=[r["episode_return_mean"] for r in results],
        env_steps_per_sec=[r["env_steps_per_sec"] for r in results],
        seconds_per_iter=[r["time_this_iter_s"] for r in results],
        pendulum_return=[r["episode_return_mean"] for r in pend],
        pendulum_env_steps_per_sec=[r["env_steps_per_sec"] for r in pend],
        pendulum_losses=[r["total_loss"] for r in pend])


def rl_offpolicy_vs_cpu(dev, card):
    """Three updates each of the IMPALA learner (one time-major
    fragment), DQN, SAC, CQL, IQL and MARWIL on the card and on the CPU,
    from the same weights, fixed batches and draws (made once on the
    host, scripts/rl_offpolicy.py); losses and params within RL_ATOL."""
    import torch
    from ray_tpu_torch.scripts import rl_offpolicy
    inputs = rl_offpolicy.make_inputs(SEED)
    on_card = rl_offpolicy.run_updates(dev, inputs)
    on_cpu = rl_offpolicy.run_updates(torch.device("cpu"), inputs)
    errs = rl_offpolicy.max_errors(on_card, on_cpu)
    for name, err in errs.items():
        check(err["losses"] <= RL_ATOL and err["params"] <= RL_ATOL,
              f"rl_offpolicy_vs_cpu: {name} {err} > {RL_ATOL}")
    return dict(card=card, updates=rl_offpolicy.UPDATES,
                tolerance=RL_ATOL, max_abs_err=errs,
                losses_card={k: v["losses"] for k, v in on_card.items()})


def _update_ms(step, reps: int = RL_OFF_TIMED):
    """ms per call of ``step()`` (one learner update) over ``reps``
    calls: the host clock and CUDA events around the same window."""
    import torch
    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    end.record()
    torch.cuda.synchronize()
    return dict(ms_per_update_host=(time.perf_counter() - t0) * 1e3 / reps,
                ms_per_update_events=start.elapsed_time(end) / reps)


def _iterations(algo, n):
    """``n`` train() results, reduced to what the phase prints."""
    keep = ("episode_return_mean", "env_steps_per_sec", "time_this_iter_s",
            "num_env_steps_sampled_lifetime", "loss", "critic_loss",
            "actor_loss", "alpha", "cql_penalty", "value_loss",
            "total_loss", "policy_loss")
    return [{k: r[k] for k in keep if k in r}
            for r in (algo.train() for _ in range(n))]


def _finite(name, rows, keys=None):
    """Every number of ``rows`` (of ``keys`` where given) is finite."""
    for r in rows:
        for k in (keys or r):
            check(math.isfinite(r[k]), f"rl_offpolicy: {name} {k} = {r[k]}")


def rl_offpolicy(dev, card):
    """DQN on CartPole and SAC on Pendulum for a few iterations each,
    PPO on CartPole through ObsNormalizer + FrameStack(4) on the Python
    runner, and CQL and IQL for RL_OFF_UPDATES updates on episodes
    collected on the host; env-steps/s, ms per update (host clock and
    CUDA events over RL_OFF_TIMED updates on a replay batch) and
    returns."""
    import numpy as np
    from ray_tpu_torch.rl import (
        CQLConfig, DQNConfig, FrameStack, IQLConfig, ObsNormalizer,
        OfflineData, PPOConfig, SACConfig, collect_episodes)
    from ray_tpu_torch.rl.env import Pendulum
    from ray_tpu_torch.rl.learner import batch_to_device
    out = {"card": card}
    rng = np.random.default_rng(SEED)

    dqn = (DQNConfig().environment("CartPole-v1").debugging(seed=SEED)
           .build_algo(device=dev))
    rows = _iterations(dqn, RL_OFF_ITERS)
    # the loss from the first iteration past learning_starts (500 env
    # steps, 256 an iteration), every number at the last
    _finite("dqn", rows[1:], ("loss", "env_steps_per_sec"))
    _finite("dqn", rows[-1:])
    batch = batch_to_device(
        dqn.buffer.sample(dqn.config.train_batch_size, rng), dev)
    out["dqn"] = dict(iterations=rows, updates=dqn._grad_updates,
                      **_update_ms(lambda: dqn.train_step(batch)))

    sac = (SACConfig().environment("Pendulum-v1")
           .training(learning_starts=256).debugging(seed=SEED)
           .build_algo(device=dev))
    rows = _iterations(sac, RL_OFF_ITERS)
    # updates from the first iteration; the first 200-step episodes end
    # in the fourth
    _finite("sac", rows, ("critic_loss", "actor_loss", "alpha",
                          "env_steps_per_sec"))
    _finite("sac", rows[-1:])
    sbatch = batch_to_device(
        sac.buffer.sample(sac.config.train_batch_size, rng), dev)
    snoise = {k: v[0] for k, v in sac.noise("update", 1).items()}
    out["sac"] = dict(iterations=rows,
                      **_update_ms(lambda: sac.train_step(sbatch, snoise)))

    ppo = (PPOConfig().environment("CartPole-v1")
           .env_to_module([ObsNormalizer, lambda: FrameStack(4)])
           .env_runners(num_envs_per_env_runner=8,
                        rollout_fragment_length=128)
           .debugging(seed=SEED).build_algo(device=dev))
    raw = 4  # CartPole's observation width
    check(ppo.spec.obs_dim == 4 * raw and ppo.tensor_runner is None,
          f"rl_offpolicy: connector PPO obs_dim {ppo.spec.obs_dim}")
    rows = _iterations(ppo, RL_OFF_ITERS)
    _finite("ppo_connectors", rows)
    width = ppo.runners[0]._obs.shape[-1]
    check(width == 4 * raw, f"rl_offpolicy: stacked obs width {width}")
    out["ppo_connectors"] = dict(obs_dim=ppo.spec.obs_dim,
                                 stacked_obs_width=width, iterations=rows)

    t0 = time.perf_counter()
    episodes = collect_episodes(
        Pendulum, lambda obs: rng.uniform(-2.0, 2.0, (1,)).astype(
            np.float32), num_episodes=RL_OFF_EPISODES, seed=SEED,
        max_steps=200)
    data = OfflineData(episodes)
    out["offline_collect_s"] = time.perf_counter() - t0
    for name, cfg in (("cql", CQLConfig()), ("iql", IQLConfig())):
        algo = (cfg.environment("Pendulum-v1").offline(data)
                .training(num_gradient_steps=RL_OFF_UPDATES // 3)
                .evaluation(evaluation_episodes=1)
                .debugging(seed=SEED).build_algo(device=dev))
        t0 = time.perf_counter()
        rows = _iterations(algo, 3)
        seconds = time.perf_counter() - t0
        _finite(name, rows)
        obatch = batch_to_device(
            data.sample(algo.config.train_batch_size, rng), dev)
        if name == "cql":
            onoise = {k: v[0] for k, v in algo.noise("update", 1).items()}
            timing = _update_ms(lambda: algo.train_step(obatch, onoise,
                                                        False))
        else:
            timing = _update_ms(lambda: algo.train_step(obatch))
        out[name] = dict(iterations=rows, updates=algo._updates,
                         seconds_with_eval=seconds, **timing)
    return out


# rl_dreamer: DreamerV3 at its default widths on CartPole, training from
# the first iteration (64 env steps and 64 train steps an iteration)
DREAMER_ENVS, DREAMER_FRAGMENT, DREAMER_STARTS = 4, 16, 32
DREAMER_TIMED, DREAMER_PROFILED, DREAMER_COLLECT = 20, 5, 64


def rl_dreamer_vs_cpu(dev, card):
    """Three chained DreamerV3 train steps at the default widths on the
    card and on the CPU from the same weights, batches and draws
    (scripts/rl_dreamer.py): every sampled latent and imagined action
    equal, losses (relative above 1) and params within RL_ATOL."""
    import torch
    from ray_tpu_torch.scripts import rl_dreamer
    inputs = rl_dreamer.make_inputs(SEED)
    on_card = rl_dreamer.run_steps(dev, inputs)
    on_cpu = rl_dreamer.run_steps(torch.device("cpu"), inputs)
    errs = rl_dreamer.max_errors(on_card, on_cpu)
    check(errs["samples_differ"] == 0,
          f"rl_dreamer_vs_cpu: sampled indices differ: {errs}")
    check(max(errs["losses"], errs["params"], errs["ret_scale"]) <= RL_ATOL,
          f"rl_dreamer_vs_cpu: {errs} > {RL_ATOL}")
    return dict(card=card, steps=rl_dreamer.STEPS, tolerance=RL_ATOL,
                max_err=errs, losses_card=on_card["losses"].tolist())


def _part(fn, reps: int = 5):
    """Host ms of ``fn()`` (ending in a synchronize) averaged over
    ``reps`` calls, and its launches from one profiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.scripts.profile_engine import _kernel_table
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(ms_host=ms, launches=_kernel_table(prof, 1, 0)[1])


def rl_dreamer(dev, card):
    """DreamerV3 on CartPole at its default widths: two iterations
    (metrics finite, training from the first), ms per train step on a
    replay batch (host clock and CUDA events over DREAMER_TIMED steps),
    launches and device busy time per step from a torch.profiler window,
    the step's parts (the world model's T loop forward and its backward,
    imagination's H loop and the actor-critic losses, the actor-critic
    backward) and ``_collect``'s env-steps/s."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.rl import DreamerV3Config
    from ray_tpu_torch.rl.algorithms.dreamerv3 import METRIC_NAMES
    from ray_tpu_torch.scripts.profile_engine import _kernel_table
    algo = (DreamerV3Config().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=DREAMER_ENVS,
                         rollout_fragment_length=DREAMER_FRAGMENT)
            .training(learning_starts=DREAMER_STARTS)
            .debugging(seed=SEED).build_algo(device=dev))
    rows = [algo.train() for _ in range(2)]
    for r in rows:
        check(all(k in r and math.isfinite(r[k]) for k in METRIC_NAMES),
              f"rl_dreamer: metrics {r}")
    cfg = algo.config
    batch = algo.stage_batch(algo.buffer.sample(
        cfg.batch_size_B, cfg.batch_length_T, np.random.default_rng(SEED)))
    noise = algo.train_noise()
    timing = _update_ms(lambda: algo.train_step(batch, noise), DREAMER_TIMED)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DREAMER_PROFILED):
            algo.train_step(batch, noise)
        torch.cuda.synchronize()
    busy_ms, launches, table = _kernel_table(prof, DREAMER_PROFILED, 6)
    check(launches > 0, "rl_dreamer: the profiler saw no kernel")

    # the step's parts, without the optimizer steps
    def wm_forward():
        return algo.wm_loss(batch, noise["wm_latent"])

    def wm_backward():
        wm_forward()[0].backward()
        algo.wm_opt.zero_grad(set_to_none=True)

    wm = wm_forward()
    starts = (wm[1].detach().reshape(-1, wm[1].shape[-1]),
              wm[2].detach().reshape(-1, wm[2].shape[-1]))

    def ac_forward():
        return algo.ac_loss(*starts, noise["img_action"],
                            noise["img_latent"])

    def ac_backward():
        ac_forward()[0].backward()
        algo.ac_opt.zero_grad(set_to_none=True)

    parts = {"wm_forward_T_loop": _part(wm_forward),
             "wm_forward_and_backward": _part(wm_backward),
             "imagination_H_loop_and_ac_losses": _part(ac_forward),
             "ac_forward_and_backward": _part(ac_backward)}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    algo._collect(DREAMER_COLLECT)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    host_ms = timing["ms_per_update_host"]
    return dict(
        card=card, envs=DREAMER_ENVS, widths=dict(
            deter=cfg.deter_size, latents=[cfg.stoch_groups,
                                           cfg.stoch_classes],
            units=cfg.units, B=cfg.batch_size_B, T=cfg.batch_length_T,
            H=cfg.horizon_H),
        iterations=[{k: r[k] for k in ("env_steps_per_sec",
                                       "time_this_iter_s", "buffer_size",
                                       *METRIC_NAMES)} for r in rows],
        ms_per_train_step_host=host_ms,
        ms_per_train_step_events=timing["ms_per_update_events"],
        device_busy_ms_per_train_step=busy_ms,
        launches_per_train_step=launches,
        idle_share=1.0 - busy_ms / host_ms, top_kernels=table,
        parts=parts,
        collect_env_steps_per_sec=DREAMER_COLLECT * DREAMER_ENVS / collect_s)


def rl_multi_agent(dev, card):
    """Multi-agent PPO on the card in tests/test_rl.py:628-672's and
    :932-962's configurations, gated on their bars: the learner beats a
    frozen rock-biased opponent (evaluation reward above 3.0 after 12
    iterations, zero-sum per policy), and tic-tac-toe self-play's mean
    episode length rises above max(4, first + 0.5) in 14 iterations."""
    import numpy as np
    from ray_tpu_torch.rl import PPOConfig, RepeatedRockPaperScissors, TicTacToe
    t0 = time.perf_counter()
    rps = (PPOConfig().environment(RepeatedRockPaperScissors)
           .multi_agent(policy_mapping_fn=lambda aid: (
               "learner" if aid == "player_0" else "opponent"),
               policies_to_train=["learner"])
           .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=40)
           .training(lr=0.02, num_epochs=4, minibatch_size=128,
                     entropy_coeff=0.0)
           .evaluation(evaluation_duration=8, evaluation_num_envs=4)
           .debugging(seed=SEED).build_algo(device=dev))
    opp = rps.ma_learners["opponent"]
    params = opp.get_weights()
    params["pi"][-1]["b"] = np.array([5.0, 0.0, 0.0], np.float32)
    opp.set_weights(params)
    rows = [rps.train() for _ in range(12)]
    check("opponent/total_loss" not in rows[-1],
          "rl_multi_agent: the frozen opponent trained")
    ev = rps.evaluate()
    learner, opponent = (ev["policy_reward_mean/learner"],
                         ev["policy_reward_mean/opponent"])
    check(abs(learner + opponent) <= 1e-5 and learner > 3.0,
          f"rl_multi_agent: rock-paper-scissors evaluation {ev}")
    rps_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    ttt = (PPOConfig().environment(TicTacToe)
           .multi_agent(policy_mapping_fn=lambda aid: "shared")
           .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=32)
           .training(lr=0.01, num_epochs=4, minibatch_size=256,
                     entropy_coeff=0.01)
           .debugging(seed=SEED).build_algo(device=dev))
    trows = [ttt.train() for _ in range(14)]
    lens = [r["episode_len_mean"] for r in trows]
    check(lens[-1] > max(4.0, lens[0] + 0.5),
          f"rl_multi_agent: tic-tac-toe episode lengths {lens}")
    return dict(
        card=card,
        rps=dict(seconds=rps_s, evaluation=ev,
                 env_steps_per_sec=[r["env_steps_per_sec"] for r in rows],
                 learner_reward=[r.get("policy_reward_mean/learner")
                                 for r in rows]),
        tictactoe=dict(seconds=time.perf_counter() - t0, episode_len=lens,
                       env_steps_per_sec=[r["env_steps_per_sec"]
                                          for r in trows]))


# rl_remote: PPO over remote runners, the learner group, APPO / IMPALA
REMOTE_ITERS, GROUP_UPDATES, ASYNC_ITERS = 3, 3, 4
REMOTE_RUNNERS, REMOTE_ENVS, REMOTE_FRAGMENT = 2, 8, 64
GROUP_ROWS, GROUP_ATOL = 256, 1e-5
SEBULBA_UPDATES = 12


def _runtime(**system_config):
    """A fresh port runtime on this machine (it counts the card)."""
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    return ray_tpu_torch.init(system_config=system_config or None)


def _stop_runtime():
    import ray_tpu_torch
    from ray_tpu_torch import serve
    if ray_tpu_torch.is_initialized():
        serve.shutdown()
        ray_tpu_torch.shutdown()


def _flat_leaves(tree):
    import numpy as np
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat_leaves(v)]
    return [np.asarray(tree)]


def group_batch(n, seed):
    """A PPO minibatch of ``n`` CartPole-shaped rows from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(2, size=n).astype(np.int32),
        "action_logp": np.full(n, -0.69, dtype=np.float32),
        "vf_preds": rng.normal(size=n).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }


def ddp_in_process(learner, batches, n):
    """The learner group's arithmetic in this process: per batch, the
    gradients of each wraparound shard's loss, their mean, the clip and
    Adam's step."""
    import numpy as np
    import torch
    from ray_tpu_torch.rl.learner import batch_to_device, clip_by_global_norm_
    params = list(learner.module.parameters())
    for batch in batches:
        size = len(batch["obs"])
        idx = np.arange(max(size, n)) % size
        total = [torch.zeros_like(p) for p in params]
        for chunk in np.array_split(idx, n):
            shard = batch_to_device({k: v[chunk] for k, v in batch.items()},
                                    learner.device)
            loss, _ = learner.loss(learner.module, shard)
            total = [t + g for t, g in
                     zip(total, torch.autograd.grad(loss, params))]
        learner.optimizer.zero_grad(set_to_none=True)
        for p, t in zip(params, total):
            p.grad = t / n
        clip_by_global_norm_([p.grad for p in params], learner.grad_clip)
        learner.optimizer.step()


def _timed_train(algo, n):
    rows, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        rows.append(algo.train())
        ms.append((time.perf_counter() - t0) * 1e3)
    return rows, ms


def rl_remote(dev, card):
    """RL's remote parts on the port's runtime. PPO on CartPole (Python
    env) through 2 remote CPU runners, the learner on the card, each
    runner's first fragment bit for bit a local CPU runner's; a learner
    group of 2 actors on half the card each against the same steps in
    this process; APPO and IMPALA for 4 iterations each."""
    import numpy as np
    import ray_tpu_torch
    from ray_tpu_torch.rl import (APPOConfig, IMPALAConfig, PPOConfig,
                                  RLModuleSpec)
    from ray_tpu_torch.rl.algorithms.ppo import PPOLearner
    from ray_tpu_torch.rl.env import CartPole
    from ray_tpu_torch.rl.env_runner import SingleAgentEnvRunner
    from ray_tpu_torch.rl.learner import LearnerGroup
    from ray_tpu_torch.rl.spaces import Box, Discrete
    _runtime()
    out = dict(card=card)
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
        check(gpus >= 1, f"rl_remote: the runtime counts {gpus} GPUs")
        # PPO: 2 remote runners, the learner here on the card
        t0 = time.perf_counter()
        algo = (PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=REMOTE_RUNNERS,
                             num_envs_per_env_runner=REMOTE_ENVS,
                             rollout_fragment_length=REMOTE_FRAGMENT,
                             prefer_tensor_env=False)
                .training(num_epochs=2, minibatch_size=256)
                .debugging(seed=SEED).build_algo(device=dev))
        out["ppo_start_s"] = time.perf_counter() - t0
        try:
            check(algo.learner_group.local_learner.device == dev,
                  "rl_remote: PPO's learner is not on the card")
            weights = algo.learner_group.get_weights()
            for i, runner in enumerate(algo.runners):
                local = SingleAgentEnvRunner(
                    env_creator=CartPole, module_spec=algo.spec,
                    num_envs=REMOTE_ENVS, rollout_len=REMOTE_FRAGMENT,
                    seed=SEED + i, device="cpu")
                local.set_weights(weights)
                ray_tpu_torch.get(runner.set_weights.remote(weights))
                cols, _m, _d = ray_tpu_torch.get(runner.sample.remote())
                want = local.sample()
                for key in want:
                    check(np.array_equal(cols[key], want[key]),
                          f"rl_remote: runner {i}'s {key} differs from a "
                          "local CPU runner's")
            rows, ms = _timed_train(algo, REMOTE_ITERS)
            for r in rows:
                check(r["num_env_steps_sampled"]
                      == REMOTE_RUNNERS * REMOTE_ENVS * REMOTE_FRAGMENT,
                      f"rl_remote: sampled {r['num_env_steps_sampled']}")
                check(math.isfinite(r["total_loss"]),
                      f"rl_remote: PPO loss {r['total_loss']}")
            out["ppo"] = dict(
                train_ms=ms, env_steps_per_sec=[r["env_steps_per_sec"]
                                                for r in rows],
                return_curve=[r["episode_return_mean"] for r in rows])
        finally:
            algo.stop()

        # the learner group: 2 actors on half the card each
        spec = RLModuleSpec(Box(-np.full(4, 2.0, np.float32),
                                np.full(4, 2.0, np.float32)), Discrete(2),
                            (64, 64))
        kw = dict(lr=1e-3, grad_clip=0.5, seed=SEED)
        t0 = time.perf_counter()
        group = LearnerGroup(PPOLearner, num_learners=2, module_spec=spec,
                             device=dev, **kw)
        start_s = time.perf_counter() - t0
        try:
            local = PPOLearner(spec, device=dev, **kw)
            group.set_state({"params": {k: v.cpu() for k, v in
                                        local.module.state_dict().items()},
                             "opt_state": local.optimizer.state_dict()})
            batches = [group_batch(GROUP_ROWS, s)
                       for s in range(GROUP_UPDATES)]
            update_ms = []
            for b in batches:
                t0 = time.perf_counter()
                group.update(b)
                update_ms.append((time.perf_counter() - t0) * 1e3)
            ddp_in_process(local, batches, 2)
            w0, w1 = ray_tpu_torch.get(
                [a.get_weights.remote() for a in group._actors])
            want = local.get_weights()
            err = 0.0
            for a, b, c in zip(_flat_leaves(w0), _flat_leaves(w1),
                               _flat_leaves(want)):
                check(np.array_equal(a, b),
                      "rl_remote: the learner actors' weights differ")
                err = max(err, float(np.abs(a - c).max()))
            check(err <= GROUP_ATOL,
                  f"rl_remote: learner group vs this process {err}")
        finally:
            group.shutdown()
        out["learner_group"] = dict(
            actors=2, num_gpus_each=0.5, start_s=start_s,
            update_ms=update_ms, rows=GROUP_ROWS, tolerance=GROUP_ATOL,
            max_abs_err=err)

        # APPO and IMPALA over 2 remote runners, the learner on the card
        for name, config in (("appo", APPOConfig), ("impala", IMPALAConfig)):
            t0 = time.perf_counter()
            algo = (config().environment("CartPole-v1")
                    .env_runners(num_env_runners=REMOTE_RUNNERS,
                                 num_envs_per_env_runner=REMOTE_ENVS,
                                 rollout_fragment_length=REMOTE_FRAGMENT)
                    .debugging(seed=SEED).build_algo(device=dev))
            start = time.perf_counter() - t0
            try:
                rows, ms = _timed_train(algo, ASYNC_ITERS)
            finally:
                algo.stop()
            last = rows[-1]
            check(sum(r["fragments_consumed"] for r in rows) >= 1
                  and last["fragments_in_flight"] >= 1,
                  f"rl_remote: {name} fragments {last}")
            check(math.isfinite(last["total_loss"]),
                  f"rl_remote: {name} loss {last['total_loss']}")
            if name == "impala":
                check(math.isfinite(last.get("mean_rho", float("nan"))),
                      f"rl_remote: IMPALA has no mean_rho {last}")
            out[name] = dict(
                start_s=start, train_ms=ms,
                fragments_consumed=[r["fragments_consumed"] for r in rows],
                fragments_in_flight=[r["fragments_in_flight"] for r in rows],
                total_loss=[r["total_loss"] for r in rows],
                mean_rho=[r.get("mean_rho") for r in rows])
    finally:
        _stop_runtime()
    return out


class BanditEnv:
    """tests/test_podracer.py's bandit: action 0 pays +1, action 1
    pays -1, 8 steps an episode."""

    _LEN = 8

    def __init__(self):
        import numpy as np
        from ray_tpu_torch.rl.spaces import Box, Discrete
        self.observation_space = Box(-np.ones(3, np.float32),
                                     np.ones(3, np.float32))
        self.action_space = Discrete(2)
        self._t = 0

    def reset(self, *, seed=None):
        import numpy as np
        self._t = 0
        return np.ones(3, np.float32), {}

    def step(self, action):
        import numpy as np
        self._t += 1
        reward = 1.0 if int(action) == 0 else -1.0
        return (np.ones(3, np.float32), reward, self._t >= self._LEN,
                False, {})


def rl_sebulba(dev, card):
    """Sebulba's bandit scenario (tests/test_podracer.py:235-295) with
    its learner actor and one inference replica sharing the card."""
    import numpy as np
    from ray_tpu_torch.rl.podracer import Sebulba, SebulbaConfig
    from ray_tpu_torch.util import flight_recorder as tfr
    _runtime(flight_recorder_enabled=True, flight_flush_interval_s=0.05)
    try:
        cfg = SebulbaConfig(
            env_creator=BanditEnv, num_actors=2, num_envs_per_actor=2,
            rollout_len=8, hidden=(16,), lr=3e-2, entropy_coeff=0.0,
            fragments_per_step=2, weight_push_interval=1,
            max_staleness=50, seed=SEED)
        t0 = time.perf_counter()
        s = Sebulba(cfg, device=dev)
        start_s = time.perf_counter() - t0
        try:
            run = s.train(SEBULBA_UPDATES, step_timeout_s=60.0)
            want = {"rollout", "infer_batch", "replay_wait", "learn_step",
                    "weight_push"}
            deadline = time.monotonic() + 10.0
            while True:
                spans = {}
                for events in tfr.merged_journals().values():
                    for ev in events:
                        if ev[3] == "rl":
                            spans.setdefault(ev[4], []).append(ev[2] / 1e6)
                if want <= set(spans) or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            s.shutdown()
    finally:
        _stop_runtime()
    learner = run["learner"]
    check(learner["num_updates"] == SEBULBA_UPDATES,
          f"rl_sebulba: {learner['num_updates']} updates")
    check(learner["weight_pushes"] >= 2 and learner["push_failures"] == 0,
          f"rl_sebulba: pushes {learner['weight_pushes']}, failures "
          f"{learner['push_failures']}")
    for actor_id, versions in run["versions_by_actor"].items():
        check(versions == sorted(versions),
              f"rl_sebulba: actor {actor_id}'s versions went backwards")
    check(run["replay"]["depth"] <= cfg.replay_capacity,
          f"rl_sebulba: replay depth {run['replay']}")
    check(learner["version_lag_max"] <= cfg.max_staleness,
          f"rl_sebulba: version lag {learner['version_lag_max']}")
    returns = run["episode_returns"]
    third = max(len(returns) // 3, 1)
    first, last = np.mean(returns[:third]), np.mean(returns[-third:])
    check(last > first, f"rl_sebulba: returns {first} -> {last}")
    check(want <= set(spans), f"rl_sebulba: spans {sorted(spans)}")
    return dict(
        card=card, start_s=start_s, updates=learner["num_updates"],
        weight_pushes=learner["weight_pushes"],
        push_failures=learner["push_failures"],
        infer_batch_ms=float(np.median(spans["infer_batch"])),
        weight_push_ms=float(np.median(spans["weight_push"])),
        learn_step_ms=float(np.median(spans["learn_step"])),
        first_learn_step_ms=learner["learn_step_ms"][0],
        env_steps_per_sec=run["env_steps_per_sec"],
        mean_batch_rows=run["mean_batch_rows"],
        version_lag_max=learner["version_lag_max"],
        replay=run["replay"], return_first_third=float(first),
        return_last_third=float(last), spans={k: len(v) for k, v in
                                              spans.items()})


def run_rl(dev, card):
    """The RL phases; none may launch K1-K5."""
    for name, fn, args in (("rl_vs_cpu", rl_vs_cpu, (dev,)),
                           ("rl_anakin", rl_anakin, (dev, card)),
                           ("rl_ppo", rl_ppo, (dev,)),
                           ("rl_offpolicy_vs_cpu", rl_offpolicy_vs_cpu,
                            (dev, card)),
                           ("rl_offpolicy", rl_offpolicy, (dev, card)),
                           ("rl_dreamer_vs_cpu", rl_dreamer_vs_cpu,
                            (dev, card)),
                           ("rl_dreamer", rl_dreamer, (dev, card)),
                           ("rl_multi_agent", rl_multi_agent, (dev, card)),
                           ("rl_remote", rl_remote, (dev, card)),
                           ("rl_sebulba", rl_sebulba, (dev, card))):
        counts = run_phase(name, (), fn, *args)
        check(not any(counts.values()),
              f"{name} launched a kernel of K1-K5: {counts}")


# ---------------------------------------------------------------------------
# phase 10: ViT, CLIP and DiT through K1-K3 without the causal mask, and
# the Llama MoE branch at Mixtral width through the engine
# ---------------------------------------------------------------------------

# (batch, seq, heads, causal) of the vision models' attention, head_dim
# 64 and H = KVH: ViT-B/16 at 224^2 with its class token, DiT-B/2 on
# 32 x 32 x 4 latents, CLIP's text tower
VISION_ATTENTION = ((64, 197, 12, False), (32, 256, 12, False),
                    (32, 77, 8, True))
# (batch, seq, heads, KV heads, causal) at DiT-XL/2's head_dim 72, each
# K1, K2 and K3: 256^2 images (S 256, the headline), 512^2 (S 1024), a
# ragged S full and causal, and a GQA group of 4 (no DiT config has one:
# it covers the kernels' GQA paths at this head_dim)
DIT_XL_HEAD_DIM = 72
DIT_XL_ATTENTION = ((32, 256, 16, 16, False), (8, 1024, 16, 16, False),
                    (4, 197, 16, 16, False), (4, 197, 16, 16, True),
                    (4, 256, 16, 4, False), (4, 197, 16, 4, True))
VISION_STEPS = 3
VS_CPU_BATCH = 4
DIT_SAMPLES, DIT_SAMPLE_STEPS, DIT_GUIDANCE = 8, 10, 1.5
ADALN_STD = 0.02
# Mixtral-8x7B cut from 32 layers to 8: the whole model is ~93 GB in
# bf16, more than the card's 80 GB
MIXTRAL_LAYERS = 8
MOE_VS_CPU_TOKENS = 64


def check_vision_attention(dev, gen):
    """K1 at every vision shape and K2/K3 at the non-causal ones, each
    against its plain version and timed beside SDPA."""
    rows = {"flash_attention": [], "flash_attention_bwd_dq": [],
            "flash_attention_bwd_dkv": [], "backward": []}
    for b, s, h, causal in VISION_ATTENTION:
        rows["flash_attention"].append(
            flash_forward_row(dev, gen, b, s, h, h, 64, causal))
        if not causal:
            flash_backward_rows(dev, gen, b, s, h, h, 64, causal, rows)
    return rows


def check_dit_xl_attention(dev, gen):
    """K1, K2 and K3 at head_dim 72 (DIT_XL_ATTENTION), each against its
    plain version with the head_dim 64 rows' tolerances and timed beside
    SDPA."""
    rows = {"flash_attention": [], "flash_attention_bwd_dq": [],
            "flash_attention_bwd_dkv": [], "backward": []}
    for b, s, h, kvh, causal in DIT_XL_ATTENTION:
        rows["flash_attention"].append(flash_forward_row(
            dev, gen, b, s, h, kvh, DIT_XL_HEAD_DIM, causal))
        flash_backward_rows(dev, gen, b, s, h, kvh, DIT_XL_HEAD_DIM, causal,
                            rows)
    return rows


def expected_encoder_counts(n_layers: int):
    """Launches of one training step of ``n_layers`` remat'd encoder
    blocks: K1 in the forward and again in each block's recompute,
    K2/K3 once a layer. LayerNorm has no kernel; there is no int8 path."""
    return {"flash_attention": 2 * n_layers,
            "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers,
            "rms_norm": 0, "int8_matmul": 0}


def add_counts(total, counts):
    if total is None:
        return dict(counts)
    return {k: total[k] + counts[k] for k in total}


def train_steps(name, step, leaves, n_layers: int):
    """A warm-up and VISION_STEPS timed steps, each ended by
    ``loss.item()`` with its launch counts zeroed before and read after:
    each step launches exactly ``expected_encoder_counts``, the first
    leaves a finite grad on every leaf, and the loss is finite and falls.
    -> (fields, launches summed over the steps, timed ms per step)."""
    import torch
    want = expected_encoder_counts(n_layers)
    losses, step_ms, counts = [], [], None
    for i in range(1 + VISION_STEPS):
        reset_counts()
        t0 = time.perf_counter()
        losses.append(step().item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_counts = read_counts()
        check(step_counts == want,
              f"{name} step {i} launches {step_counts} != {want}")
        counts = add_counts(counts, step_counts)
        if i == 0:
            check(all(t.grad is not None
                      and bool(torch.isfinite(t.grad).all())
                      for t in leaves),
                  f"{name}: a leaf got no grad, or a non-finite one")
    check(all(math.isfinite(x) for x in losses),
          f"{name}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
    timed = sum(step_ms[1:]) / VISION_STEPS
    return dict(losses=losses, step_ms=step_ms, timed_step_ms=timed,
                launches_per_step=want), counts, timed


def vision_train(dev, shared):
    """ViT-B/16 (224^2, class token, 1000 classes, bf16, remat) training
    on one seeded batch (``bench_train.setup_vision``)."""
    import torch
    from ray_tpu_torch.scripts import bench_train as bt
    t0 = time.perf_counter()
    cfg, params, step = bt.setup_vision("vit", dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    fields, counts, timed = train_steps("vision_train", step,
                                        bt.parameters(params), cfg.n_layers)
    batch = bt.VISION_BATCH["vit"]
    return dict(model="ViT-B/16", batch=batch, seq=cfg.seq_len,
                n_layers=cfg.n_layers, params=cfg.num_params(),
                init_s=init_s, images_per_s=batch / (timed / 1e3),
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                **fields), counts


def clip_step(dev, shared):
    """CLIP (ViT-B/16 image tower, 12-layer 512-wide causal text tower at
    S 77) at ``setup_vision("clip")``'s batch (32): both embeddings, then
    one loss-and-grad step and one AdamW update. Every K1 launch's mask
    is recorded: the image tower's run non-causal, the text tower's
    causal."""
    import torch
    from ray_tpu_torch.models import clip_encode_image, clip_encode_text
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.scripts import bench_train as bt
    cfg, params, step = bt.setup_vision("clip", dev)
    images, tokens = step.batch["images"], step.batch["tokens"]
    masks = []
    flash_forward = att._flash_forward

    def spy(q, k, v, causal):
        masks.append(causal)
        return flash_forward(q, k, v, causal)

    att._flash_forward = spy
    try:
        reset_counts()
        with torch.no_grad():
            img = clip_encode_image(params, images, cfg)
            txt = clip_encode_text(params, tokens, cfg)
        encode_counts = read_counts()
        leaves = bt.parameters(params)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        loss = step().item()
        step_ms = (time.perf_counter() - t0) * 1e3
        step_counts = read_counts()
    finally:
        att._flash_forward = flash_forward
    lv, lt = cfg.vision.n_layers, cfg.text.n_layers
    norms = [torch.linalg.vector_norm(e, dim=-1) for e in (img, txt)]
    worst = max((n - 1).abs().max().item() for n in norms)
    check(worst <= 1e-5, f"clip_step: embedding norm off 1 by {worst}")
    check(math.isfinite(loss), f"clip_step: loss {loss}")
    check(all(t.grad is not None and bool(torch.isfinite(t.grad).all())
              for t in leaves), "clip_step: a leaf got no grad, or a "
          "non-finite one")
    check(encode_counts == dict(expected_encoder_counts(0),
                                flash_attention=lv + lt),
          f"clip_step: encode launches {encode_counts}")
    want = expected_encoder_counts(lv + lt)
    check(step_counts == want, f"clip_step: step launches {step_counts} "
          f"!= {want}")
    # the image tower non-causal, the text tower causal, in both passes
    check(masks.count(False) == 3 * lv and masks.count(True) == 3 * lt,
          f"clip_step: K1 masks {masks.count(False)} non-causal, "
          f"{masks.count(True)} causal")
    return dict(batch=bt.VISION_BATCH["clip"],
                text_seq=cfg.text.max_seq_len,
                loss=loss, step_ms=step_ms, worst_norm_err=worst,
                k1_noncausal=masks.count(False), k1_causal=masks.count(True),
                launches_per_step=step_counts,
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9), \
        add_counts(encode_counts, step_counts)


DIT_MODELS = {"dit": "DiT-B/2", "dit_xl": "DiT-XL/2"}


def dit_train(dev, shared, model="dit"):
    """DiT-B/2 (``model="dit"``, head_dim 64) or DiT-XL/2
    (``"dit_xl"``, head_dim 72, 28 layers), 1000 classes, 32 x 32 x 4
    latents, bf16, remat, attention="flash": training from its adaLN-Zero
    init on one seeded batch, with one set of draws (t, eps, label drop)
    for every step (``bench_train.setup_vision``)."""
    import torch
    from ray_tpu_torch.scripts import bench_train as bt
    name = f"{model}_train"
    t0 = time.perf_counter()
    cfg, params, step = bt.setup_vision(model, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(cfg.attention == "flash", f"{name}: attention {cfg.attention}")
    torch.cuda.reset_peak_memory_stats(dev)
    leaves = bt.parameters(params)
    fields, counts, timed = train_steps(name, step, leaves, cfg.n_layers)
    for t in leaves:
        t.requires_grad_(False)
    shared[model] = (cfg, params)
    batch = bt.VISION_BATCH[model]
    return dict(model=DIT_MODELS[model], batch=batch, seq=cfg.n_patches,
                n_layers=cfg.n_layers, head_dim=cfg.head_dim,
                params=sum(t.numel() for t in leaves), init_s=init_s,
                samples_per_s=batch / (timed / 1e3),
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                **fields), counts


def dit_sample_phase(dev, shared, model="dit"):
    """DDIM sampling of DIT_SAMPLES latents over DIT_SAMPLE_STEPS steps
    with classifier-free guidance (two forwards a step) from the weights
    the training phase of ``model`` left."""
    import torch
    from ray_tpu_torch.models import dit_sample, draw_dit_noise
    cfg, params = shared.pop(model)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    noise = draw_dit_noise(gen, (DIT_SAMPLES, cfg.input_size,
                                 cfg.input_size, cfg.channels), dev)
    labels = torch.arange(DIT_SAMPLES, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dit_sample(params, noise, cfg, DIT_SAMPLES, DIT_SAMPLE_STEPS,
                     labels=labels, guidance_scale=DIT_GUIDANCE)
    biggest = out.abs().max().item()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check(tuple(out.shape) == tuple(noise["eps"].shape)
          and bool(torch.isfinite(out).all()), f"{model} sample: non-finite "
          f"or misshapen samples {tuple(out.shape)}")
    want = dict(expected_encoder_counts(0),
                flash_attention=2 * cfg.n_layers * DIT_SAMPLE_STEPS)
    check(counts == want, f"{model} sample launches {counts} != {want}")
    return dict(model=DIT_MODELS[model], n=DIT_SAMPLES,
                steps=DIT_SAMPLE_STEPS,
                guidance_scale=DIT_GUIDANCE, max_abs=biggest,
                step_ms=seconds / DIT_SAMPLE_STEPS * 1e3,
                samples_per_s=DIT_SAMPLES / seconds), counts


def vision_vs_cpu(dev, shared):
    """2-layer full-width ViT-B/16, DiT-B/2 and DiT-XL/2 (random adaLN
    leaves; DiT-XL/2 at head_dim 72), loss and grads at batch
    VS_CPU_BATCH: bf16 on the card through K1-K3 against the plain f32
    version on the CPU from the same weights and draws, with
    train_vs_cpu's bars (loss 1e-2, grads 1e-1 relative L2)."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import (
        DiTConfig, ViTConfig, dit_init, dit_loss, draw_dit_noise,
        unstack_layers, vit_init, vit_loss)
    from ray_tpu_torch.scripts.bench_train import parameters, random_adaln
    rng = np.random.default_rng(SEED)
    vit = ViTConfig.base(n_classes=1000, pool="cls", n_layers=2)
    images = torch.from_numpy(rng.standard_normal(
        (VS_CPU_BATCH, vit.image_size, vit.image_size, vit.channels)
    ).astype(np.float32))
    vit_labels = torch.from_numpy(rng.integers(0, 1000, VS_CPU_BATCH))
    dit = DiTConfig.b_2(n_classes=1000, n_layers=2)
    dit_xl = DiTConfig.xl_2(n_classes=1000, n_layers=2)
    shape = (VS_CPU_BATCH, dit.input_size, dit.input_size, dit.channels)
    x0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dit_labels = torch.from_numpy(rng.integers(0, 1000, VS_CPU_BATCH))
    gen = torch.Generator()
    gen.manual_seed(SEED + 5)
    noise = draw_dit_noise(gen, shape, "cpu")

    def dit_loss_fn(p, c, d):
        return dit_loss(p, {k: t.to(d) for k, t in noise.items()},
                        x0.to(d), c, dit_labels.to(d))

    def dit_params(cfg):
        return unstack_layers(random_adaln(dit_init(
            SEED, dataclasses.replace(cfg, dtype=torch.float32), "cpu"),
            ADALN_STD, SEED + 6))

    dit_top = ("patch_embed", "time_w1", "label_embed", "final_w")
    dit_stacked = ("wq", "w2", "mod_w")
    models = {
        "vit": (vit, unstack_layers(vit_init(
            SEED, dataclasses.replace(vit, dtype=torch.float32), "cpu")),
            lambda p, c, d: vit_loss(p, images.to(d), vit_labels.to(d), c),
            ("patch_embed", "pos_embed", "head_w"), ("wq", "wv", "w1",
                                                     "w2")),
        "dit": (dit, dit_params(dit), dit_loss_fn, dit_top, dit_stacked),
        "dit_xl": (dit_xl, dit_params(dit_xl), dit_loss_fn, dit_top,
                   ("wq", "wk", "wv", "wo", "w2", "mod_w")),
    }
    out, total = {}, None
    for name, (cfg, params_cpu, loss_fn, top, stacked) in models.items():
        check(cfg.attention == "flash", f"{name}: attention {cfg.attention}")
        def loss_and_grads(params, c, device):
            for t in parameters(params):
                t.requires_grad_(True)
            loss = loss_fn(params, c, device)
            loss.backward()
            grads = {k: params[k].grad for k in top}
            grads.update({k: torch.stack([lp[k].grad for lp in
                                          params["layers"]])
                          for k in stacked})
            return loss.item(), {k: g.float().cpu() for k, g in
                                 grads.items()}

        params_gpu = to_card(params_cpu, dev, torch.bfloat16)
        reset_counts()
        loss_gpu, grads_gpu = loss_and_grads(params_gpu, cfg, dev)
        counts = read_counts()
        want = expected_encoder_counts(cfg.n_layers)
        check(counts == want, f"{name} card loss+grad launches {counts} "
              f"!= {want}")
        cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
        loss_cpu, grads_cpu = loss_and_grads(params_cpu, cpu_cfg, "cpu")
        rel_loss = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        check(rel_loss <= 1e-2,
              f"{name} card vs CPU loss {loss_gpu} vs {loss_cpu}")
        rel_grads = {}
        for k, g in grads_gpu.items():
            c = grads_cpu[k]
            check(bool(torch.isfinite(g).all()), f"{name} grad {k} "
                  "non-finite")
            rel_grads[k] = (torch.linalg.vector_norm(g - c)
                            / torch.linalg.vector_norm(c)).item()
            check(rel_grads[k] <= 1e-1, f"{name} card vs CPU grad {k} "
                  f"relative L2 {rel_grads[k]} > 1e-1")
        out[name] = dict(loss_card=loss_gpu, loss_cpu=loss_cpu,
                         rel_loss=rel_loss, rel_l2_grads=rel_grads)
        total = add_counts(total, counts)
        del params_gpu
        free()
    return out, total


def engine_moe(dev, shared):
    """The engine at Mixtral-8x7B width, MIXTRAL_LAYERS of its 32 layers,
    bf16 random weights from the seed, on the PROMPT_LENS prompts; then a
    1-layer Mixtral-width prefill on the card against the plain f32
    version on the CPU (top-k sets and the output where they agree); then
    LlamaConfig.tiny_moe() in f32 on the card and the CPU, whose routing
    and greedy streams must be equal (dense and chunked prefill)."""
    import numpy as np
    import torch
    from ray_tpu_torch.llm import ContinuousBatchingEngine, EngineConfig
    from ray_tpu_torch.models import LlamaConfig, llama_init, llama_prefill
    from ray_tpu_torch.parallel import moe
    cfg = LlamaConfig.mixtral_8x7b(n_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = llama_init(SEED, cfg, dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in
                     [*params["layers"].values(), params["embedding"],
                      params["lm_head"]]) / 1e9
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    torch.cuda.reset_peak_memory_stats(dev)
    fields, counts, _outs = run_engine(dev, None, prompts, params, cfg)
    check(counts["flash_attention"] > 0 and counts["rms_norm"] > 0,
          f"engine_moe did not launch K1/K4: {counts}")
    del params
    free()

    routes = []
    top_k_gating = moe.top_k_gating

    def spy(x, router, k):
        got = top_k_gating(x, router, k)
        routes.append(got[1])
        return got

    one = dataclasses.replace(cfg, n_layers=1)
    one_f32 = dataclasses.replace(one, dtype=torch.float32)
    params_f32 = llama_init(SEED + 1, one_f32, dev)  # drawn on the card
    params_cpu = to_card(params_f32, "cpu", torch.float32)
    params_gpu = to_card(params_f32, dev, torch.bfloat16)
    del params_f32
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, MOE_VS_CPU_TOKENS)))
    moe.top_k_gating = spy
    try:
        reset_counts()
        logits_gpu, _, _ = llama_prefill(params_gpu, tokens.to(dev), one)
        one_counts = read_counts()
        logits_cpu, _, _ = llama_prefill(params_cpu, tokens, one_f32)
    finally:
        moe.top_k_gating = top_k_gating
    del params_gpu, params_cpu
    free()
    check(one_counts["flash_attention"] == 1
          and one_counts["rms_norm"] == 3, f"1-layer prefill launches "
          f"{one_counts}")
    sets_gpu = routes[0].cpu().sort(-1).values
    sets_cpu = routes[1].sort(-1).values
    same = (sets_gpu == sets_cpu).all(-1)
    agree = same.float().mean().item()
    check(agree >= 0.9, f"top-k sets agree on {agree} of the tokens < 0.9")
    g = logits_gpu[0][same].float().cpu()
    c = logits_cpu[0][same]
    rel = (torch.linalg.vector_norm(g - c)
           / torch.linalg.vector_norm(c)).item()
    check(bool(torch.isfinite(logits_gpu).all()), "non-finite logits")
    check(rel <= 5e-2, f"card vs CPU relative L2 {rel} > 5e-2 on the "
          "tokens routed alike")

    tiny = LlamaConfig.tiny_moe()
    tiny_cpu = llama_init(SEED, tiny, device="cpu")
    tiny_card = to_card(tiny_cpu, dev, torch.float32)
    prompts_tiny = [[1, 5, 9, 13], [2, 4, 6], list(range(30, 50))]
    streams = {}
    for kw in ({}, dict(chunked_prefill_tokens=8)):
        for where, tree in (("card", tiny_card), ("cpu", tiny_cpu)):
            engine = ContinuousBatchingEngine(
                EngineConfig(model=tiny, max_batch=4, max_seq=64,
                             seed=SEED, **kw), params=tree,
                device=dev if where == "card" else "cpu")
            streams[(str(kw), where)] = engine.generate(prompts_tiny,
                                                        max_tokens=16)
        check(streams[(str(kw), "card")] == streams[(str(kw), "cpu")],
              f"tiny_moe f32 {kw}: the card's streams differ from the CPU's")
    routes.clear()
    moe.top_k_gating = spy
    try:
        ids = torch.tensor([list(range(40, 72))])
        llama_prefill(tiny_card, ids.to(dev), tiny)
        llama_prefill(tiny_cpu, ids, tiny)
    finally:
        moe.top_k_gating = top_k_gating
    n = tiny.n_layers
    check(len(routes) == 2 * n and all(
        torch.equal(a.cpu(), b) for a, b in zip(routes[:n], routes[n:])),
        "tiny_moe f32: the card's routing differs from the CPU's")
    # since the reset before the 1-layer prefill
    rest_counts = read_counts()
    fields.update(
        model=f"Mixtral-8x7B width, {MIXTRAL_LAYERS} of 32 layers",
        weights_s=weights_s, weights_gb=weights_gb,
        vs_cpu=dict(tokens=MOE_VS_CPU_TOKENS, topk_sets_agree=agree,
                    rel_l2_where_routed_alike=rel, launches=one_counts),
        tiny_moe_streams_equal=True,
        engine_peak_mem_gb=fields.pop("peak_mem_gb"),
        engine_launches=fields.pop("launches"))
    return fields, add_counts(counts, rest_counts)


def run_models(dev):
    """Phase 10; every phase zeroes the launch counts before it runs and
    reads them after -> the launches summed over the phases."""
    shared, total = {}, None
    for name, fn in (("vision_train", vision_train),
                     ("clip_step", clip_step), ("dit_train", dit_train),
                     ("dit_sample", dit_sample_phase),
                     ("dit_xl_train", functools.partial(dit_train,
                                                        model="dit_xl")),
                     ("dit_xl_sample", functools.partial(
                         dit_sample_phase, model="dit_xl")),
                     ("vision_vs_cpu", vision_vs_cpu),
                     ("engine_moe", engine_moe)):
        t0 = time.perf_counter()
        fields, counts = fn(dev, shared)
        free()
        emit(name, seconds=time.perf_counter() - t0, launches=counts,
             **fields)
        total = add_counts(total, counts)
    return total


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
    vision_checks = check_vision_attention(dev, gen)
    dit_xl_checks = check_dit_xl_attention(dev, gen)
    t0 = time.perf_counter()
    seq_fields, counts_seq = seq_parallel(dev, gen)
    emit("seq_parallel", seconds=time.perf_counter() - t0,
         launches=counts_seq, **seq_fields)
    free()
    t0 = time.perf_counter()
    shard_fields, counts_sharded = sharded(dev)
    emit("sharded", seconds=time.perf_counter() - t0,
         launches=counts_sharded, **shard_fields)
    free()
    t0 = time.perf_counter()
    vision_fields, counts_vision = sharded_vision(dev)
    emit("sharded_vision", seconds=time.perf_counter() - t0,
         launches=counts_vision, **vision_fields)
    free()
    t0 = time.perf_counter()
    sync_fields, counts_sync = grad_sync(dev)
    emit("grad_sync", seconds=time.perf_counter() - t0,
         launches=counts_sync, **sync_fields)
    free()

    rng = __import__("numpy").random.default_rng(SEED)
    # printable ASCII after the byte tokenizer's BOS: the engine phases
    # take these ids, the Serve phases the same prompts as text
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    texts = [bytes(rng.integers(32, 127, n - 1).tolist()).decode("ascii")
             for n in PROMPT_LENS]
    prompts = [ByteTokenizer().encode(t) for t in texts]
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
                                   outs_int8, smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    counts_serve = run_serve(dev, smi, texts, prompts, outs_bf16)

    prefill_vs_cpu = end_to_end_vs_cpu(dev)
    emit("end_to_end_vs_cpu", **prefill_vs_cpu)

    train, counts_train = run_train(dev)
    emit("train", **train)
    grads_vs_cpu = train_vs_cpu(dev)
    emit("train_vs_cpu", **grads_vs_cpu)
    t0 = time.perf_counter()
    ckpt, counts_ckpt = train_checkpoint(dev)
    emit("train_checkpoint", seconds=time.perf_counter() - t0,
         launches=counts_ckpt, **ckpt)
    run_rl(dev, smi)
    counts_models = run_models(dev)
    free()
    t0 = time.perf_counter()
    trainer_fields, counts_trainer = trainer(dev)
    emit("trainer", seconds=time.perf_counter() - t0, card=smi,
         **trainer_fields)
    free()
    t0 = time.perf_counter()
    pipe_fields, counts_pipe = mpmd_pipeline(dev, smi)
    emit("mpmd_pipeline", seconds=time.perf_counter() - t0, **pipe_fields)
    free()

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
        shapes = (checks[kname] + vision_checks.get(kname, [])
                  + dit_xl_checks.get(kname, []))
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=(counts_bf16[kname] + counts_int8[kname]
                      + counts_features[kname] + counts_train[kname]
                      + prefill_vs_cpu["launches"][kname]
                      + grads_vs_cpu["launches"][kname]
                      + counts_ckpt[kname] + counts_models[kname]
                      + counts_seq[kname] + counts_sharded[kname]
                      + counts_vision[kname] + counts_sync[kname]
                      + counts_trainer[kname] + counts_pipe[kname]
                      + counts_serve[kname]),
            max_abs_err=max(r["max_abs_err"] for r in shapes),
            ms=row["ms"], call_ms=row["call_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"],
            shapes=shapes))
    # the whole backward as the model calls it, beside K2's row (whose
    # library_ms is SDPA's whole backward)
    kernels[1]["whole_backward"] = (checks["backward"]
                                    + vision_checks["backward"]
                                    + dit_xl_checks["backward"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
