"""Where the serving engine's time goes on the GPU.

    python -m ray_tpu_torch.scripts.profile_engine [--quantization int8]

Builds the ``ContinuousBatchingEngine`` at full Llama-3-8B width and
depth (random weights from seed 0, max_batch 8, max_seq 2048) and
measures two windows, each first on the host clock with no profiler and
then once under ``torch.profiler``:

- prefill: the four prompts of chip_smoke.py (17, 100, 300 and 700
  tokens) submitted at once and admitted by one step, as chip_smoke.py
  does; each request's time to first token (TTFT), the median of
  PREFILL_REPS admissions after a warm-up one;
- decode: decode steps with those four requests active.

Prints one JSON line per window with its host-clock times, the device
time (sum of kernel times), the device's idle share, kernel launches
and the kernels that take the most device time. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import time

STEPS = 10        # decode steps per window
PREFILL_REPS = 5  # timed admissions of the four prompts
TOP_KERNELS = 12  # kernels listed per window
PROMPT_LENS = (17, 100, 300, 700)


def _device_rows(prof):
    """(device us, name, count) of every kernel in the window. GPU user
    annotations (``Optimizer.step#...``) are ranges over kernels, not
    kernels, and would count their time twice."""
    import torch
    return [(evt.self_device_time_total, evt.key, evt.count)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)]


def _kernel_table(prof, steps: int, top: int):
    rows = sorted(_device_rows(prof), reverse=True)
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[2] for r in rows)
    table = [{"kernel": name[:80], "ms_per_step": t / steps / 1e3,
              "calls_per_step": n / steps} for t, name, n in rows[:top]]
    return busy_us / steps / 1e3, launches / steps, table


class _FirstToken:
    """A stream queue that keeps the time of the first token pushed."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.ttft = None

    def put_nowait(self, item) -> None:
        if self.ttft is None and item is not None:
            self.ttft = time.perf_counter() - self.t_start


def _admit_all(engine, prompts, request_cls):
    """Submits every prompt at once (one token each) and admits them in
    one step -> each request's TTFT in s."""
    import torch
    t0 = time.perf_counter()
    clocks = [_FirstToken(t0) for _ in prompts]
    for p, clock in zip(prompts, clocks):
        engine.add_request(request_cls(prompt_ids=p, max_tokens=1,
                                       stream_queue=clock))
    engine.step()
    torch.cuda.synchronize()
    return [clock.ttft for clock in clocks]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quantization", default=None, choices=[None, "int8"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.llm import (
        ContinuousBatchingEngine, EngineConfig, GenerationRequest)
    from ray_tpu_torch.models import LlamaConfig

    if not torch.cuda.is_available():
        raise SystemExit("profile_engine needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    engine = ContinuousBatchingEngine(
        EngineConfig(model=LlamaConfig.llama3_8b(), max_batch=8,
                     max_seq=2048, seed=0,
                     quantization=args.quantization), device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128256, n).tolist() for n in PROMPT_LENS]

    _admit_all(engine, prompts, GenerationRequest)  # warm-up (and build)
    reps = [_admit_all(engine, prompts, GenerationRequest)
            for _ in range(PREFILL_REPS)]
    ttft = [sorted(r[i] for r in reps)[PREFILL_REPS // 2]
            for i in range(len(prompts))]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ttft_profiled = _admit_all(engine, prompts, GenerationRequest)
    busy_ms, launches, table = _kernel_table(prof, 1, TOP_KERNELS)
    print(json.dumps({
        "window": "prefill", "quantization": args.quantization,
        "device": torch.cuda.get_device_name(0), "prompt_lens": PROMPT_LENS,
        "ttft_s": ttft, "ttft_s_reps": reps,
        "ttft_s_profiled": ttft_profiled,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (ttft_profiled[-1] * 1e3),
        "launches": launches, "top_kernels": table}), flush=True)

    for p in prompts:
        engine.add_request(GenerationRequest(prompt_ids=p,
                                             max_tokens=4 * STEPS + 8))
    engine.step()  # admission: four blocking prefills and one decode
    engine.step()  # warm decode
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(STEPS):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            engine.step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) / STEPS * 1e3
    busy_ms, launches, table = _kernel_table(prof, STEPS, TOP_KERNELS)
    print(json.dumps({
        "window": "decode", "quantization": args.quantization,
        "device": torch.cuda.get_device_name(0), "batch": 4,
        "step_ms": step_ms, "step_ms_profiled": profiled_ms,
        "device_busy_ms_per_step": busy_ms,
        # unclipped: below 0 means the kernel sum counts something twice
        "device_idle_share": 1.0 - busy_ms / profiled_ms,
        "launches_per_step": launches, "top_kernels": table}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
