"""Where a training step's time goes on the GPU.

    python -m ray_tpu_torch.scripts.profile_train [--model M] [--trace PATH]

``--model llama`` (the default): the configuration and step of
``bench_train`` (Llama-3-8B at full width and depth, random weights
from seed 0, 1 x 2048, remat, CE chunk 1024; loss, backward, fused
AdamW). ``--model vit`` / ``dit`` / ``dit_xl``:
``bench_train.setup_vision``'s ViT-B/16 at batch 64, DiT-B/2 or
DiT-XL/2 at batch 32 (bf16, remat, the same AdamW), which
``chip_smoke.py``'s ``vision_train``, ``dit_train`` and ``dit_xl_train``
also run. After one warm-up step it
times ``STEPS``
steps on the host clock with no profiler, then one window of ``STEPS``
steps under ``torch.profiler``. Prints one JSON line: step ms, device
busy ms per step (the sum of kernel times), the device's idle share in
the profiled window and busy time over the unprofiled step, launches
per step, device time per group of kernels (the port's K1-K5, matrix
products, AdamW, the rest) and the kernels that take the most.
``--trace`` also writes the window's Chrome trace. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json

from ray_tpu_torch.scripts.profile_engine import _device_rows, _kernel_table

STEPS = 3
TOP_KERNELS = 15
# kernel name fragment (lower case) -> group, first match wins
GROUPS = (("flash_fwd_kernel", "K1 flash fwd"),
          ("flash_bwd_dq_kernel", "K2 flash bwd dQ"),
          ("flash_bwd_dkv_kernel", "K3 flash bwd dK/dV"),
          ("gqa_sum_kernel", "K3 flash bwd dK/dV"),  # K3's group sum
          ("rms_norm_kernel", "K4 rmsnorm"),
          ("int8_mm", "K5 int8 matmul"),
          ("multi_tensor_apply", "AdamW"),
          ("gemm", "matmul"), ("xmma", "matmul"), ("nvjet", "matmul"),
          ("cutlass", "matmul"))


def _groups(prof, steps: int):
    out = {}
    for us, name, _count in _device_rows(prof):
        group = next((g for frag, g in GROUPS if frag in name.lower()),
                     "other")
        out[group] = out.get(group, 0.0) + us
    return {g: us / steps / 1e3 for g, us in
            sorted(out.items(), key=lambda kv: -kv[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama", "vit", "dit", "dit_xl"),
                    default="llama")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.scripts import bench_train as bt

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA GPU")
    if args.model == "llama":
        cfg = LlamaConfig.llama3_8b(ce_chunk_tokens=bt.CE_CHUNK)
        _params, step, tokens, targets = bt.setup(cfg, bt.BATCH, bt.SEQ)
        inputs = (tokens, targets)
        fields = dict(batch=bt.BATCH, seq=bt.SEQ,
                      ce_chunk_tokens=cfg.ce_chunk_tokens)
    else:
        cfg, _params, step = bt.setup_vision(args.model)
        inputs = ()
        fields = dict(batch=bt.VISION_BATCH[args.model],
                      seq=cfg.seq_len if args.model == "vit"
                      else cfg.n_patches)
    step(*inputs).item()  # warm-up
    step_ms, _ = bt.timed_steps(step, STEPS, *inputs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms, _ = bt.timed_steps(step, STEPS, *inputs)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    busy_ms, launches, table = _kernel_table(prof, STEPS, TOP_KERNELS)
    print(json.dumps({
        "window": "train", "model": args.model,
        "device": torch.cuda.get_device_name(0),
        "n_layers": cfg.n_layers, **fields,
        "step_ms": step_ms,
        "step_ms_profiled": profiled_ms,
        "device_busy_ms_per_step": busy_ms,
        # unclipped: below 0 means the kernel sum counts something twice
        "device_idle_share": 1.0 - busy_ms / profiled_ms,
        # the profiler stretches the host's side of the step, not the
        # kernels: busy over the unprofiled step bounds the idle share
        "device_busy_over_unprofiled_step": busy_ms / step_ms,
        "launches_per_step": launches,
        "groups_ms_per_step": _groups(prof, STEPS),
        "top_kernels": table}), flush=True)
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
