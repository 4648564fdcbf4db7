"""Fused RMSNorm (port of ray_tpu/ops/rmsnorm.py).

On a CPU tensor :func:`rms_norm` runs the plain PyTorch version; on a
CUDA tensor it launches the hand-written kernel K4
(``csrc/rmsnorm.cu``: the row held in registers, every load issued
before the f32 reduction, one trip to memory) or raises. The kernel
replaces the Pallas ``_rms_kernel``; like the JAX function it takes
bf16, fp16 and f32 and any width (a ragged or unaligned row takes the
kernel's masked scalar path). :func:`_rms_plan` sets its launch. When
grad is needed the call goes through :class:`_RMSNorm`, whose backward
is the VJP of the plain version, recomputed, as the reference's ``_bwd``
is: there is no backward kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ray_tpu_torch.ops import _build

# dtype -> the C entry's type code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_THREADS = 512   # a block, csrc/rmsnorm.cu kMaxThreads
_ROW_THREADS = 128   # threads a row while 1, 2 or 4 slots each cover it


@dataclasses.dataclass(frozen=True)
class RmsPlan:
    """How K4 covers a row: a block of ``threads`` threads, each holding
    ``vecs`` slots of ``width`` elements (16 bytes) per chunk of the
    row, ``chunks`` chunks. ``vector``: 16-byte loads, else masked
    scalar ones."""
    threads: int
    vecs: int
    width: int
    vector: bool
    chunks: int


@functools.lru_cache(maxsize=None)
def _rms_plan(d: int, dtype: torch.dtype, aligned: bool) -> RmsPlan:
    """The plan for rows of ``d`` elements of ``dtype`` (``aligned``: x,
    w and out start on 16 bytes); the grid is one block per row. A row
    of up to 128 slots takes one slot a thread, up to 256 two, and up
    to 2048 four (d 16384 in bf16: 512 threads); a wider one is walked
    in chunks of 512 x 4 slots (measured at d 4096 against one and two
    slots a thread, and against several rows a block: PERF.md)."""
    width = 16 // dtype.itemsize
    slots = -(-d // width)
    vecs = next((v for v in (1, 2) if slots <= _ROW_THREADS * v), 4)
    if slots <= _MAX_THREADS * vecs:
        threads, chunks = (-(-slots // vecs) + 31) // 32 * 32, 1
    else:
        threads, chunks = _MAX_THREADS, -(-slots // (_MAX_THREADS * vecs))
    return RmsPlan(threads=threads, vecs=vecs, width=width,
                   vector=aligned and d % width == 0, chunks=chunks)


def _rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                        eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


_entry = None


def _rt_rms_norm():
    """The C entry, bound once (the library lock is taken only then)."""
    global _entry
    if _entry is None:
        _entry = _build.lib().rt_rms_norm
    return _entry


def _rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Kernel K4 on the card."""
    d = x.shape[-1]
    code = _DTYPES.get(x.dtype)
    if code is None:
        raise TypeError(f"rms_norm kernel takes bf16, fp16 or f32, not "
                        f"{x.dtype}")
    if weight.dtype != x.dtype or weight.shape != (d,) \
            or weight.get_device() != x.get_device():
        raise ValueError("weight must be [d] with x's dtype and device")
    if not x.is_contiguous():
        raise ValueError("rms_norm kernel needs a contiguous input")
    weight = weight.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if not rows:
        return out
    xp, wp, op = x.data_ptr(), weight.data_ptr(), out.data_ptr()
    plan = _rms_plan(d, x.dtype, not (xp | wp | op) % 16)
    rc = _rt_rms_norm()(xp, wp, op, rows, d, eps, code, plan.threads,
                        plan.vecs, plan.vector, plan.chunks,
                        _build.stream_ptr(x.device))
    if rc:
        _build.check(rc, "rt_rms_norm")
    rms_norm.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    """K4 forward on the card (the plain version on the CPU); the
    backward is the VJP of the plain version at the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.is_cpu:
            return _rms_norm_reference(x, weight, eps)
        return _rms_norm_kernel(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            x_ = x.detach().requires_grad_()
            w_ = weight.detach().requires_grad_()
            y = _rms_norm_reference(x_, w_, ctx.eps)
        dx, dw = torch.autograd.grad(y, (x_, w_), g)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: x * rsqrt(mean(x^2)+eps) * weight."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    if x.is_cpu:
        return _rms_norm_reference(x, weight, eps)
    return _rms_norm_kernel(x, weight, eps)


rms_norm.launches = 0
