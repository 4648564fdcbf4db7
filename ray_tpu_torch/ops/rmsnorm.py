"""Fused RMSNorm (port of ray_tpu/ops/rmsnorm.py).

On a CPU tensor :func:`rms_norm` runs the plain PyTorch version; on a
CUDA tensor it launches the hand-written kernel K4
(``csrc/rmsnorm.cu``: one warp per row, 16-byte loads, f32 reduction)
or raises. The kernel replaces the Pallas ``_rms_kernel``. When grad is
needed the call goes through :class:`_RMSNorm`, whose backward is the
VJP of the plain version, recomputed, as the reference's ``_bwd`` is:
there is no backward kernel.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops import _build


def _rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                        eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def _rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Kernel K4 on the card."""
    d = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rms_norm kernel takes bf16 or f32, not {x.dtype}")
    if weight.dtype != x.dtype or weight.shape != (d,) \
            or weight.device != x.device:
        raise ValueError("weight must be [d] with x's dtype and device")
    if d % 8:
        raise ValueError(f"rms_norm kernel needs d % 8 == 0, got {d}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        raise ValueError("rms_norm kernel needs a contiguous input")
    weight = weight.contiguous()
    out = torch.empty_like(x2)
    if any(t.data_ptr() % 16 for t in (x2, weight, out)):
        raise ValueError("rms_norm kernel needs 16-byte aligned tensors")
    lib = _build.lib()
    rc = lib.rt_rms_norm(x2.data_ptr(), weight.data_ptr(), out.data_ptr(),
                         x2.shape[0], d, float(eps),
                         int(x.dtype == torch.bfloat16),
                         _build.stream_ptr(x.device))
    _build.check(rc, "rt_rms_norm")
    rms_norm.launches += 1
    return out.reshape(x.shape)


class _RMSNorm(torch.autograd.Function):
    """K4 forward on the card (the plain version on the CPU); the
    backward is the VJP of the plain version at the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
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
    if x.device.type == "cpu":
        return _rms_norm_reference(x, weight, eps)
    return _rms_norm_kernel(x, weight, eps)


rms_norm.launches = 0
