"""Weight-only int8 matmul (port of ray_tpu/ops/quant_matmul.py).

Decode-time matmuls stream the whole weight matrix for a handful of
rows, so int8 weights halve their bytes, but only if the dequantization
happens in registers after the tile load. On a CPU tensor
:func:`int8_matmul` runs the plain PyTorch version; on a CUDA tensor it
launches the hand-written kernel K5 (``csrc/quant_matmul.cu``) or
raises. Unlike the TPU kernel, K5 masks ragged M, N and K, so no width
has to divide a block (Llama-2-7B's FFN width 11008 works).
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.ops import _build

__all__ = ["scale_from_amax", "quantize_int8", "int8_matmul"]

# Block shapes of csrc/quant_matmul.cu: decode blocks (M <= 32) own 128
# output channels by 8, 16 or 32 tokens, prefill blocks 256 channels by
# 128 tokens; both stream K in 64-deep stages.
_DEPTH = 64


@dataclasses.dataclass(frozen=True)
class MmPlan:
    """How K5 covers one call: blocks of ``block_m`` tokens by ``block_n``
    channels, ``tiles`` of them; K cut into ``splits`` ranges of
    ``k_per_split`` (a multiple of the stage depth) over blocks, whose
    f32 partials a second launch sums in split order."""
    block_m: int
    block_n: int
    tiles: int
    splits: int
    k_per_split: int


def _mm_plan(m: int, k: int, n: int, sms: int) -> MmPlan:
    """Split K until the grid fills the card, two decode blocks or one
    prefill block per SM (at decode one token tile leaves too few blocks
    to keep the weights streaming), keeping at least four stages per
    split."""
    block_m = next((b for b in (8, 16, 32) if m <= b), 128)
    block_n = 128 if block_m < 128 else 256
    tiles = -(-m // block_m) * -(-n // block_n)
    want = -(-(2 if block_m < 128 else 1) * sms // tiles)
    splits = max(1, min(want, k // (4 * _DEPTH)))
    k_per_split = max(_DEPTH,
                      -(-(-(-k // splits)) // _DEPTH) * _DEPTH)
    splits = max(1, -(-k // k_per_split))
    return MmPlan(block_m=block_m, block_n=block_n, tiles=tiles,
                  splits=splits, k_per_split=k_per_split)


def scale_from_amax(amax, qmax: float = 127.0) -> torch.Tensor:
    """Symmetric quantization scale from a per-group |max|: 127 for
    int8, 448 for fp8-e4m3."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    return torch.clamp(amax / qmax, min=1e-8)


def quantize_int8(w: torch.Tensor, axis: int = 0):
    """Symmetric per-output-channel int8 quantization.

    w: [K, N] float -> (w8 [K, N] int8, scale [N] f32), w ~= w8 * scale.
    """
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = scale_from_amax(amax)
    w8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w8, scale.reshape(-1)


def _int8_matmul_reference(x: torch.Tensor, w8: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """(x @ w8) * scale with the sum in f32 (the x dtype for f32), cast
    to x's dtype: for bf16 x the kernel's arithmetic."""
    acc = x.float() @ w8.float()
    return (acc * scale.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, w8: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ (w8 [K, N] int8 * scale [N]) -> [M, N] in x's dtype
    (bf16 on the card)."""
    if x.dim() != 2 or w8.dim() != 2 or x.shape[1] != w8.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w8 {tuple(w8.shape)} do "
                         "not multiply")
    m, k = x.shape
    n = w8.shape[1]
    if scale.shape != (n,):
        raise ValueError(f"scale length {tuple(scale.shape)} != N {n} "
                         "(quantize per output channel, axis=0)")
    if x.device.type == "cpu":
        return _int8_matmul_reference(x, w8, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise RuntimeError("int8_matmul kernel has no backward (nor has "
                           "the reference's Pallas kernel); call it under "
                           "torch.no_grad()")
    if x.dtype != torch.bfloat16 or w8.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError("int8_matmul kernel takes x bf16, w8 int8, scale "
                        f"f32; got {x.dtype}, {w8.dtype}, {scale.dtype}")
    if not (x.device == w8.device == scale.device):
        raise ValueError("x, w8, scale must share one device")
    if not (x.is_contiguous() and w8.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("int8_matmul kernel needs contiguous operands")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    plan = _mm_plan(m, k, n, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    ws = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, m, n), dtype=torch.float32,
                         device=x.device)
    vec_ok = int(k % 8 == 0 and n % 16 == 0 and x.data_ptr() % 16 == 0
                 and w8.data_ptr() % 16 == 0)
    rc = _build.lib().rt_int8_matmul(
        x.data_ptr(), w8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, k, n,
        plan.block_m, plan.splits, plan.k_per_split, vec_ok,
        _build.stream_ptr(x.device))
    _build.check(rc, "rt_int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
