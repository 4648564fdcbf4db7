"""Causal flash attention, forward and backward (port of
ray_tpu/ops/attention.py).

On a CPU tensor :func:`flash_attention` runs the plain PyTorch versions;
on a CUDA tensor it launches the hand-written kernels or raises: K1
(``csrc/attention.cu``) for the forward, which replaces the Pallas
``_fwd_kernel`` (online softmax over K/V tiles in f32, bf16 P before
P.V) and also returns the row logsumexp; K2 (dQ) and K3 (dK/dV,
``csrc/attention_bwd.cu``) for the backward, which replace
``_dq_kernel`` and ``_dkv_kernel`` and rebuild P from that logsumexp.
When grad is needed, :func:`flash_attention` goes through
:class:`_FlashAttention`, which saves (q, k, v, o, lse) as the
reference's ``custom_vjp`` does; under ``no_grad`` it runs the forward
alone.

The kernels take head_dim 64, 72 (DiT-XL/2) and 128; 72 runs in tiles
of 128 columns whose last 56 TMA fills with zeros (csrc/attention.cu).
Any other head_dim raises on a CUDA tensor.

Layout: [batch, seq, heads, head_dim], as in the reference. Unlike the
reference, K/V may carry fewer heads than Q (GQA): head h reads KV head
h // (H // KVH), which is what the reference's ``jnp.repeat`` of K/V
computes, without the copy; dK/dV come back with the KV heads, summed
over each group (the VJP of ``jnp.repeat``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, KVH, D] -> [B, S, H, D], each KV head repeated in place
    (``jnp.repeat`` along the head axis)."""
    n_rep = n_heads // k.shape[2]
    return k.repeat_interleave(n_rep, dim=2) if n_rep > 1 else k


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """[Sq, Sk] bool: key j is live for query i iff j <= i + (Sk - Sq)."""
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril(sk - sq)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scaled scores [B, H, Sq, Sk] in f32, K's heads repeated."""
    k = _repeat_kv(k, q.shape[2])
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / (q.shape[-1] ** 0.5)


def _attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    s = _scores(q, k)
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    v = _repeat_kv(v, q.shape[2])
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (o [B, Sq, H, D], lse [B, H, Sq] f32). A row
    with no key at all keeps K1's l == 0 guard: lse = NEG_INF."""
    s = _scores(q, k)
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isneginf(lse), torch.full_like(lse, NEG_INF),
                      lse)
    return _attention_reference(q, k, v, causal), lse


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32 -> [B, H, Sq], as the reference computes it
    before its backward kernels."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _probs(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """P = exp(S * scale - lse) [B, H, Sq, Sk] f32, exactly 0 where the
    key is masked (so a row with no live key contributes nothing)."""
    p = torch.exp(_scores(q, k) - lse[..., None])
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        p = torch.where(mask[None, None], p, torch.zeros_like(p))
    return p


def _ds(p: torch.Tensor, do: torch.Tensor, v: torch.Tensor,
        delta: torch.Tensor, scale: float) -> torch.Tensor:
    """dS = P * (dO V^T - delta) * scale, f32 [B, H, Sq, Sk]."""
    v = _repeat_kv(v, do.shape[2])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p * (dp - delta[..., None]) * scale


def _bwd_dq_reference(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """Plain version of K2: dQ = dS K, dS rounded to K's dtype as the
    product's operand (as the reference kernel does)."""
    p = _probs(q, k, lse, causal)
    ds = _ds(p, do, v, delta, q.shape[-1] ** -0.5)
    kr = _repeat_kv(k, q.shape[2])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kr.float())
    return dq.to(q.dtype)


def _bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: dV = P^T dO and dK = dS^T Q per query head,
    P and dS rounded to the operands' dtype, then summed over each GQA
    group of query heads (the VJP of repeating K/V)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    p = _probs(q, k, lse, causal)
    ds = _ds(p, do, v, delta, d ** -0.5)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dk = dk.reshape(b, sk, kvh, h // kvh, d).sum(3)
    dv = dv.reshape(b, sk, kvh, h // kvh, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_backward_reference(q, k, v, o, lse, do, causal: bool):
    """Plain version of K2 + K3, with the signature of
    :func:`_flash_backward`: q [B, Sq, H, D], k/v [B, Sk, KVH, D], o and
    do like q, lse [B, H, Sq] f32 -> (dq, dk, dv)."""
    delta = _delta(o, do)
    dq = _bwd_dq_reference(q, k, v, do, lse, delta, causal)
    dk, dv = _bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_operand(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bf16; {name} is "
                        f"{t.dtype}")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"flash_attention kernel needs {name} with a "
                         "contiguous last dim, strides that are multiples "
                         "of 8 and a 16-byte aligned base")


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, do: Optional[torch.Tensor] = None):
    """Validate what the kernels take; return (B, Sq, H, D, Sk, KVH)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} do not match")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if d not in (64, 72, 128):
        raise ValueError(f"flash_attention kernel takes head_dim 64, 72 "
                         f"or 128, not {d}")
    if causal and sk < sq:
        raise ValueError("causal flash_attention needs Sk >= Sq")
    named = [("q", q), ("k", k), ("v", v)]
    if do is not None:
        if do.shape != q.shape:
            raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
        named.append(("do", do))
    if any(t.device != q.device for _, t in named):
        raise ValueError("q, k, v (and do) must share one device")
    for name, t in named:
        _check_operand(name, t)
    return b, sq, h, d, sk, kvh


def _check_rows(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be contiguous f32 {shape} on "
                         f"{device}; got {t.dtype} {tuple(t.shape)}")


# Query rows per K1 block (csrc/attention.cu): one consumer warpgroup,
# two blocks per SM.
_FWD_ROWS = 64


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How K1 covers one forward call (csrc/attention.cu): ``blocks``
    blocks, one per (query tile of _FWD_ROWS rows, head, batch); block i
    takes query tile ``first + step * (i // (H * B))``, which the kernel
    reads from these fields. Under the causal mask the last query tiles
    see the most keys, so they run first."""
    tiles: int
    blocks: int
    first: int
    step: int

    @property
    def order(self) -> Tuple[int, ...]:
        """The query tile of each block in launch order (the same for
        every head and batch)."""
        return tuple(self.first + self.step * i for i in range(self.tiles))


def _fwd_plan(b: int, sq: int, h: int, causal: bool = True) -> FwdPlan:
    """The launch plan of K1 for q [b, sq, h, d]."""
    n_q = -(-sq // _FWD_ROWS)
    return FwdPlan(tiles=n_q, blocks=n_q * h * b,
                   first=n_q - 1 if causal else 0, step=-1 if causal else 1)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1: q [B, Sq, H, D], k/v [B, Sk, KVH, D] bf16 on the card
    -> (o [B, Sq, H, D] bf16, lse [B, H, Sq] f32)."""
    b, sq, h, d, sk, kvh = _check_qkv(q, k, v, causal)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    plan = _fwd_plan(b, sq, h, causal)
    rc = _build.lib().rt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, kvh, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), float(d ** -0.5), plan.blocks, plan.first, plan.step,
        _build.stream_ptr(q.device))
    _build.check(rc, "rt_flash_attention_fwd")
    _build.count_launch(flash_attention)
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, causal):
    b, sq, h, d, sk, kvh = _check_qkv(q, k, v, causal, do)
    _check_rows("lse", lse, (b, h, sq), q.device)
    _check_rows("delta", delta, (b, h, sq), q.device)
    return (b, h, kvh, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], int(causal),
            float(d ** -0.5), _build.stream_ptr(q.device))


# Tile sizes of csrc/attention_bwd.cu: K2 blocks own 128 query rows, K3
# blocks 128 keys (two consumer warpgroups of 64 each).
_DQ_ROWS = 128
_DKV_KEYS = 128


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How K2 and K3 cover one backward call (csrc/attention_bwd.cu).

    ``dq_order`` / ``dkv_order``: the query / key tile of each block in
    launch order (the same for every head and batch), heaviest first
    under the causal mask: K2's last query tiles and K3's first key
    tiles see the most pairs. K3 runs one block per (key tile, query
    head, batch); with more than one query head per KV head it writes f32
    partials to ``scratch_shape`` (one buffer each for dK and dV) and a
    second pass sums each group in a fixed head order."""
    dq_blocks: int
    dkv_blocks: int
    dq_order: Tuple[int, ...]
    dkv_order: Tuple[int, ...]
    group: int
    scratch_shape: Optional[Tuple[int, int, int, int]]

    @property
    def scratch_bytes(self) -> int:
        if self.scratch_shape is None:
            return 0
        b, s, h, d = self.scratch_shape
        return 2 * 4 * b * s * h * d


def _bwd_plan(b: int, sq: int, sk: int, h: int, kvh: int, d: int,
              causal: bool = True) -> BwdPlan:
    """The launch plan of K2 and K3 for q [b, sq, h, d] and k/v
    [b, sk, kvh, d]."""
    n_q = -(-sq // _DQ_ROWS)
    n_k = -(-sk // _DKV_KEYS)
    group = h // kvh
    return BwdPlan(
        dq_blocks=n_q * h * b, dkv_blocks=n_k * h * b,
        dq_order=tuple(range(n_q))[::-1] if causal else tuple(range(n_q)),
        dkv_order=tuple(range(n_k)), group=group,
        scratch_shape=(b, sk, h, d) if group > 1 else None)


def flash_attention_bwd_dq(q, k, v, do, lse, delta,
                           causal: bool) -> torch.Tensor:
    """dq [B, Sq, H, D] from q, do [B, Sq, H, D], k/v [B, Sk, KVH, D]
    and lse, delta [B, H, Sq] f32: the plain version on a CPU tensor,
    kernel K2 on a CUDA tensor (bf16, strided)."""
    if q.device.type == "cpu":
        return _bwd_dq_reference(q, k, v, do, lse, delta, causal)
    args = _bwd_args(q, k, v, do, lse, delta, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = _build.lib().rt_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args)
    _build.check(rc, "rt_flash_attention_bwd_dq")
    _build.count_launch(flash_attention_bwd_dq)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Sk, KVH, D], each summed over the query heads of its
    GQA group; inputs as for :func:`flash_attention_bwd_dq`. The plain
    version on a CPU tensor, kernel K3 (and its group sum) on a CUDA
    tensor."""
    if q.device.type == "cpu":
        return _bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    args = _bwd_args(q, k, v, do, lse, delta, causal)
    plan = _bwd_plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                     k.shape[2], q.shape[3], causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    pk = pv = None
    if plan.scratch_shape is not None:
        pk = torch.empty(plan.scratch_shape, dtype=torch.float32,
                         device=q.device)
        pv = torch.empty_like(pk)
    rc = _build.lib().rt_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if pk is None else pk.data_ptr(),
        None if pv is None else pv.data_ptr(), *args)
    _build.check(rc, "rt_flash_attention_bwd_dkv")
    _build.count_launch(flash_attention_bwd_dkv)
    return dk, dv


def flash_attention_fwd(q, k, v, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Sq, H, D], lse [B, H, Sq] f32) from q [B, Sq, H, D] and k/v
    [B, Sk, KVH, D]: the plain version on a CPU tensor, kernel K1 on a
    CUDA tensor (bf16, strided)."""
    if q.device.type == "cpu":
        return _flash_forward_reference(q, k, v, causal)
    return _flash_forward(q, k, v, causal)


def _flash_backward(q, k, v, o, lse, do, causal: bool):
    """(dq, dk, dv) of attention from the forward's o and lse: delta,
    then K2, then K3 and its group sum (their plain versions on a CPU
    tensor)."""
    delta = _delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: K1 forward and K2/K3 backward
    on the card, the plain versions of both on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over an expanded grad (stride 0, from a sum),
        # which the kernels' strided reads do not take
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do.contiguous(),
                                     ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Fused causal attention: q [B, Sq, H, D], k/v [B, Sk, KVH, D]
    -> [B, Sq, H, D]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return _attention_reference(q, k, v, causal)
    return _flash_forward(q, k, v, causal)[0]


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
