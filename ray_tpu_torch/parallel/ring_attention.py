"""Sequence parallelism: ring attention and Ulysses attention over a
``torch.distributed`` group (port of ray_tpu/parallel/ring_attention.py).

Each rank of the group holds one contiguous shard of the sequence,
q [B, S/n, H, D] and k/v [B, S/n, KVH, D]; rank r holds positions
[r S/n, (r + 1) S/n). The group takes the place of the reference's mesh
axis (``_group.resolve``: None is the default group, or world 1).

- **Ring attention.** Each rank keeps its queries; the K/V blocks go
  round the ring (send to rank + 1, receive from rank - 1, through
  ``dist.batch_isend_irecv``, posted before the step's compute and
  waited after it). At step i rank r holds the block of rank
  j = (r - i) mod n. Each block goes through K1 (:func:`ring_forward_step`),
  which returns (o, lse), and the blocks merge by log-sum-exp into an f32
  accumulator. Under the causal mask a block with j < r is full, j == r
  is the diagonal (K1 causal, Sq == Sk), and j > r is skipped: the
  reference computes it and masks it to an exact zero, which gives the
  same numbers. K/V keep their KVH heads (K1-K3 group the query heads
  natively), so the ring moves H / KVH times fewer bytes than the
  reference, which repeats them to H heads first. The backward
  (:func:`ring_backward_step`) runs K2 and K3 on each block from the
  global lse and delta = rowsum(dO O), which makes each block's P the
  global probability; dK/dV accumulate in f32 buffers that travel with
  their block and end at its owner after n hops.
- **Ulysses.** An all-to-all (``dist.all_to_all_single``) moves
  [B, S/n, H, D] sequence shards to [B, S, H/n, D] head shards, flash
  attention runs over the whole sequence (K1, and K2/K3 under
  autograd), and a second all-to-all moves the output back; the backward
  of each all-to-all is the inverse all-to-all.

On the CPU the blocks run the kernels' plain versions; on the card K1-K3
launch, or the call raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import (
    NEG_INF, _delta, _repeat_kv, flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_fwd)
from ray_tpu_torch.parallel import _group

Acc = Tuple[torch.Tensor, torch.Tensor]


def ring_block_causal(rank: int, src: int, causal: bool) -> Optional[bool]:
    """K1's causal flag for the K/V block of rank ``src`` under the
    queries of rank ``rank``, or None when the causal mask hides the
    whole block (it is skipped)."""
    if not causal or src < rank:
        return False
    return True if src == rank else None


def ring_forward_step(q, k, v, acc: Optional[Acc],
                      block_causal: bool) -> Acc:
    """One ring step's forward: attention of q over one K/V block (K1 on
    the card), merged into ``acc`` = (o f32 [B, Sq, H, D], lse f32
    [B, H, Sq]) by log-sum-exp; ``acc`` None starts it."""
    o, lse = flash_attention_fwd(q, k, v, block_causal)
    if acc is None:
        return o.float(), lse
    o_acc, lse_acc = acc
    lse_new = torch.logaddexp(lse_acc, lse)
    w_acc = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    w_blk = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    return o_acc * w_acc + o.float() * w_blk, lse_new


def ring_backward_step(q, k, v, do, lse, delta, block_causal: bool,
                       dq, dk, dv) -> None:
    """One ring step's backward: K2 and K3 over one K/V block from the
    global ``lse`` and ``delta`` (both [B, H, Sq] f32), added in place
    into the f32 ``dq`` and the block's travelling ``dk`` / ``dv``."""
    dq.add_(flash_attention_bwd_dq(q, k, v, do, lse, delta, block_causal))
    dk_blk, dv_blk = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                             block_causal)
    dk.add_(dk_blk)
    dv.add_(dv_blk)


def _check_shard(q, k, v) -> None:
    if k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError(f"ring attention takes equal sequence shards: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")


def _ring_forward(q, k, v, group, rank: int, n: int, causal: bool):
    """This rank's forward over the ring -> (o in q's dtype, lse)."""
    acc, blocks = None, (k, v)
    for i in range(n):
        pending = (_group.shift(blocks, group, rank, n) if i < n - 1
                   else None)
        block_causal = ring_block_causal(rank, (rank - i) % n, causal)
        if block_causal is not None:
            acc = ring_forward_step(q, *blocks, acc, block_causal)
        if pending is not None:
            blocks = tuple(pending.wait())
    o, lse = acc
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, o, lse, do, group, rank: int, n: int,
                   causal: bool):
    """This rank's backward over the ring -> (dq, dk, dv); dK/dV of each
    block travel with it and are home after the n-th hop."""
    delta = _delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    blocks = (k, v)
    for i in range(n):
        pending = (_group.shift(blocks, group, rank, n) if i < n - 1
                   else None)
        block_causal = ring_block_causal(rank, (rank - i) % n, causal)
        if block_causal is not None:
            ring_backward_step(q, *blocks, do, lse, delta, block_causal,
                               dq, dk, dv)
        if n > 1:
            dk, dv = _group.shift((dk, dv), group, rank, n).wait()
        if pending is not None:
            blocks = tuple(pending.wait())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """Ring attention with its written-out backward (torch's P2P calls
    carry no autograd)."""

    @staticmethod
    def forward(ctx, q, k, v, group, rank, n, causal):
        o, lse = _ring_forward(q, k, v, group, rank, n, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = (group, rank, n, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over an expanded grad, which K2/K3 do not take
        dq, dk, dv = _ring_backward(q, k, v, o, lse, do.contiguous(),
                                    *ctx.ring)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, group=None, *, causal: bool = True):
    """Attention over a sequence sharded on ``group``: q [B, S/n, H, D],
    k/v [B, S/n, KVH, D], this rank's contiguous shard -> its shard of
    the output [B, S/n, H, D]."""
    _check_shard(q, k, v)
    group, rank, n = _group.resolve(group, q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, group, rank, n, causal)
    return _ring_forward(q, k, v, group, rank, n, causal)[0]


def ring_attention_lockstep(qs: Sequence[torch.Tensor],
                            ks: Sequence[torch.Tensor],
                            vs: Sequence[torch.Tensor], causal: bool = True,
                            dos: Optional[Sequence[torch.Tensor]] = None):
    """The ring's schedule for n = len(qs) virtual ranks in one process:
    every rank takes step i before any takes step i + 1, and each block
    (with its dK/dV accumulators in the backward) is handed to the next
    rank where the ring would send it. The same step functions as
    :func:`ring_attention`, so one device checks the schedule and the
    kernels' launches. Returns the outputs [B, S/n, H, D] per rank and,
    given ``dos`` (dO per rank), also (dqs, dks, dvs)."""
    n = len(qs)
    accs: List[Optional[Acc]] = [None] * n
    for i in range(n):
        for r in range(n):
            j = (r - i) % n
            block_causal = ring_block_causal(r, j, causal)
            if block_causal is not None:
                accs[r] = ring_forward_step(qs[r], ks[j], vs[j], accs[r],
                                            block_causal)
    outs = [acc[0].to(q.dtype) for acc, q in zip(accs, qs)]
    if dos is None:
        return outs
    lses = [acc[1] for acc in accs]
    deltas = [_delta(o, do) for o, do in zip(outs, dos)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    # dk_acc[j] travels with block j: at step i it is at rank j + i
    dk_acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
              for k in ks]
    dv_acc = [torch.zeros_like(t) for t in dk_acc]
    for i in range(n):
        for r in range(n):
            j = (r - i) % n
            block_causal = ring_block_causal(r, j, causal)
            if block_causal is not None:
                ring_backward_step(qs[r], ks[j], vs[j], dos[r], lses[r],
                                   deltas[r], block_causal, dqs[r],
                                   dk_acc[j], dv_acc[j])
    return (outs, [dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [d.to(k.dtype) for d, k in zip(dk_acc, ks)],
            [d.to(v.dtype) for d, v in zip(dv_acc, vs)])


def _all_to_all(x: torch.Tensor, group, n: int,
                to_heads: bool) -> torch.Tensor:
    """[B, S/n, H, D] sequence shards -> [B, S, H/n, D] head shards
    (``to_heads``), or back. Chunk r of the send buffer goes to rank r,
    chunk r of the receive buffer came from rank r."""
    if to_heads:
        b, s, h, d = x.shape
        send = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    else:
        b, s_all, h, d = x.shape
        send = x.reshape(b, n, s_all // n, h, d).permute(1, 0, 2, 3, 4)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if to_heads:  # [n (sequence block), B, S/n, H/n, D]
        return recv.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)
    # [n (head group), B, S/n, H/n, D]
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s_all // n, n * h, d)


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` whose backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, n, to_heads):
        ctx.args = (group, n, to_heads)
        return _all_to_all(x, group, n, to_heads)

    @staticmethod
    def backward(ctx, grad):
        group, n, to_heads = ctx.args
        return (_all_to_all(grad.contiguous(), group, n, not to_heads),
                None, None, None)


def ulysses_attention(q, k, v, group=None, *, causal: bool = True):
    """Ulysses sequence parallelism: shards as for :func:`ring_attention`;
    the heads are scattered over ``group``, so H must divide by its
    size. K/V heads are scattered too when KVH divides by it, else
    repeated to H first (as the reference always does)."""
    _check_shard(q, k, v)
    group, _rank, n = _group.resolve(group, q.device)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"ulysses needs heads ({h}) divisible by the "
                         f"group size ({n})")
    if n == 1:
        return flash_attention(q, k, v, causal)
    if k.shape[2] % n:
        k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    q, k, v = (_AllToAll.apply(t, group, n, True) for t in (q, k, v))
    return _AllToAll.apply(flash_attention(q, k, v, causal), group, n,
                           False)


def reference_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Unsharded attention in f32 for correctness checks: q [B, S, H, D],
    k/v [B, S, KVH, D], output in q's dtype."""
    d = q.shape[-1]
    k, v = _repeat_kv(k, q.shape[2]), _repeat_kv(v, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
