"""Mixture-of-Experts with expert parallelism: a port of
ray_tpu/parallel/moe.py and of what GSPMD makes of it on a mesh.

The reference's formulation is kept as it is: a softmax router picks the
top-k experts of each token, one-hot dispatch and combine masks
[T, E, C] bound each expert to ``capacity`` tokens, and the expert
SwiGLU FFNs run batched over the expert axis as einsums. The masks are
built in f32 and cast to the model dtype, slots fill one after another
(each after the occupancy the earlier ones left), and the capacity is
``max(1, int(capacity_factor * k * T / E))`` of the tokens given,
padding included, all as in the reference.

**Sharded tokens.** When this rank's tokens [B, S] are a shard of the
global batch (over the ``batch_axes``, and of the sequence over
``seq_axis``), the routing is still that of the global token set, as
the reference's is: the capacity comes from the global T, and the slots
fill in global token order (row-major over [B, S]), every token's
first choice before any second. Each rank counts its tokens' choices per
row, slot and expert ([B, k, E] integers); one all-gather of the counts
over each token axis gives every rank the slots that the tokens before
its own take, so its rows of the global dispatch mask are computed
locally. The load-balancing loss is the global one (the global top-1
fractions, the global mean probabilities), raised to its global value
on every rank with this rank's share as its gradient. A token never
leaves its rank: the expert FFN works row by row, so each rank runs its
own tokens' slots, and no all-to-all is needed while the tokens are
replicated over the expert axis.

**Expert parallelism.** With ``expert_axis``, a rank holds E / ep of
the expert stacks ([E / ep, D, H]) and runs the dispatch and the expert
einsums on its experts' rows of [E, C, D] only; the combine leaves a
partial sum over its experts, summed over the expert axis (an
all-reduce of [T, D] in the model dtype, 2 (ep - 1) / ep of it sent per
rank). In the backward the tokens' and gates' gradients, which each rank
holds for its own experts only, are summed over the axis too
(Megatron's f and g, parallel/_sharded.py).

No Pallas kernel has a twin here: the products go to ``torch.einsum``
(cuBLAS on the card), as the reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel._sharded import (
    Axis, all_gather, copy_to, global_value, reduce_from)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, largest
    first, ties to the lower index (as ``jax.lax.top_k``; the order of
    ``torch.topk`` among equal values is unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _router_probs(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x.float() @ router.float(), dim=-1)   # [T, E]


def top_k_gating(x: torch.Tensor, router: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route tokens -> (gates [T, E] f32, topk_idx [T, k], aux).

    ``x`` [T, D], ``router`` [D, E]. Gates are zero outside the top-k and
    renormalised over the chosen experts; ``aux`` is the Switch
    load-balancing term E * sum_e(frac_tokens_e * mean_prob_e), its
    gradient through the mean probabilities only."""
    probs = _router_probs(x, router)
    topk_vals, topk_idx = _top_k(probs, k)                     # [T, k]
    topk_vals = topk_vals / torch.clamp(
        topk_vals.sum(dim=-1, keepdim=True), min=1e-9)
    num_experts = router.shape[-1]
    gates = torch.zeros_like(probs).scatter(1, topk_idx, topk_vals)
    top1 = F.one_hot(topk_idx[:, 0], num_experts).float()
    aux = num_experts * torch.sum(top1.mean(0) * probs.mean(0))
    return gates, topk_idx, aux


def _slot_offsets(counts: torch.Tensor, batch_axes: Sequence[Axis],
                  seq_axis: Optional[Axis]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``counts`` [B, k, E]: this rank's choices per row, slot and
    expert -> (offsets [B, k, E]: the slots of each expert taken before
    each of this rank's rows fills slot j, totals [k, E] over the global
    tokens). The global order is slot-major, then row-major over the
    global [B, S]: a segment is one row's positions on one sequence
    shard, and the segments of this rank are rows ``start + b`` of the
    global batch, sequence shard ``q``."""
    b, k, e = counts.shape
    q, n_seq = 0, 1
    segs = counts[:, None]                                   # [B, 1, k, E]
    if seq_axis is not None:
        q, n_seq = seq_axis.rank, seq_axis.size
        segs = all_gather(counts, 0, seq_axis).reshape(
            n_seq, b, k, e).transpose(0, 1)                  # [B, nq, k, E]
    start = 0
    for axis in reversed(batch_axes):   # the minor axis first
        segs = all_gather(segs, 0, axis)
    for axis in batch_axes:
        start = start * axis.size + axis.rank
    segs = segs.reshape(-1, k, e)                  # global segment order
    totals = segs.sum(0)
    before = segs.cumsum(0) - segs
    occupancy = totals.cumsum(0) - totals          # earlier slots' claims
    mine = (start * b + torch.arange(b, device=counts.device)) * n_seq + q
    return before[mine] + occupancy, totals


def _positions(topk_idx: torch.Tensor, offsets: torch.Tensor,
               num_experts: int) -> torch.Tensor:
    """topk_idx [B, S, k], offsets [B, k, E] -> each choice's slot in its
    expert's buffer, [B * S, k]."""
    b, s, k = topk_idx.shape
    pos = []
    for slot in range(k):
        expert = topk_idx[..., slot]                         # [B, S]
        onehot = F.one_hot(expert, num_experts)              # [B, S, E]
        pos_in_expert = (torch.cumsum(onehot, dim=1) - 1
                         + offsets[:, slot, None, :])
        pos.append(pos_in_expert.gather(2, expert[..., None])[..., 0])
    return torch.stack(pos, dim=-1).reshape(b * s, k)


def _masks(gates, topk_idx, positions, num_experts: int, capacity: int):
    """(dispatch [T, E, C] one-hot, combine [T, E, C]) in gates' dtype
    from each choice's slot; a choice past its expert's capacity is
    dropped there."""
    num_tokens, k = topk_idx.shape
    dispatch = torch.zeros((num_tokens, num_experts, capacity),
                           dtype=gates.dtype, device=gates.device)
    for slot in range(k):
        onehot = F.one_hot(topk_idx[:, slot], num_experts)   # [T, E]
        pos = positions[:, slot]
        keep = (pos < capacity).to(gates.dtype)
        pos_onehot = F.one_hot(torch.clamp(pos, 0, capacity - 1),
                               capacity).to(gates.dtype)     # [T, C]
        dispatch = dispatch + (onehot.to(gates.dtype)[:, :, None]
                               * pos_onehot[:, None, :]
                               * keep[:, None, None])
    return dispatch, dispatch * gates[:, :, None]


def _choice_counts(topk_idx: torch.Tensor, num_experts: int
                   ) -> torch.Tensor:
    """topk_idx [B, S, k] -> [B, k, E] choices per row, slot, expert."""
    return F.one_hot(topk_idx, num_experts).sum(1)


def moe_dispatch(gates: torch.Tensor, topk_idx: torch.Tensor,
                 num_experts: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing masks -> (dispatch [T, E, C] one-hot, combine [T, E, C]),
    in gates' dtype. Each expert takes at most ``capacity`` tokens; the
    slots fill in order (every token's first choice before any second),
    and a token past its expert's capacity is dropped there (its
    residual path still carries it)."""
    idx = topk_idx[None]                                     # one row
    offsets, _totals = _slot_offsets(_choice_counts(idx, num_experts), (),
                                     None)
    return _masks(gates, topk_idx, _positions(idx, offsets, num_experts),
                  num_experts, capacity)


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert for ``num_tokens`` tokens (padding included)."""
    return max(1, int(capacity_factor * top_k * num_tokens / num_experts))


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
            w3: torch.Tensor, w2: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 2.0,
            batch_axes: Sequence[Axis] = (), seq_axis: Optional[Axis] = None,
            expert_axis: Optional[Axis] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE SwiGLU layer: x [B, S, D], router [D, E], expert stacks
    w1/w3 [E, D, H] and w2 [E, H, D] -> (y [B, S, D], aux f32).

    ``batch_axes`` / ``seq_axis``: the mesh axes (of more than one rank)
    that ``x``'s batch and sequence are split over, major first; the
    routing is then the global batch's (see the module docstring).
    ``expert_axis``: the axis the expert stacks are split over; w1, w3
    and w2 are this rank's E / ep experts, in order."""
    b, s, d = x.shape
    num_experts = router.shape[-1]
    token_axes = (*batch_axes, *([seq_axis] if seq_axis else []))
    n_tokens = b * s * math.prod(a.size for a in token_axes)
    tokens = x.reshape(b * s, d)
    gates, topk_idx, aux = top_k_gating(tokens, router, top_k)
    idx = topk_idx.reshape(b, s, top_k)
    offsets, totals = _slot_offsets(_choice_counts(idx, num_experts),
                                    batch_axes, seq_axis)
    if token_axes:
        # the global load-balancing loss: global top-1 fractions, and
        # this rank's share of the global mean probabilities
        probs = _router_probs(tokens, router)
        share = num_experts * torch.sum(
            totals[0].float() / n_tokens * (probs.sum(0) / n_tokens))
        aux = global_value(share, token_axes)
    capacity = moe_capacity(n_tokens, num_experts, top_k, capacity_factor)
    dispatch, combine = _masks(copy_to(gates, expert_axis), topk_idx,
                               _positions(idx, offsets, num_experts),
                               num_experts, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    if expert_axis is not None:
        local = w1.shape[0]
        if local * expert_axis.size != num_experts:
            raise ValueError(
                f"{num_experts} experts over an expert axis of "
                f"{expert_axis.size}: this rank holds {local}")
        mine = slice(expert_axis.rank * local, (expert_axis.rank + 1) * local)
        dispatch, combine = dispatch[:, mine], combine[:, mine]
        tokens = copy_to(tokens, expert_axis)
    expert_in = torch.einsum("tec,td->ecd", dispatch, tokens)   # [E, C, D]
    gate = F.silu(torch.einsum("ecd,edh->ech", expert_in, w1))
    up = torch.einsum("ecd,edh->ech", expert_in, w3)
    expert_out = torch.einsum("ech,ehd->ecd", gate * up, w2)
    y = reduce_from(torch.einsum("tec,ecd->td", combine, expert_out),
                    expert_axis)
    return y.reshape(b, s, d), aux
