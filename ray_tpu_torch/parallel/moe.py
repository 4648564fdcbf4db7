"""Mixture-of-Experts on one device: a port of ray_tpu/parallel/moe.py.

The reference's formulation is kept as it is: a softmax router picks the
top-k experts of each token, one-hot dispatch and combine masks
[T, E, C] bound each expert to ``capacity`` tokens, and the expert
SwiGLU FFNs run batched over the expert axis as einsums. The masks are
built in f32 and cast to the model dtype, slots fill one after another
(each after the occupancy the earlier ones left), and the capacity is
``max(1, int(capacity_factor * k * T / E))`` of the tokens given,
padding included, all as in the reference.

No Pallas kernel has a twin here: the products go to ``torch.einsum``
(cuBLAS on the card), as the reference leaves them to XLA. Expert
parallelism across cards (the reference's "expert" mesh axis) comes
with the multi-GPU work.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, largest
    first, ties to the lower index (as ``jax.lax.top_k``; the order of
    ``torch.topk`` among equal values is unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def top_k_gating(x: torch.Tensor, router: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route tokens -> (gates [T, E] f32, topk_idx [T, k], aux).

    ``x`` [T, D], ``router`` [D, E]. Gates are zero outside the top-k and
    renormalised over the chosen experts; ``aux`` is the Switch
    load-balancing term E * sum_e(frac_tokens_e * mean_prob_e), its
    gradient through the mean probabilities only."""
    logits = x.float() @ router.float()                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    topk_vals, topk_idx = _top_k(probs, k)                     # [T, k]
    topk_vals = topk_vals / torch.clamp(
        topk_vals.sum(dim=-1, keepdim=True), min=1e-9)
    num_experts = router.shape[-1]
    gates = torch.zeros_like(probs).scatter(1, topk_idx, topk_vals)
    top1 = F.one_hot(topk_idx[:, 0], num_experts).float()
    aux = num_experts * torch.sum(top1.mean(0) * probs.mean(0))
    return gates, topk_idx, aux


def moe_dispatch(gates: torch.Tensor, topk_idx: torch.Tensor,
                 num_experts: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing masks -> (dispatch [T, E, C] one-hot, combine [T, E, C]),
    in gates' dtype. Each expert takes at most ``capacity`` tokens; the
    slots fill in order (every token's first choice before any second),
    and a token past its expert's capacity is dropped there (its
    residual path still carries it)."""
    num_tokens, k = topk_idx.shape
    dispatch = torch.zeros((num_tokens, num_experts, capacity),
                           dtype=gates.dtype, device=gates.device)
    occupancy = torch.zeros((num_experts,), dtype=torch.long,
                            device=gates.device)
    for slot in range(k):
        expert = topk_idx[:, slot]                              # [T]
        onehot = F.one_hot(expert, num_experts)                 # [T, E]
        # position of each token within its chosen expert's buffer
        pos_in_expert = torch.cumsum(onehot, dim=0) - 1 + occupancy[None]
        pos = pos_in_expert.gather(1, expert[:, None])[:, 0]    # [T]
        keep = (pos < capacity).to(gates.dtype)
        pos_onehot = F.one_hot(torch.clamp(pos, 0, capacity - 1),
                               capacity).to(gates.dtype)        # [T, C]
        dispatch = dispatch + (onehot.to(gates.dtype)[:, :, None]
                               * pos_onehot[:, None, :]
                               * keep[:, None, None])
        occupancy = occupancy + onehot.sum(0)
    return dispatch, dispatch * gates[:, :, None]


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert for ``num_tokens`` tokens (padding included)."""
    return max(1, int(capacity_factor * top_k * num_tokens / num_experts))


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
            w3: torch.Tensor, w2: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 2.0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE SwiGLU layer: x [B, S, D], router [D, E], expert stacks
    w1/w3 [E, D, H] and w2 [E, H, D] -> (y [B, S, D], aux f32)."""
    b, s, d = x.shape
    num_experts = router.shape[-1]
    tokens = x.reshape(b * s, d)
    gates, topk_idx, aux = top_k_gating(tokens, router, top_k)
    capacity = moe_capacity(b * s, num_experts, top_k, capacity_factor)
    dispatch, combine = moe_dispatch(gates, topk_idx, num_experts, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    expert_in = torch.einsum("tec,td->ecd", dispatch, tokens)   # [E, C, D]
    gate = F.silu(torch.einsum("ecd,edh->ech", expert_in, w1))
    up = torch.einsum("ecd,edh->ech", expert_in, w3)
    expert_out = torch.einsum("ech,ehd->ecd", gate * up, w2)
    y = torch.einsum("tec,ecd->td", combine, expert_out)
    return y.reshape(b, s, d), aux
