"""Parallel layers of the port: the mixture-of-experts layer
(``moe.py``) on one device; ring and Ulysses attention
(``ring_attention.py``) and the GPipe pipeline (``pipeline.py``) over a
``torch.distributed`` group. Expert parallelism across cards comes with
the multi-GPU work."""

from ray_tpu_torch.parallel.moe import moe_dispatch, moe_ffn, top_k_gating
from ray_tpu_torch.parallel.pipeline import pipeline
from ray_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_attention, ring_attention_lockstep,
    ring_backward_step, ring_block_causal, ring_forward_step,
    ulysses_attention)

__all__ = ["moe_dispatch", "moe_ffn", "top_k_gating", "pipeline",
           "reference_attention", "ring_attention",
           "ring_attention_lockstep", "ring_backward_step",
           "ring_block_causal", "ring_forward_step", "ulysses_attention"]
