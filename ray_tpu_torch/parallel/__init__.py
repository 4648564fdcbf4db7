"""Parallel layers of the port: the mixture-of-experts layer
(``moe.py``) on one device. Expert parallelism across cards comes with
the multi-GPU work."""

from ray_tpu_torch.parallel.moe import moe_dispatch, moe_ffn, top_k_gating

__all__ = ["moe_dispatch", "moe_ffn", "top_k_gating"]
