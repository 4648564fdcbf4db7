"""The port's compute kernels with their plain PyTorch versions.

flash-attention forward (K1) and backward (K2 dQ, K3 dK/dV), RMSNorm
(K4) and the weight-only int8 matmul (K5) are hand-written CUDA C++ for
sm_90a (``csrc/``); rotary embeddings are plain PyTorch, as in the
reference. Each wrapper runs the plain version on a CPU tensor and its
kernel on a CUDA tensor.
"""

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.quant_matmul import (
    int8_matmul, quantize_int8, scale_from_amax)
from ray_tpu_torch.ops.rmsnorm import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = ["apply_rope", "flash_attention", "int8_matmul", "quantize_int8",
           "rms_norm", "rope_frequencies", "scale_from_amax"]
