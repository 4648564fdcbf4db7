"""Models of the port: the Llama family, for serving and training."""

from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import (
    LlamaConfig, chunked_cross_entropy, llama_decode_step, llama_forward,
    llama_init, llama_init_cache, llama_loss, llama_prefill,
    llama_verify_step, lora_init, quantize_llama_ffn, stack_layers,
    unstack_layers)

__all__ = ["LlamaConfig", "chunked_cross_entropy", "llama_decode_step",
           "llama_forward", "llama_init", "llama_init_cache", "llama_loss",
           "llama_prefill", "llama_verify_step", "lora_init",
           "params_from_jax", "quantize_llama_ffn", "stack_layers",
           "unstack_layers"]
