"""Models of the port: the Llama family (dense and MoE) for serving and
training, on sharded parameters too, the MLP classifier, ViT and CLIP,
and DiT, with each family's sharding rules."""

from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.dit import (
    DiTConfig, dit_forward, dit_init, dit_loss, dit_sample,
    dit_sharding_rules, draw_dit_noise)
from ray_tpu_torch.models.llama import (
    LlamaConfig, chunked_cross_entropy, llama_decode_step, llama_forward,
    llama_init, llama_init_cache, llama_loss, llama_prefill,
    llama_sharding_rules, llama_verify_step, lora_init, quantize_llama_ffn,
    stack_layers, unstack_layers)
from ray_tpu_torch.models.mlp import MLPConfig, mlp_forward, mlp_init
from ray_tpu_torch.models.vit import (
    CLIPConfig, CLIPTextConfig, ViTConfig, clip_encode_image,
    clip_encode_text, clip_init, clip_loss, clip_sharding_rules, vit_forward,
    vit_init, vit_loss, vit_sharding_rules)

__all__ = ["CLIPConfig", "CLIPTextConfig", "DiTConfig", "LlamaConfig",
           "MLPConfig", "ViTConfig", "chunked_cross_entropy",
           "clip_encode_image", "clip_encode_text", "clip_init", "clip_loss",
           "clip_sharding_rules", "dit_forward", "dit_init", "dit_loss",
           "dit_sample", "dit_sharding_rules", "draw_dit_noise",
           "llama_decode_step", "llama_forward", "llama_init",
           "llama_init_cache", "llama_loss", "llama_prefill",
           "llama_sharding_rules", "llama_verify_step", "lora_init",
           "mlp_forward", "mlp_init", "params_from_jax", "quantize_llama_ffn", "stack_layers",
           "unstack_layers", "vit_forward", "vit_init", "vit_loss",
           "vit_sharding_rules"]
