"""DiT, the diffusion transformer with adaLN-Zero, in PyTorch: a port of
ray_tpu/models/dit.py (Peebles & Xie, arXiv 2212.09748).

Parameters keep the reference's tree (layers stacked on axis 0, every
projection [in, out]), so ``params_from_jax`` carries a JAX tree over
without reshaping; ``unstack_layers`` (models/llama.py) gives each layer
its own leaves for training. The modulation projections start at zero
(adaLN-Zero), so at init every block is the identity and the predicted
noise is exactly zero.

Every random draw goes through :func:`draw_dit_noise`: ``dit_loss`` and
``dit_sample`` take its dict where the reference takes a PRNG key, so a
caller can hand them any draws (the tests replay ``jax.random``'s).

Kernels on this path: with ``attention="flash"`` each block's attention
is K1 on the card (non-causal) and, under autograd, K2 and K3
(ops/attention.py): DiT-B/2 at head_dim 64 (768 / 12), DiT-XL/2 at 72
(1152 / 16). LayerNorm, the modulation, GELU and the timestep features
are PyTorch ops (jnp in the reference), and the products
``torch.matmul``. ``dit_sharding_rules`` are the reference's rules for
this tree. With ``mesh`` and ``rules`` the forward and the loss run on
this rank's local shards and rows, as ViT's do (models/vit.py):
Megatron's pairs on ``model`` run on their shards; every other leaf is
gathered on use, ``mod_w`` too, though its rules split its output
columns over ``model``: the block cuts that output into six modulation
vectors, and a rank's column shard would hold pieces of the wrong ones.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import _layer, remat_wrap
from ray_tpu_torch.models.vit import (
    EncoderPlan, _attend, _mode_specs, encoder_plan, fan_in_init, gelu,
    layer_norm, n_layers_of)
from ray_tpu_torch.parallel._sharded import (
    copy_to, global_mean, local_rows, reduce_from)
from ray_tpu_torch.parallel.sharding import P, ShardingRules

Params = Dict[str, Any]


@dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32        # latent (or image) height = width
    patch_size: int = 2
    channels: int = 4           # 4 = VAE latent space, 3 = pixels
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    n_classes: int = 0          # >0 = class-conditional (+ null class)
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    attention: str = "flash"    # flash | reference
    remat: bool = True
    time_freq_dim: int = 256    # sinusoidal timestep feature width

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size * self.patch_size

    # --- presets (the reference's, same shapes) ------------------------
    @staticmethod
    def b_2(**kw) -> "DiTConfig":
        return DiTConfig(**kw)  # DiT-B/2

    @staticmethod
    def xl_2(**kw) -> "DiTConfig":
        defaults = dict(dim=1152, n_layers=28, n_heads=16,
                        hidden_dim=4608)
        defaults.update(kw)
        return DiTConfig(**defaults)

    @staticmethod
    def tiny(**kw) -> "DiTConfig":
        """Test-scale config."""
        defaults = dict(input_size=8, patch_size=2, channels=3, dim=32,
                        n_layers=2, n_heads=4, hidden_dim=64,
                        time_freq_dim=16, dtype=torch.float32,
                        attention="reference", remat=False)
        defaults.update(kw)
        return DiTConfig(**defaults)


def _patchify(x, c: DiTConfig):
    b, h, w, ch = x.shape
    p = c.patch_size
    x = x.reshape(b, h // p, p, w // p, p, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * ch)


def _unpatchify(tokens, c: DiTConfig):
    b = tokens.shape[0]
    hp = c.input_size // c.patch_size
    p = c.patch_size
    x = tokens.reshape(b, hp, hp, p, p, c.channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, c.input_size, c.input_size, c.channels)


def timestep_embedding(t, freq_dim: int):
    """Sinusoidal features of continuous t in [0, 1] -> [B, freq_dim]."""
    half = freq_dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dit_init(seed: int, config: DiTConfig, device: DeviceLike = None
             ) -> Params:
    """Random parameters from a seed (a ``torch.Generator`` on
    ``device``), the reference's tree and initialisers: the modulation
    projections and the output projection zero (adaLN-Zero). The bits
    differ from ``jax.random``'s."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, H, L = c.dim, c.hidden_dim, c.n_layers

    def init(shape, fan_in):
        return fan_in_init(gen, shape, fan_in, c.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=c.dtype, device=dev)

    params = {
        "patch_embed": init((c.patch_dim, D), c.patch_dim),
        "patch_bias": zeros(D),
        "pos_embed": fan_in_init(gen, (c.n_patches, D), None, c.dtype,
                                 std=0.02),
        "time_w1": init((c.time_freq_dim, D), c.time_freq_dim),
        "time_b1": zeros(D),
        "time_w2": init((D, D), D),
        "time_b2": zeros(D),
        "layers": {
            "wq": init((L, D, D), D), "wk": init((L, D, D), D),
            "wv": init((L, D, D), D), "wo": init((L, D, D), D),
            "w1": init((L, D, H), D), "w2": init((L, H, D), H),
            # adaLN-Zero: 6 modulation vectors per block, zero at init
            "mod_w": zeros(L, D, 6 * D),
            "mod_b": zeros(L, 6 * D),
        },
        # final layer: adaLN (shift, scale) and a zero output projection
        "final_mod_w": zeros(D, 2 * D),
        "final_mod_b": zeros(2 * D),
        "final_w": zeros(D, c.patch_dim),
        "final_b": zeros(c.patch_dim),
    }
    if c.n_classes:
        # +1 slot: the "null" class for classifier-free guidance
        params["label_embed"] = fan_in_init(gen, (c.n_classes + 1, D), None,
                                            c.dtype, std=0.02)
    return params


def _ada_ln(x, shift, scale, eps: float):
    """Parameter-free LN (in f32, cast back to x's dtype), then
    modulated per sample in x's dtype: h * (1 + scale) + shift."""
    d = x.shape[-1]
    h = layer_norm(x, torch.ones((d,), device=x.device),
                   torch.zeros((d,), device=x.device), eps)
    return h * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _dit_block(layer: Params, x, cond, config: DiTConfig,
               plan: EncoderPlan):
    c = config
    b, s, _ = x.shape
    layer = plan.layer(layer)
    attn_axis, mlp_axis = plan.attn_model, plan.mlp_model
    heads = c.n_heads if attn_axis is None else c.n_heads // attn_axis.size
    mod = (cond @ layer["mod_w"] + layer["mod_b"]).to(x.dtype)
    sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod, 6, dim=-1)

    h = _ada_ln(x, sh1, sc1, c.norm_eps).to(x.dtype)
    h = copy_to(h, attn_axis)  # column-parallel wq / wk / wv
    q = (h @ layer["wq"]).reshape(b, s, heads, c.head_dim)
    k = (h @ layer["wk"]).reshape(b, s, heads, c.head_dim)
    v = (h @ layer["wv"]).reshape(b, s, heads, c.head_dim)
    attn = _attend(q, k, v, c.attention, False)
    attn = reduce_from(attn.reshape(b, s, heads * c.head_dim).to(x.dtype)
                       @ layer["wo"], attn_axis)
    x = x + g1[:, None, :] * attn

    h = _ada_ln(x, sh2, sc2, c.norm_eps).to(x.dtype)
    h = copy_to(h, mlp_axis)  # column-parallel w1, row-parallel w2
    y = reduce_from(gelu(h @ layer["w1"]) @ layer["w2"], mlp_axis)
    return x + g2[:, None, :] * y


def _dit_forward(params: Params, x_t, t, config: DiTConfig, labels,
                 plan: EncoderPlan):
    c = config
    x = _patchify(x_t.to(c.dtype), c) @ plan.leaf(params, "patch_embed")
    x = x + plan.leaf(params, "patch_bias") + plan.leaf(params, "pos_embed")

    temb = timestep_embedding(t, c.time_freq_dim).to(c.dtype)
    cond = F.silu(temb @ plan.leaf(params, "time_w1")
                  + plan.leaf(params, "time_b1"))
    cond = cond @ plan.leaf(params, "time_w2") + plan.leaf(params, "time_b2")
    if c.n_classes:
        lab = (torch.full((x.shape[0],), c.n_classes, dtype=torch.long,
                          device=x.device) if labels is None else labels)
        cond = cond + plan.leaf(params, "label_embed")[lab]

    block = remat_wrap(functools.partial(_dit_block, config=c, plan=plan),
                       c.remat)
    for i in range(n_layers_of(params["layers"])):
        x = block(_layer(params["layers"], i), x, cond)

    fmod = (cond @ plan.leaf(params, "final_mod_w")
            + plan.leaf(params, "final_mod_b")).to(x.dtype)
    shift, scale = torch.chunk(fmod, 2, dim=-1)
    x = _ada_ln(x, shift, scale, c.norm_eps).to(x.dtype)
    out = x @ plan.leaf(params, "final_w") + plan.leaf(params, "final_b")
    return _unpatchify(out.float(), c)


def _plan(params: Params, config: DiTConfig, mesh, rules) -> EncoderPlan:
    return encoder_plan(params, mesh, rules, config.n_heads, what="DiT")


def dit_forward(params: Params, x_t, t, config: DiTConfig, labels=None, *,
                mesh=None, rules: Optional[ShardingRules] = None):
    """x_t [B, H, W, C] noised input, t [B] in [0, 1], labels [B] int
    (n_classes = the null class) -> predicted noise [B, H, W, C] f32.
    With ``mesh`` and ``rules``, ``params`` are this rank's local shards
    and ``x_t``, ``t`` and ``labels`` its rows, and so is the output."""
    return _dit_forward(params, x_t, t, config, labels,
                        _plan(params, config, mesh, rules))


def cosine_alpha_sigma(t):
    """Continuous cosine schedule: alpha, sigma with alpha^2 + sigma^2 = 1."""
    angle = 0.5 * math.pi * t
    return torch.cos(angle), torch.sin(angle)


def draw_dit_noise(generator: Optional[torch.Generator], shape,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Every random draw of a ``dit_loss`` or ``dit_sample`` call, for a
    batch of ``shape`` [B, H, W, C]: ``t`` [B] uniform in
    [1e-4, 1 - 1e-4], ``eps`` [B, H, W, C] standard normal (the loss's
    target noise, or the sampler's start), ``drop`` [B] uniform in
    [0, 1) (label drop where below ``label_drop``), all f32."""
    dev = resolve_device(device)
    b = shape[0]
    t = torch.rand((b,), generator=generator, device=dev)
    return {"t": 1e-4 + (1.0 - 2e-4) * t,
            "eps": torch.randn(tuple(shape), generator=generator, device=dev),
            "drop": torch.rand((b,), generator=generator, device=dev)}


def dit_loss(params: Params, noise: Dict[str, torch.Tensor], x0,
             config: DiTConfig, labels=None, label_drop: float = 0.1, *,
             mesh=None, rules: Optional[ShardingRules] = None):
    """Continuous-time eps-prediction MSE with the draws ``noise``
    (:func:`draw_dit_noise` for x0's shape). With labels, each is
    dropped to the null class where ``noise["drop"] < label_drop``
    (classifier-free guidance training). With ``mesh`` and ``rules``,
    ``x0`` and ``labels`` are this rank's rows of the global batch,
    ``noise`` holds the global batch's draws, of which the rank takes
    its rows, and the loss is the global mean."""
    c = config
    plan = _plan(params, c, mesh, rules)
    axes = plan.batch_axes()
    if axes:
        rows = noise["t"].shape[0]
        if rows != x0.shape[0] * math.prod(a.size for a in axes):
            raise ValueError(f"draws for {rows} rows; a mesh's loss takes "
                             f"the global batch's draws, and x0 holds "
                             f"{x0.shape[0]} of its rows")
        noise = {k: local_rows(v, axes) for k, v in noise.items()}
    t, eps = noise["t"], noise["eps"]
    alpha, sigma = cosine_alpha_sigma(t)
    x_t = (alpha[:, None, None, None] * x0.float()
           + sigma[:, None, None, None] * eps)
    if c.n_classes and labels is not None and label_drop > 0:
        labels = torch.where(noise["drop"] < label_drop,
                             torch.full_like(labels, c.n_classes), labels)
    pred = _dit_forward(params, x_t, t, c, labels, plan)
    return global_mean((pred - eps) ** 2, axes)


def _linspace(start: float, stop: float, num: int, device):
    """``jnp.linspace``'s formula in f32: start * (1 - s) + stop * s
    at s = i / (num - 1), the last point ``stop`` itself."""
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    lo = torch.tensor(start, dtype=torch.float32, device=device)
    hi = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([lo * (1 - s) + hi * s, hi[None]])


@torch.no_grad()
def dit_sample(params: Params, noise: Dict[str, torch.Tensor],
               config: DiTConfig, n: int, steps: int = 50, labels=None,
               guidance_scale: float = 0.0, x0_clip: float = 4.0):
    """Deterministic DDIM sampler from the start noise ``noise["eps"]``
    [n, H, W, C] (:func:`draw_dit_noise`), from t = 0.99 to 1e-4 in
    ``steps`` steps. ``guidance_scale`` > 0 with labels runs a
    conditional and a null pass per step (classifier-free guidance);
    each step clips the denoised estimate to +-``x0_clip`` and
    re-derives eps from it."""
    c = config
    x = noise["eps"]
    want = (n, c.input_size, c.input_size, c.channels)
    if tuple(x.shape) != want:
        raise ValueError(f"start noise {tuple(x.shape)} != {want}")
    ts = _linspace(0.99, 1e-4, steps + 1, x.device)

    def eps_hat(x, t_vec):
        if guidance_scale > 0 and c.n_classes and labels is not None:
            e_c = dit_forward(params, x, t_vec, c, labels)
            e_u = dit_forward(params, x, t_vec, c, None)
            return e_u + (1.0 + guidance_scale) * (e_c - e_u)
        return dit_forward(params, x, t_vec, c, labels)

    for i in range(steps):
        t_now, t_next = ts[i], ts[i + 1]
        a_now, s_now = cosine_alpha_sigma(t_now)
        a_next, s_next = cosine_alpha_sigma(t_next)
        e = eps_hat(x, t_now.expand(n))
        x0 = torch.clamp((x - s_now * e) / a_now, -x0_clip, x0_clip)
        # re-derive eps from the clipped x0 so the update stays consistent
        e = (x - a_now * x0) / torch.clamp(s_now, min=1e-6)
        x = a_next * x0 + s_next * e
    return x


def dit_sharding_rules(mode: str = "fsdp") -> ShardingRules:
    """ddp | fsdp | tp | fsdp_tp: the ViT/CLIP family's mode table
    (leading axis = layers on the block weights)."""
    if mode == "ddp":
        return ShardingRules(rules=[(r".*", P())])
    spec_in, spec_out, embed = _mode_specs(mode)
    return ShardingRules(rules=[
        (r"patch_embed", embed),
        (r"layers/(wq|wk|wv|w1)", spec_in),
        (r"layers/(wo|w2)", spec_out),
        (r"layers/mod_w", spec_in),
        (r".*", P()),
    ])
