"""Vision Transformer and the CLIP dual encoder in PyTorch: a port of
ray_tpu/models/vit.py.

Parameters keep the reference's tree: the encoder layers stacked on a
leading n_layers axis, every projection stored [in, out] (``x @ W``),
so ``params_from_jax`` carries a JAX tree over without reshaping. The
layer loop is a Python loop over views of the stacks (the reference's
``lax.scan``); ``unstack_layers`` (models/llama.py) gives each layer
its own leaf tensors for training, and every function here takes both
forms.

Kernels on this path: with ``attention="flash"`` each block's attention
is K1 on the card (non-causal in the image tower, causal in the text
tower) and, under autograd, K2 and K3 in the backward
(ops/attention.py); ``"reference"`` runs the plain attention, as the
reference's config choice does. On the card the kernels take head_dim
64, 72 or 128 and raise otherwise. LayerNorm, the tanh GELU and the
patchify reshapes are PyTorch ops (jnp in the reference, with no Pallas
twin), and the products are ``torch.matmul``.

``vit_sharding_rules`` and ``clip_sharding_rules`` are the reference's
rules for these trees. With ``mesh`` and ``rules`` the forwards and
losses run on this rank's local shards (``parallel.sharding.
shard_pytree`` of the stacked tree) and this rank's rows of the batch
(over ``data`` x ``fsdp``, data major): each leaf is gathered where a
layer uses it, but for Megatron's pairs on ``model`` (column ``wq``,
``wk``, ``wv`` and row ``wo``; column ``w1`` and row ``w2``), whose
layers run on their shards with ``model`` dividing the heads
(parallel/_sharded.py). A loss is the global mean over the batch axes;
CLIP's gathers both towers' embeddings over them first
(``gather_rows``), so its loss is global on every rank as it stands.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import _layer, remat_wrap
from ray_tpu_torch.ops.attention import _attention_reference, flash_attention
from ray_tpu_torch.parallel._sharded import (
    Plan, copy_to, gather_rows, global_mean, reduce_from)
from ray_tpu_torch.parallel.sharding import P, ShardingRules

Params = Dict[str, Any]


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    n_classes: int = 0       # >0 adds a classifier head on the pooled rep
    pool: str = "mean"       # mean | cls
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    attention: str = "flash"  # flash | reference
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size * self.patch_size

    @property
    def seq_len(self) -> int:
        return self.n_patches + (1 if self.pool == "cls" else 0)

    # --- presets (the reference's, same shapes) ------------------------
    @staticmethod
    def base(**kw) -> "ViTConfig":
        return ViTConfig(**kw)  # ViT-B/16

    @staticmethod
    def large(**kw) -> "ViTConfig":
        defaults = dict(dim=1024, n_layers=24, n_heads=16,
                        hidden_dim=4096)
        defaults.update(kw)
        return ViTConfig(**defaults)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        """Test-scale config."""
        defaults = dict(image_size=16, patch_size=4, dim=32, n_layers=2,
                        n_heads=4, hidden_dim=64, dtype=torch.float32,
                        attention="reference", remat=False)
        defaults.update(kw)
        return ViTConfig(**defaults)

    def num_params(self) -> int:
        per_layer = (4 * self.dim * self.dim          # wq wk wv wo
                     + 2 * self.dim * self.hidden_dim  # w1 w2
                     + 4 * self.dim)                   # 2 LN scale+bias
        n = (self.patch_dim * self.dim + self.dim      # patch embed + b
             + self.seq_len * self.dim                 # pos embed
             + self.n_layers * per_layer
             + 2 * self.dim)                           # final LN
        if self.pool == "cls":
            n += self.dim
        if self.n_classes:
            n += self.dim * self.n_classes + self.n_classes
        return n


def layer_norm(x, scale, bias, eps: float):
    """LayerNorm in f32 with the biased variance, cast back to x's
    dtype (the reference's ``layer_norm``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


# jax.nn.gelu's default is the tanh approximation; PyTorch's is erf
gelu = functools.partial(F.gelu, approximate="tanh")


def patchify(images, config: ViTConfig):
    """[B, H, W, C] -> [B, n_patches, patch_dim] by reshapes."""
    b, h, w, ch = images.shape
    p = config.patch_size
    x = images.reshape(b, h // p, p, w // p, p, ch)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, Hp, Wp, p, p, C]
    return x.reshape(b, (h // p) * (w // p), p * p * ch)


def fan_in_init(gen: torch.Generator, shape, fan_in, dtype, std=None):
    """N(0, 1/fan_in) (or N(0, std^2)) drawn in f32 by ``gen`` on its
    device and cast to ``dtype``; a stacked shape [L, ...] is drawn one
    layer at a time, so the f32 copy of a whole stack never exists."""
    scale = fan_in ** -0.5 if std is None else std
    dev = gen.device

    def draw(s):
        return (torch.randn(s, generator=gen, device=dev) * scale).to(dtype)

    if len(shape) < 3:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=dev)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


def _encoder_layers_init(gen, L: int, D: int, H: int, dtype) -> Params:
    """The stacked pre-LN layer tree of the ViT and CLIP-text towers."""
    dev = gen.device

    def init(shape, fan_in):
        return fan_in_init(gen, shape, fan_in, dtype)

    def full(value):
        return torch.full((L, D), value, dtype=dtype, device=dev)

    return {
        "ln1_scale": full(1.0), "ln1_bias": full(0.0),
        "wq": init((L, D, D), D), "wk": init((L, D, D), D),
        "wv": init((L, D, D), D), "wo": init((L, D, D), D),
        "ln2_scale": full(1.0), "ln2_bias": full(0.0),
        "w1": init((L, D, H), D), "w2": init((L, H, D), H),
    }


def _attend(q, k, v, attention: str, causal: bool):
    """The configured attention over [B, S, H, D]: the flash path (K1,
    and K2/K3 under autograd, on the card) or the plain version."""
    if attention == "flash":
        return flash_attention(q, k, v, causal)
    return _attention_reference(q, k, v, causal)


# Megatron's pairs of an encoder layer on the model axis: (column, row)
ATTN_PAIR = (("wq", "wk", "wv"), ("wo",))
MLP_PAIR = (("w1",), ("w2",))


class EncoderPlan(Plan):
    """The shared plan with an encoder's two pairs: ``attn_model`` and
    ``mlp_model`` are the model axis where the rules split the pair on
    it (the layers then run on their shards), else None."""

    def __init__(self, layout=None, specs=None, n_heads: int = 1,
                 what: str = "encoder"):
        super().__init__(layout, specs)
        self.attn_model = self.mlp_model = None
        if specs is None:
            return
        if layout.size("seq") > 1:
            raise ValueError(f"{what}: a seq axis of {layout.size('seq')}; "
                             "the vision and diffusion models split the "
                             "batch only")
        self.attn_model = self.split_pair(ATTN_PAIR)
        if self.attn_model is not None and n_heads % self.attn_model.size:
            raise ValueError(f"{what}: the model axis "
                             f"({self.attn_model.size}) must divide n_heads "
                             f"({n_heads})")
        self.mlp_model = self.split_pair(MLP_PAIR)


def encoder_plan(params: Params, mesh, rules: Optional[ShardingRules],
                 n_heads: int, prefix: str = "", what: str = "encoder"
                 ) -> EncoderPlan:
    """The plan of one tower (its tree under ``prefix`` in the rules'
    paths): :class:`EncoderPlan` on ``mesh``, or the whole-parameter one
    without a mesh."""
    if mesh is None:
        return EncoderPlan()
    device = params["pos_embed"].device
    return EncoderPlan.for_mesh(mesh, rules, params, device, prefix,
                                n_heads=n_heads, what=what)


def _encoder_block(layer: Params, x, *, n_heads: int, norm_eps: float,
                   attention: str, causal: bool, plan: EncoderPlan):
    """One pre-LN block: LN -> MHA -> residual -> LN -> GELU MLP ->
    residual. ``plan`` gathers the layer's leaves (on a mesh) and names
    the model axis of each pair (None: whole)."""
    b, s, d = x.shape
    hd = d // n_heads
    layer = plan.layer(layer)
    attn_axis, mlp_axis = plan.attn_model, plan.mlp_model
    heads = n_heads if attn_axis is None else n_heads // attn_axis.size
    h = layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], norm_eps)
    h = copy_to(h, attn_axis)  # column-parallel wq / wk / wv
    q = (h @ layer["wq"]).reshape(b, s, heads, hd)
    k = (h @ layer["wk"]).reshape(b, s, heads, hd)
    v = (h @ layer["wv"]).reshape(b, s, heads, hd)
    attn = _attend(q, k, v, attention, causal)
    x = x + reduce_from(attn.reshape(b, s, heads * hd).to(x.dtype)
                        @ layer["wo"], attn_axis)
    h = layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], norm_eps)
    h = copy_to(h, mlp_axis)  # column-parallel w1, row-parallel w2
    return x + reduce_from(gelu(h @ layer["w1"]) @ layer["w2"], mlp_axis)


def n_layers_of(layers) -> int:
    """Depth of a layer tree, stacked (dict) or unstacked (list)."""
    if isinstance(layers, list):
        return len(layers)
    return next(iter(layers.values())).shape[0]


def _encoder_scan(layers, x, *, n_heads: int, norm_eps: float,
                  attention: str, causal: bool, remat: bool,
                  plan: EncoderPlan):
    block = remat_wrap(functools.partial(
        _encoder_block, n_heads=n_heads, norm_eps=norm_eps,
        attention=attention, causal=causal, plan=plan), remat)
    for i in range(n_layers_of(layers)):
        x = block(_layer(layers, i), x)
    return x


def vit_init(seed: int, config: ViTConfig, device: DeviceLike = None
             ) -> Params:
    """Random parameters from a seed (a ``torch.Generator`` on
    ``device``), the reference's tree and initialisers. The bits differ
    from ``jax.random``'s; ``params_from_jax`` carries JAX weights
    over."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D = c.dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=c.dtype, device=dev)

    params = {
        "patch_embed": fan_in_init(gen, (c.patch_dim, D), c.patch_dim,
                                   c.dtype),
        "patch_bias": zeros(D),
        "pos_embed": fan_in_init(gen, (c.seq_len, D), None, c.dtype,
                                 std=0.02),
        "layers": _encoder_layers_init(gen, c.n_layers, D, c.hidden_dim,
                                       c.dtype),
        "final_ln_scale": torch.ones((D,), dtype=c.dtype, device=dev),
        "final_ln_bias": zeros(D),
    }
    if c.pool == "cls":
        params["cls_token"] = zeros(D)
    if c.n_classes:
        params["head_w"] = fan_in_init(gen, (D, c.n_classes), D, c.dtype)
        params["head_b"] = zeros(c.n_classes)
    return params


def _vit_forward(params: Params, images, config: ViTConfig,
                 return_pooled: bool, plan: EncoderPlan):
    c = config
    x = patchify(images.to(c.dtype), c) @ plan.leaf(params, "patch_embed")
    x = x + plan.leaf(params, "patch_bias")
    if c.pool == "cls":
        cls = plan.leaf(params, "cls_token").expand(x.shape[0], 1, c.dim)
        x = torch.cat([cls, x], dim=1)
    x = x + plan.leaf(params, "pos_embed")
    x = _encoder_scan(params["layers"], x, n_heads=c.n_heads,
                      norm_eps=c.norm_eps, attention=c.attention,
                      causal=False, remat=c.remat, plan=plan)
    x = layer_norm(x, plan.leaf(params, "final_ln_scale"),
                   plan.leaf(params, "final_ln_bias"), c.norm_eps)
    pooled = x[:, 0] if c.pool == "cls" else x.mean(1)
    if c.n_classes and not return_pooled:
        return (pooled @ plan.leaf(params, "head_w")
                + plan.leaf(params, "head_b")).float()
    return pooled


def vit_forward(params: Params, images, config: ViTConfig,
                return_pooled: bool = False, *, mesh=None,
                rules: Optional[ShardingRules] = None):
    """images [B, H, W, C] -> logits [B, n_classes] f32 (with a head)
    or the pooled representation [B, dim]; ``return_pooled`` forces the
    pooled rep even with a head (the CLIP tower). With ``mesh`` and
    ``rules``, ``params`` are this rank's local shards and ``images``
    its rows, and so are the outputs (see the module docstring)."""
    plan = encoder_plan(params, mesh, rules, config.n_heads, what="ViT")
    return _vit_forward(params, images, config, return_pooled, plan)


def vit_loss(params: Params, images, labels, config: ViTConfig, *,
             mesh=None, rules: Optional[ShardingRules] = None):
    """Softmax cross-entropy for supervised classification; with
    ``mesh`` and ``rules``, the mean over the global batch of which
    ``images`` and ``labels`` are this rank's rows."""
    plan = encoder_plan(params, mesh, rules, config.n_heads, what="ViT")
    logits = _vit_forward(params, images, config, False, plan)
    logp = torch.log_softmax(logits, dim=-1)
    return global_mean(-logp.gather(-1, labels[:, None].long()),
                       plan.batch_axes())


# mode -> (layer in-projection, layer out-projection, embedding) specs;
# shared by vit_sharding_rules, clip_sharding_rules and
# dit_sharding_rules (layer specs have a leading None for the stacked
# axis).
_MODE_SPECS = {
    "fsdp": (P(None, "fsdp", None), P(None, None, "fsdp"),
             P("fsdp", None)),
    "tp": (P(None, None, "model"), P(None, "model", None),
           P(None, "model")),
    "fsdp_tp": (P(None, "fsdp", "model"), P(None, "model", "fsdp"),
                P("fsdp", "model")),
}


def _mode_specs(mode: str):
    if mode not in _MODE_SPECS:
        raise ValueError(f"unknown sharding mode {mode}")
    return _MODE_SPECS[mode]


def vit_sharding_rules(mode: str = "fsdp") -> ShardingRules:
    """ddp | fsdp | tp | fsdp_tp over the stacked-layer tree (leading
    axis = layers, like llama_sharding_rules)."""
    if mode == "ddp":
        return ShardingRules(rules=[(r".*", P())])
    spec_in, spec_out, embed = _mode_specs(mode)
    return ShardingRules(rules=[
        (r"patch_embed", embed),
        (r"layers/(wq|wk|wv|w1)", spec_in),
        (r"layers/(wo|w2)", spec_out),
        # classifier head [D, n_classes]: the embedding's layout
        (r"head_w", embed),
        (r".*", P()),
    ])


# ---------------------------------------------------------------------------
# CLIP dual encoder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_seq_len: int = 77
    dim: int = 512
    n_layers: int = 12
    n_heads: int = 8
    hidden_dim: int = 2048
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    attention: str = "flash"
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**kw) -> "CLIPTextConfig":
        defaults = dict(vocab_size=128, max_seq_len=16, dim=32,
                        n_layers=2, n_heads=4, hidden_dim=64,
                        dtype=torch.float32, attention="reference",
                        remat=False)
        defaults.update(kw)
        return CLIPTextConfig(**defaults)


@dataclass(frozen=True)
class CLIPConfig:
    vision: ViTConfig = field(default_factory=ViTConfig)
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    embed_dim: int = 512
    # learnable temperature, stored as its log
    logit_scale_init: float = 2.6592  # log(1/0.07), the CLIP paper value

    @staticmethod
    def tiny(**kw) -> "CLIPConfig":
        defaults = dict(vision=ViTConfig.tiny(), text=CLIPTextConfig.tiny(),
                        embed_dim=16)
        defaults.update(kw)
        return CLIPConfig(**defaults)


def _text_init(gen: torch.Generator, c: CLIPTextConfig) -> Params:
    D = c.dim
    return {
        "embedding": fan_in_init(gen, (c.vocab_size, D), None, c.dtype,
                                 std=0.02),
        "pos_embed": fan_in_init(gen, (c.max_seq_len, D), None, c.dtype,
                                 std=0.01),
        "layers": _encoder_layers_init(gen, c.n_layers, D, c.hidden_dim,
                                       c.dtype),
        "final_ln_scale": torch.ones((D,), dtype=c.dtype, device=gen.device),
        "final_ln_bias": torch.zeros((D,), dtype=c.dtype, device=gen.device),
    }


def _text_forward(params: Params, tokens, c: CLIPTextConfig,
                  plan: EncoderPlan):
    """Causal text tower -> the rep at the final position (EOS last)."""
    s = tokens.shape[1]
    x = plan.leaf(params, "embedding")[tokens].to(c.dtype)
    x = x + plan.leaf(params, "pos_embed")[:s]
    x = _encoder_scan(params["layers"], x, n_heads=c.n_heads,
                      norm_eps=c.norm_eps, attention=c.attention,
                      causal=True, remat=c.remat, plan=plan)
    x = layer_norm(x, plan.leaf(params, "final_ln_scale"),
                   plan.leaf(params, "final_ln_bias"), c.norm_eps)
    return x[:, -1]


def clip_init(seed: int, config: CLIPConfig, device: DeviceLike = None
              ) -> Params:
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "vision": vit_init(seed + 1, c.vision, dev),
        "text": _text_init(gen, c.text),
        "proj_v": fan_in_init(gen, (c.vision.dim, c.embed_dim),
                              c.vision.dim, c.vision.dtype),
        "proj_t": fan_in_init(gen, (c.text.dim, c.embed_dim), c.text.dim,
                              c.text.dtype),
        "logit_scale": torch.tensor(c.logit_scale_init,
                                    dtype=torch.float32, device=dev),
    }


def _unit(emb):
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


class _CLIPPlan:
    """A CLIP forward's plans: one per tower (their paths under
    ``vision/`` and ``text/``) and one for the projections."""

    def __init__(self, params: Params, config: CLIPConfig, mesh, rules):
        self.vision = encoder_plan(params["vision"], mesh, rules,
                                   config.vision.n_heads, "vision/",
                                   "CLIP's image tower")
        self.text = encoder_plan(params["text"], mesh, rules,
                                 config.text.n_heads, "text/",
                                 "CLIP's text tower")
        projections = {k: params[k] for k in ("proj_v", "proj_t")}
        self.top = (Plan() if mesh is None else Plan.for_mesh(
            mesh, rules, projections, params["proj_v"].device))


def _encode_image(params, images, config: CLIPConfig, plan: _CLIPPlan):
    rep = _vit_forward(params["vision"], images, config.vision, True,
                       plan.vision)
    return _unit((rep @ plan.top.leaf(params, "proj_v")).float())


def _encode_text(params, tokens, config: CLIPConfig, plan: _CLIPPlan):
    rep = _text_forward(params["text"], tokens, config.text, plan.text)
    return _unit((rep @ plan.top.leaf(params, "proj_t")).float())


def clip_encode_image(params: Params, images, config: CLIPConfig, *,
                      mesh=None, rules: Optional[ShardingRules] = None):
    """Unit image embeddings [B, embed_dim] f32; with ``mesh`` and
    ``rules``, of this rank's rows ``images`` from its local shards."""
    return _encode_image(params, images, config,
                         _CLIPPlan(params, config, mesh, rules))


def clip_encode_text(params: Params, tokens, config: CLIPConfig, *,
                     mesh=None, rules: Optional[ShardingRules] = None):
    """Unit text embeddings [B, embed_dim] f32; with ``mesh`` and
    ``rules``, of this rank's rows ``tokens`` from its local shards."""
    return _encode_text(params, tokens, config,
                        _CLIPPlan(params, config, mesh, rules))


def clip_loss(params: Params, images, tokens, config: CLIPConfig, *,
              mesh=None, rules: Optional[ShardingRules] = None):
    """Symmetric InfoNCE over in-batch negatives (the CLIP objective),
    the temperature's log clipped to [-5, 4.6052]. With ``mesh`` and
    ``rules``, ``images`` and ``tokens`` are this rank's rows: both
    towers' embeddings are gathered over the batch axes for the global
    [B, B] logits (``gather_rows``, whose backward hands each rank its
    rows' gradient), so the loss is the global one on every rank."""
    plan = _CLIPPlan(params, config, mesh, rules)
    axes = plan.top.batch_axes()
    img = gather_rows(_encode_image(params, images, config, plan), axes)
    txt = gather_rows(_encode_text(params, tokens, config, plan), axes)
    # used whole after the gather: its gradient is the global one on every
    # rank already, so it takes no sum over the batch axes
    scale = torch.exp(torch.clamp(params["logit_scale"], -5.0, 4.6052))
    logits = scale * (img @ txt.T)  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)[:, None]
    li = -torch.log_softmax(logits, dim=-1).gather(1, labels).mean()
    lt = -torch.log_softmax(logits.T, dim=-1).gather(1, labels).mean()
    return 0.5 * (li + lt)


def clip_sharding_rules(mode: str = "fsdp") -> ShardingRules:
    """One rule set over the combined {vision, text, proj_*} tree: the
    tower rules are path-prefixed copies of vit_sharding_rules."""
    if mode == "ddp":
        return ShardingRules(rules=[(r".*", P())])
    in_s, out_s, emb = _mode_specs(mode)
    return ShardingRules(rules=[
        (r"(vision|text)/layers/(wq|wk|wv|w1)", in_s),
        (r"(vision|text)/layers/(wo|w2)", out_s),
        (r"vision/patch_embed", emb),
        (r"text/embedding", emb),
        (r"proj_(v|t)", emb),
        (r".*", P()),
    ])
