"""Llama-family decoder (Llama-2/3 architecture) in PyTorch: a port of
ray_tpu/models/llama.py for serving and training.

Parameters keep the reference's stacked layout, a plain dict with every
per-layer weight stacked on a leading n_layers axis and every
projection stored [in, out] (``x @ W``), so a JAX parameter tree crosses
over without reshaping (models/convert.py). The layer loop is a Python
loop over views of those stacks (the reference's ``lax.scan``). For
training, :func:`unstack_layers` turns the stacks into one dict of leaf
tensors per layer, so that each layer's grads land in their own tensors
(the backward of a view ``stack[i]`` would build a zero tensor the size
of the whole stack for every layer); every function here takes both
forms.

Kernels on this path: RMSNorm (K4), flash-attention forward (K1) and,
under autograd, its backward (K2, K3), and the weight-only int8 matmul
in every FFN when the FFN is quantized (K5, serving only). The remaining
large matrix products go to ``torch.matmul``, as the reference leaves
them to XLA. Attention over the cache (the decode step and the chunk
verify step) and the LoRA deltas are plain PyTorch, as in the
reference. With ``moe_experts`` set, every FFN (training, prefill,
decode and verify alike) is the mixture-of-experts layer of
parallel/moe.py, whose einsums are ``torch.einsum``.

Sequence parallelism: with ``attention="ring"`` or ``"ulysses"``,
:func:`llama_forward` and :func:`llama_loss` take a ``torch.distributed``
group where the reference takes its mesh, and ``tokens`` / ``targets``
are this rank's contiguous shard of the sequence. RoPE rotates the
shard at its global positions, attention runs through
parallel/ring_attention.py (K1-K3 on every block), and the loss divides
by the group's token count, so every rank returns the global loss; its
grads are this rank's share, which the training step sums over the
group. An MoE FFN routes the group's tokens as one set (parallel/moe.py).

Sharded parameters: with ``mesh=`` (a ``DeviceMesh`` from
``parallel.mesh.make_mesh``) and ``rules=`` (:func:`llama_sharding_rules`),
``params`` is this rank's local shards (``parallel.sharding.shard_pytree``
of the stacked tree, unstacked for training) and ``tokens`` / ``targets``
this rank's shard of the batch: rows split over ``data`` and ``fsdp``
(data major), positions over ``seq`` (ring or Ulysses attention),
replicated over ``model`` and ``expert``. Each leaf is gathered where a
layer uses it (parallel/_sharded.py), but for the Megatron pairs on
``model``: wq / wk / wv and w1 / w3 are column-parallel (K1-K3 run on the
rank's H / m query and KVH / m KV heads), wo and w2 row-parallel with an
all-reduce after each; and for the expert stacks on ``expert``, which
stay local (expert parallelism, parallel/moe.py). The loss is the global
token mean on every rank, and after its backward each leaf's gradient is
the same slice of the unsharded gradient: the sums over the token axes
run inside the backward.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import _attention_reference, flash_attention
from ray_tpu_torch.ops.quant_matmul import int8_matmul, quantize_int8
from ray_tpu_torch.ops.rmsnorm import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies
from ray_tpu_torch.parallel import _group
from ray_tpu_torch.parallel._sharded import (
    REPLICATED, Layout, Plan, all_reduce, copy_to, global_value, leaf_specs,
    reduce_from)
from ray_tpu_torch.parallel.moe import moe_ffn
from ray_tpu_torch.parallel.ring_attention import (
    ring_attention, ulysses_attention)
from ray_tpu_torch.parallel.sharding import P, ShardingRules

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attention: str = "flash"  # flash | reference | ring | ulysses
    # Recompute each block in the backward (the reference's
    # jax.checkpoint): only block inputs stay alive between the passes.
    remat: bool = True
    # Chunked cross-entropy: tokens per chunk (0 = dense loss), so the
    # [B, S, vocab] f32 logits never exist (chunked_cross_entropy).
    ce_chunk_tokens: int = 0
    # Mixture-of-Experts: >0 replaces the dense FFN with moe_experts
    # expert FFNs routed top-k (parallel/moe.py), expert-parallel over
    # the "expert" mesh axis.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    # weight of the Switch-style load-balancing aux loss (per layer)
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    # --- presets (the reference's, same shapes) ------------------------
    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, hidden_dim=14336,
                           max_seq_len=8192, rope_theta=500000.0, **kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config."""
        defaults = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                        dtype=torch.float32, attention="reference",
                        remat=False)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def mixtral_8x7b(**kw) -> "LlamaConfig":
        """Mixtral-8x7B shape: 8-expert top-2 SwiGLU MoE on a
        Mistral-7B trunk (GQA 8 KV heads)."""
        defaults = dict(vocab_size=32000, dim=4096, n_layers=32,
                        n_heads=32, n_kv_heads=8, hidden_dim=14336,
                        max_seq_len=32768, rope_theta=1e6,
                        moe_experts=8, moe_top_k=2)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def tiny_moe(**kw) -> "LlamaConfig":
        """Test-scale MoE config."""
        defaults = dict(moe_experts=4, moe_top_k=2)
        defaults.update(kw)
        return LlamaConfig.tiny(**defaults)

    @staticmethod
    def small_1b(**kw) -> "LlamaConfig":
        defaults = dict(vocab_size=32000, dim=2048, n_layers=16,
                        n_heads=16, n_kv_heads=16, hidden_dim=5504,
                        max_seq_len=2048)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    def num_params(self) -> int:
        hd = self.head_dim
        ffn_copies = max(1, self.moe_experts)
        per_layer = (
            self.dim * self.n_heads * hd          # wq
            + 2 * self.dim * self.n_kv_heads * hd  # wk, wv
            + self.n_heads * hd * self.dim         # wo
            + ffn_copies * 3 * self.dim * self.hidden_dim  # w1, w2, w3
            + (self.dim * self.moe_experts if self.moe_experts else 0)
            + 2 * self.dim                         # norms
        )
        return (self.vocab_size * self.dim * 2     # embedding + lm_head
                + self.n_layers * per_layer + self.dim)

    def active_params_per_token(self) -> int:
        total = self.num_params()
        if self.moe_experts:
            inactive = ((self.moe_experts - min(self.moe_top_k,
                                                self.moe_experts))
                        * 3 * self.dim * self.hidden_dim * self.n_layers)
            total -= inactive
        return total

    def flops_per_token(self) -> float:
        """Approx training FLOPs/token (6 * active params)."""
        return 6.0 * self.active_params_per_token()


def llama_init(seed: int, config: LlamaConfig,
               device: DeviceLike = None) -> Params:
    """Random parameters from a seed, drawn by a ``torch.Generator`` on
    ``device``, layers stacked on axis 0, each weight N(0, 1/fan_in) in
    the model dtype. Each layer's slice is drawn in f32 and cast on its own, so
    the f32 copy of a whole stack never exists. The bits differ from
    ``jax.random``; ``params_from_jax`` carries JAX weights over. An MoE
    config stacks its expert FFNs as [L, E, ...] beside a router
    [L, D, E], as the reference does."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hd = c.head_dim

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * fan_in ** -0.5).to(c.dtype)

    def stack(shape, fan_in):
        out = torch.empty((c.n_layers, *shape), dtype=c.dtype, device=dev)
        for i in range(c.n_layers):
            out[i] = dense(shape, fan_in)
        return out

    layers: Params = {
        "attn_norm": torch.ones((c.n_layers, c.dim), dtype=c.dtype,
                                device=dev),
        "wq": stack((c.dim, c.n_heads * hd), c.dim),
        "wk": stack((c.dim, c.n_kv_heads * hd), c.dim),
        "wv": stack((c.dim, c.n_kv_heads * hd), c.dim),
        "wo": stack((c.n_heads * hd, c.dim), c.n_heads * hd),
        "mlp_norm": torch.ones((c.n_layers, c.dim), dtype=c.dtype,
                               device=dev),
    }
    experts = (c.moe_experts,) if c.moe_experts else ()
    if c.moe_experts:
        layers["router"] = stack((c.dim, c.moe_experts), c.dim)
    layers["w1"] = stack((*experts, c.dim, c.hidden_dim), c.dim)
    layers["w3"] = stack((*experts, c.dim, c.hidden_dim), c.dim)
    layers["w2"] = stack((*experts, c.hidden_dim, c.dim), c.hidden_dim)
    return {
        "embedding": dense((c.vocab_size, c.dim), c.dim),
        "layers": layers,
        "final_norm": torch.ones((c.dim,), dtype=c.dtype, device=dev),
        "lm_head": dense((c.dim, c.vocab_size), c.dim),
    }


def _layer(layers, i: int) -> Params:
    """Layer i's parameters: its dict when the layers are unstacked,
    else views into the stacks."""
    if isinstance(layers, list):
        return layers[i]
    return {name: stack[i] for name, stack in layers.items()}


def remat_wrap(block, remat: bool):
    """``block`` under ``torch.utils.checkpoint`` when ``remat`` is set
    and grad is on (the reference's ``jax.checkpoint``): the backward
    recomputes the block, and only its inputs stay alive between the
    passes."""
    if remat and torch.is_grad_enabled():
        return functools.partial(checkpoint, block, use_reentrant=False)
    return block


def unstack_layers(params: Params) -> Params:
    """``params`` with ``"layers"`` as a list of per-layer dicts of leaf
    tensors (copies), one per layer; the other entries are shared. The
    training step keeps this form (see the module docstring)."""
    layers = params["layers"]
    n = next(iter(layers.values())).shape[0]
    unstacked: List[Params] = [{} for _ in range(n)]
    for name, stack in layers.items():
        for i in range(n):
            unstacked[i][name] = stack[i].clone()
    return {**params, "layers": unstacked}


def stack_layers(params: Params) -> Params:
    """The inverse of :func:`unstack_layers`: per-layer dicts back to
    [n_layers, ...] stacks."""
    layers = params["layers"]
    stacked = {name: torch.stack([lp[name].detach() for lp in layers])
               for name in layers[0]}
    return {**params, "layers": stacked}


SEQ_PARALLEL = ("ring", "ulysses")


def _attention(q, k, v, config: LlamaConfig, group=None):
    """Dispatch to the configured attention implementation. K/V keep
    their KV heads: every path groups the query heads over them (Ulysses
    repeats them when the group does not divide them)."""
    if config.attention == "flash":
        return flash_attention(q, k, v, True)
    if config.attention == "ring":
        return ring_attention(q, k, v, group, causal=True)
    if config.attention == "ulysses":
        return ulysses_attention(q, k, v, group, causal=True)
    if config.attention == "reference":
        return _attention_reference(q, k, v, True)
    raise ValueError(f"unknown attention {config.attention!r}")


def _int8_mm(x2d, w8, scale):
    """x2d @ dequant(w8, scale) in x2d's dtype, as the reference's
    ``_int8_mm``: off the CPU, K5 takes x in bf16 (a no-op cast for a bf16
    model) and its bf16 result is cast back; on the CPU the plain version
    computes in x's dtype."""
    if x2d.device.type == "cpu":
        return int8_matmul(x2d, w8, scale)
    return int8_matmul(x2d.to(torch.bfloat16), w8, scale).to(x2d.dtype)


def _ffn(layer_params: Params, h, config: LlamaConfig, plan=None):
    """FFN output (pre-residual): dense SwiGLU, its weight-only int8
    form through ``int8_matmul`` (kernel K5 on the card, its plain
    version on the CPU), or the MoE layer. Returns (y, aux); aux is the
    MoE load-balancing loss, 0 for a dense FFN. ``plan``: the
    :class:`_Plan` of a sharded or sequence-parallel forward."""
    c = config
    if c.moe_experts:
        return moe_ffn(h, layer_params["router"], layer_params["w1"],
                       layer_params["w3"], layer_params["w2"],
                       top_k=c.moe_top_k,
                       capacity_factor=c.moe_capacity_factor,
                       **({} if plan is None else plan.moe_axes()))
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if "w1_q8" in layer_params:
        b_t = h.shape[:-1]
        h2 = h.reshape(-1, h.shape[-1])
        gate = F.silu(_int8_mm(h2, layer_params["w1_q8"],
                               layer_params["w1_s"]))
        up = _int8_mm(h2, layer_params["w3_q8"], layer_params["w3_s"])
        y = _int8_mm((gate * up).to(h.dtype), layer_params["w2_q8"],
                     layer_params["w2_s"])
        return y.reshape(*b_t, -1).to(h.dtype), zero
    axis = None if plan is None else plan.ffn_model
    h = copy_to(h, axis)  # column-parallel w1 / w3, row-parallel w2
    gate = F.silu(h @ layer_params["w1"])
    up = h @ layer_params["w3"]
    return reduce_from((gate * up) @ layer_params["w2"], axis), zero


def quantize_llama_ffn(params: Params, config: LlamaConfig) -> Params:
    """Weight-only int8 for the stacked FFN weights: each [L, K, N]
    stack becomes an int8 stack plus per-output-channel scales [L, N].
    Layers quantize one at a time, so the f32 copy of a whole stack is
    never built. Attention projections and lm_head stay as they are."""
    if config.moe_experts:
        raise ValueError("int8 quantization supports dense FFNs only "
                         "(MoE expert stacks are not wired)")
    layers = dict(params["layers"])
    for name in ("w1", "w3", "w2"):
        if name not in layers:
            raise ValueError(f"params missing FFN stack {name!r}")
        stack = layers.pop(name)
        n_layers, k, n = stack.shape
        w8 = torch.empty((n_layers, k, n), dtype=torch.int8,
                         device=stack.device)
        scale = torch.empty((n_layers, n), dtype=torch.float32,
                            device=stack.device)
        for i in range(n_layers):
            w8[i], scale[i] = quantize_int8(stack[i])
        layers[name + "_q8"] = w8
        layers[name + "_s"] = scale
    return {**params, "layers": layers}


def _block(layer_params: Params, x, cos, sin, config: LlamaConfig,
           lora=None, group=None, plan=None):
    """One transformer block. Returns (x, (k, v), aux); K/V are
    post-rope, the layout the KV cache stores. ``lora``: optional
    (A_q, B_q, A_v, B_v, scale) low-rank deltas on the q and v
    projections; ``group``: the sequence-parallel group; ``plan``: the
    :class:`_Plan` of a sharded or sequence-parallel forward, which
    gathers the layer's leaves and runs the Megatron pairs."""
    c = config
    b, s, _ = x.shape
    hd = c.head_dim
    axis = None
    if plan is not None:
        if lora is not None:
            raise ValueError("LoRA deltas on sharded parameters are not "
                             "wired")
        layer_params = plan.layer(layer_params)
        axis = plan.attn_model
    m = 1 if axis is None else axis.size
    h = rms_norm(x, layer_params["attn_norm"], c.norm_eps)
    hq = copy_to(h, axis)  # column-parallel wq / wk / wv
    q = hq @ layer_params["wq"]
    k = hq @ layer_params["wk"]
    v = hq @ layer_params["wv"]
    if lora is not None:
        a_q, b_q, a_v, b_v, scale = lora
        q = q + scale * _lora_delta(h, a_q, b_q)
        v = v + scale * _lora_delta(h, a_v, b_v)
    q = q.reshape(b, s, c.n_heads // m, hd)
    k = k.reshape(b, s, c.n_kv_heads // m, hd)
    v = v.reshape(b, s, c.n_kv_heads // m, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = _attention(q, k, v, c, group)
    x = x + reduce_from(attn.reshape(b, s, -1) @ layer_params["wo"], axis)
    h = rms_norm(x, layer_params["mlp_norm"], c.norm_eps)
    y, aux = _ffn(layer_params, h, c, plan)
    return x + y, (k, v), aux


def _embed(params: Params, tokens, config: LlamaConfig):
    return params["embedding"][tokens].to(config.dtype)


def _seq_group(config: LlamaConfig, group, device):
    """(group, rank, size) of the sequence-parallel group; world 1 for
    the single-device attentions, which take no group."""
    if config.attention not in SEQ_PARALLEL:
        if group is not None:
            raise ValueError(f"attention={config.attention!r} takes no "
                             f"group; sequence parallelism is "
                             f"{SEQ_PARALLEL}")
        return None, 0, 1
    return _group.resolve(group, device)


# The layer leaves of Megatron's pairs on the model axis: column-parallel
# (the output dimension split), then row-parallel (the input dimension)
_ATTN_PAIR = (("wq", "wk", "wv"), ("wo",))
_FFN_PAIR = (("w1", "w3"), ("w2",))


class _Plan(Plan):
    """How one forward runs: its sequence group (ring or Ulysses), and
    with a mesh the shared :class:`~ray_tpu_torch.parallel._sharded.Plan`
    with Llama's pairs, head check and expert axis. Without either,
    every leaf is used as it is."""

    def __init__(self, config: LlamaConfig, seq, layout=None, specs=None):
        super().__init__(layout, specs)
        self.seq_group, self.seq_rank, self.seq_n = seq
        self.attn_model = self.ffn_model = self.expert = None
        if specs is None:
            return
        self.attn_model = self.split_pair(_ATTN_PAIR)
        model = self.attn_model
        if model is not None and (config.n_heads % model.size
                                  or config.n_kv_heads % model.size):
            raise ValueError(
                f"the model axis ({model.size}) must divide n_heads "
                f"({config.n_heads}) and n_kv_heads ({config.n_kv_heads})")
        if not config.moe_experts:
            self.ffn_model = self.split_pair(_FFN_PAIR)
        expert = layout.split("expert")
        if config.moe_experts and expert is not None and all(
                self.on(n, 0, "expert") for n in ("w1", "w3", "w2")):
            self.expert = expert
            self.local.update(dict.fromkeys(("w1", "w3", "w2"),
                                            ("expert",)))

    def moe_axes(self) -> Dict[str, Any]:
        if self.layout is None:
            return {}
        return dict(batch_axes=self.layout.batch_axes(),
                    seq_axis=self.layout.split("seq"),
                    expert_axis=self.expert)


def _plan(config: LlamaConfig, group, mesh, rules, params: Params) -> _Plan:
    device = params["lm_head"].device
    if mesh is None:
        seq = _seq_group(config, group, device)
        layout = None if seq[0] is None else Layout.from_group(seq[0],
                                                               device)
        return _Plan(config, seq, layout)
    if group is not None:
        raise ValueError("pass a mesh or a sequence group, not both")
    layout = Layout.from_mesh(mesh, device)
    layout.check()
    seq = layout.axes["seq"]
    if config.attention not in SEQ_PARALLEL and seq.size > 1:
        raise ValueError(f"a seq axis of {seq.size} needs ring or Ulysses "
                         f"attention, not {config.attention!r}")
    specs = leaf_specs(params, rules or REPLICATED)
    return _Plan(config, (seq.group, seq.rank, seq.size), layout, specs)


def _forward(params: Params, tokens, config: LlamaConfig, plan: _Plan,
             return_hidden: bool):
    c = config
    x = plan.leaf(params, "embedding")[tokens].to(c.dtype)
    s, rank, n = tokens.shape[1], plan.seq_rank, plan.seq_n
    cos, sin = rope_frequencies(c.head_dim, n * s, c.rope_theta,
                                device=x.device)
    cos, sin = cos[rank * s:(rank + 1) * s], sin[rank * s:(rank + 1) * s]
    block = remat_wrap(functools.partial(
        _block, group=plan.seq_group,
        plan=None if plan.layout is None else plan), c.remat)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(c.n_layers):
        x, _kv, aux = block(_layer(params["layers"], i), x, cos, sin, c)
        aux_sum = aux_sum + aux
    x = rms_norm(x, plan.leaf(params, "final_norm"), c.norm_eps)
    if return_hidden:
        return x, aux_sum
    return (x @ plan.leaf(params, "lm_head")).float(), aux_sum


def llama_forward(params: Params, tokens, config: LlamaConfig, group=None,
                  return_aux: bool = False, return_hidden: bool = False, *,
                  mesh=None, rules: Optional[ShardingRules] = None):
    """tokens: [B, S] int -> logits [B, S, vocab] (float32), differentiable.
    With return_aux, also returns the MoE load-balancing loss summed over
    the layers (0 for dense FFNs). With return_hidden, returns the
    final-norm hidden states INSTEAD of logits (chunked_cross_entropy
    applies lm_head chunk by chunk). With ``config.remat`` and grad
    enabled, each block runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward. With ring or Ulysses attention, tokens
    are this rank's shard [B, S / n] of a sequence sharded over
    ``group``; with ``mesh`` and ``rules``, ``params`` and ``tokens`` are
    this rank's shards (see the module docstring)."""
    out, aux = _forward(params, tokens, config,
                        _plan(config, group, mesh, rules, params),
                        return_hidden)
    return (out, aux) if return_aux else out


def _ce_chunk(h, lm_head, t, m):
    logits = (h @ lm_head).float()                       # [chunk, V]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, t[:, None])[:, 0]
    return ((lse - tgt) * m).sum()


def _token_mean(total, count, axes=()):
    """``total`` / max(``count``, 1), or, when the tokens are split over
    ``axes`` (``_sharded.Axis``), this rank's share of the global token
    mean (``count`` summed over the axes), its value raised to the global
    mean itself: the other ranks' shares enter as a constant, so every
    rank returns the global loss and backpropagates its own share."""
    count = all_reduce(count, axes) if axes else count.detach()
    return global_value(total / torch.clamp(count, min=1.0), axes)


def _ce_total(hidden, lm_head, targets, mask, chunk_tokens: int):
    """(summed NLL, summed weight) of chunked_cross_entropy."""
    dim = hidden.shape[-1]
    flat_h = hidden.reshape(-1, dim)
    flat_t = targets.reshape(-1).long()
    n = flat_h.shape[0]
    flat_m = (torch.ones((n,), dtype=torch.float32, device=hidden.device)
              if mask is None else mask.reshape(-1).float())
    chunk = min(chunk_tokens, n)
    pad = (-n) % chunk
    if pad:
        flat_h = F.pad(flat_h, (0, 0, 0, pad))
        flat_t = F.pad(flat_t, (0, pad))
        flat_m = F.pad(flat_m, (0, pad))  # padded tokens weigh 0
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, flat_h.shape[0], chunk):
        args = (flat_h[lo:lo + chunk], lm_head, flat_t[lo:lo + chunk],
                flat_m[lo:lo + chunk])
        total = total + (checkpoint(_ce_chunk, *args, use_reentrant=False)
                         if remat else _ce_chunk(*args))
    return total, flat_m.sum()


def chunked_cross_entropy(hidden, lm_head, targets, mask=None, *,
                          chunk_tokens: int, group=None):
    """Token-mean NLL without materializing [B, S, vocab] logits: the
    output projection and log-softmax run per chunk of tokens under
    ``torch.utils.checkpoint``, so the backward recomputes one chunk's
    logits at a time (the reference's rematerialized scan). The tail is
    padded with weight 0; the sum is divided by max(sum(mask), 1).
    ``group``: the group the tokens are a sequence shard of (None: not
    sharded), over which the mask is summed."""
    total, count = _ce_total(hidden, lm_head, targets, mask, chunk_tokens)
    axes = () if group is None else Layout.from_group(
        group, hidden.device).token_axes()
    return _token_mean(total, count, axes)


def llama_loss(params: Params, tokens, targets, config: LlamaConfig,
               group=None, mask=None, *, mesh=None,
               rules: Optional[ShardingRules] = None):
    """Next-token cross-entropy, f32 scalar, plus ``moe_aux_weight`` x
    the mean per-layer load-balancing loss for an MoE config.
    ``config.ce_chunk_tokens`` switches to the chunked loss that never
    materializes the [B, S, vocab] logits; ``mask`` [B, S] weighs each
    token. With ring or Ulysses attention, tokens, targets and mask are
    this rank's sequence shard, and the mean runs over the group's
    tokens; with ``mesh`` and ``rules``, they are this rank's shard of
    the batch and ``params`` its local shards, and the mean runs over
    the mesh's token axes (see the module docstring)."""
    c = config
    plan = _plan(c, group, mesh, rules, params)
    axes = plan.token_axes()
    if c.ce_chunk_tokens:
        hidden, aux = _forward(params, tokens, c, plan, return_hidden=True)
        total, count = _ce_total(hidden, plan.leaf(params, "lm_head"),
                                 targets, mask, c.ce_chunk_tokens)
        loss = _token_mean(total, count, axes)
    else:
        logits, aux = _forward(params, tokens, c, plan, return_hidden=False)
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(-1, targets[..., None].long())[..., 0]
        if mask is None:
            loss = _token_mean(-ll.sum(), ll.new_full((), ll.numel()), axes)
        else:
            mask = mask.float()
            loss = _token_mean(-(ll * mask).sum(), mask.sum(), axes)
    if c.moe_experts:
        loss = loss + c.moe_aux_weight * aux / c.n_layers
    return loss


def llama_sharding_rules(mode: str = "fsdp_tp") -> ShardingRules:
    """Sharding rules for this parameter tree (leading axis = layers),
    the reference's: ddp | fsdp | tp | fsdp_tp | ep. MoE trees need no
    flag: ndim-constrained rule variants shard the 4-D expert-stacked
    FFN weights on D/H (never the expert axis), and ``ep`` splits them
    on the expert axis."""
    def ffn(spec_in: P, spec_out: P):
        # 4-D variants for MoE expert-stacked weights [L, E, D, H]
        # (matched by ndim, so dense 3-D weights fall through).
        moe_in = P(None, None, *spec_in[1:])
        moe_out = P(None, None, *spec_out[1:])
        return [
            (r"layers/(w1|w3)", moe_in, 4),
            (r"layers/w2", moe_out, 4),
            (r"layers/(wq|wk|wv|w1|w3)", spec_in),
            (r"layers/(wo|w2)", spec_out),
        ]

    if mode == "ddp":
        return ShardingRules(rules=[(r".*", P())])
    if mode == "fsdp":
        return ShardingRules(rules=[
            (r"embedding", P("fsdp", None)),
            (r"lm_head", P(None, "fsdp")),
            *ffn(P(None, "fsdp", None), P(None, None, "fsdp")),
            (r".*", P()),
        ])
    if mode == "tp":
        return ShardingRules(rules=[
            (r"embedding", P(None, "model")),
            (r"lm_head", P(None, "model")),
            *ffn(P(None, None, "model"), P(None, "model", None)),
            (r".*", P()),
        ])
    if mode == "fsdp_tp":
        return ShardingRules(rules=[
            (r"embedding", P("fsdp", "model")),
            (r"lm_head", P(None, ("fsdp", "model"))),
            *ffn(P(None, "fsdp", "model"), P(None, "model", "fsdp")),
            (r".*", P()),
        ])
    if mode == "ep":
        # Expert parallelism: expert-stacked FFN weights [L, E, D, H]
        # split on the "expert" axis (parallel/moe.py); attention, the
        # router and the embeddings replicate.
        return ShardingRules(rules=[
            (r"layers/(w1|w2|w3)", P(None, "expert", None, None)),
            (r".*", P()),
        ])
    raise ValueError(f"unknown sharding mode {mode}")


# ---------------------------------------------------------------------------
# Inference: KV-cache prefill, single-token decode, chunk verify
# ---------------------------------------------------------------------------

def lora_init(seed: int, config: LlamaConfig, rank: int = 8,
              alpha: float = 16.0, device: DeviceLike = None) -> Params:
    """A LoRA adapter on the q and v projections, drawn from ``seed`` by a
    ``torch.Generator`` on ``device``: A [L, D, r] is N(0, 1/D), B starts
    at zero so a fresh adapter is the identity, and ``scale`` (0-d) is
    alpha / rank. The bits differ from ``jax.random``'s."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def a():
        # A maps dim -> rank whatever the projection's output size
        return (torch.randn((c.n_layers, c.dim, rank), generator=gen,
                            device=dev, dtype=torch.float32)
                * c.dim ** -0.5).to(c.dtype)

    a_q, a_v = a(), a()
    return {
        "A_q": a_q,
        "B_q": torch.zeros((c.n_layers, rank, c.n_heads * c.head_dim),
                           dtype=c.dtype, device=dev),
        "A_v": a_v,
        "B_v": torch.zeros((c.n_layers, rank, c.n_kv_heads * c.head_dim),
                           dtype=c.dtype, device=dev),
        "scale": torch.tensor(alpha / rank, dtype=c.dtype, device=dev),
    }


def _lora_delta(h, a, b):
    """h @ A @ B with A and B shared ([D, r], [r, H]) or gathered per
    batch row ([B, D, r], [B, r, H]); h: [B, S, D]."""
    if a.dim() == 2:
        return (h @ a) @ b
    return torch.bmm(torch.bmm(h, a), b)


def llama_init_cache(config: LlamaConfig, batch: int, max_seq: int,
                     device: DeviceLike = None):
    """KV cache pair, each [L, B, S, KVH, HD] in the model dtype."""
    c = config
    dev = resolve_device(device)
    shape = (c.n_layers, batch, max_seq, c.n_kv_heads, c.head_dim)
    return (torch.zeros(shape, dtype=c.dtype, device=dev),
            torch.zeros(shape, dtype=c.dtype, device=dev))


@torch.no_grad()
def llama_prefill(params: Params, tokens, config: LlamaConfig, lora=None):
    """Forward over a padded prompt, keeping per-layer K/V.

    tokens: [B, S] int -> (logits [B, S, vocab] f32,
    k [L, B, S, KVH, HD], v [L, B, S, KVH, HD]). Junk K/V at padding
    positions is never attended later because decode masks by position.
    ``lora``: optional adapter (``lora_init``'s dict) applied to the
    whole prefill; per-request adapters at decode go through the bank.
    """
    c = config
    x = _embed(params, tokens, c)
    cos, sin = rope_frequencies(c.head_dim, tokens.shape[1], c.rope_theta,
                                device=x.device)
    ks, vs = [], []
    for i in range(c.n_layers):
        layer_lora = None if lora is None else (
            lora["A_q"][i], lora["B_q"][i], lora["A_v"][i], lora["B_v"][i],
            lora["scale"])
        x, (k, v), _aux = _block(_layer(params["layers"], i), x, cos, sin, c,
                                 lora=layer_lora)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, torch.stack(ks), torch.stack(vs)


def _cached_attention(q, ck, cv, visible, config: LlamaConfig):
    """Attention of q [B, G, H, HD] over a cache layer ck/cv [B, S, KVH,
    HD] where ``visible`` [B, G, S] holds: query head g*n_rep + r reads
    KV head g (the reference's jnp.repeat of the cache, without the
    copy). Scores and softmax in f32; returns [B, G, H * HD]."""
    c = config
    b, g, _, hd = q.shape
    kvh = ck.shape[2]
    qg = q.reshape(b, g, kvh, c.n_heads // kvh, hd)
    scores = torch.einsum("bgkrd,bskd->bkrgs", qg, ck).float()
    scores = scores * (hd ** -0.5)
    scores = torch.where(visible[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    weights = torch.softmax(scores, dim=-1).to(c.dtype)
    attn = torch.einsum("bkrgs,bskd->bgkrd", weights, cv)
    return attn.reshape(b, g, c.n_heads * hd)


@torch.no_grad()
def llama_decode_step(params: Params, token, cache_k, cache_v, pos,
                      config: LlamaConfig, lora_bank=None, lora_idx=None):
    """One token for every sequence in the batch.

    token: [B] int (the token at position ``pos``); pos: [B] int;
    cache_k/v: [L, B, S, KVH, HD]. Returns (logits [B, vocab] f32,
    cache_k, cache_v). The new K/V are written at ``pos`` IN PLACE: the
    returned caches are the ones passed in (the reference returns new
    arrays and donates the old ones, which comes to the same).

    Multi-LoRA: ``lora_bank`` stacks adapters on a leading axis ({A_q:
    [N, L, D, r], B_q: [N, L, r, H * HD], A_v, B_v, scale}; index 0 all
    zero, no adapter) and ``lora_idx`` [B] picks one per row; each layer
    gathers its own [B, D, r] and [B, r, *] factors from the bank.
    """
    c = config
    n_layers, b, s, kvh, hd = cache_k.shape
    x = _embed(params, token, c)[:, None, :]                     # [B,1,D]
    cos, sin = rope_frequencies(hd, s, c.rope_theta, device=x.device)
    pos_2d = pos[:, None]                                        # [B,1]
    # causal visibility: this token may attend to cache slots <= pos
    visible = (torch.arange(s, device=x.device)[None, :]
               <= pos_2d)[:, None, :]                            # [B,1,S]
    rows = torch.arange(b, device=x.device)
    for i in range(n_layers):
        lp = _layer(params["layers"], i)
        ck, cv = cache_k[i], cache_v[i]                          # [B,S,KVH,HD]
        h = rms_norm(x, lp["attn_norm"], c.norm_eps)
        q = (h @ lp["wq"]).reshape(b, 1, c.n_heads, hd)
        k = (h @ lp["wk"]).reshape(b, 1, kvh, hd)
        v = (h @ lp["wv"]).reshape(b, 1, kvh, hd)
        if lora_bank is not None:
            dq = _lora_delta(h, lora_bank["A_q"][lora_idx, i],
                             lora_bank["B_q"][lora_idx, i])
            dv = _lora_delta(h, lora_bank["A_v"][lora_idx, i],
                             lora_bank["B_v"][lora_idx, i])
            q = q + (lora_bank["scale"] * dq).reshape(b, 1, c.n_heads, hd)
            v = v + (lora_bank["scale"] * dv).reshape(b, 1, kvh, hd)
        q = apply_rope(q, cos, sin, positions=pos_2d)
        k = apply_rope(k, cos, sin, positions=pos_2d)
        ck[rows, pos] = k[:, 0]
        cv[rows, pos] = v[:, 0]
        attn = _cached_attention(q, ck, cv, visible, c)
        x = x + attn @ lp["wo"]
        h = rms_norm(x, lp["mlp_norm"], c.norm_eps)
        y, _aux = _ffn(lp, h, c)
        x = x + y
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    return logits, cache_k, cache_v


@torch.no_grad()
def llama_verify_step(params: Params, tokens, cache_k, cache_v, pos,
                      config: LlamaConfig):
    """Score a G-token chunk per sequence in ONE forward: a speculative
    chunk (the current token and G-1 drafts), a prompt's suffix over a
    cached prefix, or a chunk of a prompt being prefilled.

    tokens: [B, G] int; pos: [B] int chunk start positions; cache_k/v:
    [L, B, S, KVH, HD]. Returns (logits [B, G, vocab] f32, cache_k,
    cache_v); the chunk's K/V are written IN PLACE at pos..pos+G-1 of
    each row, which must lie inside the cache (the caller checks: an
    index past S raises on the CPU and faults on the card).
    logits[:, g] is the distribution of the token AFTER chunk input g;
    chunk position g attends cache slot t iff t <= pos + g.
    """
    c = config
    n_layers, b, s, kvh, hd = cache_k.shape
    g = tokens.shape[1]
    x = _embed(params, tokens, c)                                # [B,G,D]
    cos, sin = rope_frequencies(hd, s, c.rope_theta, device=x.device)
    positions = pos[:, None] + torch.arange(g, device=x.device)[None, :]
    visible = (torch.arange(s, device=x.device)[None, None, :]
               <= positions[:, :, None])                         # [B,G,S]
    rows = torch.arange(b, device=x.device)[:, None]
    for i in range(n_layers):
        lp = _layer(params["layers"], i)
        ck, cv = cache_k[i], cache_v[i]                          # [B,S,KVH,HD]
        h = rms_norm(x, lp["attn_norm"], c.norm_eps)
        q = (h @ lp["wq"]).reshape(b, g, c.n_heads, hd)
        k = (h @ lp["wk"]).reshape(b, g, kvh, hd)
        v = (h @ lp["wv"]).reshape(b, g, kvh, hd)
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
        ck[rows, positions] = k
        cv[rows, positions] = v
        # [B, KVH, n_rep, G, S] f32 scores live for this layer only
        attn = _cached_attention(q, ck, cv, visible, c)
        x = x + attn @ lp["wo"]
        h = rms_norm(x, lp["mlp_norm"], c.norm_eps)
        y, _aux = _ffn(lp, h, c)
        x = x + y
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, cache_k, cache_v
