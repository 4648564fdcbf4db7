"""Training throughput of the port: the counterpart of ``bench.py``'s
``_bench_config`` (next-token loss, its backward, one AdamW step).

    python -m ray_tpu_torch.scripts.bench_train

Llama-3-8B at full width and depth (``LlamaConfig.llama3_8b``), remat
and CE chunk 1024, random weights from seed 0, batch 1 x 2048 (what one
80 GB card holds), one warm-up step and three timed steps on one fixed
batch, each run ended by ``loss.item()``. Prints one JSON line with
bench.py's keys: tokens/s, MFU against the H100's 989 TFLOP/s bf16 dense
peak (6 x params per token, as bench.py counts it), the final loss and
the device. Runs on the card; ``device="cpu"`` (tests) runs the plain
versions and reports no MFU.
"""

from __future__ import annotations

import functools
import json
import time

import torch
import torch.distributed as dist

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.dit import (
    DiTConfig, dit_init, dit_loss, dit_sharding_rules, draw_dit_noise)
from ray_tpu_torch.models.llama import (
    SEQ_PARALLEL, LlamaConfig, Params, llama_init, llama_loss,
    unstack_layers)
from ray_tpu_torch.models.vit import (
    CLIPConfig, ViTConfig, clip_init, clip_loss, clip_sharding_rules,
    vit_init, vit_loss, vit_sharding_rules)
from ray_tpu_torch.parallel import _group
from ray_tpu_torch.parallel._sharded import Layout, local_rows
from ray_tpu_torch.parallel.sharding import shard_pytree

H100_BF16_DENSE_FLOPS = 989e12
BATCH, SEQ, STEPS, CE_CHUNK = 1, 2048, 3, 1024


def parameters(params: Params):
    """Every tensor of a parameter tree, in a fixed order."""
    if isinstance(params, torch.Tensor):
        return [params]
    items = params.values() if isinstance(params, dict) else params
    return [t for item in items for t in parameters(item)]


def make_adamw(leaves, lr: float = 3e-4, weight_decay: float = 0.01):
    """AdamW (betas 0.9/0.999, eps 1e-8) over ``leaves`` in one
    parameter group, since ``optax.adamw`` decays every leaf. On the
    card it is the fused AdamW: the ``foreach`` one would allocate
    temporaries the size of all parameters. The moments take the
    parameters' dtype."""
    on_card = leaves[0].device.type == "cuda"
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay,
                             fused=True if on_card else None)


def all_reduce_grads(leaves, group) -> None:
    """Sum each leaf's grad over ``group`` in place: with the sequence
    sharded over the group, each rank's backward holds its shard's share
    of the gradient (the reference gets the sum from GSPMD)."""
    group, _rank, n = _group.resolve(group, leaves[0].device)
    if n == 1:
        return
    for t in leaves:
        if t.grad is not None:
            dist.all_reduce(t.grad, op=dist.ReduceOp.SUM, group=group)


def make_step(params: Params, loss_fn, lr: float = 3e-4,
              weight_decay: float = 0.01, group=None, optimizer=None):
    """``step(*args) -> loss`` that updates ``params`` in place:
    ``loss_fn(*args)``, its backward, the grads summed over ``group``
    when one is given (:func:`all_reduce_grads`), then the AdamW update
    over ``parameters(params)``: ``optimizer``, or a new
    :func:`make_adamw`. Keep the layers unstacked (``unstack_layers``).
    ``step.optimizer`` is that AdamW, so that a checkpoint reaches its
    ``state_dict`` and ``load_state_dict``; ``step.loss_fn`` is
    ``loss_fn``."""
    leaves = parameters(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = (optimizer if optimizer is not None
           else make_adamw(leaves, lr, weight_decay))

    def step(*args) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(*args)
        loss.backward()
        if group is not None:
            all_reduce_grads(leaves, group)
        opt.step()
        return loss.detach()

    step.optimizer = opt
    step.loss_fn = loss_fn
    return step


def make_train_step(cfg: LlamaConfig, params: Params, lr: float = 3e-4,
                    weight_decay: float = 0.01, group=None, optimizer=None,
                    *, mesh=None, rules=None):
    """``step(tokens, targets) -> loss``: :func:`make_step` over
    ``llama_loss``. With ring or Ulysses attention, tokens and targets
    are this rank's sequence shard over ``group`` (None: the default
    group, or world 1), and the grads are summed over it. With ``mesh``
    and ``rules``, ``params`` are this rank's local shards and tokens and
    targets its shard of the batch; the loss's backward leaves every
    shard's full gradient, so AdamW steps each shard on its own."""
    if mesh is not None:
        return make_step(
            params, lambda tokens, targets: llama_loss(
                params, tokens, targets, cfg, mesh=mesh, rules=rules),
            lr, weight_decay, None, optimizer)
    if cfg.attention in SEQ_PARALLEL:
        group = _group.resolve(group, params["lm_head"].device)[0]
    return make_step(
        params, lambda tokens, targets: llama_loss(params, tokens, targets,
                                                   cfg, group),
        lr, weight_decay, group, optimizer)


def setup(cfg: LlamaConfig, batch: int, seq: int, device: DeviceLike = None):
    """The bench's state -> ``(params, step, tokens, targets)``: weights
    from seed 0 with the layers unstacked, the AdamW step over them, and
    one fixed batch of tokens and targets from seed 1."""
    dev = resolve_device(device)
    params = unstack_layers(llama_init(0, cfg, dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev)
    targets = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                            device=dev)
    return params, make_train_step(cfg, params), tokens, targets


# images (ViT-B/16, CLIP) or latents (DiT-B/2, DiT-XL/2) per step of
# setup_vision
VISION_BATCH = {"vit": 64, "clip": 32, "dit": 32, "dit_xl": 32}
VISION_RULES = {"vit": vit_sharding_rules, "clip": clip_sharding_rules,
                "dit": dit_sharding_rules, "dit_xl": dit_sharding_rules}


def _local(stacked: Params, mesh, rules, towers=()) -> Params:
    """A stacked tree cut to this rank's shards (with ``mesh``), its
    layers unstacked (those of each tower in ``towers``)."""
    if mesh is not None:
        stacked = shard_pytree(stacked, mesh, rules)
    if not towers:
        return unstack_layers(stacked)
    return {**stacked, **{t: unstack_layers(stacked[t]) for t in towers}}


def random_adaln(params: Params, std: float, seed: int = 2) -> Params:
    """DiT's stacked ``params`` with the adaLN-Zero leaves (zero at init,
    where the blocks are the identity and most grads zero, so that a
    comparison of grads proves little) drawn N(0, std^2) by a generator
    seeded ``seed`` on their device."""
    dev = params["final_w"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(t):
        return (torch.randn(t.shape, generator=gen, device=dev)
                * std).to(t.dtype)

    layers = dict(params["layers"], mod_w=draw(params["layers"]["mod_w"]),
                  mod_b=draw(params["layers"]["mod_b"]))
    return dict(params, layers=layers, **{
        k: draw(params[k]) for k in ("final_mod_w", "final_mod_b",
                                     "final_w")})


def setup_vision(model: str, device: DeviceLike = None, *, mesh=None,
                 mode: str = "fsdp_tp", adaln_std: float = 0.0):
    """A vision model's training state -> ``(cfg, params, step)``:
    ViT-B/16 (224^2, class token, 1000 classes), CLIP (``"clip"``: the
    ViT-B/16 image tower and the 512-wide causal text tower at S 77),
    DiT-B/2 or DiT-XL/2 (``"dit_xl"``: head_dim 72, 28 layers) at 1000
    classes on 32 x 32 x 4 latents (256^2 images), bf16 with remat, at
    ``VISION_BATCH[model]``; weights from seed 0 with the layers
    unstacked, one fixed batch (and DiT's draws: t, eps, label drop) from
    seed 1, and ``step() -> loss``, the :func:`make_step` over it, with
    that batch's tensors in ``step.batch``. With ``mesh``, the parameters
    are this rank's shards under the model's rules for ``mode`` and the
    batch its rows; the loss is the global one, and AdamW steps each
    shard on its own. ``adaln_std`` > 0 draws DiT's adaLN-Zero leaves
    with :func:`random_adaln` before they are sharded."""
    if model not in VISION_RULES:
        raise ValueError(f"unknown vision model {model!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = VISION_BATCH[model]
    rules = None if mesh is None else VISION_RULES[model](mode)
    axes = () if mesh is None else Layout.from_mesh(mesh, dev).batch_axes()
    kw = {} if mesh is None else dict(mesh=mesh, rules=rules)

    def rows(x):
        return local_rows(x, axes)

    def state(cfg, params, loss_fn, **tensors):
        step = make_step(params, loss_fn)
        step.batch = tensors
        return cfg, params, step

    labels_of = functools.partial(torch.randint, 0, 1000, (batch,),
                                  generator=gen, device=dev)
    if model in ("vit", "clip"):
        cfg = (ViTConfig.base(n_classes=1000, pool="cls") if model == "vit"
               else CLIPConfig())
        v = cfg if model == "vit" else cfg.vision
        params = (_local(vit_init(0, cfg, dev), mesh, rules)
                  if model == "vit" else
                  _local(clip_init(0, cfg, dev), mesh, rules,
                         ("vision", "text")))
        images = rows(torch.randn((batch, v.image_size, v.image_size,
                                   v.channels), generator=gen, device=dev))
        if model == "vit":
            labels = rows(labels_of())
            return state(cfg, params, lambda: vit_loss(
                params, images, labels, cfg, **kw), images=images,
                labels=labels)
        tokens = rows(torch.randint(0, cfg.text.vocab_size,
                                    (batch, cfg.text.max_seq_len),
                                    generator=gen, device=dev))
        return state(cfg, params, lambda: clip_loss(
            params, images, tokens, cfg, **kw), images=images, tokens=tokens)
    cfg = (DiTConfig.b_2 if model == "dit" else DiTConfig.xl_2)(
        n_classes=1000)
    params = dit_init(0, cfg, dev)
    if adaln_std:
        params = random_adaln(params, adaln_std)
    params = _local(params, mesh, rules)
    shape = (batch, cfg.input_size, cfg.input_size, cfg.channels)
    x0 = rows(torch.randn(shape, generator=gen, device=dev))
    labels = rows(labels_of())
    noise = draw_dit_noise(gen, shape, dev)  # the global batch's draws
    return state(cfg, params, lambda: dit_loss(
        params, noise, x0, cfg, labels, **kw), x0=x0, labels=labels,
        noise=noise)


def timed_steps(step, steps: int, *args):
    """``steps`` calls of ``step(*args)`` back to back, ended by
    ``loss.item()`` -> (host ms per step, final loss)."""
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(*args)
    final_loss = loss.item()
    return (time.perf_counter() - t0) / steps * 1e3, final_loss


def bench_config(cfg: LlamaConfig, batch: int, seq: int, steps: int,
                 device: DeviceLike = None) -> dict:
    """One measured configuration -> bench.py's metrics dict."""
    dev = resolve_device(device)
    _params, step, tokens, targets = setup(cfg, batch, seq, dev)
    step(tokens, targets).item()  # warm-up: allocator, cuBLAS, kernel build
    step_ms, final_loss = timed_steps(step, steps, tokens, targets)

    tokens_per_sec = batch * seq / (step_ms / 1e3)
    on_card = dev.type == "cuda"
    return {
        "metric": "llama_train_tokens_per_sec_per_chip",
        "value": tokens_per_sec,
        "unit": "tokens/s/chip",
        "mfu": (tokens_per_sec * cfg.flops_per_token()
                / H100_BF16_DENSE_FLOPS) if on_card else None,
        "model_params": cfg.num_params(),
        "n_layers": cfg.n_layers,
        "batch": batch, "seq": seq,
        "ce_chunk_tokens": cfg.ce_chunk_tokens,
        "step_ms": step_ms,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if on_card else None),
        "final_loss": final_loss,
    }


def main() -> int:
    cfg = LlamaConfig.llama3_8b(ce_chunk_tokens=CE_CHUNK)
    print(json.dumps(bench_config(cfg, BATCH, SEQ, STEPS)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
