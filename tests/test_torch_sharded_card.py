"""Sharded Llama and expert-parallel MoE on the card, and the spawned
gloo workers of their CPU parity tests.

The ``cuda`` tests (they skip without a GPU) run through a world-1 mesh
with all six axes: Llama-3-8B width, 2 layers, bf16, 1 x 2048 under
ddp, fsdp, tp and fsdp_tp, each loss and grad bit-equal to the
unsharded flash path from the same parameters, with K1-K4's launch
counts; Mixtral-8x7B width, 2 layers, under ep and under ring attention,
equal to the unsharded run. The four-card test runs NCCL at world 4
against the unsharded run on each card. This file imports no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_sharded_card.py``.

The CPU parity tests (``test_torch_sharded_llama.py``,
``test_torch_expert_parallel.py``) compute the JAX side in their own
process and run the port over gloo in processes spawned by
``GroupRun``, which import only torch, the port and the two card files.
"""

import dataclasses

import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import attention as att
from ray_tpu_torch.ops import rms_norm
from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from ray_tpu_torch.parallel.sharding import (
    mesh_coords, mesh_shape, shard_pytree)
from ray_tpu_torch.scripts import bench_train
from test_torch_seq_parallel_card import (  # noqa: F401 (fixtures)
    GroupRun, _rel, cuda_device, nccl_world1)

# ---------------------------------------------------------------------------
# spawned gloo workers (CPU)
# ---------------------------------------------------------------------------


def token_shard(a, sizes, coords):
    """This rank's shard of a [B, S] batch: rows over data x fsdp (data
    major), positions over seq."""
    n_rows = sizes["data"] * sizes["fsdp"]
    row = coords["data"] * sizes["fsdp"] + coords["fsdp"]
    return a.chunk(n_rows, 0)[row].chunk(sizes["seq"], 1)[coords["seq"]]


def grads_tree(params, grads=None):
    """Grads of an unstacked tree (``grads`` in ``parameters`` order, or
    each leaf's ``.grad``), stacked in the JAX tree's layout."""
    if grads is None:
        grads = [t.grad for t in bench_train.parameters(params)]
    it = iter(grads)
    tree = {k: ([{n: next(it) for n in lp} for lp in v] if k == "layers"
                else next(it)) for k, v in params.items()}
    return tl.stack_layers(tree)


def numpy_tree(tree):
    return {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict)
                else v.detach().numpy()) for k, v in tree.items()}


def sharded_worker(rank, world, payload):
    """``payload``: JAX weight trees (numpy, by name), tokens and targets
    [B, S], ``cases`` (each: the tree's name, a sharding mode or None for
    a sequence group without a mesh, the mesh's axes, LlamaConfig.tiny
    keywords) and optionally ``step`` (one AdamW step of a case) -> per
    case (loss, this rank's grads, mesh sizes and coordinates), and the
    step's loss and local parameters."""
    meshes = {}

    def setup(case):
        name, mode, axes, kw = case
        cfg = tl.LlamaConfig.tiny(**kw)
        params = convert.params_from_jax(payload["params"][name],
                                         device="cpu")
        key = tuple(sorted(axes.items()))
        if key not in meshes:
            meshes[key] = make_mesh(MeshSpec(**axes), "cpu")
        mesh = meshes[key]
        sizes, coords = mesh_shape(mesh), mesh_coords(mesh)
        toks, tgts = (token_shard(torch.from_numpy(payload[k]).long(),
                                  sizes, coords)
                      for k in ("tokens", "targets"))
        rules = None if mode is None else tl.llama_sharding_rules(mode)
        if rules is not None:
            params = shard_pytree(params, mesh, rules)
        params = tl.unstack_layers(params)
        for t in bench_train.parameters(params):
            t.requires_grad_(True)
        return cfg, params, mesh, rules, sizes, coords, toks, tgts

    out = {"cases": []}
    for case in payload["cases"]:
        cfg, params, mesh, rules, sizes, coords, toks, tgts = setup(case)
        if rules is None:  # a sequence group (the default one), no mesh
            loss = tl.llama_loss(params, toks, tgts, cfg)
            loss.backward()
            bench_train.all_reduce_grads(bench_train.parameters(params),
                                         None)
        else:
            loss = tl.llama_loss(params, toks, tgts, cfg, mesh=mesh,
                                 rules=rules)
            loss.backward()
        out["cases"].append((loss.item(), numpy_tree(grads_tree(params)),
                             sizes, coords))
    if "step" in payload:
        cfg, params, mesh, rules, sizes, coords, toks, tgts = setup(
            payload["step"])
        step = bench_train.make_train_step(cfg, params, mesh=mesh,
                                           rules=rules)
        out["step_loss"] = step(toks, tgts).item()
        out["stepped"] = numpy_tree(tl.stack_layers(params))
    return out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

DENSE_MODES = ("ddp", "fsdp", "tp", "fsdp_tp")
SEQ = 2048


def counts():
    return [f.launches for f in (att.flash_attention,
                                 att.flash_attention_bwd_dq,
                                 att.flash_attention_bwd_dkv, rms_norm)]


def loss_and_grads(params, tokens, targets, cfg, **kw):
    """(loss, grads of every leaf, K1 / K2 / K3 / K4 launches)."""
    before = counts()
    loss = tl.llama_loss(params, tokens, targets, cfg, **kw)
    grads = torch.autograd.grad(loss, bench_train.parameters(params))
    torch.cuda.synchronize()
    return loss, grads, [a - b for a, b in zip(counts(), before)]


def two_layers(cfg, dev, seed=0):
    params = tl.unstack_layers(tl.llama_init(seed, cfg, dev))
    for t in bench_train.parameters(params):
        t.requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens, targets = (torch.randint(0, cfg.vocab_size, (1, SEQ),
                                     generator=gen, device=dev)
                       for _ in range(2))
    return params, tokens, targets


@pytest.mark.cuda
def test_world1_mesh_dense_modes_bit_equal_with_launch_counts(nccl_world1):
    dev = nccl_world1
    cfg = dataclasses.replace(tl.LlamaConfig.llama3_8b(ce_chunk_tokens=1024),
                              n_layers=2)
    params, tokens, targets = two_layers(cfg, dev)
    want_loss, want, want_counts = loss_and_grads(params, tokens, targets,
                                                  cfg)
    assert want_counts == [4, 2, 2, 9]
    mesh = make_mesh(MeshSpec(), dev)
    assert mesh.mesh_dim_names == ("pipe", "data", "fsdp", "seq", "expert",
                                   "model")
    for mode in DENSE_MODES:
        rules = tl.llama_sharding_rules(mode)
        local = tl.unstack_layers(shard_pytree(tl.stack_layers(params),
                                               mesh, rules))
        for t in bench_train.parameters(local):
            t.requires_grad_(True)
        loss, grads, launched = loss_and_grads(local, tokens, targets, cfg,
                                               mesh=mesh, rules=rules)
        assert launched == want_counts, mode
        assert torch.equal(loss, want_loss), mode
        for g, w in zip(grads, want):
            assert torch.equal(g, w), mode


@pytest.mark.cuda
def test_world1_mesh_mixtral_ep_and_ring_equal_unsharded(nccl_world1):
    dev = nccl_world1
    cfg = dataclasses.replace(tl.LlamaConfig.mixtral_8x7b(
        ce_chunk_tokens=1024), n_layers=2)
    params, tokens, targets = two_layers(cfg, dev)
    want_loss, want, want_counts = loss_and_grads(params, tokens, targets,
                                                  cfg)
    mesh = make_mesh(MeshSpec(), dev)
    for mode, attention in (("ep", "flash"), ("ep", "ring"),
                            ("fsdp_tp", "ring")):
        rules = tl.llama_sharding_rules(mode)
        c = dataclasses.replace(cfg, attention=attention)
        loss, grads, launched = loss_and_grads(params, tokens, targets, c,
                                               mesh=mesh, rules=rules)
        assert launched == want_counts, (mode, attention)
        assert torch.equal(loss, want_loss), (mode, attention)
        for g, w in zip(grads, want):
            assert torch.equal(g, w), (mode, attention)


def nccl_sharded_worker(rank, world, payload):
    """On ``world`` cards over NCCL, rank r on card r, every input drawn
    from one seed on each card: the unsharded loss and grads on this
    card, then the sharded run of each case (Llama-3-8B width at fsdp 2
    x model 2, Mixtral width at expert 4, tiny MoE under ring at seq 4)
    -> per case (relative loss error, the relative L2 of each of this
    rank's grads against the same slice of the unsharded grads, for an
    MoE case the relative L2 of each unsharded bf16 grad against the f32
    run with plain attention (bf16 alone moves a router's grads by 10-30
    %: a routing flip near a tie changes which tokens an expert keeps),
    launches). ``payload``: None, or the device type to run on instead
    of card r."""
    from ray_tpu_torch.parallel.sharding import local_shards
    dev = torch.device("cuda", rank) if payload is None else torch.device(
        payload)
    out = {}
    cases = (
        ("llama_fsdp_tp", dataclasses.replace(tl.LlamaConfig.llama3_8b(
            ce_chunk_tokens=1024), n_layers=2), "fsdp_tp",
         MeshSpec(fsdp=2, model=2), (2, 1024)),
        ("mixtral_ep", dataclasses.replace(tl.LlamaConfig.mixtral_8x7b(
            ce_chunk_tokens=1024), n_layers=2), "ep", MeshSpec(expert=4),
         (1, 2048)),
        ("tiny_moe_ring", tl.LlamaConfig.tiny_moe(
            dtype=torch.bfloat16, attention="ring", dim=256, n_heads=2,
            n_kv_heads=1, moe_capacity_factor=0.5), "ddp", MeshSpec(seq=4),
         (2, 1024)),
    )
    for name, cfg, mode, spec, (b, s) in cases:
        params = tl.llama_init(0, cfg, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        tokens, targets = (torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device=dev)
                           for _ in range(2))
        full = tl.unstack_layers(params)
        for t in bench_train.parameters(full):
            t.requires_grad_(True)
        ref_loss, ref_grads, _ = loss_and_grads(
            full, tokens, targets, dataclasses.replace(cfg,
                                                       attention="flash"))
        bf16_noise = None
        if cfg.moe_experts:
            leaves32 = [t.detach().float().requires_grad_()
                        for t in bench_train.parameters(full)]
            it = iter(leaves32)
            full32 = {k: ([{n: next(it) for n in lp} for lp in v]
                          if k == "layers" else next(it))
                      for k, v in full.items()}
            _loss, grads32, _ = loss_and_grads(
                full32, tokens, targets, dataclasses.replace(
                    cfg, dtype=torch.float32, attention="reference"))
            bf16_noise = [_rel(g, w) for g, w in zip(ref_grads, grads32)]
            del leaves32, full32, grads32
        ref_tree = grads_tree(full, ref_grads)
        del full
        mesh = make_mesh(spec, dev)
        rules = tl.llama_sharding_rules(mode)
        sizes, coords = mesh_shape(mesh), mesh_coords(mesh)
        local = tl.unstack_layers(shard_pytree(params, mesh, rules))
        del params
        for t in bench_train.parameters(local):
            t.requires_grad_(True)
        loss, grads, launched = loss_and_grads(
            local, token_shard(tokens, sizes, coords),
            token_shard(targets, sizes, coords), cfg, mesh=mesh,
            rules=rules)
        want = bench_train.parameters(tl.unstack_layers(
            local_shards(ref_tree, rules, sizes, coords)))
        out[name] = (abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()),
                     [_rel(g, w) for g, w in zip(grads, want)], bf16_noise,
                     launched)
        del local, grads, want, ref_tree, ref_grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


@pytest.mark.cuda
def test_sharded_llama_and_expert_parallel_over_nccl_on_four_cards(tmp_path):
    """The collectives themselves (all-gather, reduce-scatter, all-reduce
    over NCCL), which a world-1 mesh never issues. Dense: loss 1e-3,
    every grad 5e-2 (the sequence-parallel four-card test's gates);
    MoE: loss 1e-3, every grad within 5e-2 or twice what bf16 alone
    moves it by."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA GPUs")
    results = GroupRun(nccl_sharded_worker, 4, None, tmp_path,
                       timeout=600.0, backend="nccl").join()
    for rank, r in enumerate(results):
        for name, (rel_loss, rel_grads, noise, _launched) in r.items():
            gates = ([5e-2] * len(rel_grads) if noise is None
                     else [max(5e-2, 2 * n) for n in noise])
            print(f"rank {rank} {name}: loss {rel_loss:.3e}, worst grad "
                  f"{max(rel_grads):.3e}, worst bf16 noise "
                  f"{max(noise) if noise else 0:.3e}, worst grad / gate "
                  f"{max(e / g for e, g in zip(rel_grads, gates)):.3f}")
            assert rel_loss <= 1e-3, (rank, name, rel_loss)
            assert all(e <= g for e, g in zip(rel_grads, gates)), (
                rank, name, rel_grads, gates)
        # K1-K3 on the rank's 16 query and 4 KV heads of 32 and 8
        assert r["llama_fsdp_tp"][3] == [4, 2, 2, 9], (rank, r)
