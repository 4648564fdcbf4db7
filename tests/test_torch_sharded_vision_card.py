"""Sharded ViT, CLIP and DiT and gradient sync on the card, and the spawned
gloo workers of their CPU parity tests.

The ``cuda`` tests (they skip without a GPU) run ViT-B/16, CLIP (the
ViT-B/16 image tower and the 512-wide text tower) and DiT-XL/2 at full
width and depth through a world-1 mesh under ddp, fsdp, tp and fsdp_tp,
each loss and grad bit-equal to the unsharded run with the unsharded
step's K1-K3 launches; the four-card test runs each model at fsdp 2 x
model 2 over NCCL against the unsharded run on each card, with its
launches and K1-K3 at H / 2 heads against the plain attention, the int8
ring against the uncompressed all-reduce and ZeRO-1 against DDP over
NCCL, each the same on every rank. This file imports no
JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_sharded_vision_card.py``.

The CPU parity tests (``test_torch_sharded_vision.py``,
``test_torch_collectives.py``, ``test_torch_zero1.py``,
``test_torch_sharded_rl.py``) compute the JAX side in their own process
and run the port over gloo in processes spawned by ``GroupRun``, which
import only torch, the port and the card files.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import dit as td
from ray_tpu_torch.models import vit as tv
from ray_tpu_torch.models.llama import stack_layers, unstack_layers
from ray_tpu_torch.ops import attention as att
from ray_tpu_torch.parallel import collective as C
from ray_tpu_torch.parallel._sharded import Layout, local_rows
from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from ray_tpu_torch.parallel.sharding import (
    local_shards, mesh_coords, mesh_shape, shard_pytree)
from ray_tpu_torch.scripts import bench_train
from ray_tpu_torch.train.collective import (
    DDPOptimizer, Zero1Optimizer, make_optimizer)
from test_torch_seq_parallel_card import (  # noqa: F401 (fixtures)
    GroupRun, _rel, cuda_device, nccl_world1)

# ---------------------------------------------------------------------------
# spawned gloo workers (CPU)
# ---------------------------------------------------------------------------

RULES = {"vit": tv.vit_sharding_rules, "clip": tv.clip_sharding_rules,
         "dit": td.dit_sharding_rules}
TOWERS = {"vit": (), "clip": ("vision", "text"), "dit": ()}


def tiny_config(model: str, **kw):
    """The port's tiny config of ``model`` (the JAX package's tiny's
    fields), f32."""
    if model == "vit":
        return tv.ViTConfig.tiny(n_classes=10, pool="cls", **kw)
    if model == "clip":
        return tv.CLIPConfig.tiny(**kw)
    return td.DiTConfig.tiny(n_classes=10, **kw)


def unstack(tree, towers=()):
    """The layers of a stacked tree (or of each tower) unstacked."""
    if not towers:
        return unstack_layers(tree)
    return {**tree, **{t: unstack_layers(tree[t]) for t in towers}}


def grads_of(tree):
    """The grads of an unstacked tree as numpy, its layers stacked (the
    JAX tree's layout)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):  # unstacked layers
            return {name: np.stack([lp[name].grad.numpy() for lp in node])
                    for name in node[0]}
        return node.grad.numpy()
    return walk(tree)


def params_of(tree):
    """An unstacked tree's values as numpy, its layers stacked."""
    def walk(node):
        if isinstance(node, dict):
            if isinstance(node.get("layers"), list):
                node = stack_layers(node)
            return {k: walk(v) for k, v in node.items()}
        return node.detach().numpy()
    return walk(tree)


def model_loss(model, params, batch, cfg, **kw):
    """The loss of ``model`` on this rank's rows ``batch``; DiT's draws
    are the global batch's."""
    if model == "vit":
        return tv.vit_loss(params, batch["images"], batch["labels"], cfg,
                           **kw)
    if model == "clip":
        return tv.clip_loss(params, batch["images"], batch["tokens"], cfg,
                            **kw)
    return td.dit_loss(params, batch["noise"], batch["x0"], cfg,
                       batch["labels"], 0.5, **kw)


def _batch(payload, model, axes):
    rows = {k: local_rows(torch.from_numpy(v), axes)
            for k, v in payload["batches"][model].items() if k != "noise"}
    if model == "dit":
        rows["noise"] = {k: torch.from_numpy(v)
                         for k, v in payload["batches"][model]["noise"]
                         .items()}
    return rows


def vision_worker(rank, world, payload):
    """``payload``: JAX weight trees (numpy, by model), each model's
    global batch, ``cases`` (model, sharding mode, mesh axes) and
    ``steps`` (cases of one AdamW step) -> per case (loss, this rank's
    grads, mesh sizes and coordinates), per step (loss, this rank's
    parameters after the step), and the message of the refusal of a
    model axis that does not divide the heads."""
    meshes = {}

    def setup(case):
        model, mode, axes = case
        key = tuple(sorted(axes.items()))
        if key not in meshes:
            meshes[key] = make_mesh(MeshSpec(**axes), "cpu")
        mesh = meshes[key]
        rules = RULES[model](mode)
        params = unstack(shard_pytree(convert.params_from_jax(
            payload["params"][model], device="cpu"), mesh, rules),
            TOWERS[model])
        for t in bench_train.parameters(params):
            t.requires_grad_(True)
        batch = _batch(payload, model,
                       Layout.from_mesh(mesh, torch.device("cpu"))
                       .batch_axes())
        return mesh, rules, params, batch

    out = {"cases": [], "steps": []}
    for case in payload["cases"]:
        mesh, rules, params, batch = setup(case)
        loss = model_loss(case[0], params, batch, tiny_config(case[0]),
                          mesh=mesh, rules=rules)
        loss.backward()
        out["cases"].append((loss.item(), grads_of(params), mesh_shape(mesh),
                             mesh_coords(mesh)))
    for case in payload["steps"]:
        mesh, rules, params, batch = setup(case)
        cfg = tiny_config(case[0])
        step = bench_train.make_step(params, functools.partial(
            model_loss, case[0], params, batch, cfg, mesh=mesh,
            rules=rules))
        out["steps"].append((step().item(), params_of(params)))
    mesh = make_mesh(MeshSpec(model=4), "cpu")
    cfg = tv.ViTConfig.tiny(n_heads=2)
    params = shard_pytree(tv.vit_init(0, cfg, "cpu"), mesh,
                          tv.vit_sharding_rules("tp"))
    try:
        tv.vit_forward(params, torch.zeros(4, 16, 16, 3), cfg, mesh=mesh,
                       rules=tv.vit_sharding_rules("tp"))
        out["bad_heads"] = None
    except ValueError as exc:
        out["bad_heads"] = str(exc)
    return out


def collectives_worker(rank, world, payload):
    """The ring and the in-graph reductions on this rank's inputs
    (``payload["inputs"][name][rank]``, numpy) -> their results (numpy),
    the error-feedback residuals and the byte counters."""
    from ray_tpu_torch.util import metrics
    inputs = payload["inputs"]
    t = {k: torch.from_numpy(v[rank]) for k, v in inputs.items()}
    out = {"exact_sum": C.allreduce(t["ints"], "sum").numpy(),
           "exact_mean": C.allreduce(t["ints"], "mean").numpy()}
    for comp in ("int8", "fp8"):
        out[f"ring_{comp}"] = [
            C.allreduce(t["g"], "sum", compression=comp,
                        ef_key=f"leaf_{comp}").numpy()
            for _ in range(2)]
        out[f"residual_{comp}"] = C.error_feedback_residual(
            None, f"leaf_{comp}").numpy()
        out[f"rs_{comp}"] = C.reduce_scatter_flat(
            t["g"], "mean", compression=comp)[0].numpy()
    out["exact"] = C.allreduce(t["g"], "sum").numpy()
    truth = C.allreduce(t["ef"], "mean")
    naive, ef = torch.zeros_like(truth), torch.zeros_like(truth)
    for _ in range(payload["rounds"]):
        naive += C.allreduce(t["ef"], "mean", compression="int8")
        ef += C.allreduce(t["ef"], "mean", compression="int8",
                          ef_key="efleaf")
    n = payload["rounds"]
    out["naive_bias"] = float((naive / n - truth).abs().max())
    out["ef_bias"] = float((ef / n - truth).abs().max())
    out["ops"] = {op: C.allreduce(t["x"], op).numpy()
                  for op in ("prod", "max", "min")}

    def counted(dtype, op="allreduce"):
        return metrics._registry.counters.get(
            ("ray_tpu_train_collective_bytes_total",
             (("dtype", dtype), ("op", op))), 0.0)
    before = {op: counted("float32", op)
              for op in ("reduce_scatter", "allgather")}
    shard, off = C.reduce_scatter_flat(t["rt"], "mean")
    out["roundtrip"] = (C.allgather_flat(shard).numpy(), off, shard.numel(),
                        C.allreduce(t["rt"], "mean").numpy())
    out["halves_bytes"] = {op: counted("float32", op) - b
                           for op, b in before.items()}
    before = {d: counted(d) for d in ("float32", "int8")}
    C.allreduce(t["ones"], "sum")
    C.allreduce(t["ones"], "sum", compression="int8")
    out["bytes"] = {d: counted(d) - before[d] for d in before}
    out["ratio"] = metrics._registry.gauges.get(
        ("ray_tpu_train_collective_compression_ratio",
         (("dtype", "int8"), ("op", "allreduce"))))
    C.reset_error_feedback()
    out["after_reset"] = C.error_feedback_residual(None, "efleaf")
    x = t["x"]
    err0 = torch.zeros_like(x)
    for dtype in ("int8", "fp8"):
        out[f"psum_{dtype}"] = C.quantized_psum(x, None, dtype).numpy()
        out[f"pmean_{dtype}"] = C.quantized_pmean(x, None, dtype).numpy()
        s, e = C.quantized_psum(x, None, dtype, error=err0 + 0.01)
        out[f"psum_ef_{dtype}"] = (s.numpy(), e.numpy())
        out[f"qrs_{dtype}"] = C.quantized_reduce_scatter(
            t["y"], None, dtype).numpy()
        every = [torch.from_numpy(v) for v in inputs["x"]]
        out[f"lockstep_{dtype}"] = C.quantized_psum_lockstep(
            every, dtype)[rank].numpy()
    return out


def zero1_worker(rank, world, payload):
    """Five steps of ZeRO-1 and of DDP from the same f32 tree and the
    same grads (rank's seed), with and without int8 -> the parameters,
    the optimizer states' bytes, and the refusals."""
    params = {"w": torch.linspace(-1.0, 1.0, 1003).reshape(17, 59),
              "b": torch.zeros(59)}
    adam = functools.partial(torch.optim.Adam, lr=0.05, eps=1e-8)
    out = {}
    for comp in (None, "int8"):
        z1 = make_optimizer(adam, params, zero1=True, grad_compression=comp)
        ddp = make_optimizer(adam, params, zero1=False,
                             grad_compression=comp)
        assert isinstance(z1, Zero1Optimizer)
        assert isinstance(ddp, DDPOptimizer)
        p_z1, p_ddp = params, params
        rng = np.random.default_rng(100 + rank)
        for _ in range(payload["steps"]):
            grads = {"w": torch.from_numpy(rng.standard_normal(
                (17, 59)).astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal(59).astype(
                    np.float32))}
            p_z1 = z1.step(p_z1, grads)
            p_ddp = ddp.step(p_ddp, grads)
        out[comp] = ({k: v.numpy().copy() for k, v in p_z1.items()},
                     {k: v.numpy().copy() for k, v in p_ddp.items()},
                     z1.optimizer_state_bytes(),
                     ddp.optimizer_state_bytes())
    mixed = {"w": params["w"].to(torch.bfloat16), "b": params["b"]}
    stepped = DDPOptimizer(adam, mixed).step(
        mixed, {"w": torch.ones(17, 59, dtype=torch.bfloat16),
                "b": torch.ones(59)})
    out["dtypes"] = {k: str(v.dtype) for k, v in stepped.items()}
    try:
        z1.step({"w": params["w"]}, {"w": params["w"]})
        out["resized"] = None
    except ValueError as exc:
        out["resized"] = str(exc)
    return out


def rl_worker(rank, world, payload):
    """``PPOLearner(mesh=)`` over the data axis: three updates on the
    global batch from the JAX weights -> each update's metrics and the
    weights; and ``iter_device_batches(sharding=)``'s staged rows."""
    from ray_tpu_torch.data.iterator import iter_device_batches
    from ray_tpu_torch.parallel.sharding import P
    from ray_tpu_torch.rl import RLModuleSpec
    from ray_tpu_torch.rl.algorithms.ppo import PPOLearner
    from ray_tpu_torch.rl.env import CartPoleTensor
    env = CartPoleTensor()
    spec = RLModuleSpec(env.observation_space, env.action_space, (8,))
    mesh = make_mesh(MeshSpec(data=world), "cpu")
    learner = PPOLearner(spec, seed=0, lr=1e-2, grad_clip=0.5, mesh=mesh,
                         device="cpu")
    learner.set_weights(payload["weights"])
    metrics = [{k: v.item() for k, v in learner.update(
        payload["batch"]).items()} for _ in range(3)]
    staged = [{k: v.numpy() for k, v in b.items()}
              for b in iter_device_batches(
                  iter(payload["stream"]), device="cpu",
                  sharding=(mesh, P(("data", "fsdp"))))]
    return {"metrics": metrics, "weights": learner.get_weights(),
            "staged": staged}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

MODES = ("ddp", "fsdp", "tp", "fsdp_tp")
MODELS = ("vit", "clip", "dit_xl")


def counts():
    return [f.launches for f in (att.flash_attention,
                                 att.flash_attention_bwd_dq,
                                 att.flash_attention_bwd_dkv)]


ADALN_STD = 0.02


def loss_and_grads(model, dev, **kw):
    """``setup_vision(model)``'s loss and the grads of every leaf, from
    seed 0's weights (DiT's adaLN-Zero leaves drawn N(0, ADALN_STD^2):
    at zero most grads are zero) and seed 1's batch, with K1 / K2 / K3's
    launches."""
    if model.startswith("dit"):
        kw["adaln_std"] = ADALN_STD
    _cfg, params, step = bench_train.setup_vision(model, dev, **kw)
    before = counts()
    loss = step.loss_fn()
    grads = torch.autograd.grad(loss, bench_train.parameters(params))
    torch.cuda.synchronize()
    return loss.detach(), grads, [a - b for a, b in zip(counts(), before)]


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_world1_mesh_vision_modes_bit_equal_with_launch_counts(nccl_world1,
                                                               model):
    dev = nccl_world1
    want_loss, want, want_counts = loss_and_grads(model, dev)
    mesh = make_mesh(MeshSpec(), dev)
    for mode in MODES:
        loss, grads, launched = loss_and_grads(model, dev, mesh=mesh,
                                               mode=mode)
        assert launched == want_counts, (model, mode)
        assert torch.equal(loss, want_loss), (model, mode)
        for g, w in zip(grads, want):
            assert torch.equal(g, w), (model, mode)
        del grads
    torch.cuda.empty_cache()


# each model's heads a rank at model 2, by K1's mask (CLIP's image tower
# runs non-causal, its text tower causal)
HEADS_AT_MODEL2 = {"vit": {False: 6}, "clip": {False: 6, True: 4},
                   "dit_xl": {False: 8}}
ATTN_REL_L2 = 2e-2  # bf16 K1-K3 against the plain f32 attention


def first_attention_calls(run):
    """``run()`` with the (q, k, v) of K1's first call for each mask
    kept -> (run's result, {causal: (q, k, v)})."""
    seen, forward = {}, att._flash_forward

    def spy(q, k, v, causal):
        if causal not in seen:
            seen[causal] = tuple(t.detach().clone() for t in (q, k, v))
        return forward(q, k, v, causal)

    att._flash_forward = spy
    try:
        return run(), seen
    finally:
        att._flash_forward = forward


def attention_vs_reference(q, k, v, causal, gen):
    """K1 and K2 / K3 on (q, k, v) (their plain versions on a CPU tensor)
    against the plain f32 attention and its autograd grads under one
    random dO -> relative L2 of o, dq, dk, dv."""
    o, lse = att.flash_attention_fwd(q, k, v, causal)
    do = torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
    got = (o, *att._flash_backward(q, k, v, o, lse, do, causal))
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = att._attention_reference(*leaves, causal)
    want_grads = torch.autograd.grad(want, leaves, do.float())
    return [_rel(g, w) for g, w in zip(got, (want, *want_grads))]


def nccl_vision_worker(rank, world, payload):
    """On ``world`` cards over NCCL, rank r on card r (or ``payload``'s
    device type): each model's unsharded loss, grads and K1-K3 launches
    on this card, then its fsdp 2 x model 2 run -> per model (relative
    loss error, the relative L2 of each of this rank's grads against the
    same slice of the unsharded grads, the sharded and the unsharded
    launches, and per K1 mask the heads of its first call and that call's
    attention against the plain version); the int8 ring's result beside
    the uncompressed all-reduce's, and ZeRO-1's and DDP's parameters
    after three steps from the same grads."""
    dev = torch.device("cuda", rank) if payload is None else torch.device(
        payload)
    out = {}
    mesh = make_mesh(MeshSpec(fsdp=2, model=2), dev)
    sizes, coords = mesh_shape(mesh), mesh_coords(mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(rank)
    for model in MODELS:
        ref_loss, ref_grads, ref_launched = loss_and_grads(model, dev)
        _cfg, full, _step = bench_train.setup_vision(
            model, dev, adaln_std=ADALN_STD if model == "dit_xl" else 0.0)
        it = iter(ref_grads)

        def like(node):
            if isinstance(node, dict):
                return {k: like(v) for k, v in node.items()}
            if isinstance(node, list):
                return [like(v) for v in node]
            return next(it)
        towers = () if model != "clip" else ("vision", "text")
        tree = like(full)
        tree = (stack_layers(tree) if not towers else
                {**tree, **{t: stack_layers(tree[t]) for t in towers}})
        rules = bench_train.VISION_RULES[model]("fsdp_tp")
        want = bench_train.parameters(unstack(
            local_shards(tree, rules, sizes, coords), towers))
        del full, tree, ref_grads
        (loss, grads, launched), calls = first_attention_calls(
            lambda: loss_and_grads(model, dev, mesh=mesh, mode="fsdp_tp"))
        attention = {causal: (q.shape[2], attention_vs_reference(
            q, k, v, causal, gen)) for causal, (q, k, v) in calls.items()}
        out[model] = (abs(loss.item() - ref_loss.item())
                      / abs(ref_loss.item()),
                      [_rel(g, w) for g, w in zip(grads, want)], launched,
                      ref_launched, attention)
        del grads, want, calls
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    g = torch.randn(1 << 20, generator=gen, device=dev)
    out["ring_int8"] = C.allreduce(g, "sum", compression="int8",
                                   ef_key="card").cpu().numpy()
    out["allreduce"] = C.allreduce(g, "sum").cpu().numpy()
    params = {"w": torch.linspace(-1.0, 1.0, 1 << 20, device=dev)}
    grads = [{"w": torch.randn(1 << 20, generator=gen, device=dev)}
             for _ in range(3)]
    adam = functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-8)
    for name, cls in (("zero1", Zero1Optimizer), ("ddp", DDPOptimizer)):
        opt, p = cls(adam, params), params
        for grad in grads:
            p = opt.step(p, grad)
        out[name] = p["w"].cpu().numpy()
    return out


@pytest.mark.cuda
def test_sharded_vision_and_grad_sync_over_nccl_on_four_cards(tmp_path):
    """The collectives themselves, which a world-1 mesh never issues:
    each model at fsdp 2 x model 2 against the unsharded run on each
    card, loss within 5e-2 and every grad within 1e-1 relative L2 (the
    vision gates of PERF.md section 2), with the unsharded run's K1-K3
    launches; each K1 mask's first call at H / 2 heads, its K1-K3 within
    ATTN_REL_L2 of the plain f32 attention; the int8 ring within the
    int8 bar (0.02) of the uncompressed all-reduce and the same on every
    rank, and ZeRO-1 within 1e-5 of DDP."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA GPUs")
    results = GroupRun(nccl_vision_worker, 4, None, tmp_path,
                       timeout=900.0, backend="nccl").join()
    for rank, r in enumerate(results):
        for model in MODELS:
            rel_loss, rel_grads, launched, want_launched, attention = r[model]
            print(f"rank {rank} {model}: loss {rel_loss:.3e}, worst grad "
                  f"{max(rel_grads):.3e}, launches {launched}, attention "
                  f"{attention}")
            assert rel_loss <= 5e-2, (rank, model, rel_loss)
            assert max(rel_grads) <= 1e-1, (rank, model, rel_grads)
            assert launched == want_launched and min(launched) > 0, (
                rank, model, launched, want_launched)
            assert {c: h for c, (h, _e) in attention.items()} == \
                HEADS_AT_MODEL2[model], (rank, model, attention)
            for causal, (_h, errs) in attention.items():
                assert max(errs) <= ATTN_REL_L2, (rank, model, causal, errs)
        exact = r["allreduce"]
        rel = np.abs(r["ring_int8"] - exact).max() / np.abs(exact).max()
        z1 = np.abs(r["zero1"] - r["ddp"]).max()
        print(f"rank {rank}: int8 ring {rel:.3e} of the largest sum, "
              f"ZeRO-1 {z1:.3e} from DDP")
        assert rel < 0.02, (rank, rel)
        np.testing.assert_array_equal(r["ring_int8"],
                                      results[0]["ring_int8"])
        np.testing.assert_allclose(r["zero1"], r["ddp"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(r["zero1"], results[0]["zero1"])
