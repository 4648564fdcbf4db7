"""Ring and Ulysses attention and the pipeline on the card, and the
spawned gloo workers of their CPU parity tests.

The ``cuda`` tests (they skip without a GPU) run the ring's per-rank
steps for four virtual ranks on one card against ``flash_attention``
over the whole sequence, with K1-K3's launch counts, and
``ring_attention``, ``ulysses_attention`` and ``pipeline`` through a
world-1 NCCL group. This file imports no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_seq_parallel_card.py``.

The CPU parity tests (``test_torch_ring_attention.py``,
``test_torch_llama_seq_parallel.py``, ``test_torch_pipeline.py``)
compute the JAX side in their own process and run the port over gloo in
processes spawned by :class:`GroupRun`, which import only torch, the
port and this file.
"""

import dataclasses
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import attention as att
from ray_tpu_torch.parallel import _group
from ray_tpu_torch.parallel.pipeline import pipeline
from ray_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_attention, ring_attention_lockstep,
    ulysses_attention)
from ray_tpu_torch.scripts import bench_train

# ---------------------------------------------------------------------------
# spawned gloo workers (CPU)
# ---------------------------------------------------------------------------


def _child(fn, rank, world, store_path, payload_path, out_path, backend):
    torch.set_num_threads(1)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        device = None
        if backend == "nccl":  # rank r on card r
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, device_id=device)
        try:
            result = ("ok", fn(rank, world, payload))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails the test
        result = ("error", traceback.format_exc())
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)


class GroupRun:
    """``fn(rank, world, payload)`` in ``world`` spawned processes joined
    by a process group (a FileStore under ``tmp_dir``; gloo, or NCCL
    with rank r on card r), started at once; :meth:`join` waits for
    their results. The payload goes through a file: a process's
    arguments go through a pipe that ``start`` fills while the child is
    still importing, which would start the children one after
    another."""

    def __init__(self, fn, world, payload, tmp_dir, timeout=120.0,
                 backend="gloo"):
        ctx = multiprocessing.get_context("spawn")
        tmp_dir = str(tmp_dir)
        os.makedirs(tmp_dir, exist_ok=True)
        payload_path = os.path.join(tmp_dir, f"payload_{world}.pkl")
        with open(payload_path, "wb") as f:
            pickle.dump(payload, f)
        self.name, self.world, self.timeout = fn.__name__, world, timeout
        self.outs = [os.path.join(tmp_dir, f"result_{world}_{rank}.pkl")
                     for rank in range(world)]
        self.procs = [ctx.Process(target=_child, args=(
            fn, rank, world, os.path.join(tmp_dir, f"store_{world}"),
            payload_path, self.outs[rank], backend))
            for rank in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def _failed(self) -> bool:
        for path in self.outs:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    if pickle.load(f)[0] == "error":
                        return True
        return False

    def close(self) -> None:
        """Kill every child still running."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)

    def join(self):
        """The results by rank. A child that raises, or a run past the
        timeout, kills every child still running and fails the test."""
        try:
            while any(p.is_alive() for p in self.procs) \
                    and time.monotonic() < self.deadline \
                    and not self._failed():
                time.sleep(0.05)
        finally:
            self.close()
        results, report = [], []
        for rank, path in enumerate(self.outs):
            if not os.path.exists(path):
                report.append(f"rank {rank}: no result (exit code "
                              f"{self.procs[rank].exitcode})")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                report.append(f"rank {rank}:\n{value}")
            results.append(value)
        if report:
            pytest.fail(f"world {self.world} of {self.name} failed "
                        f"(timeout {self.timeout} s):\n" + "\n".join(report))
        return results


def _shard(a: np.ndarray, rank: int, world: int, axis: int = 1):
    """This rank's contiguous shard of ``a`` along ``axis``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.split(a, world, axis=axis)[rank]))


def attention_worker(rank, world, cases):
    """Each case: kind "ring" / "ulysses" over the sequence shards of q,
    k, v, g (numpy [B, S, *, D]) -> the shards of the output and of the
    grads of sum(out * g); kind "bad_heads" / "gloo_cuda" -> the message
    of the ValueError raised."""
    out = []
    for case in cases:
        if case["kind"] == "bad_heads":
            q = torch.zeros((1, 4, case["heads"], 16))
            try:
                ulysses_attention(q, q, q)
            except ValueError as exc:
                out.append(str(exc))
            continue
        if case["kind"] == "gloo_cuda":
            try:
                _group.resolve(None, torch.device("cuda"))
            except ValueError as exc:
                out.append(str(exc))
            continue
        q, k, v = (_shard(case[n], rank, world).requires_grad_()
                   for n in "qkv")
        fn = ring_attention if case["kind"] == "ring" else ulysses_attention
        o = fn(q, k, v, causal=case["causal"])
        (o * _shard(case["g"], rank, world)).sum().backward()
        out.append({"out": o.detach().numpy(), "dq": q.grad.numpy(),
                    "dk": k.grad.numpy(), "dv": v.grad.numpy()})
    return out


def _grads_like_jax(params):
    """Grads of an unstacked port tree in the JAX tree's layout (numpy)."""
    layers = params["layers"]
    return {
        "embedding": params["embedding"].grad.numpy(),
        "final_norm": params["final_norm"].grad.numpy(),
        "lm_head": params["lm_head"].grad.numpy(),
        "layers": {name: torch.stack([lp[name].grad for lp in layers])
                   .numpy() for name in layers[0]},
    }


def _tree_numpy(params):
    stacked = tl.stack_layers(params)
    return {k: ({n: t.detach().numpy() for n, t in v.items()}
                if isinstance(v, dict) else v.detach().numpy())
            for k, v in stacked.items()}


def llama_worker(rank, world, payload):
    """``payload``: JAX weights (numpy tree), tokens and targets [B, S],
    ``cases`` (LlamaConfig.tiny keywords) and ``step`` (keywords of one
    training step) -> per case (loss, grads summed over the group), and
    the parameters after the step, from this rank's shard."""
    tokens = _shard(payload["tokens"], rank, world).long()
    targets = _shard(payload["targets"], rank, world).long()

    def fresh():
        params = tl.unstack_layers(convert.params_from_jax(
            payload["params"], device="cpu"))
        for t in bench_train.parameters(params):
            t.requires_grad_(True)
        return params

    cases = []
    for kw in payload["cases"]:
        params = fresh()
        loss = tl.llama_loss(params, tokens, targets,
                             tl.LlamaConfig.tiny(**kw))
        loss.backward()
        bench_train.all_reduce_grads(bench_train.parameters(params), None)
        cases.append((loss.item(), _grads_like_jax(params)))
    params = fresh()
    step = bench_train.make_train_step(tl.LlamaConfig.tiny(**payload["step"]),
                                       params)
    loss = step(tokens, targets).item()
    return {"cases": cases, "step_loss": loss,
            "stepped": _tree_numpy(params)}


def pipeline_worker(rank, world, payload):
    """The reference's four pipeline scenarios on this rank's stage:
    ``w`` [S, d, d] (stage s holds w[s]), the global batches ``x`` of
    the parity and multi-round cases in the strided layout -> this
    rank's outputs, the grads of sum(out^2) with and without remat, and
    the messages of the two rejections."""

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"])

    def local(x, n_micro):
        """Microbatches rank, rank + S, ... of x, concatenated."""
        rounds = n_micro // world
        mb = x.shape[0] // n_micro
        share = x.reshape(rounds, world, mb, *x.shape[1:])[:, rank]
        return torch.from_numpy(np.ascontiguousarray(
            share.reshape(rounds * mb, *x.shape[1:])))

    out = {}
    seq = payload["sequential"]
    w = {"w": torch.from_numpy(seq["w"][rank])}
    out["sequential"] = pipeline(stage_fn, w, local(seq["x"], 4),
                                 num_microbatches=4).numpy()
    multi = payload["multi_round"]
    x = local(multi["x"], 12)
    out["multi_round"] = pipeline(
        stage_fn, {"w": torch.from_numpy(multi["w"][rank])}, x,
        num_microbatches=12).numpy()
    for remat in (False, True):
        w = {"w": torch.from_numpy(multi["w"][rank]).requires_grad_()}
        xg = x.clone().requires_grad_()
        y = pipeline(stage_fn, w, xg, num_microbatches=12, remat=remat)
        (y ** 2).sum().backward()
        out[f"grad_remat_{remat}"] = (w["w"].grad.numpy(), xg.grad.numpy())
    for name, (rows, n_micro) in (("bad_microbatch", (3, 8)),
                                  ("uneven_stages", (3, 6))):
        try:
            pipeline(lambda p, x: x, {"w": torch.zeros((8, 8))},
                     torch.zeros((rows, 8)), num_microbatches=n_micro)
        except ValueError as exc:
            out[name] = str(exc)
    return out


def nccl_worker(rank, world, payload):
    """On ``world`` cards over NCCL, rank r on card r, every input drawn
    from one seed on each card: ring and Ulysses attention at B1
    S(2048 world) H32 KVH8 D128 against ``flash_attention`` over the
    whole sequence; a 2-layer Llama-3-8B-width loss and summed grads with
    ring and Ulysses against flash's over the whole sequence; ``pipeline``
    with one Llama block a stage against the blocks run in turn ->
    (relative L2 errors, launches) per check, from this rank's share."""
    dev = torch.device("cuda", rank)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}

    def shard(t):
        return t.chunk(world, dim=1)[rank].contiguous()

    q, k, v, do = _qkvg(dev, 1, 2048 * world, 32, 8, 128)
    for causal in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = att.flash_attention(*leaves, causal)
        o.backward(do)
        want = [shard(t) for t in [o.detach()] + [t.grad for t in leaves]]
        for name, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention)):
            leaves = [shard(t).requires_grad_() for t in (q, k, v)]
            before = _counts()
            o = fn(*leaves, causal=causal)
            o.backward(shard(do))
            torch.cuda.synchronize()
            got = [o.detach()] + [t.grad for t in leaves]
            out[(name, causal)] = ([_rel(a, b) for a, b in zip(got, want)],
                                   [a - b for a, b in zip(_counts(),
                                                          before)])

    cfg = dataclasses.replace(
        tl.LlamaConfig.llama3_8b(ce_chunk_tokens=1024), n_layers=2)
    params = tl.unstack_layers(tl.llama_init(0, cfg, dev))
    leaves = bench_train.parameters(params)
    for t in leaves:
        t.requires_grad_(True)
    tokens, targets = (torch.randint(0, cfg.vocab_size, (1, 2048 * world),
                                     generator=gen, device=dev)
                       for _ in range(2))
    loss = tl.llama_loss(params, tokens, targets,
                         dataclasses.replace(cfg, attention="flash"), None)
    want = torch.autograd.grad(loss, leaves)
    want_loss = loss.item()
    for attention in ("ring", "ulysses"):
        c = dataclasses.replace(cfg, attention=attention)
        loss = tl.llama_loss(params, shard(tokens), shard(targets), c)
        loss.backward()
        bench_train.all_reduce_grads(leaves, None)
        out[attention] = (abs(loss.item() - want_loss) / abs(want_loss),
                          max(_rel(t.grad, w) for t, w in zip(leaves, want)))
        for t in leaves:
            t.grad = None

    cfg = dataclasses.replace(tl.LlamaConfig.llama3_8b(), n_layers=world)
    layers = tl.unstack_layers(tl.llama_init(1, cfg, dev))["layers"]
    cos, sin = tl.rope_frequencies(cfg.head_dim, 512, cfg.rope_theta,
                                   device=dev)

    def block(p, x):
        return tl._block(p, x, cos, sin, cfg)[0]

    n_micro = 2 * world
    x = torch.randn((n_micro, 512, cfg.dim), generator=gen,
                    device=dev).bfloat16()
    for lp in layers:
        for t in lp.values():
            t.requires_grad_(True)
    mine = x.reshape(2, world, 1, 512, cfg.dim)[:, rank].reshape(
        2, 512, cfg.dim).clone().requires_grad_()
    y = pipeline(block, layers[rank], mine, num_microbatches=n_micro,
                 remat=True)
    (y.float().square().sum() / x.numel()).backward()
    got = [t.grad.clone() for t in layers[rank].values()]
    for lp in layers:
        for t in lp.values():
            t.grad = None
    xs = x.clone().requires_grad_()
    seq = []
    for i in range(n_micro):
        h = xs[i:i + 1]
        for lp in layers:
            h = block(lp, h)
        (h.float().square().sum() / x.numel()).backward()
        seq.append(h.detach())
    seq = torch.cat(seq).reshape(2, world, 1, 512, cfg.dim)[:, rank]
    out["pipeline"] = (
        torch.equal(y.detach(), seq.reshape(y.shape)),
        max(_rel(a, t.grad) for a, t in zip(got, layers[rank].values())),
        _rel(mine.grad, xs.grad.reshape(2, world, 1, 512, cfg.dim)[
            :, rank].reshape(mine.shape)))
    return out


def unshard_microbatches(outs, n_micro):
    """Per-rank strided outputs [R * mb, ...] -> the global batch."""
    world = len(outs)
    rounds = n_micro // world
    per = [o.reshape(rounds, -1, *o.shape[1:]) for o in outs]
    stacked = np.stack(per, axis=1)            # [R, S, mb, ...]
    return stacked.reshape(-1, *stacked.shape[3:])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def nccl_world1(cuda_device):
    """A world-1 NCCL default group (a HashStore: no port is bound)."""
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=cuda_device)
    try:
        yield cuda_device
    finally:
        dist.destroy_process_group()


def _counts():
    return [f.launches for f in (att.flash_attention,
                                 att.flash_attention_bwd_dq,
                                 att.flash_attention_bwd_dkv)]


def _qkvg(dev, b, s, h, kvh, d, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn((b, s, heads, d), generator=gen, device=dev)
            .bfloat16() for heads in (h, kvh, kvh, h)]


def _rel(a, b):
    return (torch.linalg.vector_norm(a.float() - b.float())
            / torch.linalg.vector_norm(b.float())).item()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_four_virtual_ranks_match_flash_with_launch_counts(cuda_device,
                                                           causal):
    n = 4
    q, k, v, do = _qkvg(cuda_device, 1, 4 * 512, 8, 2, 128)
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    want = att.flash_attention(qf, kf, vf, causal)
    want.backward(do)
    chunks = [list(t.chunk(n, dim=1)) for t in (q, k, v, do)]
    chunks = [[c.contiguous() for c in ts] for ts in chunks]
    before = _counts()
    outs, dqs, dks, dvs = ring_attention_lockstep(*chunks[:3], causal,
                                                  chunks[3])
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    assert launched == [n * (n + 1) // 2 if causal else n * n] * 3
    for got, ref, tol in ((outs, want, 1e-2), (dqs, qf.grad, 2e-2),
                          (dks, kf.grad, 2e-2), (dvs, vf.grad, 2e-2)):
        assert _rel(torch.cat(got, dim=1), ref) <= tol
    exact = reference_attention(q, k, v, causal=causal)
    assert _rel(torch.cat(outs, dim=1), exact) <= 1e-2


@pytest.mark.cuda
def test_ring_and_ulysses_through_a_world1_nccl_group(nccl_world1):
    dev = nccl_world1
    q, k, v, do = _qkvg(dev, 1, 1024, 8, 2, 128, seed=1)
    results = {}
    for name, fn in (("flash", lambda a, b, c: att.flash_attention(
            a, b, c, True)), ("ring", ring_attention),
                     ("ulysses", ulysses_attention)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = _counts()
        out = fn(*leaves)
        out.backward(do)
        torch.cuda.synchronize()
        results[name] = (out, *[t.grad for t in leaves])
        assert [a - b for a, b in zip(_counts(), before)] == [1, 1, 1]
    for name in ("ring", "ulysses"):
        for got, want in zip(results[name], results["flash"]):
            assert torch.equal(got, want), name


@pytest.mark.cuda
def test_gloo_group_refuses_cuda_tensors(nccl_world1):
    gloo = dist.new_group(backend="gloo")
    q = torch.zeros((1, 128, 2, 128), dtype=torch.bfloat16,
                    device=nccl_world1)
    with pytest.raises(ValueError, match="gloo"):
        ring_attention(q, q, q, gloo)
    with pytest.raises(ValueError, match="gloo"):
        ulysses_attention(q, q, q, gloo)


@pytest.mark.cuda
def test_pipeline_and_llama_ring_through_a_world1_nccl_group(nccl_world1):
    dev = nccl_world1
    cfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16, attention="flash",
                              dim=256, n_heads=2, n_kv_heads=1)
    params = tl.unstack_layers(tl.llama_init(0, cfg, dev))
    for t in bench_train.parameters(params):
        t.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=dev)
    losses = {}
    for attention in ("flash", "ring", "ulysses"):
        c = dataclasses.replace(cfg, attention=attention)
        loss = tl.llama_loss(params, tokens, tokens, c)
        grads = torch.autograd.grad(loss, bench_train.parameters(params))
        losses[attention] = (loss, grads)
    for attention in ("ring", "ulysses"):
        assert torch.equal(losses[attention][0], losses["flash"][0])
        for g, w in zip(losses[attention][1], losses["flash"][1]):
            assert torch.equal(g, w)

    layer = params["layers"][0]
    cos, sin = tl.rope_frequencies(cfg.head_dim, 128, cfg.rope_theta,
                                   device=dev)

    def stage(p, x):
        return tl._block(p, x, cos, sin, cfg)[0]

    x = torch.randn((4, 128, cfg.dim), device=dev).bfloat16()
    xs = x.clone().requires_grad_()
    got = pipeline(stage, layer, xs, num_microbatches=4, remat=True)
    got.float().square().sum().backward()
    g_pipe = [layer[n].grad.clone() for n in layer]
    for n in layer:
        layer[n].grad = None
    xr = x.clone().requires_grad_()
    want = torch.cat([stage(layer, xr[i:i + 1]) for i in range(4)])
    want.float().square().sum().backward()
    assert torch.equal(got, want)
    assert _rel(xs.grad, xr.grad) <= 1e-2
    for g, n in zip(g_pipe, layer):
        assert _rel(g, layer[n].grad) <= 1e-2, n


@pytest.mark.cuda
def test_ring_ulysses_llama_and_pipeline_over_nccl_on_four_cards(tmp_path):
    """The exchanges themselves (P2P and all-to-all over NCCL), which a
    world-1 group never makes."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA GPUs")
    world = 4
    results = GroupRun(nccl_worker, world, None, tmp_path, timeout=300.0,
                       backend="nccl").join()
    for rank, r in enumerate(results):
        for causal in (True, False):
            blocks = (rank + 1) if causal else world
            for name, launched in (("ring", [blocks] * 3),
                                   ("ulysses", [1, 1, 1])):
                errors, counts = r[(name, causal)]
                assert counts == launched, (rank, name, causal)
                assert errors[0] <= 1e-2, (rank, name, causal, errors)
                assert max(errors[1:]) <= 2e-2, (rank, name, causal, errors)
        for attention in ("ring", "ulysses"):
            rel_loss, rel_grads = r[attention]
            assert rel_loss <= 1e-3 and rel_grads <= 5e-2, (
                rank, attention, rel_loss, rel_grads)
        out_equal, rel_w, rel_x = r["pipeline"]
        assert out_equal and rel_w <= 1e-2 and rel_x <= 1e-2, (
            rank, r["pipeline"])
