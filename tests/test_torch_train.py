"""The port's training step (ray_tpu_torch.scripts.bench_train) against
the JAX package's: ``jax.value_and_grad(llama_loss)`` then
``optax.adamw(3e-4, weight_decay=0.01)``, as ``bench.py``'s
``_bench_config`` steps. Same weights on both sides (``params_from_jax``),
same tokens (numpy seed), f32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.scripts import bench_train


def _jax_steps(jcfg, jp, toks, tgts, n):
    opt = optax.adamw(3e-4, weight_decay=0.01)
    state = opt.init(jp)
    losses = []
    for _ in range(n):
        loss, grads = jax.value_and_grad(
            lambda p: jl.llama_loss(p, toks, tgts, jcfg))(jp)
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        losses.append(float(loss))
    return losses, jp


@pytest.mark.parametrize("kw", [dict(), dict(attention="flash",
                                             ce_chunk_tokens=8)],
                         ids=["gqa", "flash-chunked"])
def test_adamw_trajectory_matches_optax(kw):
    jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    jp = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 12)).astype(np.int32)
    tgts = rng.integers(0, 256, (2, 12)).astype(np.int32)
    want_losses, want = _jax_steps(jcfg, jp, jnp.asarray(toks),
                                   jnp.asarray(tgts), 3)

    tp = tl.unstack_layers(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    step = bench_train.make_train_step(tcfg, tp)
    losses = [step(torch.from_numpy(toks).long(),
                   torch.from_numpy(tgts).long()).item() for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, atol=1e-5)
    assert losses[2] < losses[0]
    got = tl.stack_layers(tp)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.detach().numpy(), np.asarray(leaf),
                                   atol=1e-5, err_msg=str(path))


def test_train_step_updates_every_leaf_once():
    cfg = tl.LlamaConfig.tiny()
    params = tl.unstack_layers(tl.llama_init(0, cfg, device="cpu"))
    before = [t.clone() for t in bench_train.parameters(params)]
    step = bench_train.make_train_step(cfg, params)
    toks = torch.randint(0, 256, (1, 8))
    loss = step(toks, toks)
    assert loss.dim() == 0 and loss.grad_fn is None
    after = bench_train.parameters(params)
    assert len(after) == 3 + 9 * cfg.n_layers
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


def test_bench_config_on_cpu_reports_no_device_metric():
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), ce_chunk_tokens=4)
    out = bench_train.bench_config(cfg, batch=1, seq=8, steps=1,
                                   device="cpu")
    assert out["metric"] == "llama_train_tokens_per_sec_per_chip"
    assert out["device"] == "cpu" and out["mfu"] is None
    assert out["ce_chunk_tokens"] == 4 and out["batch"] == 1
    assert np.isfinite(out["final_loss"])


def test_bench_train_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        bench_train.bench_config(tl.LlamaConfig.tiny(), 1, 8, 1)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        bench_train.main()
