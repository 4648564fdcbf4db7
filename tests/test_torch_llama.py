"""The port's Llama (ray_tpu_torch.models) against the JAX package's.

Both sides run the same weights: ``llama_init`` of the JAX package from
PRNGKey(0), carried over by ``params_from_jax``. Everything runs in f32
on the CPU (the port's plain versions), so the tolerances cover the
order of f32 sums only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.scripts.bench_train import parameters

CONFIGS = {
    "gqa": dict(),                # tiny: 4 query heads over 2 KV heads
    "mha": dict(n_kv_heads=4),
    "flash": dict(attention="flash"),
}


def _configs(name):
    kw = CONFIGS[name]
    return jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)


def _params(jcfg):
    jp = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    return jp, convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                       device="cpu")


def _tokens(n=12, batch=1, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (batch, n)).astype(
        np.int32)


@pytest.mark.parametrize("name", ["gqa", "mha"])
def test_params_from_jax_exact(name):
    jcfg, _ = _configs(name)
    jp, tp = _params(jcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(tp["layers"]) + 3
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_params_from_jax_bf16_bits_exact():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.bfloat16)
    jp, tp = _params(jcfg)
    assert tp["lm_head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["lm_head"].view(torch.int16).numpy(),
        np.asarray(jp["lm_head"]).view(np.int16))


@pytest.mark.parametrize("name", ["gqa", "mha", "flash"])
def test_forward_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    toks = _tokens(batch=2)
    want = np.asarray(jl.llama_forward(jp, jnp.asarray(toks), jcfg))
    got = tl.llama_forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("name", ["gqa", "mha"])
def test_prefill_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    toks = _tokens(16)
    jlog, jks, jvs = jl.llama_prefill(jp, jnp.asarray(toks), jcfg)
    tlog, tks, tvs = tl.llama_prefill(tp, torch.from_numpy(toks).long(), tcfg)
    assert tuple(tks.shape) == jks.shape == (2, 1, 16, tcfg.n_kv_heads,
                                             tcfg.head_dim)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), atol=1e-5)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=1e-5)


@pytest.mark.parametrize("name", ["gqa", "mha"])
def test_decode_step_after_prefill_matches_jax(name):
    """The scenario of the JAX package's decode test: prefill 10 tokens,
    seat them in a 16-row cache, decode one more."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    toks = np.arange(10, dtype=np.int32)[None, :]
    _, jks, jvs = jl.llama_prefill(jp, jnp.asarray(toks), jcfg)
    jck, jcv = jl.llama_init_cache(jcfg, 1, 16)
    jck = jck.at[:, :, :10].set(jks)
    jcv = jcv.at[:, :, :10].set(jvs)
    jlog, jck2, _ = jl.llama_decode_step(jp, jnp.array([3], jnp.int32), jck,
                                         jcv, jnp.array([10]), jcfg)

    _, tks, tvs = tl.llama_prefill(tp, torch.from_numpy(toks).long(), tcfg)
    tck, tcv = tl.llama_init_cache(tcfg, 1, 16, device="cpu")
    tck[:, :, :10] = tks
    tcv[:, :, :10] = tvs
    tlog, tck2, _ = tl.llama_decode_step(tp, torch.tensor([3]), tck, tcv,
                                         torch.tensor([10]), tcfg)
    assert tck2 is tck  # written in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    np.testing.assert_allclose(tck2.numpy(), np.asarray(jck2), atol=1e-5)
    # and the decode agrees with the port's own full forward
    full = tl.llama_forward(
        tp, torch.from_numpy(np.append(toks, [[3]], axis=1)).long(), tcfg)
    np.testing.assert_allclose(tlog[0].numpy(), full[0, -1].numpy(),
                               atol=1e-4)


def test_int8_ffn_matches_jax_quantized_forward():
    jcfg, tcfg = _configs("gqa")
    jp, tp = _params(jcfg)
    jq = jl.quantize_llama_ffn(jp, jcfg)
    tq = tl.quantize_llama_ffn(tp, tcfg)
    assert "w1" not in tq["layers"] and tq["layers"]["w1_q8"].dtype == \
        torch.int8
    for name in ("w1", "w3", "w2"):
        np.testing.assert_array_equal(tq["layers"][name + "_q8"].numpy(),
                                      np.asarray(jq["layers"][name + "_q8"]))
        np.testing.assert_allclose(tq["layers"][name + "_s"].numpy(),
                                   np.asarray(jq["layers"][name + "_s"]),
                                   rtol=0, atol=1e-7)
    toks = _tokens()
    want = np.asarray(jl.llama_forward(jq, jnp.asarray(toks), jcfg))
    got = tl.llama_forward(tq, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_llama_init_is_seeded_and_shaped():
    cfg = tl.LlamaConfig.tiny()
    a = tl.llama_init(7, cfg, device="cpu")
    b = tl.llama_init(7, cfg, device="cpu")
    assert torch.equal(a["layers"]["w2"], b["layers"]["w2"])
    assert tuple(a["layers"]["wk"].shape) == (2, 64, 32)
    assert a["embedding"].dtype == torch.float32
    n = sum(t.numel() for t in [a["embedding"], a["lm_head"],
                                a["final_norm"], *a["layers"].values()])
    assert n == cfg.num_params()


def test_config_presets_match_jax():
    for preset in ("llama2_7b", "llama3_8b", "small_1b", "mixtral_8x7b"):
        j = getattr(jl.LlamaConfig, preset)()
        t = getattr(tl.LlamaConfig, preset)()
        same = {f.name for f in dataclasses.fields(t)} - {"dtype"}
        assert {n: getattr(t, n) for n in same} == \
            {n: getattr(j, n) for n in same}
        assert t.num_params() == j.num_params()
        assert t.flops_per_token() == j.flops_per_token()


def test_moe_and_sequence_parallel_are_not_ported():
    with pytest.raises(NotImplementedError):
        tl.llama_init(0, tl.LlamaConfig.tiny_moe(), device="cpu")
    cfg = tl.LlamaConfig.tiny(attention="ring")
    p = tl.llama_init(0, tl.LlamaConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        tl.llama_forward(p, torch.zeros((1, 4), dtype=torch.long), cfg)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tl.llama_init(0, tl.LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.llama_init_cache(tl.LlamaConfig.tiny(), 1, 8)


# --- training: loss and grads ----------------------------------------------

def _grads_like_jax(tp_unstacked):
    """Grads of the unstacked port tree, stacked back into the JAX tree's
    layout as numpy."""
    layers = tp_unstacked["layers"]
    return {
        "embedding": tp_unstacked["embedding"].grad.numpy(),
        "final_norm": tp_unstacked["final_norm"].grad.numpy(),
        "lm_head": tp_unstacked["lm_head"].grad.numpy(),
        "layers": {name: torch.stack([lp[name].grad for lp in layers]).numpy()
                   for name in layers[0]},
    }


@pytest.mark.parametrize("name,chunk,masked,remat", [
    ("gqa", 0, False, False),
    ("flash", 0, False, False),
    ("gqa", 0, True, False),
    ("gqa", 5, False, False),     # 24 tokens: 5 does not divide them
    ("flash", 5, True, False),
    ("flash", 0, False, True),
    ("gqa", 7, True, True),
])
def test_llama_loss_and_grads_match_jax(name, chunk, masked, remat):
    kw = dict(CONFIGS[name], ce_chunk_tokens=chunk, remat=remat)
    jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    jp, tp = _params(jcfg)
    toks = _tokens(batch=2)
    tgts = _tokens(batch=2, seed=1)
    mask = (np.random.default_rng(2).random((2, 12)) < 0.7).astype(
        np.float32) if masked else None
    jloss, jgrads = jax.value_and_grad(
        lambda p: jl.llama_loss(p, jnp.asarray(toks), jnp.asarray(tgts),
                                jcfg, mask=None if mask is None
                                else jnp.asarray(mask)))(jp)

    tp = tl.unstack_layers(tp)
    for t in parameters(tp):
        t.requires_grad_(True)
    loss = tl.llama_loss(tp, torch.from_numpy(toks).long(),
                         torch.from_numpy(tgts).long(), tcfg,
                         mask=None if mask is None
                         else torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    got = _grads_like_jax(tp)
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


def test_unstack_then_stack_gives_back_the_tree():
    _, tp = _params(jl.LlamaConfig.tiny())
    un = tl.unstack_layers(tp)
    assert isinstance(un["layers"], list) and len(un["layers"]) == 2
    assert un["layers"][1]["wq"].is_contiguous()
    assert un["layers"][1]["wq"].data_ptr() != tp["layers"]["wq"].data_ptr()
    back = tl.stack_layers(un)
    assert back["layers"].keys() == tp["layers"].keys()
    for key, stack in tp["layers"].items():
        assert torch.equal(back["layers"][key], stack)
    for key in ("embedding", "final_norm", "lm_head"):
        assert back[key] is tp[key]
    # and both forms give the same forward
    toks = torch.from_numpy(_tokens()).long()
    cfg = tl.LlamaConfig.tiny()
    np.testing.assert_array_equal(tl.llama_forward(un, toks, cfg).numpy(),
                                  tl.llama_forward(tp, toks, cfg).numpy())


def test_forward_keeps_no_graph_under_no_grad_and_hidden_matches():
    jcfg, tcfg = _configs("gqa")
    jp, tp = _params(jcfg)
    toks = _tokens(batch=2)
    want = np.asarray(jl.llama_forward(jp, jnp.asarray(toks), jcfg,
                                       return_hidden=True))
    got, aux = tl.llama_forward(tp, torch.from_numpy(toks).long(), tcfg,
                                return_aux=True, return_hidden=True)
    assert got.grad_fn is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
