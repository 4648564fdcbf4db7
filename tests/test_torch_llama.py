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
    """Both are ported now; the name is kept from when they were not.
    The MoE branch (tests/test_torch_moe.py): its init builds the
    reference's router and expert stacks. Sequence parallelism
    (tests/test_torch_llama_seq_parallel.py): a ring forward at world 1
    (no process group) equals flash's."""
    moe = tl.llama_init(0, tl.LlamaConfig.tiny_moe(), device="cpu")
    assert tuple(moe["layers"]["router"].shape) == (2, 64, 4)
    assert tuple(moe["layers"]["w2"].shape) == (2, 4, 128, 64)
    p = tl.llama_init(0, tl.LlamaConfig.tiny(), device="cpu")
    toks = torch.from_numpy(_tokens(n=16, batch=2)).long()
    flash = tl.llama_forward(p, toks, tl.LlamaConfig.tiny(attention="flash"))
    ring = tl.llama_forward(p, toks, tl.LlamaConfig.tiny(attention="ring"))
    np.testing.assert_allclose(ring.numpy(), flash.numpy(), atol=1e-6,
                               rtol=1e-6)


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


# --------------------------------------------- LoRA, the bank, verify step

def _jax_adapter(jcfg, seed, rank):
    """A JAX adapter with random nonzero B (a fresh one is the identity)."""
    key = jax.random.PRNGKey(seed)
    lora = jl.lora_init(key, jcfg, rank=rank)
    for i, part in enumerate(("B_q", "B_v")):
        lora[part] = jax.random.normal(jax.random.fold_in(key, i + 1),
                                       lora[part].shape) * 0.5
    return lora


def test_jax_adapter_carried_over_with_its_0d_scale():
    jcfg, _ = _configs("gqa")
    lora = _jax_adapter(jcfg, 3, 4)
    got = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, lora),
                                  device="cpu")
    assert got["scale"].dim() == 0 and float(got["scale"]) == 4.0
    for part in ("A_q", "B_q", "A_v", "B_v"):
        np.testing.assert_array_equal(got[part].numpy(),
                                      np.asarray(lora[part]))
    fresh = tl.lora_init(0, tl.LlamaConfig.tiny(), rank=4, alpha=8.0,
                         device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    assert float(fresh["scale"]) == 2.0 and not fresh["B_q"].any()


@pytest.mark.parametrize("name", ["gqa", "mha"])
def test_lora_prefill_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    lora = _jax_adapter(jcfg, 3, 4)
    tlora = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, lora),
                                    device="cpu")
    toks = _tokens(12)
    jlog, jks, jvs = jl.llama_prefill(jp, jnp.asarray(toks), jcfg, lora=lora)
    tlog, tks, tvs = tl.llama_prefill(tp, torch.from_numpy(toks).long(),
                                      tcfg, lora=tlora)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=1e-5)
    base, _, _ = tl.llama_prefill(tp, torch.from_numpy(toks).long(), tcfg)
    assert (tlog - base).abs().max() > 1e-2  # the adapter does something


def _seated_caches(jp, jcfg, batch, rows, prompt_len):
    """Both sides' caches with one prompt's prefill K/V seated in each
    of ``batch`` rows."""
    toks = _tokens(prompt_len)
    _, jks, jvs = jl.llama_prefill(jp, jnp.asarray(toks), jcfg)
    jck, jcv = jl.llama_init_cache(jcfg, batch, rows)
    jck = jck.at[:, :, :prompt_len].set(jnp.repeat(jks, batch, axis=1))
    jcv = jcv.at[:, :, :prompt_len].set(jnp.repeat(jvs, batch, axis=1))
    tck = torch.from_numpy(np.array(jck))
    tcv = torch.from_numpy(np.array(jcv))
    return jck, jcv, tck, tcv


@pytest.mark.parametrize("name", ["gqa", "mha"])
def test_decode_step_with_a_bank_matches_jax(name):
    """Three rows, three bank entries (base, and two adapters of which
    one is rank-padded), in one step."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    n, r = 3, 8
    bank = {part: np.zeros((n, jcfg.n_layers) + shape, np.float32)
            for part, shape in (("A_q", (jcfg.dim, r)),
                                ("B_q", (r, jcfg.n_heads * jcfg.head_dim)),
                                ("A_v", (jcfg.dim, r)),
                                ("B_v", (r, jcfg.n_kv_heads * jcfg.head_dim)))}
    for idx, rank in ((1, 4), (2, 8)):
        lora = _jax_adapter(jcfg, idx, rank)
        for part in bank:
            a = np.asarray(lora[part])
            if part.startswith("B"):
                a = a * float(lora["scale"])
            sl = (idx, slice(None)) + ((slice(None), slice(0, rank))
                                       if part.startswith("A")
                                       else (slice(0, rank),))
            bank[part][sl] = a
    bank["scale"] = np.float32(1.0)
    jbank = {k: jnp.asarray(v) for k, v in bank.items()}
    tbank = convert.params_from_jax(bank, device="cpu")
    idx = np.array([2, 0, 1])
    jck, jcv, tck, tcv = _seated_caches(jp, jcfg, 3, 16, 10)
    tok = np.array([3, 4, 5])
    pos = np.array([10, 10, 10])
    jlog, jck2, jcv2 = jl.llama_decode_step(
        jp, jnp.asarray(tok), jck, jcv, jnp.asarray(pos), jcfg,
        lora_bank=jbank, lora_idx=jnp.asarray(idx))
    tlog, tck2, tcv2 = tl.llama_decode_step(
        tp, torch.from_numpy(tok), tck, tcv, torch.from_numpy(pos), tcfg,
        lora_bank=tbank, lora_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    np.testing.assert_allclose(tcv2.numpy(), np.asarray(jcv2), atol=1e-5)
    # the base row equals a step with no bank at all
    _, _, bck, bcv = _seated_caches(jp, jcfg, 3, 16, 10)
    plain, _, _ = tl.llama_decode_step(tp, torch.from_numpy(tok), bck, bcv,
                                       torch.from_numpy(pos), tcfg)
    np.testing.assert_array_equal(tlog[1].numpy(), plain[1].numpy())


@pytest.mark.parametrize("name", ["gqa", "mha"])
def test_verify_step_matches_jax_with_a_parked_row(name):
    """Row 0 scores a 4-token chunk after its prompt; row 1 is parked at
    the cache's last four rows, as an idle slot is in the engine."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    rows, g = 24, 4
    jck, jcv, tck, tcv = _seated_caches(jp, jcfg, 2, rows, 10)
    chunk = _tokens(g, batch=2, seed=1)
    pos = np.array([10, rows - g])
    jlog, jck2, jcv2 = jl.llama_verify_step(
        jp, jnp.asarray(chunk), jck, jcv, jnp.asarray(pos), jcfg)
    tlog, tck2, tcv2 = tl.llama_verify_step(
        tp, torch.from_numpy(chunk).long(), tck, tcv,
        torch.from_numpy(pos), tcfg)
    assert tck2 is tck and tlog.shape == (2, g, tcfg.vocab_size)
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    np.testing.assert_allclose(tck2.numpy(), np.asarray(jck2), atol=1e-5)
    np.testing.assert_allclose(tcv2.numpy(), np.asarray(jcv2), atol=1e-5)
    # chunk position i scores as the decode step at pos + i does
    _, _, dck, dcv = _seated_caches(jp, jcfg, 2, rows, 10)
    for i in range(g):
        dlog, _, _ = tl.llama_decode_step(
            tp, torch.from_numpy(chunk[:, i]).long(), dck, dcv,
            torch.from_numpy(pos + i), tcfg)
        np.testing.assert_allclose(dlog[0].numpy(), tlog[0, i].numpy(),
                                   atol=1e-4)
