"""The port's mixture-of-experts layer and the MoE branch of its Llama
against the JAX package's.

Inputs come from a numpy seed; weights are the JAX package's, carried
over by ``params_from_jax``. Everything runs in f32 on the CPU, where
routing is held exactly (gates, top-k indices, dispatch masks) and
outputs within 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import engine as je
from ray_tpu.models import llama as jl
from ray_tpu.parallel import moe as jmoe
from ray_tpu_torch.llm import engine as te
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.scripts.bench_train import parameters


def _rng(seed=0):
    return np.random.default_rng(seed)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a))


_jax_gating = jax.jit(jmoe.top_k_gating, static_argnums=2)


def _layer_inputs(t=24, d=16, e=4, h=32, seed=0):
    rng = _rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    w1 = (rng.standard_normal((e, d, h)) * d ** -0.5).astype(np.float32)
    w3 = (rng.standard_normal((e, d, h)) * d ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((e, h, d)) * h ** -0.5).astype(np.float32)
    return x, router, w1, w3, w2


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_gating_matches_jax(k):
    x, router, *_ = _layer_inputs()
    jg, ji, jaux = _jax_gating(jnp.asarray(x), jnp.asarray(router), k)
    tg, ti, taux = tmoe.top_k_gating(_t(x), _t(router), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # which gates are zero is exact; the chosen ones are the same f32
    # math, but XLA's exp and PyTorch's differ in the last bit (the
    # softmax of equal logits already does), so they agree to an ulp
    np.testing.assert_array_equal(tg.numpy() == 0, np.asarray(jg) == 0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


def test_top_k_breaks_ties_like_lax_top_k():
    """Experts with equal probabilities (a router with repeated columns)
    rank lower index first, as ``jax.lax.top_k`` does."""
    x, router, *_ = _layer_inputs(e=3)
    router = np.concatenate([router, router[:, ::-1], router], axis=1)
    jg, ji, _ = _jax_gating(jnp.asarray(x), jnp.asarray(router), 3)
    tg, ti, _ = tmoe.top_k_gating(_t(x), _t(router), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # every row's three choices tie exactly; the order is the tie-break
    chosen = np.take_along_axis(np.asarray(jg), np.asarray(ji), axis=1)
    assert (chosen == chosen[:, :1]).all()
    assert (np.diff(ti.numpy(), axis=1) > 0).all()


@pytest.mark.parametrize("t,capacity", [(24, 12), (24, 5), (32, 1)])
def test_dispatch_matches_jax_including_drops(t, capacity):
    x, router, *_ = _layer_inputs(t=t)
    jg, ji, _ = _jax_gating(jnp.asarray(x), jnp.asarray(router), 2)
    jd, jc = jax.jit(jmoe.moe_dispatch, static_argnums=(2, 3))(
        jg, ji, 4, capacity)
    td, tc = tmoe.moe_dispatch(_t(jg), _t(ji).long(), 4, capacity)
    assert td.dtype == torch.float32 and tuple(td.shape) == (t, 4, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    kept = td.sum().item()
    if capacity * 4 < 2 * t:
        assert kept < 2 * t  # the case drops tokens


@pytest.mark.parametrize("b,s,cf", [(2, 12, 2.0), (1, 24, 0.5),
                                    (3, 8, 1.0)])
def test_moe_ffn_matches_jax(b, s, cf):
    x, router, w1, w3, w2 = _layer_inputs(t=b * s)
    x3 = x.reshape(b, s, -1)
    jy, jaux = jax.jit(functools.partial(
        jmoe.moe_ffn, top_k=2, capacity_factor=cf))(
            *(jnp.asarray(a) for a in (x3, router, w1, w3, w2)))
    ty, taux = tmoe.moe_ffn(_t(x3), *(_t(a) for a in (router, w1, w3, w2)),
                            top_k=2, capacity_factor=cf)
    assert tmoe.moe_capacity(b * s, 4, 2, cf) == max(1, int(cf * 2 * b * s
                                                            / 4))
    assert _rel_l2(ty.numpy(), jy) <= 1e-5
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


def test_moe_ffn_grads_match_jax():
    x, router, w1, w3, w2 = _layer_inputs(t=16)
    x3 = x.reshape(2, 8, -1)

    def jloss(args):
        y, aux = jmoe.moe_ffn(*args, top_k=2, capacity_factor=1.0)
        return jnp.sum(y ** 2) + aux

    jargs = [jnp.asarray(a) for a in (x3, router, w1, w3, w2)]
    jgrads = jax.jit(jax.grad(jloss))(jargs)
    targs = [_t(a).requires_grad_(True) for a in (x3, router, w1, w3, w2)]
    y, aux = tmoe.moe_ffn(*targs, top_k=2, capacity_factor=1.0)
    ((y ** 2).sum() + aux).backward()
    for name, ta, jg in zip(("x", "router", "w1", "w3", "w2"), targs,
                            jgrads):
        assert _rel_l2(ta.grad.numpy(), jg) <= 1e-4, name


# --- the MoE branch of the Llama -------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params():
    """The JAX tiny_moe weights (every variant below shares them)."""
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(jl.llama_init, static_argnums=1)(
            jax.random.PRNGKey(0), jl.LlamaConfig.tiny_moe()))


def _llama(**kw):
    jcfg = jl.LlamaConfig.tiny_moe(**kw)
    tcfg = tl.LlamaConfig.tiny_moe(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    return jcfg, tcfg, jp, params_from_jax(_jax_params(), device="cpu")


def _tokens(batch=2, n=12, seed=0):
    return _rng(seed).integers(0, 256, (batch, n + 1)).astype(np.int32)


def test_llama_moe_init_and_config_match_jax():
    jcfg, tcfg, jp, tp = _llama()
    assert tcfg.moe_capacity_factor == jcfg.moe_capacity_factor
    assert tcfg.moe_aux_weight == jcfg.moe_aux_weight
    mix = tl.LlamaConfig.mixtral_8x7b()
    assert mix.num_params() == jl.LlamaConfig.mixtral_8x7b().num_params()
    own = tl.llama_init(0, tcfg, device="cpu")
    for name, leaf in jp["layers"].items():
        assert tuple(tp["layers"][name].shape) == leaf.shape
        assert tuple(own["layers"][name].shape) == leaf.shape
    assert tuple(own["layers"]["w1"].shape) == (2, 4, 64, 128)


@pytest.mark.parametrize("attention", ["reference", "flash"])
def test_llama_moe_forward_and_aux_match_jax(attention):
    jcfg, tcfg, jp, tp = _llama()
    tcfg = dataclasses.replace(tcfg, attention=attention)
    toks = _tokens()[:, :-1]
    jlog, jaux = jax.jit(functools.partial(
        jl.llama_forward, config=jcfg, return_aux=True))(jp,
                                                         jnp.asarray(toks))
    tlog, taux = tl.llama_forward(tp, torch.from_numpy(toks).long(), tcfg,
                                  return_aux=True)
    assert _rel_l2(tlog.numpy(), jlog) <= 1e-5
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(ce_chunk_tokens=8, remat=True)],
                         ids=["dense_ce", "chunked_ce_remat"])
def test_llama_moe_loss_and_grads_match_jax(kw):
    jcfg, tcfg, jp, tp = _llama(**kw)
    ids = _tokens(seed=1)
    toks, tgts = ids[:, :-1], ids[:, 1:]
    jloss, jgrads = jax.jit(jax.value_and_grad(jl.llama_loss),
                            static_argnums=3)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    tp = tl.unstack_layers(tp)
    for leaf in parameters(tp):
        leaf.requires_grad_(True)
    tloss = tl.llama_loss(tp, torch.from_numpy(toks).long(),
                          torch.from_numpy(tgts).long(), tcfg)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for name in ("router", "w1", "w3", "w2", "wq"):
        got = torch.stack([lp[name].grad for lp in tp["layers"]]).numpy()
        assert _rel_l2(got, jgrads["layers"][name]) <= 1e-4, name
    for name in ("embedding", "lm_head"):
        assert _rel_l2(tp[name].grad.numpy(), jgrads[name]) <= 1e-4, name


def test_llama_moe_aux_enters_the_loss():
    """The loss is the CE plus moe_aux_weight x aux / n_layers."""
    _, tcfg, _, tp = _llama()
    ids = torch.from_numpy(_tokens(seed=2)).long()
    toks, tgts = ids[:, :-1], ids[:, 1:]
    logits, aux = tl.llama_forward(tp, toks, tcfg, return_aux=True)
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, 256),
                                           tgts.reshape(-1))
    want = ce + tcfg.moe_aux_weight * aux / tcfg.n_layers
    got = tl.llama_loss(tp, toks, tgts, tcfg)
    assert abs(got.item() - want.item()) <= 1e-6
    assert aux.item() > 0


def test_llama_moe_prefill_decode_verify_match_jax():
    jcfg, tcfg, jp, tp = _llama()
    toks = _tokens(batch=1, n=10)[:, :10]
    jlog, jks, jvs = jax.jit(jl.llama_prefill, static_argnums=2)(
        jp, jnp.asarray(toks), jcfg)
    tlog, tks, tvs = tl.llama_prefill(tp, torch.from_numpy(toks).long(),
                                      tcfg)
    assert _rel_l2(tlog.numpy(), jlog) <= 1e-5
    jck, jcv = jl.llama_init_cache(jcfg, 1, 16)
    jck, jcv = jck.at[:, :, :10].set(jks), jcv.at[:, :, :10].set(jvs)
    tck, tcv = tl.llama_init_cache(tcfg, 1, 16, device="cpu")
    tck[:, :, :10], tcv[:, :, :10] = tks, tvs
    jd, jck, jcv = jax.jit(jl.llama_decode_step, static_argnums=5)(
        jp, jnp.array([3], jnp.int32), jck, jcv, jnp.array([10]), jcfg)
    td, _, _ = tl.llama_decode_step(tp, torch.tensor([3]), tck, tcv,
                                    torch.tensor([10]), tcfg)
    assert _rel_l2(td.numpy(), jd) <= 1e-5
    chunk = np.array([[5, 6, 7]], np.int32)
    jv, _, _ = jax.jit(jl.llama_verify_step, static_argnums=5)(
        jp, jnp.asarray(chunk), jck, jcv, jnp.array([11]), jcfg)
    tv, _, _ = tl.llama_verify_step(tp, torch.from_numpy(chunk).long(), tck,
                                    tcv, torch.tensor([11]), tcfg)
    assert _rel_l2(tv.numpy(), jv) <= 1e-5


def test_quantize_refuses_moe_like_jax():
    _, tcfg, _, tp = _llama()
    with pytest.raises(ValueError, match="dense FFNs only"):
        tl.quantize_llama_ffn(tp, tcfg)


@pytest.mark.parametrize("kw", [dict(), dict(chunked_prefill_tokens=8)],
                         ids=["dense", "chunked"])
def test_moe_engine_greedy_streams_equal_jax(kw):
    jcfg, tcfg, jp, tp = _llama(max_seq_len=64)
    jeng = je.ContinuousBatchingEngine(
        je.EngineConfig(model=jcfg, max_batch=2, max_seq=64, **kw),
        params=jp)
    teng = te.ContinuousBatchingEngine(
        te.EngineConfig(model=tcfg, max_batch=2, max_seq=64, **kw),
        params=tp, device="cpu")
    prompts = [[1, 2, 3], list(range(4, 24)), [9, 8, 7, 6]]
    want = jeng.generate(prompts, max_tokens=6)
    got = teng.generate(prompts, max_tokens=6)
    assert got == want
    assert [len(o) for o in got] == [6, 6, 6]
