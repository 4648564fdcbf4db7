"""The port engine's scheduling features against the JAX engine's.

Multi-LoRA, multi-step decode, speculative decoding, prefix caching and
chunked prefill: both engines serve the same tiny weights (the JAX
``llama_init`` from PRNGKey(0), carried over by ``params_from_jax``) in
f32 on the CPU, and their greedy token streams must be identical; the
JAX engine's own tests hold these features to the dense stream exactly
in f32, so the port is held to both. Sampled ids come from different
generators on the two sides, so sampled requests are checked for their
length and vocabulary only. The JAX engines are shared by module-scoped
fixtures: each one compiles its programs once.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import engine as je
from ray_tpu.models import llama as jl
from ray_tpu_torch.llm import engine as te
from ray_tpu_torch.models import LlamaConfig, params_from_jax
from ray_tpu_torch.models import llama as tl

MAX_SEQ = 64
JCFG = jl.LlamaConfig.tiny(max_seq_len=MAX_SEQ, attention="reference",
                           remat=False)
TCFG = LlamaConfig.tiny(max_seq_len=MAX_SEQ)
DRAFT_KW = dict(dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=64)
JDRAFT = dataclasses.replace(JCFG, **DRAFT_KW)
TDRAFT = dataclasses.replace(TCFG, **DRAFT_KW)


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params, JAX draft params, port draft params)."""
    jp = jl.llama_init(jax.random.PRNGKey(0), JCFG)
    jd = jl.llama_init(jax.random.PRNGKey(1), JDRAFT)
    return jp, _to_torch(jp), jd, _to_torch(jd)


def _adapters():
    """Two JAX adapters with random nonzero B, of rank 4 and 8 (the bank's
    rank), and a fresh one (B = 0)."""
    rng = jax.random.PRNGKey(3)
    ada = jl.lora_init(rng, JCFG, rank=4)
    bob = jl.lora_init(jax.random.fold_in(rng, 9), JCFG, rank=8)
    for i, (lora, part) in enumerate(((ada, "B_q"), (ada, "B_v"),
                                      (bob, "B_q"), (bob, "B_v"))):
        lora[part] = jax.random.normal(jax.random.fold_in(rng, i + 1),
                                       lora[part].shape) * 0.5
    return {"ada": ada, "bob": bob,
            "zero": jl.lora_init(jax.random.PRNGKey(0), JCFG, rank=8)}


def _draft(weights, draft, side):
    """(draft config, draft params) of one side (0 JAX, 1 port) for a
    named draft: a random small model, the target itself, or a model
    whose vocab does not match."""
    jp, tp, jd, td = weights
    if draft is None:
        return None, None
    if draft == "target":
        return (JCFG, TCFG)[side], (jp, tp)[side]
    cfg = (JDRAFT, TDRAFT)[side]
    if draft == "bad_vocab":
        return dataclasses.replace(cfg, vocab_size=999), None
    return cfg, (jd, td)[side]


def _jax_engine(weights, max_batch=2, draft=None, adapters=False, **kw):
    model, params = _draft(weights, draft, 0)
    eng = je.ContinuousBatchingEngine(
        je.EngineConfig(model=JCFG, max_batch=max_batch, max_seq=MAX_SEQ,
                        draft_model=model, **kw),
        params=weights[0], draft_params=params)
    if adapters:
        for name, lora in _adapters().items():
            eng.register_adapter(name, lora)
    return eng


def _port(weights, max_batch=2, draft=None, adapters=False, **kw):
    model, params = _draft(weights, draft, 1)
    eng = te.ContinuousBatchingEngine(
        te.EngineConfig(model=TCFG, max_batch=max_batch, max_seq=MAX_SEQ,
                        draft_model=model, **kw),
        params=weights[1], draft_params=params, device="cpu")
    if adapters:
        for name, lora in _adapters().items():
            eng.register_adapter(name, _to_torch(lora))
    return eng


def _build(weights, **kw):
    return _jax_engine(weights, **kw), _port(weights, **kw)


@pytest.fixture(scope="module")
def jax_engines(weights):
    """JAX engines memoised by configuration, so that each compiles its
    programs once per module."""
    memo = {}

    def get(**kw):
        key = repr(sorted(kw.items()))
        if key not in memo:
            memo[key] = _jax_engine(weights, **kw)
        return memo[key]

    return get


def _serve(engine, mod, specs):
    """Serve GenerationRequests of ``mod`` built from dicts, all at once;
    returns them finished."""
    reqs = [engine.add_request(mod.GenerationRequest(
        **dict(s, prompt_ids=list(s["prompt_ids"])))) for s in specs]
    while any(not r.done for r in reqs):
        engine.step()
    return reqs


def _dense_streams(jax_engines, prompts, max_tokens):
    """The JAX engine's dense greedy streams."""
    return jax_engines().generate(prompts, max_tokens=max_tokens)


# ---------------------------------------------------------------- LoRA

@pytest.mark.parametrize("kw", [{}, {"multi_step": 4},
                                {"chunked_prefill_tokens": 4}],
                         ids=["dense", "multi_step", "chunked"])
def test_adapters_batched_with_base_equal_jax(weights, jax_engines, kw):
    """Base, two adapters of different rank and a fresh adapter in ONE
    batch: every stream equals the JAX engine's, the base and fresh
    streams equal base served alone, the adapters change the output."""
    jeng = jax_engines(max_batch=4, adapters=True, max_loras=3,
                       lora_rank=8, **kw)
    teng = _port(weights, max_batch=4, adapters=True, max_loras=3,
                 lora_rank=8, **kw)
    prompt = [3, 7, 11, 15, 2, 9]
    specs = [dict(prompt_ids=prompt, max_tokens=7, adapter=a)
             for a in (None, "ada", "bob", "zero")]
    want = [r.output_ids for r in _serve(jeng, je, specs)]
    got = [r.output_ids for r in _serve(teng, te, specs)]
    assert got == want
    base_alone = _dense_streams(jax_engines, [prompt], 7)[0]
    assert got[0] == got[3] == base_alone
    assert got[1] != base_alone and got[2] != base_alone
    assert got[1] != got[2]


def test_mixed_batch_equals_each_request_alone(weights):
    teng = _port(weights, max_batch=4, adapters=True, max_loras=3,
                 lora_rank=8)
    specs = [dict(prompt_ids=[5, 6, 7], max_tokens=6, adapter=a)
             for a in (None, "ada", "bob")]
    mixed = [r.output_ids for r in _serve(teng, te, specs)]
    alone = [_serve(teng, te, [s])[0].output_ids for s in specs]
    assert mixed == alone


def test_fresh_port_adapter_is_identity(weights):
    teng = _port(weights, max_loras=1)
    teng.register_adapter("zero", tl.lora_init(0, TCFG, rank=8,
                                               device="cpu"))
    base, zero = _serve(teng, te, [
        dict(prompt_ids=[1, 2, 3], max_tokens=5),
        dict(prompt_ids=[1, 2, 3], max_tokens=5, adapter="zero")])
    assert zero.output_ids == base.output_ids


def test_unknown_adapter_fails_fast(weights, jax_engines):
    jeng = jax_engines(max_loras=1)
    teng = _port(weights, max_loras=1)
    for mod, eng in ((je, jeng), (te, teng)):
        with pytest.raises(ValueError, match="unknown LoRA adapter"):
            eng.add_request(mod.GenerationRequest(prompt_ids=[1],
                                                  adapter="nope"))
    assert not teng.has_work()


def test_register_adapter_refusals_reserve_no_slot(weights):
    teng = _port(weights, max_loras=1, lora_rank=4)
    good = tl.lora_init(1, TCFG, rank=4, device="cpu")
    with pytest.raises(ValueError, match="exceeds the engine's lora_rank"):
        teng.register_adapter("big", tl.lora_init(1, TCFG, rank=8,
                                                  device="cpu"))
    other = tl.lora_init(1, dataclasses.replace(TCFG, dim=32), rank=4,
                         device="cpu")
    with pytest.raises(ValueError, match="bank slot shape"):
        teng.register_adapter("other", other)
    bank = teng.lora_bank
    teng.register_adapter("good", good)   # slot 1: nothing leaked
    assert teng._adapters == {"good": 1}
    assert teng.lora_bank is not bank     # a new dict, swapped whole
    assert float(bank["A_q"].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="LoRA bank full"):
        teng.register_adapter("more", good)
    with pytest.raises(ValueError, match="max_loras=0"):
        _port(weights).register_adapter("x", good)


# ---------------------------------------------------- speculative decoding

@pytest.mark.parametrize("draft", ["random", "target"])
def test_speculative_greedy_equals_jax_and_dense(weights, jax_engines,
                                                 draft):
    prompts = [[1, 5, 9, 13], [2, 4, 6]]
    want = jax_engines(draft=draft, spec_tokens=4).generate(prompts,
                                                            max_tokens=16)
    teng = _port(weights, draft=draft, spec_tokens=4)
    got = teng.generate(prompts, max_tokens=16)
    assert got == want == _dense_streams(jax_engines, prompts, 16)
    assert all(len(o) == 16 for o in got)
    stats = teng.stats()
    assert 0 <= stats["spec_accepted"] <= stats["spec_proposed"]
    if draft == "target":
        assert stats["spec_accepted"] == stats["spec_proposed"] > 0


def test_speculative_perfect_draft_skips_target_steps(weights, jax_engines):
    """draft == target accepts every proposal: spec_tokens tokens per
    target forward."""
    teng = _port(weights, max_batch=1, draft="target", spec_tokens=4)
    [out] = teng.generate([[1, 2, 3]], max_tokens=13)
    assert len(out) == 13
    assert teng._step_counter <= 1 + 3  # the prefill + ceil(12 / 4) rounds
    assert out == _dense_streams(jax_engines, [[1, 2, 3]], 13)[0]


def test_speculative_stop_mid_chunk_equals_jax(weights, jax_engines):
    full = _dense_streams(jax_engines, [[1, 2, 3]], 12)[0]
    stop = full[5]
    spec = dict(prompt_ids=[1, 2, 3], max_tokens=12, stop_ids=(int(stop),))
    [want] = _serve(jax_engines(draft="target", spec_tokens=4), je, [spec])
    [got] = _serve(_port(weights, draft="target", spec_tokens=4), te, [spec])
    assert got.output_ids == want.output_ids == full[:full.index(stop) + 1]
    assert got.finish_reason == want.finish_reason == "stop"


def test_speculative_mixed_and_sampled_requests(weights, jax_engines):
    """A sampled request shares speculation rounds with a greedy one
    (one target-sampled token a round); an all-sampled batch skips
    speculation and still finishes with its lengths."""
    teng = _port(weights, draft="random", spec_tokens=3)
    greedy, sampled = _serve(teng, te, [
        dict(prompt_ids=[1, 2, 3], max_tokens=10),
        dict(prompt_ids=[4, 5], max_tokens=10, temperature=0.7, top_k=12)])
    assert greedy.output_ids == _dense_streams(jax_engines, [[1, 2, 3]],
                                               10)[0]
    assert len(sampled.output_ids) == 10
    outs = teng.generate([[1, 2], [3, 4]], max_tokens=8, temperature=0.8,
                         top_k=20)
    assert [len(o) for o in outs] == [8, 8]
    assert all(0 <= t < TCFG.vocab_size for o in outs for t in o)


def test_speculative_near_the_scratch_region_falls_back_dense(
        weights, jax_engines):
    """A prompt that leaves fewer than spec_tokens rows before the
    scratch region decodes dense to its end, as the JAX engine does."""
    prompt = list(range(1, 56))
    want = jax_engines(draft="random", spec_tokens=4).generate(
        [prompt], max_tokens=20)
    got = _port(weights, draft="random", spec_tokens=4).generate(
        [prompt], max_tokens=20)
    assert got == want
    assert len(got[0]) == MAX_SEQ - 1 - 4 - len(prompt) + 1


# ------------------------------------------------------ multi-step decode

def test_multi_step_equals_jax_and_single_step(weights, jax_engines):
    prompts = [[1, 2, 3], [7, 8]]
    want = jax_engines(multi_step=4).generate(prompts, max_tokens=11)
    teng = _port(weights, multi_step=4)
    got = teng.generate(prompts, max_tokens=11)
    assert got == want == _dense_streams(jax_engines, prompts, 11)
    assert teng._step_counter <= 2 + 3  # two prefills + ceil(10 / 4)


def test_multi_step_stop_token_mid_burst(weights, jax_engines):
    full = _dense_streams(jax_engines, [[1, 2, 3]], 12)[0]
    stop = full[4]
    spec = dict(prompt_ids=[1, 2, 3], max_tokens=12, stop_ids=(int(stop),))
    [want] = _serve(jax_engines(multi_step=4), je, [spec])
    [got] = _serve(_port(weights, multi_step=4), te, [spec])
    assert got.output_ids == want.output_ids == full[:full.index(stop) + 1]
    assert got.finish_reason == "stop"


@pytest.mark.parametrize("kw", [{"multi_step": 3},
                                {"chunked_prefill_tokens": 4}],
                         ids=["multi_step", "chunked"])
def test_sampled_overflow_finishes_every_request(weights, kw):
    """Sampling inside the fused paths, and more requests than slots."""
    teng = _port(weights, **kw)
    outs = teng.generate([list(range(1, 11)), [5, 6], list(range(20, 33)),
                          [9]], max_tokens=7, temperature=0.9, top_k=40)
    assert [len(o) for o in outs] == [7, 7, 7, 7]
    assert all(0 <= t < TCFG.vocab_size for o in outs for t in o)
    assert teng.stats()["prefilling"] == 0


@pytest.mark.parametrize("kw", [{"multi_step": 4},
                                {"chunked_prefill_tokens": 4},
                                {"draft": "random", "spec_tokens": 4}],
                         ids=["multi_step", "chunked", "spec"])
def test_logit_bias_in_the_fused_paths_equal_jax(weights, jax_engines, kw):
    """The bias applies on every path; drafts propose without it."""
    forced = 9
    specs = [dict(prompt_ids=[1, 2, 3, 4, 5], max_tokens=5,
                  logit_bias={forced: 100.0}),
             dict(prompt_ids=[1, 2, 3, 4, 5], max_tokens=5)]
    want = [r.output_ids for r in _serve(jax_engines(**kw), je, specs)]
    got = [r.output_ids for r in _serve(_port(weights, **kw), te, specs)]
    assert got == want
    assert got[0] == [forced] * 5
    assert got[1] == _dense_streams(jax_engines, [[1, 2, 3, 4, 5]], 5)[0]


# ---------------------------------------------------------- prefix caching

def test_prefix_cache_hits_equal_jax_and_keep_their_entries(
        weights, jax_engines):
    """Three prompts share a 16-token system prompt, served one after
    another; the third hits the entry the second's hit used (an in-place
    write into a view of it would show here), then the first comes back
    and hits its own entry."""
    sysp = list(range(10, 26))
    prompts = [sysp + [1, 2, 3], sysp + [7, 8], sysp + [40, 41, 42, 43],
               sysp + [1, 2, 3]]
    want = _dense_streams(jax_engines, prompts, 9)
    jeng, teng = _build(weights, enable_prefix_caching=True,
                        prefix_cache_min_tokens=8)
    for mod, eng in ((je, jeng), (te, teng)):
        outs = [eng.generate([p], max_tokens=9)[0] for p in prompts]
        assert outs == want, mod.__name__
    js, ts = jeng.stats(), teng.stats()
    for key in ("prefix_hits", "prefix_misses", "prefix_cache_entries"):
        assert ts[key] == js[key], key
    assert (ts["prefix_hits"], ts["prefix_misses"]) == (3, 1)
    # entries never alias the engine cache or each other
    entries = list(teng._prefix_cache.values())
    ptrs = {t.data_ptr() for _ids, ks, vs in entries for t in (ks, vs)}
    assert len(ptrs) == 2 * len(entries)
    assert teng.cache_k.data_ptr() not in ptrs


def test_prefix_cache_lru_and_min_tokens_equal_jax(weights):
    jeng, teng = _build(weights, max_batch=1, enable_prefix_caching=True,
                        prefix_cache_min_tokens=4, prefix_cache_entries=2)
    for eng in (jeng, teng):
        eng.generate([[1, 2]], max_tokens=2)     # below min: not stored
        assert eng.stats()["prefix_cache_entries"] == 0
        for base in (10, 20, 30):
            eng.generate([[base, base + 1, base + 2, base + 3]],
                         max_tokens=2)
        assert eng.stats()["prefix_cache_entries"] == 2  # LRU capped
    assert list(teng._prefix_cache) == list(jeng._prefix_cache)


def test_prefix_cache_bypassed_by_adapter_requests(weights):
    teng = _port(weights, max_loras=3, lora_rank=8, adapters=True,
                 enable_prefix_caching=True, prefix_cache_min_tokens=4)
    prompt = list(range(30, 40))
    base = teng.generate([prompt], max_tokens=4)[0]
    [ada] = _serve(teng, te, [dict(prompt_ids=prompt, max_tokens=4,
                                   adapter="ada")])
    assert teng.stats()["prefix_hits"] == 0
    assert ada.output_ids != base


# ---------------------------------------------------------- chunked prefill

@pytest.mark.parametrize("kw", [{"chunked_prefill_tokens": 4},
                                {"chunked_prefill_tokens": 8},
                                {"chunked_prefill_tokens": 4,
                                 "multi_step": 3}],
                         ids=["chunk4", "chunk8", "chunk4_multi_step3"])
def test_chunked_prefill_equals_jax_and_blocking(weights, jax_engines, kw):
    prompts = [list(range(1, 21)), list(range(30, 37))]
    want = jax_engines(**kw).generate(prompts, max_tokens=9)
    got = _port(weights, **kw).generate(prompts, max_tokens=9)
    assert got == want == _dense_streams(jax_engines, prompts, 9)


def test_chunked_prefill_interleaves_with_decode_like_jax(weights,
                                                          jax_engines):
    """A long prompt admitted mid-stream does not stall a decoding
    request: it keeps emitting while the newcomer's prompt advances one
    chunk a step. The streams equal the JAX engine's step for step."""
    jeng = jax_engines(chunked_prefill_tokens=4)
    teng = _port(weights, chunked_prefill_tokens=4)
    traces = []
    for mod, eng in ((je, jeng), (te, teng)):
        r1 = eng.add_request(mod.GenerationRequest(prompt_ids=[1, 2, 3],
                                                   max_tokens=30))
        while not r1.output_ids:
            eng.step()
        baseline = len(r1.output_ids)
        r2 = eng.add_request(mod.GenerationRequest(
            prompt_ids=list(range(1, 17)), max_tokens=4))   # 4 chunks
        lens = []
        for _ in range(3):
            eng.step()
            lens.append((len(r1.output_ids), len(r2.output_ids)))
        assert len(r1.output_ids) >= baseline + 3
        while not (r1.done and r2.done):
            eng.step()
        assert len(r2.output_ids) == 4
        traces.append((lens, r1.output_ids, r2.output_ids))
    assert traces[1] == traces[0]


def test_chunked_prefill_adapter_decodes_take_the_dense_step(weights,
                                                             jax_engines):
    """An adapter request prefills blocking and decodes through the dense
    step while a base prompt is being chunked beside it."""
    kw = dict(max_batch=4, adapters=True, max_loras=3, lora_rank=8,
              chunked_prefill_tokens=4)
    specs = [dict(prompt_ids=[3, 1, 4], max_tokens=8, adapter="bob"),
             dict(prompt_ids=list(range(40, 58)), max_tokens=5)]
    want = [r.output_ids for r in _serve(jax_engines(**kw), je, specs)]
    got = [r.output_ids for r in _serve(_port(weights, **kw), te, specs)]
    assert got == want


# ------------------------------------------------ configuration and rows

@pytest.mark.parametrize("kw,match", [
    (dict(draft="random", spec_tokens=1), "spec_tokens must be >= 2"),
    (dict(draft="bad_vocab"), "vocab_size must match"),
    (dict(draft="random", multi_step=4), "multi_step and draft_model"),
    (dict(draft="random", chunked_prefill_tokens=8),
     "chunked_prefill_tokens and draft_model"),
    (dict(enable_prefix_caching=True, chunked_prefill_tokens=8),
     "chunked_prefill_tokens and enable_prefix_caching"),
    (dict(chunked_prefill_tokens=128), "leaves no usable positions"),
    (dict(multi_step=63), "leaves no usable positions"),
    (dict(quantization="fp4"), "unknown quantization"),
])
def test_config_refusals_equal_jax(weights, kw, match):
    messages = []
    for build in (_jax_engine, _port):
        with pytest.raises(ValueError, match=match) as info:
            build(weights, **kw)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_scratch_region_and_parking(weights):
    for kw, scratch in ((dict(draft="random", spec_tokens=4), 4),
                        (dict(chunked_prefill_tokens=8), 8),
                        (dict(multi_step=4), 4), ({}, 0)):
        teng = _port(weights, **kw)
        assert teng._pos_limit == MAX_SEQ - 1 - scratch
        assert teng._dense_park == (MAX_SEQ - 1 if scratch else 0)


def test_out_of_range_writes_raise(weights):
    pos = np.array([0, MAX_SEQ - 4])
    te.ContinuousBatchingEngine._check_rows(pos, 4, MAX_SEQ)
    with pytest.raises(RuntimeError, match="leaves the 64-row cache"):
        te.ContinuousBatchingEngine._check_rows(pos, 5, MAX_SEQ)
    with pytest.raises(RuntimeError, match="leaves"):
        te.ContinuousBatchingEngine._check_rows(np.array([-1]), 1, MAX_SEQ)
    # the verify step itself never clamps a write past the cache
    _, tp, _, _ = weights
    ck, cv = tl.llama_init_cache(TCFG, 1, 8, device="cpu")
    with pytest.raises(IndexError):
        tl.llama_verify_step(tp, torch.zeros((1, 4), dtype=torch.long), ck,
                             cv, torch.tensor([6]), TCFG)


# ------------------------------------------------ int8 off the CPU (repair)

def test_int8_ffn_hands_the_kernel_bf16_off_the_cpu(weights, jax_engines,
                                                    monkeypatch):
    """The K5 wrapper takes only bf16 x on the card: ``_ffn`` casts x to
    bf16 there and the result back, as the reference's ``_int8_mm``
    does. The meta device stands in for the card (the wrapper's test is
    ``device.type == "cpu"``). On the CPU the f32 plain path is kept,
    and the f32 int8 stream still equals the JAX engine's."""
    seen = []
    real = tl.int8_matmul

    def spy(x, w8, scale):
        seen.append((x.device.type, x.dtype))
        if x.device.type == "cpu":
            return real(x, w8, scale)
        return torch.empty((x.shape[0], w8.shape[1]), dtype=torch.bfloat16,
                           device=x.device)

    monkeypatch.setattr(tl, "int8_matmul", spy)
    _, tp, _, _ = weights
    layer = tl._layer(tl.quantize_llama_ffn(tp, TCFG)["layers"], 0)
    meta_layer = {k: v.to("meta") for k, v in layer.items()}
    h = torch.empty((2, 3, TCFG.dim), dtype=torch.float32, device="meta")
    y, _ = tl._ffn(meta_layer, h, TCFG)
    assert seen == [("meta", torch.bfloat16)] * 3
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, 3, TCFG.dim)

    seen.clear()
    teng = _port(weights, quantization="int8")
    got = teng.generate([[1, 2, 3], [7, 8]], max_tokens=8)
    assert seen and set(seen) == {("cpu", torch.float32)}
    assert got == jax_engines(quantization="int8").generate(
        [[1, 2, 3], [7, 8]], max_tokens=8)
