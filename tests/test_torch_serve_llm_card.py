"""The LLM apps on Serve on the card, and the replica probes the CPU
tests share (this file imports no JAX: what runs inside a replica is
shipped from here by value).

On a GPU, ``build_openai_app`` and ``build_disagg_app`` serve the tiny
f32 config from replicas on the card, and their greedy completions,
usage and token ids equal the same apps with ``device="cpu"``; each card
replica launched K4 in its own process (the tiny config's attention is
the plain f32 one: K1 takes bf16). Without a GPU the card tests skip,
decided inside a fixture.

    python -m pytest --noconftest -m cuda tests/test_torch_serve_llm_card.py
"""

import os

import pytest
import torch

TINY_SEQ = 64


def tiny_llm_config(model_id="tiny", seed=0, max_seq=TINY_SEQ, max_batch=2,
                    max_tokens=8, **fields):
    from ray_tpu_torch.llm.engine import EngineConfig
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.serve.llm import LLMConfig
    return LLMConfig(
        model_id=model_id,
        engine=EngineConfig(
            model=LlamaConfig.tiny(vocab_size=258, max_seq_len=max_seq),
            max_batch=max_batch, max_seq=max_seq, seed=seed),
        max_tokens=max_tokens, **fields)


# -- probes: run inside a replica's process through ``__ray_call__`` --------


def capture_requests(replica):
    """Keep every request the replica's engine admits from now on
    (``add_request`` and ``add_prefilled``)."""
    engine = replica.callable.engine
    kept = []
    add, adopt = engine.add_request, engine.add_prefilled

    def add_request(request):
        kept.append(request)
        return add(request)

    def add_prefilled(request, *args):
        kept.append(request)
        return adopt(request, *args)

    engine.add_request, engine.add_prefilled = add_request, add_prefilled
    replica.callable._kept_requests = kept
    return True


def captured_requests(replica):
    """[(prompt ids, output ids, finish reason)] of the kept requests,
    in admission order; the list is emptied."""
    kept = replica.callable._kept_requests
    out = [(list(r.prompt_ids), list(r.output_ids), r.finish_reason)
           for r in kept]
    kept.clear()
    return out


def kernel_launches(replica, reset=False):
    """This process's launch count of each kernel wrapper (zeroed after
    the read with ``reset``)."""
    from ray_tpu_torch.ops import attention, int8_matmul, rms_norm
    fns = {"flash_attention": attention.flash_attention,
           "flash_attention_bwd_dq": attention.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": attention.flash_attention_bwd_dkv,
           "rms_norm": rms_norm, "int8_matmul": int8_matmul}
    out = {name: fn.launches for name, fn in fns.items()}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return out


def on_replicas(deployment_name, fn, *args):
    """``fn(replica, *args)`` on every replica of a deployment, in the
    replicas' processes; {replica id: result}."""
    import ray_tpu_torch
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    # a worker cannot import this test file: ``dumps`` registers its
    # module to be pickled by value, which the call's arguments then are
    serialization.dumps(fn)
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    _version, replicas = ray_tpu_torch.get(
        controller.get_replicas.remote(deployment_name))
    return {rid: ray_tpu_torch.get(h.__ray_call__.remote(fn, *args),
                                   timeout=120)
            for rid, h in replicas}


RANDOM_IDS = ("cmpl-", "chatcmpl-", "call_")


def strip_ids(obj):
    """A response without its random ids (of completions, chat
    completions and tool calls; a model's id stays)."""
    if isinstance(obj, dict):
        return {k: strip_ids(v) for k, v in obj.items()
                if not (k == "id" and isinstance(v, str)
                        and v.startswith(RANDOM_IDS))}
    if isinstance(obj, list):
        return [strip_ids(v) for v in obj]
    return obj


BODIES = [
    {"__path__": "/v1/completions", "prompt": "hello world",
     "max_tokens": 6},
    {"__path__": "/v1/completions", "prompt": "abc", "max_tokens": 4},
    {"__path__": "/v1/completions", "prompt": "the quick brown fox",
     "max_tokens": 8},
]


def serve_bodies(handle, deployment_names, bodies=BODIES):
    """Each body through ``handle`` one at a time, and the requests the
    replicas of ``deployment_names`` admitted for them."""
    for name in deployment_names:
        on_replicas(name, capture_requests)
    answers = [strip_ids(handle.remote(dict(b)).result(timeout_s=300))
               for b in bodies]
    kept = []
    for name in deployment_names:
        for reqs in on_replicas(name, captured_requests).values():
            kept += reqs
    return answers, kept


# -- card tests --------------------------------------------------------------


@pytest.fixture(scope="module")
def card_rt():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import ray_tpu_torch
    from ray_tpu_torch import serve
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    serve.start()
    yield rt
    try:
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def _card_and_cpu(build, names):
    from ray_tpu_torch import serve
    got = {}
    for device in (None, "cpu"):
        tag = "card" if device is None else "cpu"
        handle = serve.run(build(device), name=f"app_{tag}",
                           route_prefix=f"/{tag}", timeout_s=300)
        if device is None:
            for name in names:
                on_replicas(name, kernel_launches, True)
        got[tag] = serve_bodies(handle, names)
        if device is None:
            got["launches"] = [
                counts for name in names
                for counts in on_replicas(name, kernel_launches).values()]
        serve.delete(f"app_{tag}")
    return got


def _cpu_weights(cfg):
    """The config's weights made on the CPU from its seed (the card's
    generator draws other numbers), shipped to every replica."""
    from ray_tpu_torch.models import llama_init
    return llama_init(cfg.engine.seed, cfg.engine.model, "cpu")


@pytest.mark.cuda
def test_openai_app_on_the_card_equals_cpu(card_rt):
    from ray_tpu_torch.serve.llm import build_openai_app
    cfg = tiny_llm_config()
    params = _cpu_weights(cfg)
    got = _card_and_cpu(
        lambda device: build_openai_app(config=cfg, params=params,
                                        device=device),
        ["tiny"])
    assert got["card"] == got["cpu"]
    (counts,) = got["launches"]
    assert counts["rms_norm"] > 0, counts
    assert counts["flash_attention_bwd_dq"] == 0 == counts["int8_matmul"]


@pytest.mark.cuda
def test_disagg_app_on_the_card_equals_cpu(card_rt):
    from ray_tpu_torch.llm.disagg import build_disagg_app
    cfg = tiny_llm_config(model_id="dis")
    params = _cpu_weights(cfg)
    got = _card_and_cpu(
        lambda device: build_disagg_app(cfg, params=params, device=device),
        ["dis-prefill", "dis-decode"])
    assert got["card"] == got["cpu"]
    prefill, decode = got["launches"]
    assert prefill["rms_norm"] > 0 and decode["rms_norm"] > 0, (prefill,
                                                                decode)
