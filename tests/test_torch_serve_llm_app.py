"""The OpenAI apps on the port's Serve against the reference's servers
(ray_tpu/serve/llm.py: ``build_openai_app``, ``build_llm_deployment``,
``MultiplexLLMServer``).

The port's apps are served by replicas of the port's runtime with
``device="cpu"``; the reference's ``LLMServer`` / ``MultiplexLLMServer``
run in this process over the same tiny f32 weights (drawn by JAX from
PRNGKey(seed), carried over by ``params_from_jax``, shipped to the
port's replicas as a params blob and to the reference's as its own).
Greedy texts, usage and every token id must be equal (the ids read
inside the replica through ``__ray_call__``), logprobs within 1e-5.
The multiplex surface's 404 body, ``/models`` and per-model counters
must equal the reference's, and an eviction stops the evicted engine
(tests/test_llm.py:216).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.core import serialization as ref_serialization
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.models import llama as jl
from ray_tpu.serve import llm as js
from ray_tpu.util import metrics as ref_metrics
from ray_tpu_torch import serve
from ray_tpu_torch.models import params_from_jax
from ray_tpu_torch.serve import llm as ts
from ray_tpu_torch.util import metrics as port_metrics
from test_torch_serve_llm_card import (
    captured_requests, capture_requests, on_replicas, strip_ids,
    tiny_llm_config)

SEQ = 64


def _jax_config(model_id, seed, max_tokens=8):
    return js.LLMConfig(
        model_id=model_id, engine=JEngineConfig(
            model=jl.LlamaConfig.tiny(vocab_size=258, max_seq_len=SEQ,
                                      attention="reference", remat=False),
            max_batch=2, max_seq=SEQ, seed=seed),
        max_tokens=max_tokens)


def _weights(seed):
    """(the JAX tree as numpy, the port's tree on the CPU)."""
    jcfg = _jax_config("w", seed).engine.model
    tree = jax.tree_util.tree_map(
        np.asarray, jl.llama_init(jax.random.PRNGKey(seed), jcfg))
    return tree, params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def serve_rt():
    old_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old_omp = os.environ.get("OMP_NUM_THREADS")
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
        torch.set_num_threads(old_threads)
        if old_omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old_omp


def _close(got, want, tol=1e-5, where="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _close(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (where, got, want)
    else:
        assert got == want, (where, got, want)


class _RefCapture:
    """Every request the reference server's engine admits."""

    def __init__(self, server):
        self.kept = []
        add = server.engine.add_request

        def add_request(request):
            self.kept.append(request)
            return add(request)

        server.engine.add_request = add_request

    def take(self):
        out = [(list(r.prompt_ids), list(r.output_ids), r.finish_reason)
               for r in self.kept]
        self.kept.clear()
        return out


BODIES = [
    {"__path__": "/v1/completions", "prompt": "hello world",
     "max_tokens": 6},
    {"__path__": "/v1/completions", "prompt": "abc", "max_tokens": 5,
     "logprobs": 2},
    {"__path__": "/v1/chat/completions", "max_tokens": 5,
     "messages": [{"role": "user", "content": "hi there"}],
     "logprobs": True, "top_logprobs": 3},
    {"__path__": "/v1/models"},
]


def test_openai_app_matches_reference_server(serve_rt):
    tree, params = _weights(0)
    ref = js.LLMServer(_jax_config("tiny", 0),
                       ref_serialization.dumps(tree))
    try:
        cap = _RefCapture(ref)
        want = [strip_ids(ref(json.loads(json.dumps(b)))) for b in BODIES]
        want_ids = cap.take()
    finally:
        ref.stop()
    handle = serve.run(
        ts.build_openai_app(config=tiny_llm_config(), params=params,
                            device="cpu"),
        name="openai_app", route_prefix="/v1", timeout_s=120)
    on_replicas("tiny", capture_requests)
    got = [strip_ids(handle.remote(dict(b)).result(timeout_s=120))
           for b in BODIES]
    (got_ids,) = on_replicas("tiny", captured_requests).values()
    serve.delete("openai_app")
    assert "error" not in json.dumps(got)
    _close(got, want)
    assert got_ids == want_ids and len(got_ids) == 3
    assert got[0]["usage"]["completion_tokens"] == 6


def test_builders_place_replicas_by_device():
    cfg = tiny_llm_config()
    app = ts.build_openai_app(config=cfg, device="cpu")
    assert app.deployment.config.ray_actor_options == {}
    assert app.args[2] == "cpu"
    assert app.deployment.config.request_router == "pow2"
    pcfg = tiny_llm_config(num_replicas=2, max_ongoing_requests=5,
                           prefix_routing=True)
    dep = ts.build_llm_deployment(pcfg, device="cpu", name="x").deployment
    assert (dep.name, dep.config.num_replicas,
            dep.config.max_ongoing_requests,
            dep.config.request_router) == ("x", 2, 5, "prefix_aware")
    with pytest.raises(ValueError, match="no GPU share"):
        ts.build_openai_app(config=cfg, device="cpu", num_gpus=0.5)
    if not torch.cuda.is_available():
        # the device rule: the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            ts.build_openai_app(config=cfg)
    with pytest.raises(ValueError, match="params_by_model"):
        ts.build_openai_app([cfg, tiny_llm_config(model_id="b")],
                            params={}, device="cpu")


def test_llm_config_fields_match_reference():
    import dataclasses
    names = [f.name for f in dataclasses.fields(ts.LLMConfig)]
    assert names == [f.name for f in dataclasses.fields(js.LLMConfig)]
    port, ref = ts.LLMConfig(), js.LLMConfig()
    for name in names:
        if name != "engine":
            assert getattr(port, name) == getattr(ref, name), name


def _counter(metrics_mod, name, model):
    with metrics_mod._registry.lock:
        return metrics_mod._registry.counters.get(
            (name, (("model", model),)), 0.0)


COUNTERS = ("ray_tpu_serve_llm_requests_total",
            "ray_tpu_serve_llm_generated_tokens_total")


def _counts(metrics_mod):
    return {(name, m): _counter(metrics_mod, name, m)
            for name in COUNTERS for m in ("m-a", "m-b")}


MUX_BODIES = [
    {"__path__": "/v1/models"},
    {"__path__": "/v1/completions", "model": "m-a", "prompt": "route me",
     "max_tokens": 5},
    {"__path__": "/v1/completions", "model": "m-b", "prompt": "route me",
     "max_tokens": 4},
    {"__path__": "/v1/completions", "model": "nope", "prompt": "x"},
    {"__path__": "/v1/completions", "model": "m-a", "prompt": "again",
     "max_tokens": 3},
]


def test_multiplex_server_matches_reference():
    """In this process on both sides: /models, per-model answers, the
    404 body and the counters' increments."""
    trees = {m: _weights(s) for m, s in (("m-a", 1), ("m-b", 2))}
    ref = js.MultiplexLLMServer(
        [_jax_config("m-a", 1), _jax_config("m-b", 2)],
        {m: ref_serialization.dumps(t[0]) for m, t in trees.items()},
        max_models_per_replica=1)
    port = ts.MultiplexLLMServer(
        [tiny_llm_config("m-a", 1), tiny_llm_config("m-b", 2)],
        {m: ts.params_blob(t[1]) for m, t in trees.items()},
        max_models_per_replica=1, device="cpu")
    ref_before, port_before = _counts(ref_metrics), _counts(port_metrics)
    try:
        want = [strip_ids(ref(dict(b))) for b in MUX_BODIES]
        got = [strip_ids(port(dict(b))) for b in MUX_BODIES]
    finally:
        for server in (ref, port):
            for mid in ("m-a", "m-b"):
                server._load(mid).stop()
    _close(got, want)
    assert got[3]["__status__"] == 404
    assert got[3]["error"]["code"] == "model_not_found"
    assert {m["id"] for m in got[0]["data"]} == {"m-a", "m-b"}
    delta = {k: _counts(port_metrics)[k] - port_before[k]
             for k in port_before}
    assert delta == {k: _counts(ref_metrics)[k] - ref_before[k]
                     for k in ref_before}
    assert delta[(COUNTERS[0], "m-a")] == 2
    assert delta[(COUNTERS[1], "m-a")] == 8


def test_multiplex_eviction_stops_engine():
    """LRU eviction stops the evicted model: its stepper is joined
    (tests/test_llm.py:216)."""
    server = ts.MultiplexLLMServer(
        [tiny_llm_config("m1"), tiny_llm_config("m2")],
        max_models_per_replica=1, device="cpu")
    s1 = server._load("m1")
    assert not s1._stopped
    s2 = server._load("m2")  # evicts m1 (LRU size 1)
    assert s1._stopped and not s1._stepper.is_alive()
    assert not s2._stopped
    s2.stop()


def test_multi_model_app_on_replicas(serve_rt):
    """The multi-model app through a replica: each model's greedy text
    equals the reference server's on the same weights, an unknown id
    answers the 404 body, and the per-model counters reach the
    driver's registry."""
    trees = {m: _weights(s) for m, s in (("m-a", 1), ("m-b", 2))}
    ref = js.MultiplexLLMServer(
        [_jax_config("m-a", 1), _jax_config("m-b", 2)],
        {m: ref_serialization.dumps(t[0]) for m, t in trees.items()},
        max_models_per_replica=2)
    try:
        want = [strip_ids(ref(dict(b))) for b in MUX_BODIES]
    finally:
        for mid in ("m-a", "m-b"):
            ref._load(mid).stop()
    before = _counts(port_metrics)
    handle = serve.run(
        ts.build_openai_app(
            [tiny_llm_config("m-a", 1), tiny_llm_config("m-b", 2)],
            params_by_model={m: t[1] for m, t in trees.items()},
            device="cpu", name="mux"),
        name="mux_app", route_prefix="/mux", timeout_s=120)
    got = [strip_ids(handle.remote(dict(b)).result(timeout_s=120))
           for b in MUX_BODIES]
    serve.delete("mux_app")
    _close(got, want)
    delta = {k: _counts(port_metrics)[k] - before[k] for k in before}
    assert delta[(COUNTERS[0], "m-a")] == 2
    assert delta[(COUNTERS[0], "m-b")] == 1
    assert delta[(COUNTERS[1], "m-b")] == 4
