"""Prefill/decode disaggregation on the port's Serve (port of
ray_tpu/llm/disagg.py) against the reference.

In this process: the port's ``PrefillServer.prefill`` gives the
reference's K/V within 1e-5 (max abs, f32) and the same first token; a
port ``DecodeServer`` adopting either package's prefill (the port's host
tensors or the reference's numpy block) gives the reference's
``decode_prefilled`` result, guided too; ``DisaggRouter``'s refusals
use the reference's words. On the port's runtime with
``device="cpu"``: the disaggregated app's greedy text and usage equal
the reference's colocated ``LLMServer`` on the same weights
(tests/test_llm.py:440), its stream joins to the same text with the
same usage (:481), a ``response_format`` request answers the schema on
both paths and a bad schema is refused at the router (:1392).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.core import serialization as ref_serialization
from ray_tpu.llm import disagg as rd
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.models import llama as jl
from ray_tpu.serve import llm as js
from ray_tpu_torch import serve
from ray_tpu_torch.llm import disagg as pd
from ray_tpu_torch.models import params_from_jax
from ray_tpu_torch.util.host_tensor import HostTensor, from_host
from test_torch_serve_llm_card import strip_ids, tiny_llm_config

SEQ = 128
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"},
                         "n": {"type": "integer"}},
          "required": ["ok", "n"], "additionalProperties": False}
RF = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}


def _jax_config(max_tokens=8):
    return js.LLMConfig(
        model_id="dis", engine=JEngineConfig(
            model=jl.LlamaConfig.tiny(vocab_size=258, max_seq_len=SEQ,
                                      attention="reference", remat=False),
            max_batch=2, max_seq=SEQ, seed=0),
        max_tokens=max_tokens)


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree_util.tree_map(
        np.asarray, jl.llama_init(jax.random.PRNGKey(0),
                                  _jax_config().engine.model))
    return tree, params_from_jax(tree, device="cpu")


def _port_config(max_tokens=8):
    return tiny_llm_config("dis", max_seq=SEQ, max_tokens=max_tokens)


@pytest.mark.parametrize("prompt,rf", [("hello world", None),
                                       ("abc", None), ("answer:", RF)])
def test_prefill_matches_reference(weights, prompt, rf):
    tree, params = weights
    ref = rd.PrefillServer(_jax_config(), ref_serialization.dumps(tree))
    port = pd.PrefillServer(_port_config(), params, device="cpu")
    want = ref.prefill(prompt, response_format=rf)
    got = port.prefill(prompt, response_format=rf)
    assert isinstance(got["ks"], HostTensor) and got["ks"].dtype == "float32"
    for key in ("ks", "vs"):
        a = from_host(got[key], "cpu").numpy()
        b = np.asarray(want[key])
        assert a.shape == b.shape
        assert float(np.max(np.abs(a - b))) <= 1e-5, key
    for key in ("prompt_len", "first_token", "prompt_tokens"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("source", ["port", "reference"])
@pytest.mark.parametrize("rf", [None, RF])
def test_decode_adopts_either_prefill(weights, source, rf):
    """The port's decode replica adopts the port's host block or the
    reference's numpy block and answers as the reference's does."""
    tree, params = weights
    blob = ref_serialization.dumps(tree)
    ref_pre = rd.PrefillServer(_jax_config(64), blob)
    ref_dec = rd.DecodeServer(_jax_config(64), blob)
    port_dec = pd.DecodeServer(_port_config(64), params, device="cpu")
    try:
        kw = dict(max_tokens=48 if rf else 6, response_format=rf)
        prompt = "answer:" if rf else "hello world"
        want = ref_dec.decode_prefilled(
            ref_pre.prefill(prompt, response_format=rf), **kw)
        if source == "port":
            pre = pd.PrefillServer(_port_config(64), params, device="cpu")
            out = pre.prefill(prompt, response_format=rf)
        else:
            out = ref_pre.prefill(prompt, response_format=rf)
        got = port_dec.decode_prefilled(out, **kw)
    finally:
        ref_dec.stop()
        port_dec.stop()
    assert got == want
    if rf:
        obj = json.loads(got["text"])
        assert isinstance(obj["ok"], bool) and isinstance(obj["n"], int)


REFUSED = [
    {"__path__": "/v1/chat/completions",
     "messages": [{"role": "user", "content": "x"}]},
    {"__path__": "/v1/completions", "prompt": "x", "stop": ["a"]},
    {"__path__": "/v1/completions", "prompt": 5},
    {"__path__": "/v1/completions", "prompt": "x", "max_tokens": 0},
    {"__path__": "/v1/completions", "prompt": "x", "model": "other"},
    {"__path__": "/v1/completions", "prompt": "x", "response_format": {
        "type": "json_schema",
        "json_schema": {"schema": {"type": "string", "pattern": "a+"}}}},
    {"__path__": "/v1/unknown"},
    {"__path__": "/v1/models"},
]


@pytest.mark.parametrize("body", REFUSED)
def test_router_refusals_match_reference(body):
    """Validated on the router, before any replica is called."""
    ref = rd.DisaggRouter(_jax_config(), None, None)
    port = pd.DisaggRouter(_port_config(), None, None)
    assert port(dict(body)) == ref(dict(body))


@pytest.fixture(scope="module")
def disagg_app(weights):
    old_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old_omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    tree, params = weights
    ref = js.LLMServer(_jax_config(64), ref_serialization.dumps(tree))
    handle = serve.run(
        pd.build_disagg_app(_port_config(64), params=params, device="cpu"),
        name="disagg", route_prefix="/llm", timeout_s=120)
    yield handle, ref
    ref.stop()
    try:
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
        torch.set_num_threads(old_threads)
        if old_omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old_omp


def test_disagg_app_matches_colocated_reference(disagg_app):
    handle, ref = disagg_app
    for prompt, n in (("hello world", 6), ("abc", 4), ("hello world", 6)):
        body = {"__path__": "/v1/completions", "prompt": prompt,
                "max_tokens": n}
        got = handle.remote(dict(body)).result(timeout_s=120)
        want = ref.completions(dict(body))
        assert "error" not in got, got
        assert got["choices"][0]["text"] == want["choices"][0]["text"]
        assert got["usage"] == want["usage"]
        assert strip_ids(got) == strip_ids(want)


def test_disagg_streaming_matches_colocated_reference(disagg_app):
    handle, ref = disagg_app
    want = ref.completions({"prompt": "hello world", "max_tokens": 6})
    events = list(handle.options(stream=True).remote(
        {"__path__": "/v1/completions", "prompt": "hello world",
         "max_tokens": 6, "stream": True}))
    assert events[-1] == "data: [DONE]\n\n"
    chunks = [json.loads(e[len("data: "):]) for e in events[:-1]]
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        want["choices"][0]["text"]
    assert sum(1 for c in chunks if c["choices"][0]["text"]) >= 2
    final = chunks[-1]
    assert final["choices"][0]["finish_reason"] in ("stop", "length")
    assert final["usage"] == want["usage"]
    assert final["kv_handoff_ms"] >= 0.0


def test_disagg_guided_and_router_side_refusal(disagg_app):
    handle, ref = disagg_app
    body = {"__path__": "/v1/completions", "prompt": "answer:",
            "max_tokens": 48, "response_format": RF}
    got = handle.remote(dict(body)).result(timeout_s=120)
    assert "error" not in got, got
    obj = json.loads(got["choices"][0]["text"])
    assert isinstance(obj["ok"], bool) and isinstance(obj["n"], int)
    want = ref.completions(dict(body))
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    chunks = list(handle.options(stream=True).remote(
        dict(body, stream=True)))
    text = "".join(json.loads(c[len("data: "):])["choices"][0]["text"]
                   for c in chunks
                   if c.startswith("data: ") and "[DONE]" not in c)
    assert json.loads(text) == obj
    bad = handle.remote(dict(REFUSED[5])).result(timeout_s=60)
    assert bad["error"]["type"] == "invalid_request_error"
