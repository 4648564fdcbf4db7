"""The HTTP and gRPC proxies of the port's Serve (ports of
ray_tpu/serve/proxy.py and grpc_proxy.py): the scenarios of
tests/test_serve.py:251 (JSON and query bodies), :274 (gRPC ingress),
tests/test_serve_streaming.py:45 and :67 (SSE and plain JSON),
tests/test_admission.py:389 (503 with Retry-After) and
tests/test_observability.py:46 (a ``traceparent`` request's spans, read
from the GCS trace store), plus the OpenAI app behind the proxy
(tests/test_llm.py:94), whose answers equal the reference's in-process
``LLMServer`` on the same weights.

One port runtime and one HTTP proxy serve the module; every deployment
is a local class shipped by value that names only the standard library.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.core import serialization as ref_serialization
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.models import llama as jl
from ray_tpu.serve import llm as js
from ray_tpu_torch import serve
from ray_tpu_torch.models import params_from_jax
from ray_tpu_torch.serve.llm import build_openai_app
from ray_tpu_torch.util import tracing
from test_torch_serve_llm_card import strip_ids, tiny_llm_config


@pytest.fixture(scope="module")
def proxy_rt():
    old_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old_omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    serve.start(proxy=True, http_options=serve.HTTPOptions(port=0))
    yield rt, serve._proxy.port
    try:
        serve.shutdown()
        assert serve._proxy is None
    finally:
        ray_tpu_torch.shutdown()
        torch.set_num_threads(old_threads)
        if old_omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old_omp


def _post(port, path, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


def _get(port, path, timeout=60):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=timeout)


def test_http_proxy_json_and_query(proxy_rt):
    _rt, port = proxy_rt

    @serve.deployment
    def echo(req):
        return {"got": req}

    serve.run(echo.bind(), name="http_app", route_prefix="/echo")
    with _post(port, "/echo", {"a": 1}) as resp:
        assert json.loads(resp.read()) == {"got": {"a": 1}}
    with _get(port, "/echo?b=2") as resp:
        assert json.loads(resp.read()) == {"got": {"b": "2"}}
    # the remainder of the path rides in __path__; a client's own
    # __path__ is never trusted
    with _post(port, "/echo/sub/x", {"__path__": "/evil", "c": 3}) as resp:
        assert json.loads(resp.read()) == {"got": {"c": 3,
                                                   "__path__": "/sub/x"}}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(port, "/nowhere/at/all")
    assert ei.value.code == 404
    assert json.loads(ei.value.read()) == {
        "error": "no route for /nowhere/at/all"}
    serve.delete("http_app")


def test_proxy_sse_and_plain_json(proxy_rt):
    _rt, port = proxy_rt

    @serve.deployment
    class SSE:
        def __call__(self, request):
            for i in range(3):
                yield f"data: {json.dumps({'n': i})}\n\n"
                time.sleep(0.05)

    @serve.deployment
    def plain(request):
        return {"got": request.get("x")}

    serve.run(SSE.bind(), name="sse_app", route_prefix="/sse")
    serve.run(plain.bind(), name="plain_app", route_prefix="/plain")
    with _get(port, "/sse") as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        raw = resp.read().decode()
    events = [json.loads(line[len("data: "):])
              for line in raw.splitlines() if line.startswith("data: ")]
    assert events == [{"n": 0}, {"n": 1}, {"n": 2}]
    with _get(port, "/plain?x=1") as resp:
        assert json.loads(resp.read()) == {"got": "1"}
    serve.delete("sse_app")
    serve.delete("plain_app")


def test_http_503_with_retry_after(proxy_rt):
    _rt, port = proxy_rt

    @serve.deployment(max_ongoing_requests=1, max_queued_requests=0)
    class SlowHttp:
        def __call__(self, req):
            time.sleep(float(req.get("sleep", 0)))
            return {"ok": True}

    serve.run(SlowHttp.bind(), name="http503_app", route_prefix="/s")

    def post(payload):
        with _post(port, "/s", payload, timeout=30) as resp:
            return json.loads(resp.read())

    assert post({}) == {"ok": True}  # warm-up configures admission
    blocker = threading.Thread(target=post, args=({"sleep": 1.5},))
    blocker.start()
    try:
        time.sleep(0.4)
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({})
        err = ei.value
        assert err.code == 503
        assert int(err.headers.get("Retry-After")) >= 1
        body = json.loads(err.read())
        assert body["deployment"] == "SlowHttp"
        assert body["reason"] == "queue_full"
        assert body["retry_after_s"] > 0
    finally:
        blocker.join(timeout=30)
    assert post({}) == {"ok": True}  # recovered after the blocker
    serve.delete("http503_app")


def test_grpc_ingress(proxy_rt):
    """Generic handlers, no codegen: unary and server streaming routed
    like the HTTP proxy (tests/test_serve.py:274)."""
    grpc = pytest.importorskip("grpc")

    @serve.deployment
    class Echo:
        def __call__(self, request):
            if request.get("__method__") == "Ping":
                return {"pong": True, "path": request.get("__path__")}
            if request.get("__method__") == "TokensStream":
                def gen():
                    for i in range(int(request.get("n", 3))):
                        yield {"tok": i}
                return gen()
            return {"echo": {k: v for k, v in request.items()
                             if not k.startswith("__")}}

    serve.start(grpc_port=0)
    port = serve._grpc_proxy.port
    serve.run(Echo.bind(), name="g", route_prefix="/g")
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        unary = channel.unary_unary("/ray.serve.UserService/Ping")
        out = json.loads(unary(json.dumps({}).encode(),
                               metadata=(("route", "/g"),
                                         ("path", "/health"))))
        assert out == {"pong": True, "path": "/health"}
        echo = channel.unary_unary("/ray.serve.UserService/Echo")
        out = json.loads(echo(json.dumps({"x": 1}).encode(),
                              metadata=(("route", "/g"),)))
        assert out == {"echo": {"x": 1}}
        stream = channel.unary_stream(
            "/ray.serve.UserService/TokensStream")
        chunks = [json.loads(c) for c in
                  stream(json.dumps({"n": 4}).encode(),
                         metadata=(("route", "/g"),))]
        assert chunks == [{"tok": i} for i in range(4)]
        with pytest.raises(grpc.RpcError) as ei:
            echo(json.dumps([1]).encode(), metadata=(("route", "/g"),))
        assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        channel.close()
        serve.delete("g")
        serve._grpc_proxy.stop()
        serve._grpc_proxy = None


@pytest.fixture(scope="module")
def llm_app(proxy_rt):
    """The tiny OpenAI app behind the proxy, and the reference's
    LLMServer in this process on the same weights."""
    jcfg = jl.LlamaConfig.tiny(vocab_size=258, max_seq_len=64,
                               attention="reference", remat=False)
    tree = jax.tree_util.tree_map(
        np.asarray, jl.llama_init(jax.random.PRNGKey(0), jcfg))
    ref = js.LLMServer(js.LLMConfig(
        model_id="tiny", engine=JEngineConfig(model=jcfg, max_batch=2,
                                             max_seq=64),
        max_tokens=8), ref_serialization.dumps(tree))
    serve.run(build_openai_app(config=tiny_llm_config(),
                               params=params_from_jax(tree, device="cpu"),
                               device="cpu"),
              name="llm_app", route_prefix="/v1", timeout_s=120)
    yield ref
    ref.stop()
    serve.delete("llm_app")


def test_openai_app_over_http(proxy_rt, llm_app):
    _rt, port = proxy_rt
    ref = llm_app
    cases = [("/v1/completions", {"prompt": "hi", "max_tokens": 4}),
             ("/v1/chat/completions",
              {"messages": [{"role": "user", "content": "hello"}],
               "max_tokens": 3})]
    for path, body in cases:
        with _post(port, path, body, timeout=120) as resp:
            got = json.loads(resp.read())
        assert strip_ids(got) == strip_ids(ref(dict(body, __path__=path)))
    assert got["object"] == "chat.completion"
    with _get(port, "/v1/models") as resp:
        assert json.loads(resp.read())["data"] == [{"id": "tiny",
                                                    "object": "model"}]
    body = {"prompt": "hi", "max_tokens": 4, "stream": True}
    with _post(port, "/v1/completions", body, timeout=120) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        raw = resp.read().decode()
    want = "".join(ref(dict(body, __path__="/v1/completions")))
    got_events = [strip_ids(json.loads(e[len("data: "):]))
                  for e in raw.split("\n\n") if e.startswith("data: {")]
    want_events = [strip_ids(json.loads(e[len("data: "):]))
                   for e in want.split("\n\n") if e.startswith("data: {")]
    assert got_events == want_events and raw.endswith("data: [DONE]\n\n")


def test_traceparent_spans_in_the_trace_store(proxy_rt, llm_app):
    """A request with a traceparent: the proxy echoes the trace, and its
    spans cover proxy -> router -> replica -> engine under one trace id
    with the reference's parent links (tests/test_observability.py:46)."""
    rt, port = proxy_rt
    trace_id = "f0" * 16
    tp = f"00-{trace_id}-{'1a' * 8}-01"
    with _post(port, "/v1/completions", {"prompt": "hi", "max_tokens": 3},
               headers={"traceparent": tp}, timeout=120) as resp:
        assert resp.status == 200
        echoed = tracing.parse_traceparent(resp.headers.get("traceparent"))
        assert echoed.trace_id == trace_id
        json.loads(resp.read())
    want = {"http_request", "route", "handle_request_streaming",
            "engine_generate"}
    deadline = time.monotonic() + 10
    while True:
        # the replica's spans arrive by control-plane calls, and the
        # proxy's own closes after its answer has gone to the client
        spans = rt.gcs.spans_for_trace(trace_id)
        if want <= {s[3] for s in spans} or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    by_name = {s[3]: s for s in spans}
    assert want <= set(by_name), sorted(by_name)
    assert {s[4] for s in spans} >= {"serve.proxy", "serve.router",
                                      "serve.replica", "llm.engine"}
    proxy_span = by_name["http_request"]
    assert proxy_span[2] == "1a" * 8  # the client's span is its parent
    assert proxy_span[1] == echoed.span_id
    assert by_name["route"][2] == proxy_span[1]
    replica = by_name["handle_request_streaming"]
    assert by_name["engine_generate"][2] == replica[1]
    # the replica's span hangs off its actor task, whose event joined
    # the trace
    events = rt.gcs.events_for_trace(trace_id)
    assert any(tracing.task_span_id(ev.task_id) == replica[2]
               for ev in events)
