"""HTTP proxy: routes requests to ingress deployments (port of
ray_tpu/serve/proxy.py).

Capability parity with the reference's proxy (reference:
python/ray/serve/_private/proxy.py:115,530,706 HTTP proxy — longest-
prefix route matching, JSON bodies, per-request routing through the
router). The reference runs uvicorn/ASGI proxy actors on every ingress
node; here a threaded stdlib HTTP server runs in the driver (or any
host) process — dependency-free and sufficient for single-host serving;
multi-host ingress fans out by starting one proxy per node.
"""

from __future__ import annotations

import json
import threading

import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve.admission import BackpressureError
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter, Histogram

PROXY_REQUESTS = Counter(
    "ray_tpu_serve_proxy_requests_total",
    "HTTP requests through the serve proxy, by deployment and outcome",
    tag_keys=("deployment", "outcome"))
PROXY_LATENCY = Histogram(
    "ray_tpu_serve_proxy_latency_seconds",
    "Proxy-measured end-to-end HTTP request latency",
    tag_keys=("deployment",))


class _ProxyState:
    def __init__(self, controller):
        self.controller = controller
        self._routes: Dict[str, str] = {}
        self._lock = threading.Lock()

    def refresh(self) -> None:
        routes = ray_tpu_torch.get(self.controller.list_routes.remote())
        with self._lock:
            self._routes = dict(routes)

    def match(self, path: str) -> Optional[Tuple[str, str]]:
        """Longest-prefix match → (deployment_name, remaining_path)."""
        with self._lock:
            routes = dict(self._routes)
        best = None
        for prefix, dep in routes.items():
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(
                    norm + ("" if norm == "/" else "/")) or norm == "/":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, dep)
        if best is None:
            return None
        prefix, dep = best
        rest = path[len(prefix):] if prefix != "/" else path
        return dep, rest or "/"


def _make_handler(state: _ProxyState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _respond(self, code: int, payload: Any,
                     extra_headers: Optional[Dict[str, str]] = None
                     ) -> None:
            body = (payload if isinstance(payload, (bytes, bytearray))
                    else json.dumps(payload).encode())
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in (extra_headers or {}).items():
                self.send_header(key, value)
            self._send_traceparent()
            self.end_headers()
            self.wfile.write(body)

        def _send_traceparent(self) -> None:
            # Echo the request's trace so clients can retrieve the
            # distributed trace via /api/traces/<trace_id> — including
            # traces the proxy minted for header-less requests.
            ctx = getattr(self, "_trace_ctx", None)
            if ctx is not None:
                self.send_header("traceparent",
                                 tracing.format_traceparent(ctx))

        def _handle(self, body: Optional[dict]) -> None:
            # W3C trace context: continue the client's trace when a
            # valid traceparent header arrives, else mint a fresh root.
            # Everything downstream (router pick, replica execution,
            # nested .remote() calls, engine work) rides this context.
            parent_ctx = tracing.parse_traceparent(
                self.headers.get("traceparent"))
            with tracing.span("http_request", component="serve.proxy",
                              tags={"path": self.path.split("?")[0]},
                              parent=parent_ctx) as ctx:
                self._trace_ctx = ctx
                self._handle_traced(body)

        def _handle_traced(self, body: Optional[dict]) -> None:
            import time as _time
            t0 = _time.perf_counter()
            parsed = urllib.parse.urlparse(self.path)
            match = state.match(parsed.path)
            if match is None:
                state.refresh()
                match = state.match(parsed.path)
            if match is None:
                PROXY_REQUESTS.inc(tags={"deployment": "<no-route>",
                                         "outcome": "404"})
                self._respond(404, {"error": f"no route for {parsed.path}"})
                return
            dep, rest = match
            request: Dict[str, Any] = dict(
                urllib.parse.parse_qsl(parsed.query))
            if body:
                request.update(body)
            # Sub-path routing (e.g. the OpenAI /v1/* surface): expose
            # the remainder under the reserved "__path__" key. Always
            # strip any client-supplied value first — routing metadata
            # must come from the proxy, never the payload. Root requests
            # keep a pristine payload.
            request.pop("__path__", None)
            if rest != "/":
                request["__path__"] = rest
            streaming_started = False
            try:
                # Streaming-first protocol: the replica's header item
                # tells us whether the handler streamed (→ SSE/chunked
                # response, reference: serve/_private/proxy.py:706
                # streaming responses) or returned a value (→ JSON).
                from ray_tpu_torch.core import serialization
                from ray_tpu_torch.serve.handle import _get_router
                router = _get_router(dep, state.controller)
                blob = serialization.dumps(((request,), {}))
                gen = router.stream("__call__", blob, item_timeout_s=60.0)
                first = next(gen, None)
                if first is None:
                    self._respond(200, None)
                    return
                kind, value = first
                if kind == "single":
                    # Reserved "__status__": handlers set the HTTP code
                    # (e.g. 404 model_not_found on the OpenAI surface).
                    code = 200
                    if isinstance(value, dict) and "__status__" in value:
                        value = dict(value)
                        code = int(value.pop("__status__"))
                    self._respond(code, value)
                    PROXY_REQUESTS.inc(tags={"deployment": dep,
                                             "outcome": str(code)})
                    PROXY_LATENCY.observe(_time.perf_counter() - t0,
                                          tags={"deployment": dep})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self._send_traceparent()
                self.end_headers()
                streaming_started = True
                self._write_chunk(value)
                for _kind, chunk in gen:
                    self._write_chunk(chunk)
                PROXY_REQUESTS.inc(tags={"deployment": dep,
                                         "outcome": "200"})
                PROXY_LATENCY.observe(_time.perf_counter() - t0,
                                      tags={"deployment": dep})
            except BackpressureError as e:
                # Admission control shed this request (queue cap or
                # EWMA overload): 503 + Retry-After, the standard
                # please-back-off contract. Not an error outcome — the
                # system is doing exactly what it should under
                # overload — and never a latency observation.
                PROXY_REQUESTS.inc(tags={"deployment": dep,
                                         "outcome": "503"})
                if streaming_started:
                    return
                import math as _math
                retry_after = max(1, int(_math.ceil(e.retry_after_s)))
                try:
                    self._respond(
                        503,
                        {"error": "deployment overloaded",
                         "deployment": e.deployment,
                         "reason": e.reason,
                         "retry_after_s": e.retry_after_s},
                        extra_headers={"Retry-After": str(retry_after)})
                except (OSError, ValueError):
                    pass
            except Exception as e:  # noqa: BLE001 — surface as 500
                PROXY_REQUESTS.inc(tags={"deployment": dep,
                                         "outcome": "error"})
                if streaming_started:
                    return  # headers sent: a clean close, never a second
                           # status line into the SSE body
                try:
                    self._respond(500, {"error": str(e)})
                except (OSError, ValueError):
                    pass

        def _write_chunk(self, chunk: Any) -> None:
            if isinstance(chunk, (bytes, bytearray)):
                data = bytes(chunk)
            elif isinstance(chunk, str):
                data = chunk.encode()
            else:
                data = (json.dumps(chunk) + "\n").encode()
            self.wfile.write(data)
            self.wfile.flush()

        def do_GET(self):  # noqa: N802
            self._handle(None)

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            try:
                body = json.loads(raw) if raw else None
            except json.JSONDecodeError:
                body = {"body": raw.decode("utf-8", "replace")}
            self._handle(body)

    return Handler


class HttpProxy:
    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 8000):
        self.state = _ProxyState(controller)
        self.server = ThreadingHTTPServer((host, port),
                                          _make_handler(self.state))
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
