"""gRPC proxy: a second ingress next to the HTTP proxy (port of
ray_tpu/serve/grpc_proxy.py).

Capability parity with the reference's gRPC proxy (reference:
python/ray/serve/_private/proxy.py:530 gRPCProxy — gRPC services whose
method handlers route into deployments, application selected via
request metadata). Implemented with grpc's GENERIC handlers, so no
protoc codegen is required: any fully-qualified method
``/pkg.Service/Method`` is accepted, payloads are JSON bytes, and the
target deployment resolves exactly like the HTTP proxy's routes.

Routing contract:
  - metadata ``route``: the route prefix to match (default "/") — the
    same longest-prefix table the HTTP proxy uses.
  - the request dict the deployment receives carries ``__method__``
    (the bare gRPC method name) and, when metadata ``path`` is set,
    ``__path__`` (sub-path routing, e.g. the OpenAI surface).
  - methods whose name ends in ``Stream`` are served as
    server-streaming (one JSON message per streamed chunk); everything
    else is unary. Replica streaming into a unary method is collected
    into a list.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from ray_tpu_torch.serve.admission import BackpressureError
from ray_tpu_torch.serve.proxy import _ProxyState


def _to_bytes(chunk: Any) -> bytes:
    if isinstance(chunk, (bytes, bytearray)):
        return bytes(chunk)
    if isinstance(chunk, str):
        return chunk.encode()
    return json.dumps(chunk).encode()


class _GenericHandler:
    def __init__(self, state: _ProxyState):
        self.state = state

    def _resolve(self, metadata: Dict[str, str]):
        route = metadata.get("route", "/")
        match = self.state.match(route)
        if match is None:
            self.state.refresh()
            match = self.state.match(route)
        return match

    def _build_request(self, request_bytes: bytes, method_name: str,
                       metadata: Dict[str, str]) -> Dict[str, Any]:
        request: Dict[str, Any] = {}
        if request_bytes:
            parsed = json.loads(request_bytes.decode())
            if not isinstance(parsed, dict):
                raise ValueError("request payload must be a JSON object")
            request.update(parsed)
        request.pop("__method__", None)
        request.pop("__path__", None)
        request["__method__"] = method_name
        if metadata.get("path"):
            request["__path__"] = metadata["path"]
        return request

    def _stream(self, dep: str, request: Dict[str, Any]):
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.serve.handle import _get_router
        router = _get_router(dep, self.state.controller)
        blob = serialization.dumps(((request,), {}))
        return router.stream("__call__", blob, item_timeout_s=60.0)

    def unary(self, method_name: str):
        import grpc

        def handler(request_bytes, context):
            metadata = dict(context.invocation_metadata())
            match = self._resolve(metadata)
            if match is None:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"no route {metadata.get('route', '/')!r}")
            dep, _rest = match
            try:
                request = self._build_request(request_bytes, method_name,
                                              metadata)
                gen = self._stream(dep, request)
                first = next(gen, None)
                if first is None:
                    return b"null"
                kind, value = first
                if kind == "single":
                    return _to_bytes(value)
                # replica streamed into a unary method: collect
                chunks = [value] + [chunk for _k, chunk in gen]
                return _to_bytes(chunks)
            except BackpressureError as exc:
                context.set_trailing_metadata(
                    (("retry-after-s", f"{exc.retry_after_s:.3f}"),))
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              str(exc))
            except ValueError as exc:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
            except Exception as exc:  # noqa: BLE001 — surface as error
                context.abort(grpc.StatusCode.INTERNAL, str(exc))

        return handler

    def streaming(self, method_name: str):
        import grpc

        def handler(request_bytes, context):
            metadata = dict(context.invocation_metadata())
            match = self._resolve(metadata)
            if match is None:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"no route {metadata.get('route', '/')!r}")
            dep, _rest = match
            try:
                request = self._build_request(request_bytes, method_name,
                                              metadata)
                for _kind, chunk in self._stream(dep, request):
                    yield _to_bytes(chunk)
            except BackpressureError as exc:
                context.set_trailing_metadata(
                    (("retry-after-s", f"{exc.retry_after_s:.3f}"),))
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              str(exc))
            except ValueError as exc:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
            except Exception as exc:  # noqa: BLE001
                context.abort(grpc.StatusCode.INTERNAL, str(exc))

        return handler


class GrpcProxy:
    """Serves any ``/pkg.Service/Method`` via generic handlers."""

    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 0, max_workers: int = 16):
        import grpc
        from concurrent import futures

        self.state = _ProxyState(controller)
        generic = _GenericHandler(self.state)

        class Router(grpc.GenericRpcHandler):
            def service(self, call_details):
                method = call_details.method.rsplit("/", 1)[-1]
                if method.endswith("Stream"):
                    return grpc.unary_stream_rpc_method_handler(
                        generic.streaming(method))
                return grpc.unary_unary_rpc_method_handler(
                    generic.unary(method))

        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self.server.add_generic_rpc_handlers((Router(),))
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise OSError(f"could not bind gRPC proxy on {host}:{port}")
        self.server.start()

    def stop(self) -> None:
        self.server.stop(grace=0.5)
