"""DeploymentHandle: call deployments from Python (model composition)
(port of ray_tpu/serve/handle.py).

Capability parity with the reference's handle API (reference:
python/ray/serve/handle.py DeploymentHandle/DeploymentResponse —
``handle.remote()`` returns a response future; ``.options(method_name=)``
targets methods; handles serialize so replicas can call downstream
deployments).
"""

from __future__ import annotations

import threading

from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.core import serialization
from ray_tpu_torch.serve.admission import BackpressureError, Shed
from ray_tpu_torch.serve.replica import Rejected
from ray_tpu_torch.serve.router import Router

_routers: Dict[str, Router] = {}
# deployments whose routing policy could not be fetched yet (their
# provisional pow-2 router is upgraded once the controller answers)
_routers_unresolved: set = set()
_routers_lock = threading.Lock()


def _get_router(deployment_name: str, controller) -> Router:
    with _routers_lock:
        router = _routers.get(deployment_name)
        needs_policy = (router is None
                        or deployment_name in _routers_unresolved)
    if not needs_policy:
        return router
    # Policy fetch happens OUTSIDE the lock (it is a controller RPC; a
    # slow controller must not stall handle calls for every cached
    # deployment). A failed fetch falls back to pow-2 but stays marked
    # unresolved, so the next call retries instead of silently pinning
    # the wrong policy forever.
    import ray_tpu_torch
    policy = None
    try:
        policy = ray_tpu_torch.get(
            controller.get_router_policy.remote(deployment_name),
            timeout=10)
    except Exception:
        pass  # controller mid-restart: fall back to the default policy
    with _routers_lock:
        router = _routers.get(deployment_name)
        if router is not None and deployment_name not in \
                _routers_unresolved:
            return router  # another thread resolved it meanwhile
        if policy == "prefix_aware":
            from ray_tpu_torch.serve.prefix_router import PrefixAwareRouter
            if not isinstance(router, PrefixAwareRouter):
                router = PrefixAwareRouter(deployment_name, controller)
            _routers_unresolved.discard(deployment_name)
        elif policy is not None:
            if router is None:
                router = Router(deployment_name, controller)
            _routers_unresolved.discard(deployment_name)
        else:  # fetch failed: provisional pow-2, retry next call
            if router is None:
                router = Router(deployment_name, controller)
            _routers_unresolved.add(deployment_name)
        _routers[deployment_name] = router
        return router


class DeploymentResponse:
    """Future-like result of handle.remote() (reference:
    serve/handle.py DeploymentResponse).

    The response owns the admission token its router.submit() call
    acquired: result() (or garbage collection of an abandoned
    response) releases it exactly once, so ``inflight`` in the
    AdmissionController tracks truly outstanding requests."""

    def __init__(self, router: Router, method_name: str, args_blob: bytes,
                 replica_id: str, ref):
        import time
        self._router = router
        self._method_name = method_name
        self._args_blob = args_blob
        self._replica_id = replica_id
        self._ref = ref
        self._t_submit = time.monotonic()
        self._released = False

    def _release(self) -> None:
        if not self._released:
            self._released = True
            self._router.admission.release()

    def __del__(self):
        try:
            self._release()
        except Exception:  # interp teardown
            pass

    def result(self, timeout_s: Optional[float] = None) -> Any:
        import time
        try:
            try:
                value = ray_tpu_torch.get(self._ref, timeout=timeout_s)
            except ray_tpu_torch.exceptions.ActorError:
                # pre_admitted: reuse THIS response's token (released
                # in the outer finally) instead of acquiring a second
                return self._router.fetch(self._method_name,
                                          self._args_blob, timeout_s,
                                          pre_admitted=True)
            if isinstance(value, Rejected):
                # Chosen replica was saturated — re-route with backoff
                # (fetch records its own latency observation).
                return self._router.fetch(self._method_name,
                                          self._args_blob, timeout_s,
                                          pre_admitted=True)
            if isinstance(value, Shed):
                # The handler itself shed (engine saturation): surface
                # as typed, retryable backpressure — never retried
                # automatically, never recorded as latency.
                from ray_tpu_torch.serve.admission import SHED_REQUESTS
                SHED_REQUESTS.inc(tags={
                    "deployment": self._router.deployment_name,
                    "reason": value.reason})
                raise BackpressureError(self._router.deployment_name,
                                        value.retry_after_s,
                                        value.reason)
            self._router.observe_latency(time.monotonic() - self._t_submit)
            return value
        finally:
            self._release()


class DeploymentResponseGenerator:
    """Iterates a streaming deployment response's values (reference:
    serve/handle.py DeploymentResponseGenerator). For a handler that
    returned a plain value, yields that single value."""

    def __init__(self, inner):
        self._inner = inner

    def __iter__(self):
        for _kind, value in self._inner:
            yield value


class DeploymentHandle:
    def __init__(self, deployment_name: str, app_name: str = "default",
                 method_name: str = "__call__", stream: bool = False):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self.method_name = method_name
        self.stream = stream

    def _controller(self):
        return ray_tpu_torch.get_actor(
            __import__("ray_tpu_torch.serve.controller",
                       fromlist=["CONTROLLER_NAME"]).CONTROLLER_NAME)

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                **_ignored) -> "DeploymentHandle":
        return DeploymentHandle(self.deployment_name, self.app_name,
                                method_name or self.method_name,
                                self.stream if stream is None else stream)

    def remote(self, *args, **kwargs):
        router = _get_router(self.deployment_name, self._controller())
        blob = serialization.dumps((args, kwargs))
        if self.stream:
            return DeploymentResponseGenerator(
                router.stream(self.method_name, blob))
        rid, ref = router.submit(self.method_name, blob)
        return DeploymentResponse(router, self.method_name, blob, rid, ref)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self.deployment_name, self.app_name,
                                method_name=name, stream=self.stream)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name, self.method_name,
                 self.stream))
