"""Serve local testing mode: in-process deployments, no cluster
(port of ray_tpu/serve/local_mode.py).

Reference: python/ray/serve/_private/local_testing_mode.py:49 —
``serve.run(app, local_testing_mode=True)`` instantiates every
deployment in the current process and returns a handle with
``DeploymentHandle`` semantics (``.remote()``/``.result()``,
method-attribute handles, ``options(stream=True)`` generators),
so deployment logic unit-tests run without ``ray_tpu_torch.init``.

Divergences (stated): one in-process "replica" per deployment —
num_replicas / autoscaling / routing policies do not apply; calls run
on a fresh thread each (so composed deployments can call each other
without deadlock) with no max_ongoing_requests admission control.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.serve.deployment import Application


class LocalResponse:
    """Future-like result of a local handle call (mirrors
    DeploymentResponse.result)."""

    def __init__(self, fn, args, kwargs):
        self._value = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()

        def _run():
            try:
                self._value = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — re-raised in result
                self._error = e
            finally:
                self._done.set()

        threading.Thread(target=_run, daemon=True).start()

    def result(self, timeout_s: Optional[float] = None) -> Any:
        if not self._done.wait(timeout_s):
            raise TimeoutError(
                f"local deployment call not done after {timeout_s}s")
        if self._error is not None:
            raise self._error
        return self._value


class _LocalStream:
    """Iterable over a streaming local call (mirrors
    DeploymentResponseGenerator): a generator's items, or the single
    value of a non-generator handler."""

    def __init__(self, fn, args, kwargs):
        self._fn, self._args, self._kwargs = fn, args, kwargs

    def __iter__(self):
        out = self._fn(*self._args, **self._kwargs)
        if hasattr(out, "__iter__") and not isinstance(
                out, (str, bytes, dict)):
            yield from out
        else:
            yield out


class LocalDeploymentHandle:
    """DeploymentHandle look-alike bound to an in-process instance."""

    def __init__(self, instance: Any, method_name: str = "__call__",
                 stream: bool = False):
        self._instance = instance
        self._method_name = method_name
        self._stream = stream

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                **_ignored) -> "LocalDeploymentHandle":
        return LocalDeploymentHandle(
            self._instance, method_name or self._method_name,
            self._stream if stream is None else stream)

    def remote(self, *args, **kwargs):
        inst = self._instance
        import functools
        if isinstance(inst, functools.partial) or \
                (callable(inst) and not hasattr(inst, self._method_name)):
            if self._method_name != "__call__":
                raise AttributeError(
                    f"function deployment has no method "
                    f"{self._method_name!r}")
            fn = inst  # function deployment
        else:
            fn = getattr(inst, self._method_name)
        if self._stream:
            return _LocalStream(fn, args, kwargs)
        return LocalResponse(fn, args, kwargs)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return LocalDeploymentHandle(self._instance, name, self._stream)


def run_local(app: Application) -> LocalDeploymentHandle:
    """Instantiate the bound deployment graph in-process; nested
    Applications resolve to LocalDeploymentHandles (shared nodes
    instantiate once, matching deploy-time semantics)."""
    built: Dict[int, Any] = {}

    def build(node: Application):
        if id(node) in built:
            return built[id(node)]

        def resolve(v):
            return build(v) if isinstance(v, Application) else v

        args = tuple(resolve(a) for a in node.args)
        kwargs = {k: resolve(v) for k, v in node.kwargs.items()}
        target = node.deployment.func_or_class
        if isinstance(target, type):
            instance = target(*args, **kwargs)
        elif args or kwargs:
            import functools
            instance = functools.partial(target, *args, **kwargs)
        else:
            instance = target
        handle = LocalDeploymentHandle(instance)
        built[id(node)] = handle
        return handle

    return build(app)
