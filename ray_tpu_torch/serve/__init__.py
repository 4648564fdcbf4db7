"""ray_tpu_torch.serve: model serving on the port's runtime (port of
ray_tpu/serve/__init__.py; reference: python/ray/serve/ — controller,
replicas, router and proxy, autoscaling, batching, multiplexing,
composition through handles), with the OpenAI-compatible LLM surface
(``serve/llm.py``: ``LLMServer``, ``MultiplexLLMServer``,
``build_llm_deployment``, ``build_openai_app``; loaded on first access).

The controller is a named actor on ``ray_tpu_torch``'s runtime, each
replica an actor; ``serve.run`` returns the ingress
``DeploymentHandle``. ``start(proxy=True)`` starts the HTTP proxy in
this process and ``start(grpc_port=)`` the gRPC ingress (``grpc`` is
imported only then); ``run(..., local_testing_mode=True)`` builds the
deployment graph in-process with no runtime; ``deploy_config`` applies
a declarative config.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.admission import BackpressureError
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                        HTTPOptions)
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.deployment import (
    Application,
    Deployment,
    deployment,
    flatten_application,
)
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

_proxy = None
_grpc_proxy = None

_LLM_NAMES = ("LLMConfig", "LLMServer", "MultiplexLLMServer",
              "build_llm_deployment", "build_openai_app")


def __getattr__(name):
    # The LLM surface imports torch and the engine: a replica process
    # that serves something else does not pay for it.
    if name in _LLM_NAMES:
        from ray_tpu_torch.serve import llm
        return getattr(llm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _get_or_start_controller():
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        Controller = ray_tpu_torch.remote(ServeController)
        handle = Controller.options(
            name=CONTROLLER_NAME, max_concurrency=8, num_cpus=0).remote()
        ray_tpu_torch.get(handle.ping.remote())
        return handle


def start(http_options: Optional[HTTPOptions] = None,
          proxy: bool = False, grpc_port: Optional[int] = None):
    """Start the serve control plane (and optionally the HTTP proxy
    and/or the gRPC ingress — reference: serve's HTTP + gRPC proxies,
    serve/_private/proxy.py:530,706)."""
    global _proxy, _grpc_proxy
    controller = _get_or_start_controller()
    if proxy and _proxy is None:
        from ray_tpu_torch.serve.proxy import HttpProxy
        opts = http_options or HTTPOptions()
        _proxy = HttpProxy(controller, opts.host, opts.port)
    if grpc_port is not None and _grpc_proxy is None:
        from ray_tpu_torch.serve.grpc_proxy import GrpcProxy
        _grpc_proxy = GrpcProxy(controller, port=grpc_port)
    return controller


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking_ready: bool = True,
        timeout_s: float = 60.0, local_testing_mode: bool = False):
    """Deploy an application; returns the ingress handle
    (reference: python/ray/serve/api.py serve.run:694).

    ``local_testing_mode=True`` instantiates the whole deployment
    graph in-process — no controller, no cluster, no
    ray_tpu_torch.init — and returns a handle with DeploymentHandle
    semantics (reference: serve/_private/local_testing_mode.py:49)."""
    if local_testing_mode:
        from ray_tpu_torch.serve.local_mode import run_local
        return run_local(app)
    controller = _get_or_start_controller()
    specs = flatten_application(app, name, route_prefix)
    ray_tpu_torch.get(controller.deploy_application.remote(name, specs))
    ingress = app.deployment.name
    if blocking_ready:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = ray_tpu_torch.get(controller.get_status.remote())
            d = status.get(ingress)
            if d and d["status"] == "HEALTHY" and d["running_replicas"] > 0:
                break
            time.sleep(0.05)
        else:
            raise TimeoutError(f"deployment {ingress} not ready "
                               f"after {timeout_s}s: {status}")
    return DeploymentHandle(ingress, name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _get_or_start_controller()
    status = ray_tpu_torch.get(controller.get_status.remote())
    for dep, info in status.items():
        if info["app"] == name and info["route_prefix"]:
            return DeploymentHandle(dep, name)
    raise ValueError(f"no application named {name!r}")


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def status() -> Dict[str, dict]:
    controller = _get_or_start_controller()
    return ray_tpu_torch.get(controller.get_status.remote())


def delete(name: str) -> None:
    controller = _get_or_start_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name))


def shutdown() -> None:
    """Stop the proxies, remove every application, stop the controller
    and forget the driver's routers and admission state."""
    global _proxy, _grpc_proxy
    if _proxy is not None:
        _proxy.stop()
        _proxy = None
    if _grpc_proxy is not None:
        _grpc_proxy.stop()
        _grpc_proxy = None
    if not ray_tpu_torch.is_initialized():
        return
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.shutdown.remote())
        ray_tpu_torch.kill(controller)
    except ValueError:
        pass
    from ray_tpu_torch.serve import handle as handle_mod
    with handle_mod._routers_lock:
        handle_mod._routers.clear()
        handle_mod._routers_unresolved.clear()
    from ray_tpu_torch.serve.admission import reset_admission
    reset_admission()


def deploy_config(config: dict):
    """Apply a declarative application config dict (reference:
    serve/schema.py ServeDeploySchema + REST deploy)."""
    from ray_tpu_torch.serve.schema import deploy_config as _deploy
    return _deploy(config)


def deploy_config_file(path: str):
    """Apply a YAML config file (same schema as deploy_config)."""
    from ray_tpu_torch.serve.schema import deploy_config_file as _deploy_file
    return _deploy_file(path)


__all__ = [
    "Application", "AutoscalingConfig", "BackpressureError",
    "Deployment", "DeploymentConfig", "DeploymentHandle",
    "DeploymentResponse", "HTTPOptions", *_LLM_NAMES, "batch",
    "delete", "deploy_config", "deploy_config_file", "deployment",
    "get_app_handle", "get_deployment_handle", "get_multiplexed_model_id",
    "multiplexed", "run", "shutdown", "start", "status",
]
