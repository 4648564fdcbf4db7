"""Deployments and applications: the declarative serve API
(port of ray_tpu/serve/deployment.py).

Capability parity with the reference's API layer (reference:
python/ray/serve/api.py @serve.deployment / serve.run:694;
deployment.py Deployment.options/bind; model composition via bound
applications resolving to DeploymentHandles).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


class Application:
    """A bound deployment graph node (reference: serve's built
    Application). ``Deployment.bind(*args)`` captures init args; nested
    Applications become DeploymentHandles at deploy time."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Deployment:
    def __init__(self, func_or_class: Any, name: str,
                 config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                max_queued_requests: Optional[int] = None,
                shed_queue_wait_s: Optional[float] = None,
                autoscaling_config: Optional[AutoscalingConfig] = None,
                ray_actor_options: Optional[Dict[str, Any]] = None,
                user_config: Optional[Dict[str, Any]] = None,
                request_router: Optional[str] = None,
                ) -> "Deployment":
        cfg = copy.deepcopy(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if shed_queue_wait_s is not None:
            cfg.shed_queue_wait_s = shed_queue_wait_s
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if user_config is not None:
            cfg.user_config = dict(user_config)
        if request_router is not None:
            cfg.request_router = request_router
        return Deployment(self.func_or_class, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 100,
               max_queued_requests: int = -1,
               shed_queue_wait_s: float = 0.0,
               autoscaling_config=None, ray_actor_options=None,
               user_config=None, request_router: str = "pow2"):
    """``@serve.deployment`` (reference: python/ray/serve/api.py)."""

    def make(target) -> Deployment:
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            shed_queue_wait_s=shed_queue_wait_s,
            ray_actor_options=dict(ray_actor_options or {}),
            user_config=user_config,
            request_router=request_router)
        if autoscaling_config is not None:
            cfg.autoscaling_config = (
                AutoscalingConfig(**autoscaling_config)
                if isinstance(autoscaling_config, dict)
                else autoscaling_config)
        return Deployment(target, name or target.__name__, cfg)

    if _func_or_class is not None:
        return make(_func_or_class)
    return make


def flatten_application(app: Application, app_name: str,
                        route_prefix: Optional[str]) -> List[dict]:
    """Depth-first walk of the bound graph → controller deploy specs.
    Bound child Applications are replaced with DeploymentHandles.
    The root deployment gets the route_prefix (ingress)."""
    from ray_tpu_torch.serve.handle import DeploymentHandle

    specs: Dict[str, dict] = {}

    def visit(node: Application) -> DeploymentHandle:
        dep = node.deployment
        resolved_args = tuple(
            visit(a) if isinstance(a, Application) else a
            for a in node.args)
        resolved_kwargs = {
            k: (visit(v) if isinstance(v, Application) else v)
            for k, v in node.kwargs.items()}
        if dep.name not in specs:
            specs[dep.name] = {
                "name": dep.name,
                "callable_blob": serialization.dumps(dep.func_or_class),
                "init_args_blob": serialization.dumps(
                    (resolved_args, resolved_kwargs)),
                "config": dep.config,
                "route_prefix": None,
            }
        return DeploymentHandle(dep.name, app_name)

    visit(app)
    specs[app.deployment.name]["route_prefix"] = route_prefix
    return list(specs.values())
