"""Declarative serve config: schema'd YAML/dict application deploys
(port of ray_tpu/serve/schema.py).

Capability parity with the reference's config-file deploy surface
(reference: python/ray/serve/schema.py:431 ServeDeploySchema +
serve/scripts.py `serve deploy` — applications declared as import
paths with per-deployment overrides, applied idempotently). The same
dict shape drives `serve.deploy_config()` and, read from YAML (``yaml``
is imported only there), `serve.deploy_config_file()`.

    applications:
      - name: app1
        route_prefix: /a
        import_path: my_module:app        # Application or builder fn
        args: {model: "m1"}               # passed to a builder fn
        deployments:
          - name: Model
            num_replicas: 2
            max_ongoing_requests: 16
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_DEPLOYMENT_FIELDS = ("name", "num_replicas", "max_ongoing_requests",
                      "max_queued_requests", "shed_queue_wait_s",
                      "autoscaling_config", "ray_actor_options",
                      "user_config")
_APP_FIELDS = ("name", "import_path", "route_prefix", "args",
               "runtime_env", "deployments")


@dataclass
class DeploymentSchema:
    name: str
    num_replicas: Optional[int] = None
    max_ongoing_requests: Optional[int] = None
    max_queued_requests: Optional[int] = None
    shed_queue_wait_s: Optional[float] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    ray_actor_options: Optional[Dict[str, Any]] = None
    user_config: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeploymentSchema":
        unknown = set(d) - set(_DEPLOYMENT_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown deployment config field(s) {sorted(unknown)}; "
                f"supported: {_DEPLOYMENT_FIELDS}")
        if "name" not in d:
            raise ValueError("deployment override requires 'name'")
        return cls(**d)

    def overrides(self) -> Dict[str, Any]:
        out = {}
        for key in _DEPLOYMENT_FIELDS[1:]:
            value = getattr(self, key)
            if value is not None:
                out[key] = value
        return out


@dataclass
class ServeApplicationSchema:
    name: str
    import_path: str
    route_prefix: Optional[str] = "/"
    args: Dict[str, Any] = field(default_factory=dict)
    runtime_env: Optional[Dict[str, Any]] = None
    deployments: List[DeploymentSchema] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeApplicationSchema":
        unknown = set(d) - set(_APP_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown application config field(s) {sorted(unknown)}; "
                f"supported: {_APP_FIELDS}")
        for required in ("name", "import_path"):
            if required not in d:
                raise ValueError(f"application config requires {required!r}")
        if ":" not in d["import_path"]:
            raise ValueError(
                "import_path must look like 'module.sub:attribute', got "
                f"{d['import_path']!r}")
        deployments = [DeploymentSchema.from_dict(dd)
                       for dd in d.get("deployments", ())]
        return cls(name=d["name"], import_path=d["import_path"],
                   route_prefix=d.get("route_prefix", "/"),
                   args=dict(d.get("args") or {}),
                   runtime_env=d.get("runtime_env"),
                   deployments=deployments)


@dataclass
class ServeDeploySchema:
    applications: List[ServeApplicationSchema]
    http_options: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeDeploySchema":
        unknown = set(d) - {"applications", "http_options"}
        if unknown:
            raise ValueError(
                f"unknown top-level config field(s) {sorted(unknown)}")
        apps = d.get("applications")
        if not isinstance(apps, list) or not apps:
            raise ValueError("config requires a non-empty 'applications' "
                             "list")
        names = [a.get("name") for a in apps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate application names in {names}")
        http_options = d.get("http_options")
        if http_options is not None and not isinstance(http_options, dict):
            raise ValueError("http_options must be a dict (host/port)")
        return cls(applications=[ServeApplicationSchema.from_dict(a)
                                 for a in apps],
                   http_options=http_options)


def _import_target(import_path: str):
    module_name, _, attr = import_path.partition(":")
    module = importlib.import_module(module_name)
    target = module
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def _map_deployments(app, transform):
    """Rebuild a bound Application graph with ``transform(deployment)``
    applied to every node (the one graph-walk shape shared by override
    and runtime_env application)."""
    from ray_tpu_torch.serve.deployment import Application

    def visit(node: Application) -> Application:
        dep = transform(node.deployment)
        args = tuple(visit(a) if isinstance(a, Application) else a
                     for a in node.args)
        kwargs = {k: (visit(v) if isinstance(v, Application) else v)
                  for k, v in node.kwargs.items()}
        return Application(dep, args, kwargs)

    return visit(app)


def _apply_overrides(app, overrides: Dict[str, Dict[str, Any]]):
    """Per-deployment option overrides by name (reference: schema.py
    deployment overrides merged over the code-declared options)."""
    applied = set()

    def transform(dep):
        if dep.name in overrides:
            applied.add(dep.name)
            return dep.options(**overrides[dep.name])
        return dep

    out = _map_deployments(app, transform)
    missing = set(overrides) - applied
    if missing:
        raise ValueError(
            f"deployment override(s) {sorted(missing)} match no "
            "deployment in the application graph")
    return out


def build_app_from_schema(schema: ServeApplicationSchema):
    """import_path -> a bound Application with overrides applied."""
    from ray_tpu_torch.serve.deployment import Application

    target = _import_target(schema.import_path)
    if isinstance(target, Application):
        if schema.args:
            raise ValueError(
                f"{schema.import_path} is a bound Application; 'args' "
                "requires a builder function")
        app = target
    elif callable(target):
        app = target(**schema.args)
        if not isinstance(app, Application):
            raise TypeError(
                f"{schema.import_path} returned {type(app).__name__}, "
                "expected a bound Application")
    else:
        raise TypeError(f"{schema.import_path} is neither an "
                        "Application nor a builder callable")
    overrides = {d.name: d.overrides() for d in schema.deployments
                 if d.overrides()}
    if overrides:
        app = _apply_overrides(app, overrides)
    if schema.runtime_env:
        app = _apply_runtime_env(app, schema.runtime_env)
    return app


def _apply_runtime_env(app, runtime_env: Dict[str, Any]):
    """Application-level runtime_env: every replica actor inherits it
    via ray_actor_options unless a deployment set its own (reference:
    ServeApplicationSchema.runtime_env applied per deployment)."""

    def transform(dep):
        opts = dict(dep.config.ray_actor_options)
        if "runtime_env" in opts:
            return dep
        opts["runtime_env"] = dict(runtime_env)
        return dep.options(ray_actor_options=opts)

    return _map_deployments(app, transform)


def deploy_config(config: Dict[str, Any]) -> List[str]:
    """Apply a declarative config: deploy every application; returns
    the deployed application names (reference: serve deploy + REST
    PUT /api/serve/applications)."""
    from ray_tpu_torch import serve

    schema = ServeDeploySchema.from_dict(config)
    if schema.http_options:
        # Start the proxy with the declared host/port (no-op when one
        # is already running — the first deploy wins the bind).
        serve.start(proxy=True,
                    http_options=serve.HTTPOptions(**schema.http_options))
    deployed = []
    for app_schema in schema.applications:
        app = build_app_from_schema(app_schema)
        serve.run(app, name=app_schema.name,
                  route_prefix=app_schema.route_prefix)
        deployed.append(app_schema.name)
    return deployed


def deploy_config_file(path: str) -> List[str]:
    import yaml
    with open(path) as f:
        config = yaml.safe_load(f)
    return deploy_config(config)
