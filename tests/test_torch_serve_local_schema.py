"""Local testing mode and declarative deploy of the port's Serve (ports
of ray_tpu/serve/local_mode.py and schema.py) against the reference.

The same classes, bound through each package's ``serve.deployment``, run
through both ``serve.run(..., local_testing_mode=True)`` with no runtime
and give equal results (tests/test_serve_local.py); the same config
dicts through both ``ServeDeploySchema.from_dict`` and
``build_app_from_schema`` give equal schemas, equal deployment graphs
and the same refusals. On the port's runtime ``deploy_config`` and
``deploy_config_file`` deploy an app and start the proxy it declares.
"""

import dataclasses
import json
import os
import sys
import time
import types
import urllib.request

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as rserve
from ray_tpu.serve import schema as rschema
from ray_tpu_torch import serve as pserve
from ray_tpu_torch.serve import schema as pschema


class Doubler:
    def __call__(self, v):
        return 2 * v

    def label(self, v):
        return f"doubled:{v}"


class Ingress:
    def __init__(self, inner, scale=1):
        self.inner = inner
        self.scale = scale

    def __call__(self, v):
        return self.scale * self.inner.remote(v).result()

    def stream_squares(self, n):
        for i in range(n):
            yield i * i


def plain_fn(v):
    return v + 100


class Echo:
    def __call__(self, request):
        return {"got": request}


class Boom:
    def __call__(self):
        raise RuntimeError("kapow")

    def slow(self):
        time.sleep(1.0)
        return "late"


def _scenario(serve):
    """tests/test_serve_local.py's calls through one package's serve."""
    out = {}
    doubler, ingress = serve.deployment(Doubler), serve.deployment(Ingress)
    handle = serve.run(doubler.bind(), local_testing_mode=True)
    out["double"] = handle.remote(21).result()
    handle = serve.run(ingress.bind(doubler.bind(), scale=10),
                       local_testing_mode=True)
    out["composed"] = handle.remote(3).result()
    inner = serve.run(doubler.bind(), local_testing_mode=True)
    out["method"] = inner.label.remote(5).result()
    handle = serve.run(ingress.bind(doubler.bind()),
                       local_testing_mode=True)
    out["stream"] = list(handle.options(
        stream=True, method_name="stream_squares").remote(4))
    out["stream_single"] = list(inner.options(stream=True).remote(7))
    fn_handle = serve.run(serve.deployment(plain_fn).bind(),
                          local_testing_mode=True)
    out["fn"] = fn_handle.remote(1).result()
    with pytest.raises(AttributeError, match="function deployment") as ei:
        fn_handle.other.remote(1).result()
    out["fn_error"] = str(ei.value)
    boom = serve.run(serve.deployment(Boom).bind(), local_testing_mode=True)
    with pytest.raises(RuntimeError, match="kapow"):
        boom.remote().result()
    with pytest.raises(TimeoutError) as ei:
        boom.slow.remote().result(timeout_s=0.05)
    out["timeout"] = str(ei.value)
    builds = []

    class Counted:
        def __init__(self):
            builds.append(1)

        def __call__(self):
            return len(builds)

    class Two:
        def __init__(self, a, b):
            self.a, self.b = a, b

        def __call__(self):
            return (self.a.remote().result(), self.b.remote().result())

    shared = serve.deployment(Counted).bind()
    handle = serve.run(serve.deployment(Two).bind(shared, shared),
                       local_testing_mode=True)
    out["shared"] = (handle.remote().result(), len(builds))
    return out


def test_local_mode_matches_reference():
    assert not ray_tpu_torch.is_initialized()
    got = _scenario(pserve)
    assert not ray_tpu_torch.is_initialized()  # no runtime was started
    want = _scenario(rserve)
    assert got == want
    assert got["composed"] == 60 and got["shared"] == ((1, 1), 1)


def _app_module(monkeypatch):
    """One importable module holding, for each package, a bound app and
    a builder (the import paths a config names)."""
    mod = types.ModuleType("schema_apps")
    for tag, serve in (("port", pserve), ("ref", rserve)):
        model = serve.deployment(Doubler, name="Model", num_replicas=1)
        front = serve.deployment(Ingress, name="Front")
        setattr(mod, f"{tag}_app", front.bind(model.bind(), scale=3))

        def builder(scale=1, _front=front, _model=model):
            return _front.bind(_model.bind(), scale=scale)

        setattr(mod, f"{tag}_builder", builder)
        setattr(mod, f"{tag}_not_app", lambda: 42)
        setattr(mod, f"{tag}_web", serve.deployment(Echo).bind())
    monkeypatch.setitem(sys.modules, "schema_apps", mod)
    return mod


def _graph(app, application_cls):
    """A bound graph as plain data: each node's deployment name, config
    and arguments (child nodes by their graph)."""
    def node(n):
        def arg(a):
            return node(a) if isinstance(a, application_cls) else a
        return {"name": n.deployment.name,
                "config": dataclasses.asdict(n.deployment.config),
                "args": [arg(a) for a in n.args],
                "kwargs": {k: arg(v) for k, v in n.kwargs.items()}}
    return node(app)


def _config(tag, **app):
    base = {"name": "a1", "import_path": f"schema_apps:{tag}_builder",
            "route_prefix": "/a", "args": {"scale": 5},
            "runtime_env": {"env_vars": {"X": "1"}},
            "deployments": [{"name": "Model", "num_replicas": 2,
                             "max_ongoing_requests": 7,
                             "ray_actor_options": {"num_cpus": 0}}]}
    base.update(app)
    return {"applications": [base], "http_options": {"port": 0}}


@pytest.mark.parametrize("app", [
    {}, {"import_path": "schema_apps:{tag}_app", "args": {}},
    {"deployments": [{"name": "Front", "user_config": {"k": 1},
                      "autoscaling_config": {"min_replicas": 1,
                                             "max_replicas": 3}}]},
])
def test_schema_builds_equal_graphs(monkeypatch, app):
    _app_module(monkeypatch)
    graphs, schemas = {}, {}
    for tag, schema, package in (("port", pschema, "ray_tpu_torch"),
                                 ("ref", rschema, "ray_tpu")):
        cfg = _config(tag, **{k: (v.format(tag=tag) if isinstance(v, str)
                                  else v) for k, v in app.items()})
        parsed = schema.ServeDeploySchema.from_dict(cfg)
        schemas[tag] = json.loads(json.dumps(
            dataclasses.asdict(parsed)).replace(f"apps:{tag}_", "apps:T_"))
        application = sys.modules[f"{package}.serve.deployment"].Application
        graphs[tag] = _graph(
            schema.build_app_from_schema(parsed.applications[0]),
            application)
    assert schemas["port"] == schemas["ref"]
    assert json.dumps(graphs["port"], default=str) == \
        json.dumps(graphs["ref"], default=str)


BAD = [
    {"applications": []},
    {"applications": [{"name": "a"}]},
    {"applications": [{"name": "a", "import_path": "no_colon"}]},
    {"applications": [{"name": "a", "import_path": "m:x", "bogus": 1}]},
    {"applications": [{"name": "a", "import_path": "m:x"},
                      {"name": "a", "import_path": "m:y"}]},
    {"applications": [{"name": "a", "import_path": "m:x",
                       "deployments": [{"num_replicas": 2}]}]},
    {"applications": [{"name": "a", "import_path": "m:x",
                       "deployments": [{"name": "d", "colour": 2}]}]},
    {"applications": [{"name": "a", "import_path": "m:x"}],
     "http_options": 5},
    {"applications": [{"name": "a", "import_path": "m:x"}], "extra": 1},
]


@pytest.mark.parametrize("cfg", BAD)
def test_schema_refusals_match_reference(cfg):
    with pytest.raises(ValueError) as port_err:
        pschema.ServeDeploySchema.from_dict(cfg)
    with pytest.raises(ValueError) as ref_err:
        rschema.ServeDeploySchema.from_dict(cfg)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("app,exc", [
    ({"import_path": "schema_apps:{tag}_app", "args": {"scale": 2}},
     ValueError),
    ({"import_path": "schema_apps:{tag}_not_app", "args": {}}, TypeError),
    ({"deployments": [{"name": "Nope", "num_replicas": 2}]}, ValueError),
])
def test_build_refusals_match_reference(monkeypatch, app, exc):
    _app_module(monkeypatch)
    messages = {}
    for tag, schema in (("port", pschema), ("ref", rschema)):
        cfg = _config(tag, **{k: (v.format(tag=tag) if isinstance(v, str)
                                  else v) for k, v in app.items()})
        parsed = schema.ServeDeploySchema.from_dict(cfg).applications[0]
        with pytest.raises(exc) as ei:
            schema.build_app_from_schema(parsed)
        messages[tag] = str(ei.value).replace(f"apps:{tag}_", "apps:T_")
    assert messages["port"] == messages["ref"]


def test_deploy_config_and_file_on_the_runtime(monkeypatch, tmp_path):
    _app_module(monkeypatch)
    old_omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    old_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        cfg = _config("port")
        cfg["applications"][0]["deployments"][0]["num_replicas"] = 1
        assert pserve.deploy_config(cfg) == ["a1"]
        assert pserve.status()["Model"]["target_replicas"] == 1
        assert pserve.get_app_handle("a1").remote(4).result(
            timeout_s=60) == 40
        path = tmp_path / "serve.yaml"
        path.write_text(
            "applications:\n"
            "  - name: a2\n"
            "    route_prefix: /b\n"
            "    import_path: schema_apps:port_web\n"
            "    deployments:\n"
            "      - name: Echo\n"
            "        max_ongoing_requests: 3\n")
        assert pserve.deploy_config_file(str(path)) == ["a2"]
        assert pserve.status()["Echo"]["route_prefix"] == "/b"
        # the proxy deploy_config started (its http_options) serves it
        port = pserve._proxy.port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/b?x=1",
                                    timeout=60) as resp:
            assert json.loads(resp.read()) == {"got": {"x": "1"}}
    finally:
        try:
            pserve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
            torch.set_num_threads(old_threads)
            if old_omp is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = old_omp
    assert not ray_tpu.is_initialized()
