"""Serve's core on the port's runtime: the scenarios of tests/test_serve.py
(deployments, routing, composition, batching, reconfiguration,
multiplexing; the HTTP proxy is not ported) and the streaming handles of
tests/test_serve_streaming.py, on ``ray_tpu_torch.serve``.

One port runtime serves the module; every replica is an actor in a port
worker process. The deployments are local classes, shipped by value, and
name only the standard library.
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def serve_rt():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    yield rt
    try:
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture
def serve_instance(serve_rt):
    yield serve_rt
    serve.shutdown()


def test_function_deployment(serve_instance):
    @serve.deployment
    def double(req):
        return req["x"] * 2

    handle = serve.run(double.bind(), name="fn_app")
    assert handle.remote({"x": 21}).result() == 42
    assert serve.status()["double"]["status"] == "HEALTHY"


def test_class_deployment_and_methods(serve_instance):
    @serve.deployment
    class Counter:
        def __init__(self, start):
            self.count = start

        def __call__(self, req):
            return self.count

        def incr(self, by):
            self.count += by
            return self.count

    handle = serve.run(Counter.bind(10), name="cls_app")
    assert handle.remote({}).result() == 10
    assert handle.incr.remote(5).result() == 15
    assert handle.options(method_name="incr").remote(1).result() == 16
    assert serve.get_app_handle("cls_app").remote({}).result() == 16
    assert serve.get_deployment_handle(
        "Counter", "cls_app").incr.remote(0).result() == 16


def test_num_replicas_spread(serve_instance):
    @serve.deployment(num_replicas=3, ray_actor_options={"num_cpus": 0})
    class WhoAmI:
        def __init__(self):
            import os
            self.pid = os.getpid()

        def __call__(self, req):
            return self.pid

    handle = serve.run(WhoAmI.bind(), name="spread_app")
    pids = {handle.remote({}).result() for _ in range(30)}
    assert len(pids) >= 2  # pow-2 routing spreads across replicas


def test_composition(serve_instance):
    @serve.deployment
    class Adder:
        def __init__(self, amount):
            self.amount = amount

        def __call__(self, x):
            return x + self.amount

    @serve.deployment
    class Pipeline:
        def __init__(self, a, b):
            self.a = a  # DeploymentHandles
            self.b = b

        def __call__(self, req):
            x = self.a.remote(req["x"]).result()
            return self.b.remote(x).result()

    app = Pipeline.bind(Adder.options(name="add1").bind(1),
                        Adder.options(name="add10").bind(10))
    handle = serve.run(app, name="comp_app", timeout_s=110.0)
    assert handle.remote({"x": 0}).result(timeout_s=30) == 11
    serve.delete("comp_app")
    assert not {"add1", "add10", "Pipeline"} & set(serve.status())


def test_batching(serve_instance):
    @serve.deployment(max_ongoing_requests=32)
    class Batcher:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        def handle_batch(self, items):
            self.batch_sizes.append(len(items))
            return [i * 2 for i in items]

        def __call__(self, req):
            return self.handle_batch(req["x"])

        def sizes(self, req):
            return self.batch_sizes

    handle = serve.run(Batcher.bind(), name="batch_app")
    results = [None] * 16

    def call(i):
        results[i] = handle.remote({"x": i}).result()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [i * 2 for i in range(16)]
    sizes = handle.sizes.remote({}).result()
    assert max(sizes) > 1 and sum(sizes) == 16  # batching batched


def test_user_config_reconfigure(serve_instance):
    @serve.deployment(user_config={"threshold": 1})
    class Thresh:
        def __init__(self):
            self.threshold = None

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self, req):
            return self.threshold

    handle = serve.run(Thresh.bind(), name="cfg_app")
    assert handle.remote({}).result() == 1
    serve.run(Thresh.options(user_config={"threshold": 5}).bind(),
              name="cfg_app")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if handle.remote({}).result() == 5:
            break
        time.sleep(0.1)
    assert handle.remote({}).result() == 5


def test_multiplexed_models(serve_instance):
    @serve.deployment
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            self.loads.append(model_id)
            return {"id": model_id, "scale": int(model_id[-1])}

        def __call__(self, req):
            model = self.get_model(req["model"])
            assert serve.get_multiplexed_model_id() == req["model"]
            return req["x"] * model["scale"]

        def load_count(self, req):
            return len(self.loads)

    handle = serve.run(MultiModel.bind(), name="mux_app")
    assert handle.remote({"model": "m2", "x": 10}).result() == 20
    assert handle.remote({"model": "m3", "x": 10}).result() == 30
    assert handle.remote({"model": "m2", "x": 5}).result() == 10
    assert handle.load_count.remote({}).result() == 2  # m2 cached
    # a third model evicts the least recently used (m3), so m3 reloads
    assert handle.remote({"model": "m4", "x": 1}).result() == 4
    assert handle.remote({"model": "m3", "x": 1}).result() == 3
    assert handle.load_count.remote({}).result() == 4


def test_streaming_handle(serve_instance):
    @serve.deployment
    class Streamer:
        def __call__(self, n):
            for i in range(n):
                yield {"i": i}

    handle = serve.run(Streamer.bind(), name="stream_app")
    out = list(handle.options(stream=True).remote(3))
    assert out == [{"i": 0}, {"i": 1}, {"i": 2}]


def test_streaming_handle_single_value(serve_instance):
    """Non-generator handlers still work through the streaming path."""
    @serve.deployment
    def plain(x):
        return x * 2

    handle = serve.run(plain.bind(), name="plain_stream_app")
    assert list(handle.options(stream=True).remote(21)) == [42]


def test_unported_entry_points_refuse():
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        serve.start(proxy=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        serve.start(grpc_port=9000)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        serve.deployment(request_router="prefix_aware")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        serve.deploy_config({})

    @serve.deployment
    def f(x):
        return x

    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        f.options(request_router="prefix_aware")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        serve.run(f.bind(), local_testing_mode=True)
