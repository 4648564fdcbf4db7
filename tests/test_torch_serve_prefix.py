"""Prefix-aware routing of the port's Serve (port of
ray_tpu/serve/prefix_router.py): the same insert / match / evict /
``drop_replica`` sequence through both packages' ``PrefixTree`` and the
same requests through both ``extract_prompt``s give equal results
(tests/test_serve.py:435), and two replicas behind
``request_router="prefix_aware"`` keep shared-prefix prompts on one
replica (tests/test_serve.py:456). The router's pick between a cache
match and load balance is held against the reference's on a stub
replica set.
"""

import os
import random

import pytest
import torch

import ray_tpu_torch
from ray_tpu.serve import prefix_router as ref_pr
from ray_tpu_torch import serve
from ray_tpu_torch.serve import prefix_router as port_pr

TEXTS = [
    "You are a helpful assistant. Question one",
    "You are a helpful assistant. Question two",
    "You are a helpful assistant. Question three",
    "completely different",
    "System: you are terse. Document: " + "x" * 200 + " q1",
    "System: you are terse. Document: " + "x" * 200 + " q2",
    "",
    "short",
    "y" * 3000,
]


def _sequence(module, threshold):
    """A fixed sequence of tree operations; every match's result."""
    tree = module.PrefixTree(eviction_threshold_chars=threshold)
    rng = random.Random(5)
    log = []
    for step in range(60):
        text = TEXTS[rng.randrange(len(TEXTS))] + f" {step % 7}"
        rid = f"r{rng.randrange(3)}"
        op = rng.randrange(4)
        if op < 2:
            tree.insert(text, rid)
        elif op == 2:
            log.append(("match", text, tree.match(text)))
        else:
            tree.drop_replica(rid)
        log.append(("chars", tree._chars))
    for text in TEXTS:
        log.append(("final", text, tree.match(text)))
    return log


@pytest.mark.parametrize("threshold", [100, 2_000, 400_000])
def test_prefix_tree_sequence_matches_reference(threshold):
    assert _sequence(port_pr, threshold) == _sequence(ref_pr, threshold)


def test_prefix_tree_match_insert_evict():
    tree = port_pr.PrefixTree(eviction_threshold_chars=10_000)
    tree.insert(TEXTS[0], "r1")
    tree.insert(TEXTS[1], "r2")
    m = tree.match(TEXTS[2])
    assert set(m) == {"r1", "r2"} and m["r1"] >= 32
    assert tree.match("completely different") == {}
    tree.drop_replica("r1")
    assert "r1" not in tree.match("You are a helpful assistant.")
    small = port_pr.PrefixTree(eviction_threshold_chars=100)
    for i in range(50):
        small.insert(f"prompt number {i} with padding text", "r")
    assert small._chars <= 100 + 64


REQUESTS = [
    {"prompt": "hello"}, {"prompt": ""}, {"prompt": 5},
    {"messages": [{"role": "system", "content": "be terse"},
                  {"role": "user", "content": "hi"}]},
    {"messages": [{"role": "user", "content": ["parts"]}, "junk"]},
    {"messages": []}, {}, "not a dict", None,
    {"prompt": "p", "messages": [{"content": "m"}]},
]


@pytest.mark.parametrize("request_", REQUESTS)
def test_extract_prompt_matches_reference(request_):
    assert port_pr.extract_prompt(request_) == \
        ref_pr.extract_prompt(request_)


def _stub_router(module, qlens, penalised):
    """The package's PrefixAwareRouter without a controller: the
    replicas of ``qlens`` with those queue lengths, a seeded pow-2."""
    import threading
    router = object.__new__(module.PrefixAwareRouter)
    router.tree = module.PrefixTree()
    router._replicas = [(rid, rid) for rid in qlens]
    router._lock = threading.Lock()
    router._rng = random.Random(0)
    router._queue_len = lambda rid, _handle: qlens[rid]
    router.rejection_penalty = lambda rid: 1.0 if rid in penalised else 0.0
    return router


@pytest.mark.parametrize("qlens,penalised", [
    ({"a": 0, "b": 0}, ()),        # balanced: the cache match wins
    ({"a": 20, "b": 0}, ()),       # imbalanced: load wins
    ({"a": 0, "b": 0}, ("a",)),    # a recently rejecting replica sits out
    ({"a": 0, "b": 0, "c": 3}, ()),
])
def test_affinity_pick_matches_reference(qlens, penalised):
    """choose() on the serialized request, as every router path calls
    it; each routed prompt goes into the tree."""
    from ray_tpu.core import serialization as ref_ser
    from ray_tpu_torch.core import serialization as port_ser
    shared = "System: shared prefix " * 6
    requests = ([{"prompt": shared + " earlier"}]
                + [{"prompt": shared + f" q{i}"} for i in range(4)]
                + [{"prompt": "unrelated"}, {"x": 1},
                   {"messages": [{"content": shared}]}])
    picks = {}
    for name, module, ser in (("port", port_pr, port_ser),
                              ("ref", ref_pr, ref_ser)):
        router = _stub_router(module, qlens, penalised)
        router.tree.insert(shared + " seed", "a")
        picks[name] = [router.choose(ser.dumps(((r,), {})))[0]
                       for r in requests]
        picks[name].append(router.tree.match(shared))
    assert picks["port"] == picks["ref"]


@pytest.fixture(scope="module")
def serve_rt():
    old_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old_omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    yield rt
    try:
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
        torch.set_num_threads(old_threads)
        if old_omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old_omp


def test_prefix_aware_routing_affinity(serve_rt):
    """Balanced load and a shared prompt prefix: the same replica every
    time, once the first routing decision is in the tree."""

    @serve.deployment(num_replicas=2, request_router="prefix_aware",
                      ray_actor_options={"num_cpus": 0})
    class Echo:
        def __call__(self, request):
            import os
            return {"pid": os.getpid(),
                    "prompt": request.get("prompt", "")}

    serve.run(Echo.bind(), name="prefixapp", route_prefix="/pfx")
    handle = serve.get_deployment_handle("Echo", app_name="prefixapp")
    from ray_tpu_torch.serve import handle as handle_mod
    base = "System: you are terse. Document: " + "x" * 200
    pids = {handle.remote({"prompt": base + f" q{i}"}
                          ).result(timeout_s=60)["pid"] for i in range(6)}
    assert isinstance(handle_mod._routers["Echo"], port_pr.PrefixAwareRouter)
    assert len(pids) <= 2
    sticky = {handle.remote({"prompt": base + f" late{i}"}
                            ).result(timeout_s=60)["pid"]
              for i in range(4)}
    assert len(sticky) == 1
    handle.remote({"prompt": "zzz different"}).result(timeout_s=60)
    serve.delete("prefixapp")
