"""Sebulba's failure and backpressure scenarios on the port's runtime,
on the CPU (tests/test_podracer.py:296-404): an env actor killed
mid-rollout, replay backpressure that bounds the queue's depth, and
fragment refs that outlive their producer; and Sebulba's device rule.
The env the actors run lives in the JAX-free
``tests/test_torch_rl_remote_card.py``. No test here needs JAX.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core import serialization
from ray_tpu_torch.rl import RLModuleSpec
from ray_tpu_torch.rl.podracer import (
    Sebulba, SebulbaConfig, build_inference_app, create_replay_actor)
from ray_tpu_torch.rl.podracer.sebulba import _SebulbaActorImpl
from test_torch_rl_remote_card import BanditEnv


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def podracer_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, system_config={"task_max_retries": 0})
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _port_spec(hidden=(16,)):
    return RLModuleSpec(BanditEnv.observation_space, BanditEnv.action_space,
                        hidden)


def test_sebulba_actor_death_mid_rollout(podracer_cluster):
    """Killing an env-runner mid-run costs its in-flight fragment and
    nothing else: the learner finishes every update, the surviving
    actor keeps the replay queue fed."""
    cfg = SebulbaConfig(
        env_creator=BanditEnv, num_actors=2, num_envs_per_actor=2,
        rollout_len=8, hidden=(16,), fragments_per_step=1,
        weight_push_interval=2, max_staleness=50, seed=1)
    s = Sebulba(cfg, device="cpu")
    doomed = s.actors[0]
    # 0.3 s into the run (the reference waits 1 s): the port's loop can
    # finish all 8 updates within a second, after which no death shows
    timer = threading.Timer(0.3, lambda: ray_tpu_torch.kill(doomed))
    timer.start()
    try:
        out = s.train(8, step_timeout_s=60.0)
    finally:
        timer.cancel()
        s.shutdown()
    assert out["actor_deaths"] == 1
    assert len(s.actors) == 1
    assert out["learner"]["num_updates"] == 8
    assert out["fragments"] >= 4


def test_sebulba_replay_backpressure_bounds_depth(podracer_cluster):
    """An actor outrunning an absent learner: the replay queue evicts
    the oldest instead of growing."""
    spec = _port_spec()
    handle = serve.run(build_inference_app(spec, device="cpu"), name="bp",
                       route_prefix=None)
    replay = create_replay_actor(3, name="bp:replay")
    blob = serialization.dumps({
        "actor_id": 0, "env_creator": BanditEnv, "num_envs": 2,
        "rollout_len": 4, "seed": 0, "handle": handle,
        "replay_name": "bp:replay", "infer_timeout_s": 30.0})
    actor = ray_tpu_torch.remote(_SebulbaActorImpl).options(
        num_cpus=0).remote(blob)
    metas = [ray_tpu_torch.get(actor.sample_fragment.remote())
             for _ in range(8)]
    st = ray_tpu_torch.get(replay.stats.remote())
    assert st["pushed"] == 8
    assert st["depth"] == 3          # bounded, not 8
    assert st["dropped"] == 5        # evictions were counted
    assert any(m["dropped"] for m in metas)
    items = ray_tpu_torch.get(replay.pop_many.remote(99))
    fresh = [ray_tpu_torch.get(refs[0]) for _meta, refs in items]
    assert len(fresh) == 3
    assert all(f["obs"].shape == (4, 2, 3) for f in fresh)
    ray_tpu_torch.kill(actor)
    ray_tpu_torch.kill(replay)


class _Producer:
    def __init__(self, replay_name):
        self._replay = ray_tpu_torch.get_actor(replay_name)

    def produce(self, n, tag0):
        import gc
        for i in range(n):
            ref = ray_tpu_torch.put({"tag": tag0 + i,
                                     "data": np.arange(2048)})
            ray_tpu_torch.get(self._replay.push.remote(
                ({"tag": tag0 + i}, [ref])))
            del ref  # no keep-alive: the borrow chain must pin
        gc.collect()
        return True


def test_fragment_refs_survive_producer_turnover(podracer_cluster):
    """Queued fragments are pinned by the replay actor's borrowed refs
    alone, popped ones by task-return containment: a get past the 2 s
    borrow grace window still resolves every queued fragment."""
    replay = create_replay_actor(4, name="pin:replay")
    prod = ray_tpu_torch.remote(_Producer).options(num_cpus=0).remote(
        "pin:replay")
    ray_tpu_torch.get(prod.produce.remote(12, 0))
    items = ray_tpu_torch.get(replay.pop_many.remote(99))
    assert [m["tag"] for m, _refs in items] == [8, 9, 10, 11]
    time.sleep(3.0)  # outlast the borrow grace window before the gets
    for meta, refs in items:
        frag = ray_tpu_torch.get(refs[0], timeout=10)
        assert frag["tag"] == meta["tag"]
        assert frag["data"].shape == (2048,)
    ray_tpu_torch.kill(prod)
    ray_tpu_torch.kill(replay)


def test_sebulba_needs_a_card_unless_cpu_is_asked(podracer_cluster):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Sebulba(SebulbaConfig(env_creator=BanditEnv))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_inference_app(_port_spec())
