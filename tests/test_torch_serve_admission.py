"""Admission control, autoscaling and replica recovery of the port's
Serve: the unit and handle tests of tests/test_admission.py (queue caps,
EWMA overload, Retry-After, the SLO autoscaling policy's hysteresis,
rejection-penalty decay, the engine's reject-before-enqueue, sheds on
the handle path kept out of the latency histogram; the HTTP 503 test
is in test_torch_serve_proxy.py, the prefix router's in
test_torch_serve_prefix.py) and the controller scenarios of
tests/test_serve.py (autoscaling up and down, a crashed replica
replaced), on ``ray_tpu_torch.serve``.
"""

import pickle
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.admission import (
    AdmissionController, BackpressureError, Shed, _Ewma,
    get_admission_controller, reset_admission)


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


# -- AdmissionController unit semantics -------------------------------------


def test_cap_zero_sheds_only_when_slots_full():
    ac = AdmissionController("d")
    ac.configure(max_queued=0, capacity=2)
    ac.try_acquire()
    ac.try_acquire()  # both slots busy, no queue allowed ...
    with pytest.raises(BackpressureError) as ei:
        ac.try_acquire()
    assert ei.value.reason == "queue_full"
    assert ei.value.retryable is True
    ac.release()
    ac.try_acquire()  # a freed slot readmits
    assert ac.queue_depth() == 0


def test_cap_one_allows_one_waiter():
    ac = AdmissionController("d")
    ac.configure(max_queued=1, capacity=1)
    ac.try_acquire()
    ac.try_acquire()
    assert ac.queue_depth() == 1
    with pytest.raises(BackpressureError):
        ac.try_acquire()


def test_cap_negative_disables_shedding():
    ac = AdmissionController("d")
    ac.configure(max_queued=-1, capacity=1)
    for _ in range(50):
        ac.try_acquire()
    assert ac.queue_depth() == 49


def test_backpressure_error_pickles_with_fields():
    err = BackpressureError("dep", 2.5, "queue_wait_ewma")
    back = pickle.loads(pickle.dumps(err))
    assert back.deployment == "dep"
    assert back.retry_after_s == 2.5
    assert back.reason == "queue_wait_ewma"
    assert back.retryable is True
    shed = pickle.loads(pickle.dumps(Shed(1.5, "engine_saturated")))
    assert shed.retry_after_s == 1.5 and shed.reason == "engine_saturated"


def test_retry_after_bounded():
    ac = AdmissionController("d")
    ac.configure(max_queued=0, capacity=1)
    ac.note_latency(10_000.0)  # absurd latency must not blow the bound
    ac.try_acquire()
    with pytest.raises(BackpressureError) as ei:
        ac.try_acquire()
    assert 0.1 <= ei.value.retry_after_s <= 30.0


def test_ewma_queue_wait_sheds_then_recovers():
    ac = AdmissionController("d")
    ac.configure(max_queued=100, capacity=4, shed_queue_wait_s=0.05)
    ac._queue_wait = _Ewma(halflife_s=0.05)  # fast decay for the test
    ac.note_queue_wait(5.0)
    with pytest.raises(BackpressureError) as ei:
        ac.try_acquire()
    assert ei.value.reason == "queue_wait_ewma"
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        try:
            ac.try_acquire()
            break
        except BackpressureError:
            time.sleep(0.02)
    else:
        pytest.fail("EWMA never decayed below the shed threshold")


def test_take_max_queue_depth_resets_peak():
    ac = AdmissionController("d")
    ac.configure(max_queued=10, capacity=1)
    for _ in range(4):
        ac.try_acquire()
    assert ac.take_max_queue_depth() == 3
    for _ in range(4):
        ac.release()
    assert ac.take_max_queue_depth() == 3
    assert ac.take_max_queue_depth() == 0


def test_registry_is_per_deployment():
    reset_admission()
    a = get_admission_controller("a")
    b = get_admission_controller("b")
    assert a is get_admission_controller("a")
    assert a is not b
    a.configure(max_queued=0, capacity=1)
    a.try_acquire()
    with pytest.raises(BackpressureError):
        a.try_acquire()
    b.try_acquire()  # b's cap is untouched by a's overload
    reset_admission()


# -- histogram percentile readout (util/metrics) ----------------------------


def test_percentile_from_counts_interpolates():
    from ray_tpu_torch.util.metrics import percentile_from_counts
    bounds = [1.0, 2.0, 4.0]
    assert percentile_from_counts(bounds, [0, 10, 0, 0], 0.5) == \
        pytest.approx(1.5, abs=0.06)
    assert percentile_from_counts(bounds, [0, 0, 0, 5], 0.99) == 4.0
    assert percentile_from_counts(bounds, [0, 0, 0, 0], 0.5) is None


def test_histogram_percentile_readout():
    from ray_tpu_torch.util.metrics import Histogram
    h = Histogram("t_torch_adm_pctl_seconds", "t", tag_keys=("k",),
                  boundaries=[0.1, 1.0, 10.0])
    for v in (0.05, 0.5, 0.6, 5.0):
        h.observe(v, tags={"k": "x"})
    p50 = h.percentile(0.5, tags={"k": "x"})
    assert 0.1 <= p50 <= 1.0
    assert h.percentile(0.5, tags={"k": "missing"}) is None
    bounds, buckets, total, count = h.snapshot(tags={"k": "x"})
    assert count == 4 and len(buckets) == len(bounds) + 1


# -- SLO autoscaling policy -------------------------------------------------


def _slo_cfg(**kw):
    from ray_tpu_torch.serve.config import AutoscalingConfig
    defaults = dict(policy="slo", min_replicas=1, max_replicas=4,
                    target_queue_depth=4.0, upscale_delay_s=1.0,
                    downscale_delay_s=2.0, slo_stats_staleness_s=3.0)
    defaults.update(kw)
    return AutoscalingConfig(**defaults)


def test_slo_policy_upscale_needs_sustained_breach():
    from ray_tpu_torch.autoscaler.policy import ReplicaMetrics, make_policy
    pol = make_policy("slo")
    cfg = _slo_cfg()
    m = ReplicaMetrics(running_replicas=1, queue_depth=12.0,
                       stats_age_s=0.0)
    assert pol.desired_replicas(m, cfg, 1, now=100.0) == 1
    assert pol.desired_replicas(m, cfg, 1, now=100.5) == 1
    assert pol.desired_replicas(m, cfg, 1, now=101.2) == 3
    assert pol.desired_replicas(m, cfg, 3, now=101.3) == 3


def test_slo_policy_downscale_hysteresis():
    from ray_tpu_torch.autoscaler.policy import ReplicaMetrics, make_policy
    pol = make_policy("slo")
    cfg = _slo_cfg()
    calm = ReplicaMetrics(running_replicas=3, queue_depth=0.0,
                          stats_age_s=0.0)
    assert pol.desired_replicas(calm, cfg, 3, now=10.0) == 3
    busyish = ReplicaMetrics(running_replicas=3, queue_depth=3.0,
                             stats_age_s=0.0)
    assert pol.desired_replicas(busyish, cfg, 3, now=11.0) == 3
    assert pol.desired_replicas(calm, cfg, 3, now=11.5) == 3
    assert pol.desired_replicas(calm, cfg, 3, now=13.0) == 3
    assert pol.desired_replicas(calm, cfg, 3, now=13.6) == 2
    assert pol.desired_replicas(calm, cfg, 2, now=14.0) == 2
    assert pol.desired_replicas(calm, cfg, 2, now=15.7) == 1
    assert pol.desired_replicas(calm, cfg, 1, now=30.0) == 1


def test_slo_policy_stale_stats_never_upscale():
    from ray_tpu_torch.autoscaler.policy import ReplicaMetrics, make_policy
    pol = make_policy("slo")
    cfg = _slo_cfg()
    stale = ReplicaMetrics(running_replicas=1, queue_depth=100.0,
                           stats_age_s=60.0)
    assert pol.desired_replicas(stale, cfg, 1, now=0.0) == 1
    assert pol.desired_replicas(stale, cfg, 1, now=5.0) == 1


def test_slo_policy_p99_term():
    from ray_tpu_torch.autoscaler.policy import ReplicaMetrics, make_policy
    pol = make_policy("slo")
    cfg = _slo_cfg(p99_latency_slo_s=0.5)
    slow = ReplicaMetrics(running_replicas=1, queue_depth=0.0,
                          p99_latency_s=2.0, stats_age_s=0.0)
    assert pol.desired_replicas(slow, cfg, 1, now=0.0) == 1
    assert pol.desired_replicas(slow, cfg, 1, now=1.5) == 2


def test_make_policy_unknown_raises():
    from ray_tpu_torch.autoscaler import make_policy
    with pytest.raises(ValueError):
        make_policy("nope")


# -- rejection-penalty decay (router) ---------------------------------------


def test_rejection_penalty_decays_to_zero():
    from ray_tpu_torch.serve.router import Router
    r = Router("t_penalty_dep", controller=None)
    r.reject_penalty_tau_s = 0.05
    with r._lock:
        r._note_rejection_locked("a")
        r._note_rejection_locked("a")
    assert r.rejection_penalty("a") > 1.0
    deadline = time.monotonic() + 5.0
    while r.rejection_penalty("a") > 0.0:
        if time.monotonic() > deadline:
            pytest.fail("penalty never decayed to zero")
        time.sleep(0.02)
    assert "a" not in r._reject_penalty  # entry dropped at the floor


# -- engine reject-before-enqueue -------------------------------------------


def test_engine_sheds_before_enqueue():
    from ray_tpu_torch.llm import (
        ContinuousBatchingEngine, EngineConfig, EngineSaturatedError,
        GenerationRequest)
    from ray_tpu_torch.models.llama import LlamaConfig
    eng = ContinuousBatchingEngine(EngineConfig(
        model=LlamaConfig.tiny(max_seq_len=64, remat=False),
        max_batch=2, max_seq=64, max_waiting_requests=1), device="cpu")
    eng.add_request(GenerationRequest(
        request_id="r1", prompt_ids=[1, 2, 3], max_tokens=1))
    with pytest.raises(EngineSaturatedError) as ei:
        eng.add_request(GenerationRequest(
            request_id="r2", prompt_ids=[1, 2, 3], max_tokens=1))
    assert ei.value.waiting == 1 and ei.value.cap == 1
    assert len(eng.waiting) == 1  # the shed request was NOT enqueued


# -- wired chain (runtime) --------------------------------------------------


def test_handle_sheds_with_backpressure_and_recovers(serve_instance):
    @serve.deployment(max_ongoing_requests=1, max_queued_requests=0)
    class Slow:
        def __call__(self, req):
            time.sleep(req.get("sleep", 0))
            return "done"

    handle = serve.run(Slow.bind(), name="shed_app")
    assert handle.remote({}).result(timeout_s=30) == "done"
    blocker = handle.remote({"sleep": 1.5})
    time.sleep(0.2)  # let the blocker occupy the only slot
    with pytest.raises(BackpressureError) as ei:
        handle.remote({})
    assert ei.value.retryable is True
    assert ei.value.retry_after_s > 0
    assert ei.value.deployment == "Slow"
    assert blocker.result(timeout_s=30) == "done"
    assert handle.remote({}).result(timeout_s=30) == "done"


def test_shed_excluded_from_latency_histogram(serve_instance):
    from ray_tpu_torch.util.metrics import histogram_snapshot

    @serve.deployment(max_ongoing_requests=1, max_queued_requests=0)
    class Slow2:
        def __call__(self, req):
            time.sleep(req.get("sleep", 0))
            return "ok"

    handle = serve.run(Slow2.bind(), name="shed_hist_app")
    handle.remote({}).result(timeout_s=30)
    tags = {"deployment": "Slow2"}

    def latency_count():
        snap = histogram_snapshot(
            "ray_tpu_serve_request_latency_seconds", tags=tags)
        return 0 if snap is None else snap[3]

    before = latency_count()
    blocker = handle.remote({"sleep": 1.0})
    time.sleep(0.2)
    for _ in range(5):
        with pytest.raises(BackpressureError):
            handle.remote({})
    blocker.result(timeout_s=30)
    assert latency_count() == before + 1


def test_caps_are_per_deployment(serve_instance):
    @serve.deployment(name="capped", max_ongoing_requests=1,
                      max_queued_requests=0)
    class Capped:
        def __call__(self, req):
            time.sleep(req.get("sleep", 0))
            return "capped"

    @serve.deployment(name="open")
    class Open:
        def __call__(self, req):
            return "open"

    capped = serve.run(Capped.bind(), name="cap_app",
                       route_prefix="/capped")
    opened = serve.run(Open.bind(), name="open_app",
                       route_prefix="/open")
    capped.remote({}).result(timeout_s=30)
    blocker = capped.remote({"sleep": 1.0})
    time.sleep(0.2)
    with pytest.raises(BackpressureError):
        capped.remote({})
    assert opened.remote({}).result(timeout_s=30) == "open"
    blocker.result(timeout_s=30)


def test_autoscaling_up_and_down(serve_instance):
    @serve.deployment(
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1.0,
                            "upscale_delay_s": 0.0,
                            "downscale_delay_s": 0.5,
                            "look_back_period_s": 1.0},
        max_ongoing_requests=100,
        ray_actor_options={"num_cpus": 0})
    class Slow:
        def __call__(self, req):
            time.sleep(0.3)
            return 1

    handle = serve.run(Slow.bind(), name="auto_app")
    stop = time.monotonic() + 6.0

    def hammer():
        while time.monotonic() < stop:
            try:
                handle.remote({}).result()
            except Exception:  # noqa: BLE001 — load only
                pass

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    saw_upscale = False
    while time.monotonic() < stop:
        if serve.status()["Slow"]["running_replicas"] >= 2:
            saw_upscale = True
            break
        time.sleep(0.2)
    for t in threads:
        t.join()
    assert saw_upscale, serve.status()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if serve.status()["Slow"]["running_replicas"] == 1:
            break
        time.sleep(0.3)
    assert serve.status()["Slow"]["running_replicas"] == 1


def test_replica_crash_recovery(serve_instance):
    @serve.deployment(ray_actor_options={"num_cpus": 0})
    class Fragile:
        def __call__(self, req):
            if req.get("die"):
                import os
                os._exit(1)
            return "alive"

    handle = serve.run(Fragile.bind(), name="crash_app")
    assert handle.remote({}).result() == "alive"
    try:
        handle.remote({"die": True}).result(timeout_s=5)
    except Exception:  # noqa: BLE001 — the replica dies under it
        pass
    deadline = time.monotonic() + 20
    ok = False
    while time.monotonic() < deadline:
        try:
            if handle.remote({}).result(timeout_s=5) == "alive":
                ok = True
                break
        except Exception:  # noqa: BLE001 — until the replacement is up
            time.sleep(0.2)
    assert ok, "controller did not replace the dead replica"
