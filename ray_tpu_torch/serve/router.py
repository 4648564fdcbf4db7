"""Request router: power-of-two-choices replica selection
(port of ray_tpu/serve/router.py).

Capability parity with the reference's router (reference:
python/ray/serve/_private/router.py:496 AsyncioRouter;
request_router/pow_2_router.py:27 PowerOfTwoChoicesRequestRouter —
queue-length probes, retry on rejection, replica-set refresh through the
controller's long-poll).

Every public entry path (submit/fetch/stream) passes through the
deployment's AdmissionController first (ray_tpu_torch/serve/admission.py):
overload sheds with a typed BackpressureError BEFORE any replica RPC
and before any latency observation, so queues stay bounded and the
latency histograms describe served traffic only.
"""

from __future__ import annotations

import logging
import math
import random
import threading

import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve.admission import (
    BackpressureError, SHED_REQUESTS, Shed, get_admission_controller)
from ray_tpu_torch.serve.replica import Rejected
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import (
    Counter, Histogram, percentile_from_counts)

logger = logging.getLogger(__name__)

_PROBE_CACHE_S = 0.1
# how often a busy router pushes its admission snapshot (queue depth,
# windowed p99) to the controller for the SLO autoscaling policy
_SLO_REPORT_INTERVAL_S = 0.25

# Per-deployment router instrumentation (reference: serve request
# metrics surfaced for autoscaling + dashboards). Queue wait is the
# admission delay a request spends being rejected/re-routed before a
# replica accepts it.
ROUTER_REQUESTS = Counter(
    "ray_tpu_serve_router_requests_total",
    "Requests routed, by deployment", tag_keys=("deployment",))
ROUTER_REJECTIONS = Counter(
    "ray_tpu_serve_router_rejections_total",
    "Replica rejections seen while routing", tag_keys=("deployment",))
REQUEST_LATENCY = Histogram(
    "ray_tpu_serve_request_latency_seconds",
    "End-to-end request latency through the router",
    tag_keys=("deployment",),
    boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0])
QUEUE_WAIT = Histogram(
    "ray_tpu_serve_queue_wait_seconds",
    "Admission delay before a replica accepted the request",
    tag_keys=("deployment",),
    boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0])


class Router:
    # Rejection-penalty half-life: a replica's penalty score decays by
    # e^(-elapsed/tau), so a replica that STOPS rejecting drifts back
    # to zero and regains affinity traffic (tests shrink this to
    # exercise recovery without real waiting).
    reject_penalty_tau_s = 2.0
    # decayed scores below this round to zero (and drop their entry)
    _REJECT_PENALTY_FLOOR = 0.05

    def __init__(self, deployment_name: str, controller):
        self.deployment_name = deployment_name
        self.controller = controller
        self.admission = get_admission_controller(deployment_name)
        self._version = -1
        self._replicas: List[Tuple[str, Any]] = []
        self._qlen_cache: Dict[str, Tuple[float, int]] = {}
        # replicas that recently rejected requests sit out affinity-
        # based selection (content routers consult this so a saturated
        # cache-affine replica can't livelock retries while others
        # idle); pow-2 probing ignores it. rid -> (score, t_updated):
        # the score grows by 1 per rejection and decays exponentially.
        self._reject_penalty: Dict[str, Tuple[float, float]] = {}
        self._lock = threading.Lock()
        self._rng = random.Random()
        self._last_slo_report = 0.0
        # REQUEST_LATENCY bucket counts at the last SLO report; the
        # delta between consecutive snapshots yields a WINDOWED p99
        # (a lifetime histogram never forgets a slow warm-up)
        self._latency_window: Optional[list] = None

    def _refresh(self, block: bool) -> None:
        if block:
            version, replicas = ray_tpu_torch.get(
                self.controller.poll_replicas.remote(
                    self.deployment_name, self._version, 2.0))
        else:
            version, replicas = ray_tpu_torch.get(
                self.controller.get_replicas.remote(self.deployment_name))
        with self._lock:
            self._version = version
            self._replicas = replicas
        # admission capacity tracks the live replica set; the knobs
        # come from the deployment config held by the controller
        try:
            cfg = ray_tpu_torch.get(self.controller.get_admission_config.remote(
                self.deployment_name), timeout=5)
            self.admission.configure(
                max_queued=cfg["max_queued_requests"],
                capacity=max(1, len(replicas))
                * max(1, cfg["max_ongoing_requests"]),
                shed_queue_wait_s=cfg["shed_queue_wait_s"])
        except Exception:
            logger.debug("admission config fetch failed for %r "
                         "(controller restarting?)",
                         self.deployment_name, exc_info=True)

    # -- rejection penalty (EWMA with decay toward zero) --

    def _note_rejection_locked(self, rid: str) -> None:
        # caller holds self._lock (the _locked suffix is the contract)
        now = time.monotonic()
        score = self._decayed_penalty_locked(rid, now) + 1.0
        self._reject_penalty[rid] = (score, now)

    def _decayed_penalty_locked(self, rid: str, now: float) -> float:
        entry = self._reject_penalty.get(rid)
        if entry is None:
            return 0.0
        score, t = entry
        value = score * math.exp(-(now - t) / self.reject_penalty_tau_s)
        if value < self._REJECT_PENALTY_FLOOR:
            self._reject_penalty.pop(rid, None)
            return 0.0
        return value

    def rejection_penalty(self, rid: str) -> float:
        """Current (decayed) rejection-penalty score for a replica.
        0.0 means fully recovered; content-affinity policies skip a
        replica whose score is still >= 1 (one undecayed rejection)."""
        with self._lock:
            return self._decayed_penalty_locked(rid, time.monotonic())

    # -- SLO stats push (feeds the controller's "slo" policy) --

    def _maybe_report_slo(self) -> None:
        if self.controller is None:
            return
        now = time.monotonic()
        if now - self._last_slo_report < _SLO_REPORT_INTERVAL_S:
            return
        self._last_slo_report = now
        snap = self.admission.snapshot()
        p99 = 0.0
        cur = REQUEST_LATENCY.snapshot(
            tags={"deployment": self.deployment_name})
        if cur is not None:
            bounds, buckets, _total, _count = cur
            prev = self._latency_window
            window = ([b - p for b, p in zip(buckets, prev)]
                      if prev is not None and len(prev) == len(buckets)
                      else buckets)
            self._latency_window = buckets
            value = percentile_from_counts(bounds, window, 0.99)
            if value is not None:
                p99 = value
        snap["p99_latency_s"] = p99
        try:
            # fire-and-forget: the reconcile loop reads it next tick
            self.controller.report_slo_stats.remote(
                self.deployment_name, snap)
            # piggyback a cheap replica-set refresh so capacity (and
            # routing) track autoscaler-added replicas under load
            self._refresh(block=False)
        except Exception:
            logger.debug("SLO stats push failed for %r",
                         self.deployment_name, exc_info=True)

    def _queue_len(self, rid: str, handle) -> int:
        now = time.monotonic()
        cached = self._qlen_cache.get(rid)
        if cached and now - cached[0] < _PROBE_CACHE_S:
            return cached[1]
        try:
            qlen = ray_tpu_torch.get(handle.get_queue_len.remote(), timeout=1.0)
        except Exception:
            qlen = 1 << 30  # unprobeable replica loses the comparison
        with self._lock:
            self._qlen_cache[rid] = (now, qlen)
        return qlen

    def choose(self, args_blob: Optional[bytes] = None
               ) -> Tuple[str, Any]:
        """Pick a replica: two random candidates, shorter queue wins.
        ``args_blob`` (the serialized request) is ignored here but lets
        policy subclasses route on request CONTENT (prefix_router.py);
        retries re-enter choose() with the same blob, so content
        policies re-apply on every attempt."""
        deadline = time.monotonic() + 30.0
        block = False
        while True:
            with self._lock:
                replicas = list(self._replicas)
            if replicas:
                if len(replicas) == 1:
                    return replicas[0]
                a, b = self._rng.sample(replicas, 2)
                return a if (self._queue_len(*a) <= self._queue_len(*b)) \
                    else b
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no replicas for deployment "
                    f"{self.deployment_name!r} after 30 s")
            self._refresh(block)
            block = True

    def submit(self, method_name: str, args_blob: bytes):
        """Route once and return (replica_id, ObjectRef); rejection is
        surfaced at get() time and retried by DeploymentResponse.
        Admission happens HERE (raises BackpressureError when shed);
        the matching release is DeploymentResponse's duty."""
        self.admission.try_acquire()
        try:
            self._maybe_report_slo()
            ROUTER_REQUESTS.inc(tags={"deployment": self.deployment_name})
            with tracing.span("route", component="serve.router",
                              tags={"deployment": self.deployment_name}):
                rid, handle = self.choose(args_blob)
                return rid, handle.handle_request.remote(method_name,
                                                         args_blob)
        except BaseException:
            self.admission.release()  # routing failed: token back
            raise

    def observe_latency(self, seconds: float) -> None:
        """Record one finished request's latency (called by
        DeploymentResponse.result, where the handle path's wait ends)."""
        REQUEST_LATENCY.observe(seconds,
                                tags={"deployment": self.deployment_name})
        self.admission.note_latency(seconds)

    def _admit_stream(self, method_name: str, args_blob: bytes,
                      item_timeout_s: Optional[float]):
        """Route a streaming request until a replica admits it; returns
        (t0, kind, header, item_iterator). Runs under a routing span so
        the replica's actor task attaches to the request's trace;
        metrics cover admission (queue wait) and rejections. A "shed"
        header (the handler itself declared overload) raises
        BackpressureError instead of retrying — the verdict is about
        the workload, not one replica's slot count."""
        t0 = time.monotonic()
        attempts = 0
        deadline = t0 + 60.0
        dep_tags = {"deployment": self.deployment_name}
        ROUTER_REQUESTS.inc(tags=dep_tags)
        with tracing.span("route", component="serve.router",
                          tags=dep_tags):
            while True:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"streaming request to {self.deployment_name} "
                        f"not admitted after {attempts} rejected "
                        "attempts")
                rid, handle = self.choose(args_blob)
                it = handle.handle_request_streaming.options(
                    num_returns="streaming").remote(method_name,
                                                    args_blob)
                try:
                    header = ray_tpu_torch.get(it.next_ready(item_timeout_s),
                                         timeout=item_timeout_s)
                except StopIteration:
                    self._refresh(block=False)
                    continue
                except ray_tpu_torch.exceptions.ActorError:
                    self._refresh(block=False)
                    continue
                kind = header.get("type")
                if kind == "rejected":
                    attempts += 1
                    ROUTER_REJECTIONS.inc(tags=dep_tags)
                    with self._lock:
                        self._qlen_cache.pop(rid, None)
                        self._note_rejection_locked(rid)
                    time.sleep(min(0.05 * attempts, 0.5))
                    continue
                if kind == "shed":
                    SHED_REQUESTS.inc(tags={
                        "deployment": self.deployment_name,
                        "reason": header.get("reason", "saturated")})
                    raise BackpressureError(
                        self.deployment_name,
                        header.get("retry_after_s", 1.0),
                        header.get("reason", "saturated"))
                wait = time.monotonic() - t0
                QUEUE_WAIT.observe(wait, tags=dep_tags)
                self.admission.note_queue_wait(wait)
                return t0, kind, header, it

    def stream(self, method_name: str, args_blob: bytes,
               item_timeout_s: Optional[float] = None):
        """Route a streaming request (reference: router streaming path,
        serve/_private/router.py handle streaming). Returns an iterator
        of the replica's items after the header: a single
        ("single", value) item, or ("chunk", value) items as the
        handler produces them. Re-routes on rejection/replica death
        before any chunk was consumed. Raises BackpressureError AT CALL
        TIME when admission sheds (no generator is created, no latency
        is recorded)."""
        self.admission.try_acquire()
        try:
            self._maybe_report_slo()
            t0, kind, header, it = self._admit_stream(
                method_name, args_blob, item_timeout_s)
        except BaseException:
            self.admission.release()
            raise
        return self._consume_stream(t0, kind, header, it, item_timeout_s)

    def _consume_stream(self, t0: float, kind: str, header: dict, it,
                        item_timeout_s: Optional[float]):
        dep_tags = {"deployment": self.deployment_name}
        try:
            if kind == "single":
                latency = time.monotonic() - t0
                REQUEST_LATENCY.observe(latency, tags=dep_tags)
                self.admission.note_latency(latency)
                yield "single", header.get("data")
                return
            try:
                while True:
                    try:
                        ref = it.next_ready(item_timeout_s)
                    except StopIteration:
                        return
                    item = ray_tpu_torch.get(ref, timeout=item_timeout_s)
                    yield "chunk", item.get("data")
            finally:
                latency = time.monotonic() - t0
                REQUEST_LATENCY.observe(latency, tags=dep_tags)
                self.admission.note_latency(latency)
        finally:
            self.admission.release()

    def fetch(self, method_name: str, args_blob: bytes,
              timeout: Optional[float],
              pre_admitted: bool = False) -> Any:
        """Route + get with rejection retries (the blocking path).
        ``pre_admitted=True`` reuses a token the caller already holds
        (DeploymentResponse re-routing a rejected submit) instead of
        acquiring — and releasing — a second one."""
        acquired = False
        if not pre_admitted:
            self.admission.try_acquire()
            acquired = True
        try:
            return self._fetch_admitted(method_name, args_blob, timeout)
        finally:
            if acquired:
                self.admission.release()

    def _fetch_admitted(self, method_name: str, args_blob: bytes,
                        timeout: Optional[float]) -> Any:
        self._maybe_report_slo()
        t0 = time.monotonic()
        attempts = 0
        deadline = (t0 + timeout) if timeout else None
        dep_tags = {"deployment": self.deployment_name}
        ROUTER_REQUESTS.inc(tags=dep_tags)
        with tracing.span("route", component="serve.router",
                          tags=dep_tags):
            while True:
                t_attempt = time.monotonic()
                rid, handle = self.choose(args_blob)
                ref = handle.handle_request.remote(method_name, args_blob)
                try:
                    remaining = (max(0.001, deadline - time.monotonic())
                                 if deadline else None)
                    result = ray_tpu_torch.get(ref, timeout=remaining)
                except ray_tpu_torch.exceptions.ActorError:
                    self._refresh(block=False)  # replica died; new set
                    continue
                if isinstance(result, Shed):
                    SHED_REQUESTS.inc(tags={
                        "deployment": self.deployment_name,
                        "reason": result.reason})
                    raise BackpressureError(self.deployment_name,
                                            result.retry_after_s,
                                            result.reason)
                if not isinstance(result, Rejected):
                    wait = t_attempt - t0
                    QUEUE_WAIT.observe(wait, tags=dep_tags)
                    self.admission.note_queue_wait(wait)
                    latency = time.monotonic() - t0
                    REQUEST_LATENCY.observe(latency, tags=dep_tags)
                    self.admission.note_latency(latency)
                    return result
                attempts += 1
                ROUTER_REJECTIONS.inc(tags=dep_tags)
                with self._lock:
                    self._qlen_cache.pop(rid, None)
                    self._note_rejection_locked(rid)
                if deadline and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"request to {self.deployment_name} timed out "
                        f"after {attempts} rejected attempts")
                time.sleep(min(0.05 * attempts, 0.5))
