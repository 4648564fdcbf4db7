"""Admission control and backpressure for the serve chain
(port of ray_tpu/serve/admission.py).

Reference: python/ray/serve/_private/router.py max_queued_requests +
BackPressureError; the Sebulba podracer pattern (PAPERS.md) — request
sources feed batched TPU inference through explicitly BOUNDED queues,
never unbounded ones. Under overload the right answer is to shed at the
front door (cheap: one dict lookup in the driver) instead of queueing
work that will blow the latency SLO anyway.

One ``AdmissionController`` lives driver-side per deployment (next to
the router, which owns the actual dispatch). Semantics:

- ``inflight``  — requests admitted and not yet finished.
- ``capacity``  — live_replicas * max_ongoing_requests (refreshed by
  the router whenever it learns of a replica-set change).
- ``queued``    — max(0, inflight - capacity): requests the replicas
  cannot be executing right now, i.e. true queue depth.
- admit iff ``queued < max_queued_requests`` (cap < 0 disables the
  cap). A cap of 0 sheds the moment every replica slot is full; a cap
  of 1 lets exactly one request wait.
- EWMA overload detection: when the exponentially-decayed queue-wait
  (fed by the PR-1 ``ray_tpu_serve_queue_wait_seconds`` observations)
  exceeds ``shed_queue_wait_s``, new arrivals shed even under the hard
  cap — queue wait rises before queue depth saturates.

Shed requests raise ``BackpressureError`` BEFORE any latency histogram
observation, so p50/p99 reflect served traffic only; sheds are counted
separately in ``ray_tpu_serve_shed_requests_total``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional

from ray_tpu_torch.util.metrics import Counter, Gauge

SHED_REQUESTS = Counter(
    "ray_tpu_serve_shed_requests_total",
    "Requests shed by admission control, by deployment and reason",
    tag_keys=("deployment", "reason"))
ADMISSION_QUEUED = Gauge(
    "ray_tpu_serve_admission_queued_requests",
    "Requests admitted beyond replica capacity (true queue depth)",
    tag_keys=("deployment",))
ADMISSION_INFLIGHT = Gauge(
    "ray_tpu_serve_admission_inflight_requests",
    "Requests admitted and not yet finished, by deployment",
    tag_keys=("deployment",))


class BackpressureError(RuntimeError):
    """Raised on the handle path when admission control sheds a
    request (the HTTP proxy translates it to 503 + ``Retry-After``).
    ``retryable`` is True by definition: the request was never
    executed, so resubmitting after ``retry_after_s`` is always safe.
    """

    retryable = True

    def __init__(self, deployment: str, retry_after_s: float = 1.0,
                 reason: str = "queue_full"):
        self.deployment = deployment
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        super().__init__(
            f"deployment {deployment!r} is overloaded ({reason}); "
            f"retry after {self.retry_after_s:.2f}s")

    def __reduce__(self):
        return (BackpressureError,
                (self.deployment, self.retry_after_s, self.reason))


class Shed:
    """Sentinel RETURNED by a replica whose handler shed the request
    (e.g. the LLM engine's reject-before-enqueue hook). Like
    ``Rejected`` it travels the wire as a value, not a raised error —
    but unlike Rejected the router must NOT retry another replica: the
    handler itself declared overload, so the verdict goes straight back
    to the client as backpressure."""

    def __init__(self, retry_after_s: float = 1.0,
                 reason: str = "saturated"):
        self.retry_after_s = float(retry_after_s)
        self.reason = reason

    def __reduce__(self):
        return (Shed, (self.retry_after_s, self.reason))


class _Ewma:
    """Irregular-interval EWMA: the previous value's weight decays by
    elapsed wall time (half-life semantics), so a burst five minutes
    ago doesn't read as current overload."""

    def __init__(self, halflife_s: float):
        self.halflife_s = halflife_s
        self._value = 0.0
        self._t = None  # type: Optional[float]

    def update(self, sample: float, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        if self._t is None:
            self._value = float(sample)
        else:
            w = 0.5 ** (max(0.0, now - self._t) / self.halflife_s)
            self._value = w * self._value + (1.0 - w) * float(sample)
        self._t = now
        return self._value

    def value(self, now: Optional[float] = None) -> float:
        """Read WITH decay toward zero: silence is evidence of recovery,
        not of the last observed value persisting forever."""
        if self._t is None:
            return 0.0
        now = time.monotonic() if now is None else now
        return self._value * 0.5 ** (max(0.0, now - self._t)
                                     / self.halflife_s)


class AdmissionController:
    """Per-deployment admission state (driver-side, shared by every
    entry path of that deployment's router)."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name
        self._lock = threading.Lock()
        self._inflight = 0
        self._capacity = 1
        self._max_queued = -1        # < 0: cap disabled
        self._shed_queue_wait_s = 0.0  # <= 0: EWMA shedding disabled
        self._queue_wait = _Ewma(halflife_s=2.0)
        self._latency = _Ewma(halflife_s=5.0)
        self._total = 0
        self._shed_total = 0
        self._max_queued_seen = 0

    # -- configuration (router refresh path) --

    def configure(self, *, max_queued: Optional[int] = None,
                  capacity: Optional[int] = None,
                  shed_queue_wait_s: Optional[float] = None) -> None:
        with self._lock:
            if max_queued is not None:
                self._max_queued = int(max_queued)
            if capacity is not None:
                self._capacity = max(1, int(capacity))
            if shed_queue_wait_s is not None:
                self._shed_queue_wait_s = float(shed_queue_wait_s)

    # -- request path --

    def try_acquire(self) -> None:
        """Admit or raise BackpressureError. Must be paired with
        exactly one release() when admitted."""
        now = time.monotonic()
        with self._lock:
            reason = None
            # admit iff inflight < capacity + cap: with the cap at 0
            # a request sheds exactly when every replica slot is busy;
            # cap 1 lets one request wait, and so on
            if (self._max_queued >= 0
                    and self._inflight
                    >= self._capacity + self._max_queued):
                reason = "queue_full"
            elif (self._shed_queue_wait_s > 0.0
                  and self._queue_wait.value(now)
                  > self._shed_queue_wait_s):
                reason = "queue_wait_ewma"
            if reason is None:
                self._inflight += 1
                self._total += 1
                queued_after = max(0, self._inflight - self._capacity)
                self._max_queued_seen = max(self._max_queued_seen,
                                            queued_after)
                inflight = self._inflight
            else:
                self._shed_total += 1
                retry_after = self._retry_after_locked(now)
        if reason is None:
            ADMISSION_INFLIGHT.set(
                float(inflight),
                tags={"deployment": self.deployment_name})
            ADMISSION_QUEUED.set(
                float(queued_after),
                tags={"deployment": self.deployment_name})
            return
        SHED_REQUESTS.inc(tags={"deployment": self.deployment_name,
                                "reason": reason})
        raise BackpressureError(self.deployment_name, retry_after,
                                reason)

    def release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            inflight = self._inflight
            queued = max(0, inflight - self._capacity)
        ADMISSION_INFLIGHT.set(float(inflight),
                               tags={"deployment": self.deployment_name})
        ADMISSION_QUEUED.set(float(queued),
                             tags={"deployment": self.deployment_name})

    # -- signal feeds (router observation path) --

    def note_queue_wait(self, seconds: float) -> None:
        with self._lock:
            self._queue_wait.update(seconds)

    def note_latency(self, seconds: float) -> None:
        with self._lock:
            self._latency.update(seconds)

    # -- readouts --

    def queue_depth(self) -> int:
        with self._lock:
            return max(0, self._inflight - self._capacity)

    def take_max_queue_depth(self) -> int:
        """Peak queue depth since the last call (and reset) — load
        harness runs use this to report exact per-window peaks instead
        of a sampled approximation."""
        with self._lock:
            peak = self._max_queued_seen
            self._max_queued_seen = max(
                0, self._inflight - self._capacity)
            return peak

    def _retry_after_locked(self, now: float) -> float:
        # How long until a shed client's retry plausibly finds room:
        # roughly one queue's worth of service time, floored so clients
        # never busy-spin and capped so they never give up for minutes.
        latency = self._latency.value(now)
        queued = max(0, self._inflight - self._capacity)
        per_slot = latency / max(1, self._capacity)
        estimate = max(0.1, per_slot * (queued + 1))
        return min(30.0, estimate if math.isfinite(estimate) else 1.0)

    def snapshot(self) -> Dict[str, float]:
        now = time.monotonic()
        with self._lock:
            queued = max(0, self._inflight - self._capacity)
            return {
                "inflight": float(self._inflight),
                "capacity": float(self._capacity),
                "queue_depth": float(queued),
                "max_queue_depth": float(self._max_queued_seen),
                "ewma_queue_wait_s": self._queue_wait.value(now),
                "ewma_latency_s": self._latency.value(now),
                "total": float(self._total),
                "shed_total": float(self._shed_total),
            }


_controllers: Dict[str, AdmissionController] = {}
_controllers_lock = threading.Lock()


def get_admission_controller(deployment_name: str) -> AdmissionController:
    with _controllers_lock:
        ctrl = _controllers.get(deployment_name)
        if ctrl is None:
            ctrl = AdmissionController(deployment_name)
            _controllers[deployment_name] = ctrl
        return ctrl


def reset_admission() -> None:
    """Forget all per-deployment admission state (serve.shutdown)."""
    with _controllers_lock:
        _controllers.clear()
