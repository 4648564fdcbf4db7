"""Replica actor: hosts one copy of a deployment's callable
(port of ray_tpu/serve/replica.py).

Capability parity with the reference's replica (reference:
python/ray/serve/_private/replica.py:492,1138 ReplicaActor,
handle_request_with_rejection:831 — backpressure via
max_ongoing_requests; queue-length probes for the router; request
metrics for autoscaling; reconfigure(user_config); multiplexed model
LRU).
"""

from __future__ import annotations

import threading

import time
from typing import Any, Dict, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

# Replica-side instrumentation (reference: replica request metrics
# consumed by autoscaling + the dashboard). Updates are forwarded
# worker→driver through the control plane — request-rate, not hot-loop.
REPLICA_REQUESTS = Counter(
    "ray_tpu_serve_replica_requests_total",
    "Requests executed on replicas, by deployment and outcome",
    tag_keys=("deployment", "outcome"))
REPLICA_LATENCY = Histogram(
    "ray_tpu_serve_replica_request_seconds",
    "Replica-measured request execution time", tag_keys=("deployment",),
    boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0])
REPLICA_ONGOING = Gauge(
    "ray_tpu_serve_replica_ongoing_requests",
    "In-flight requests on one replica",
    tag_keys=("deployment", "replica"))


class Rejected:
    """Sentinel returned (not raised — task errors are wrapped in
    TaskError on the wire) when a replica is at max_ongoing_requests;
    the router retries on another replica."""

    def __reduce__(self):
        return (Rejected, ())


class Replica:
    def __init__(self, deployment_name: str, replica_id: str,
                 callable_blob: bytes, init_args_blob: bytes,
                 max_ongoing_requests: int,
                 user_config: Optional[dict] = None,
                 multiplex_max_models: int = 3):
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        cls_or_fn = serialization.loads(callable_blob)
        init_args, init_kwargs = serialization.loads(init_args_blob)
        if isinstance(cls_or_fn, type):
            self.callable = cls_or_fn(*init_args, **init_kwargs)
        else:
            self.callable = cls_or_fn
        self.max_ongoing = max_ongoing_requests
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        # sliding window of (t, ongoing) samples for autoscaling
        self._metric_samples = []
        self._multiplexed: "dict[str, Any]" = {}  # model_id -> model (LRU)
        self._multiplex_max = multiplex_max_models
        if user_config is not None:
            self.reconfigure(user_config)

    # -- request path --

    def handle_request(self, method_name: str, args_blob: bytes) -> Any:
        from ray_tpu_torch.serve.admission import BackpressureError, Shed
        with self._lock:
            if self._ongoing >= self.max_ongoing:
                REPLICA_REQUESTS.inc(
                    tags={"deployment": self.deployment_name,
                          "outcome": "rejected"})
                return Rejected()
            self._ongoing += 1
            self._total += 1
        t0 = time.perf_counter()
        outcome = "ok"
        try:
            with tracing.span("handle_request",
                              component="serve.replica",
                              tags={"deployment": self.deployment_name,
                                    "replica": self.replica_id,
                                    "method": method_name}):
                args, kwargs = serialization.loads(args_blob)
                fn = getattr(self.callable, method_name, self.callable)
                result = fn(*args, **kwargs)
                import inspect
                if inspect.iscoroutine(result):
                    import asyncio
                    result = asyncio.run(result)
                return result
        except BackpressureError as exc:
            # The handler itself shed (e.g. the LLM engine's reject-
            # before-enqueue hook). A sentinel — not a raised error —
            # so the router distinguishes "workload overloaded, tell
            # the client" from a replica crash it should retry.
            outcome = "shed"
            return Shed(exc.retry_after_s, exc.reason)
        except BaseException:
            outcome = "error"
            raise
        finally:
            with self._lock:
                self._ongoing -= 1
                ongoing = self._ongoing
                self._metric_samples.append((time.monotonic(), self._ongoing))
                if len(self._metric_samples) > 1000:
                    self._metric_samples = self._metric_samples[-500:]
            self._report_request_metrics(outcome,
                                         time.perf_counter() - t0,
                                         ongoing)

    def handle_control_request(self, method_name: str,
                               args_blob: bytes) -> Any:
        """Control-plane entry point: runs a method on the wrapped
        callable WITHOUT the max_ongoing_requests gate, the Rejected
        sentinel, or the Shed translation. For operations that must
        reach the replica precisely when it is saturated (weight
        pushes, reconfiguration): the data-plane path would return
        Rejected, which only the router path retries — a direct caller
        that ignores the sentinel silently loses the call."""
        with self._lock:
            self._total += 1
        with tracing.span("handle_control_request",
                          component="serve.replica",
                          tags={"deployment": self.deployment_name,
                                "replica": self.replica_id,
                                "method": method_name}):
            args, kwargs = serialization.loads(args_blob)
            fn = getattr(self.callable, method_name, self.callable)
            result = fn(*args, **kwargs)
            import inspect
            if inspect.iscoroutine(result):
                import asyncio
                result = asyncio.run(result)
            return result

    def _report_request_metrics(self, outcome: str, seconds: float,
                                ongoing: int) -> None:
        tags = {"deployment": self.deployment_name}
        REPLICA_REQUESTS.inc(tags={**tags, "outcome": outcome})
        if outcome != "shed":
            # shed requests never executed: their (near-zero) timings
            # would drag p50/p99 down exactly when overload makes the
            # latency series most load-bearing
            REPLICA_LATENCY.observe(seconds, tags=tags)
        REPLICA_ONGOING.set(float(ongoing),
                            tags={**tags, "replica": self.replica_id})

    def handle_request_streaming(self, method_name: str, args_blob: bytes):
        """Streaming request path (called with num_returns="streaming";
        reference: replica.py:793 handle_request_streaming). Yields a
        header item first:
          {"type": "rejected"}               — at max_ongoing_requests
          {"type": "single", "data": value}  — handler returned a value
          {"type": "stream"}                 — handler is a generator;
                                               chunks follow, one per item
        Backpressure accounting covers the whole stream lifetime. A
        handler that raises BackpressureError (LLM engine saturation)
        yields a {"type": "shed", "retry_after_s", "reason"} header —
        the router forwards that verdict to the client instead of
        retrying another replica.
        """
        import inspect

        from ray_tpu_torch.serve.admission import BackpressureError

        with self._lock:
            admitted = self._ongoing < self.max_ongoing
            if admitted:
                self._ongoing += 1
                self._total += 1
        if not admitted:
            # yield OUTSIDE the lock: a generator suspension while
            # holding it would block every other request thread.
            REPLICA_REQUESTS.inc(
                tags={"deployment": self.deployment_name,
                      "outcome": "rejected"})
            yield {"type": "rejected"}
            return
        t0 = time.perf_counter()
        outcome = "ok"
        try:
            with tracing.span("handle_request_streaming",
                              component="serve.replica",
                              tags={"deployment": self.deployment_name,
                                    "replica": self.replica_id,
                                    "method": method_name}):
                args, kwargs = serialization.loads(args_blob)
                fn = getattr(self.callable, method_name, self.callable)
                result = fn(*args, **kwargs)
                if inspect.iscoroutine(result):
                    import asyncio
                    result = asyncio.run(result)
                if inspect.isgenerator(result):
                    yield {"type": "stream"}
                    for chunk in result:
                        yield {"type": "chunk", "data": chunk}
                elif inspect.isasyncgen(result):
                    import asyncio

                    yield {"type": "stream"}
                    loop = asyncio.new_event_loop()
                    try:
                        while True:
                            try:
                                chunk = loop.run_until_complete(
                                    result.__anext__())
                            except StopAsyncIteration:
                                break
                            yield {"type": "chunk", "data": chunk}
                    finally:
                        loop.close()
                else:
                    yield {"type": "single", "data": result}
        except BackpressureError as exc:
            outcome = "shed"
            yield {"type": "shed", "retry_after_s": exc.retry_after_s,
                   "reason": exc.reason}
        except BaseException:
            outcome = "error"
            raise
        finally:
            with self._lock:
                self._ongoing -= 1
                ongoing = self._ongoing
                self._metric_samples.append((time.monotonic(), self._ongoing))
                if len(self._metric_samples) > 1000:
                    self._metric_samples = self._metric_samples[-500:]
            self._report_request_metrics(outcome,
                                         time.perf_counter() - t0,
                                         ongoing)

    # -- router/controller probes --

    def get_queue_len(self) -> int:
        return self._ongoing

    def get_metrics(self, window_s: float = 2.0) -> Dict[str, float]:
        now = time.monotonic()
        with self._lock:
            recent = [v for t, v in self._metric_samples
                      if now - t <= window_s]
            ongoing = self._ongoing
        avg = (sum(recent) / len(recent)) if recent else float(ongoing)
        return {"ongoing": float(ongoing), "avg_ongoing": avg,
                "total": float(self._total)}

    def check_health(self) -> bool:
        checker = getattr(self.callable, "check_health", None)
        if checker is not None:
            checker()
        return True

    def reconfigure(self, user_config: dict) -> None:
        fn = getattr(self.callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    # -- multiplexing (reference: serve/multiplex.py model LRU) --

    def load_multiplexed(self, model_id: str, loader_blob: bytes) -> None:
        with self._lock:
            if model_id in self._multiplexed:
                # LRU touch
                self._multiplexed[model_id] = \
                    self._multiplexed.pop(model_id)
                return
        loader = serialization.loads(loader_blob)
        model = loader(model_id)  # expensive load outside the lock
        with self._lock:
            if len(self._multiplexed) >= self._multiplex_max:
                evict = next(iter(self._multiplexed))
                del self._multiplexed[evict]
            self._multiplexed[model_id] = model

    def get_multiplexed_model_ids(self) -> list:
        return list(self._multiplexed)

    def get_multiplexed_model(self, model_id: str):
        return self._multiplexed.get(model_id)

    def prepare_for_shutdown(self) -> None:
        stopper = getattr(self.callable, "__del__", None)
        _ = stopper
