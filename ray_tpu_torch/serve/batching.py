"""@serve.batch — dynamic request batching inside a replica
(port of ray_tpu/serve/batching.py).

Capability parity with the reference's batching (reference:
python/ray/serve/batching.py @serve.batch — requests accumulate up to
max_batch_size or batch_wait_timeout_s, the wrapped function runs once
on the list, results fan back out). Replicas execute requests on a
thread pool (actor max_concurrency), so the queue is thread-based
rather than asyncio-based; on TPU replicas this is what turns N
concurrent HTTP requests into one batched forward pass on the MXU.
"""

from __future__ import annotations

import functools
import queue
import threading

from typing import Any, Callable, List, Optional

from ray_tpu_torch.util.metrics import Histogram

# How full batches actually run (reference: serve batching metrics).
# On TPU replicas this is the realized MXU batch width — the first
# thing to check when throughput is below the roofline.
BATCH_SIZE = Histogram(
    "ray_tpu_serve_batch_size",
    "Realized @serve.batch batch sizes", tag_keys=("fn",),
    boundaries=[1, 2, 4, 8, 16, 32, 64, 128])
BATCH_WAIT = Histogram(
    "ray_tpu_serve_batch_wait_seconds",
    "Time one batch spent accumulating before execution",
    tag_keys=("fn",),
    boundaries=[0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0])


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Batcher:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, batch_wait_timeout_s: float,
                 name: str = "batch"):
        self.fn = fn
        self.name = name
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self.queue: "queue.Queue[_Pending]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def _loop(self) -> None:
        import time
        while True:
            batch = [self.queue.get()]
            t0 = time.perf_counter()
            # Give the batch a window to fill (the MXU wants width).
            while len(batch) < self.max_batch_size:
                try:
                    batch.append(self.queue.get(timeout=self.timeout_s))
                except queue.Empty:
                    break
            BATCH_SIZE.observe(float(len(batch)), tags={"fn": self.name})
            BATCH_WAIT.observe(time.perf_counter() - t0,
                               tags={"fn": self.name})
            try:
                results = self.fn([p.item for p in batch])
                if results is None or len(results) != len(batch):
                    raise ValueError(
                        "@serve.batch function must return one result per "
                        f"input (got {results!r} for {len(batch)} inputs)")
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as e:  # propagate to every waiter
                for p in batch:
                    p.error = e
            for p in batch:
                p.event.set()

    def submit(self, item: Any) -> Any:
        self._ensure_thread()
        pending = _Pending(item)
        self.queue.put(pending)
        pending.event.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result


# Batcher state lives OUTSIDE the wrapper closure (keyed by the wrapper
# function object) so decorated classes stay picklable: a closure-held
# Lock/_Batcher would break cloudpickle when the deployment ships to a
# replica. The wrapper reaches this state through an in-body import —
# a direct global reference would get pickled by value along with the
# wrapper (whose __module__ is the user's, via functools.wraps).
_state_lock = threading.Lock()
_batchers: dict = {}  # (wrapper key, owner key) -> _Batcher


def _submit(key, call, item, max_batch_size, batch_wait_timeout_s,
            name="batch"):
    with _state_lock:
        b = _batchers.get(key)
        if b is None:
            b = _Batcher(call, max_batch_size, batch_wait_timeout_s,
                         name=name)
            _batchers[key] = b
    return b.submit(item)


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: ``fn(self, items: list) -> list`` is called with up to
    max_batch_size accumulated single-call payloads."""

    def make(fn):
        @functools.wraps(fn)
        def wrapper(*args):
            from ray_tpu_torch.serve import batching as _b
            if len(args) == 2:  # bound method: (self, item)
                owner, item = args
                key = (id(wrapper), id(owner))
                call = lambda items: fn(owner, items)  # noqa: E731
            elif len(args) == 1:  # plain function: (item,)
                (item,) = args
                key = (id(wrapper), None)
                call = fn
            else:
                raise TypeError(
                    "@serve.batch functions take exactly one request "
                    "argument")
            return _b._submit(key, call, item, max_batch_size,
                              batch_wait_timeout_s,
                              name=getattr(fn, "__qualname__", "batch"))

        return wrapper

    if _fn is not None:
        return make(_fn)
    return make
