"""Fragment replay: the Sebulba actor→learner hand-off queue (port of
ray_tpu/rl/podracer/replay.py).

Backpressure is drop-oldest: a bounded deque where a push over
capacity evicts the stalest fragment (off-policy data ages badly — the
freshest fragment is always worth more than the one the learner never
got to). ``dropped`` counts evictions so the caller can see a learner
that can't keep up. Depth is therefore bounded by construction.

Trajectory fragments do not move through the queue: env-runner actors
``ray_tpu_torch.put`` each fragment and push only ``(meta, [ref])``, so
the queue holds object references plus a few floats of metadata however
fat the fragments are; the learner pops the references and ``get``s
them from the object store.

``FragmentReplay`` is a plain thread-safe class, which the devtools
``check`` smoke and the tests exercise in-process; ``ReplayActor`` is
the thin remote wrapper the Sebulba pipeline deploys on the port's
runtime (a named actor, looked up by learner and actors alike).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 64


class FragmentReplay:
    """Bounded drop-oldest fragment queue. Thread-safe; non-blocking
    pops (the learner polls and records the wait rather than parking a
    thread)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._pushed = 0
        self._dropped = 0
        self._popped = 0

    def push(self, item: Any) -> bool:
        """Enqueue; evicts the oldest item when full. Returns True when
        the push evicted something (the producer-side overrun signal)."""
        with self._lock:
            self._pushed += 1
            dropped = len(self._items) >= self.capacity
            if dropped:
                self._items.popleft()
                self._dropped += 1
            self._items.append(item)
            return dropped

    def pop_many(self, max_items: int = 1) -> List[Any]:
        """Up to ``max_items`` fragments, oldest first; empty list when
        the queue is dry (caller decides how to wait)."""
        out: List[Any] = []
        with self._lock:
            while self._items and len(out) < max_items:
                out.append(self._items.popleft())
                self._popped += 1
        return out

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"depth": len(self._items), "capacity": self.capacity,
                    "pushed": self._pushed, "dropped": self._dropped,
                    "popped": self._popped}


class ReplayActor:
    """Remote wrapper; deployed as a named actor so every Sebulba
    participant can look it up without shipping handles around."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._replay = FragmentReplay(capacity)

    def push(self, item: Any) -> bool:
        return self._replay.push(item)

    def pop_many(self, max_items: int = 1) -> List[Any]:
        return self._replay.pop_many(max_items)

    def depth(self) -> int:
        return self._replay.depth()

    def stats(self) -> Dict[str, int]:
        return self._replay.stats()

    def ping(self) -> bool:
        return True


def create_replay_actor(capacity: int = DEFAULT_CAPACITY,
                        name: Optional[str] = None, wait: bool = True):
    """Spawn the (optionally named) replay actor and, with ``wait``,
    wait until it is live (a name resolves from the moment the actor is
    submitted). The queue holds refs and metadata only, so it asks for
    no CPU share (as serve replicas do): a 1-CPU node still schedules
    the whole Sebulba constellation."""
    import ray_tpu_torch
    opts: dict = {"num_cpus": 0}
    if name:
        opts["name"] = name
    handle = ray_tpu_torch.remote(ReplayActor).options(**opts).remote(
        capacity)
    if wait:
        ray_tpu_torch.get(handle.ping.remote())
    return handle
