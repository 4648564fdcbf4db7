"""@serve.multiplexed — per-replica LRU of loaded models
(port of ray_tpu/serve/multiplex.py).

Capability parity with the reference's model multiplexing (reference:
python/ray/serve/multiplex.py _ModelMultiplexWrapper — a replica holds up
to max_num_models_per_replica loaded models; requests carry a model id;
the loader runs on miss and the least-recently-used model is evicted).
"""

from __future__ import annotations

import collections
import functools
import threading

from typing import Any, Callable, Optional

_current_model_id = threading.local()


def get_multiplexed_model_id() -> str:
    """Inside a multiplexed request: the model id being served
    (reference: serve.get_multiplexed_model_id)."""
    return getattr(_current_model_id, "value", "")


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator over ``async/sync def load_model(self, model_id)``; the
    wrapped callable becomes ``loader(model_id) -> model`` with LRU
    caching per replica."""

    def make(load_fn):
        @functools.wraps(load_fn)
        def wrapper(*args):
            from ray_tpu_torch.serve import multiplex as _m
            if len(args) == 2:
                owner, model_id = args
                key = (id(wrapper), id(owner))
                call = lambda mid: load_fn(owner, mid)  # noqa: E731
            else:
                (model_id,) = args
                key, call = (id(wrapper), None), load_fn
            return _m._lookup(key, call, model_id,
                              max_num_models_per_replica)

        return wrapper

    if _fn is not None:
        return make(_fn)
    return make


# Cache state lives outside wrapper closures, reached via in-body import,
# so decorated classes stay picklable (see ray_tpu_torch/serve/batching.py).
_state_lock = threading.Lock()
_caches: dict = {}


def _lookup(key, call, model_id, max_models):
    with _state_lock:
        cache = _caches.setdefault(key, collections.OrderedDict())
        if model_id in cache:
            cache.move_to_end(model_id)
            _current_model_id.value = model_id
            return cache[model_id]
    model = call(model_id)
    evicted = []
    with _state_lock:
        existing = cache.get(model_id)
        if existing is not None:
            # Concurrent miss: another thread loaded first — its model
            # is canonical; release ours instead of silently replacing
            # (the loser would leak its engine + stepper thread).
            evicted.append(model)
            model = existing
            cache.move_to_end(model_id)
        else:
            cache[model_id] = model
            cache.move_to_end(model_id)
            while len(cache) > max_models:
                evicted.append(cache.popitem(last=False)[1])
    # Release evicted models' resources outside the lock (an LLM model
    # holds an engine + stepper thread; reference: serve multiplex
    # calls the model's __del__ on eviction).
    for old in evicted:
        stop = getattr(old, "stop", None)
        if callable(stop):
            try:
                stop()
            except Exception:
                pass  # eviction is best-effort; model is unreferenced
    _current_model_id.value = model_id
    return model
