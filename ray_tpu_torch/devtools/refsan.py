"""refsan: opt-in distributed object-lifetime sanitizer.

The static half of the ownership contract lives in graftlint's
GL014-GL017 (``ray_tpu/devtools/lint/rules/ownership.py``); this module
is the runtime half, in the locktrace/threadguard mold: a cluster-wide
reference *ledger* hooked into every lifetime transition of the object
plane —

* client/worker REF_ADD / REF_DROP sends (``core/worker.py``,
  ``core/client.py``),
* head-side ``ReferenceCounter`` add / drop / grace-reclaim
  (``core/task_manager.py`` + the deleter in ``core/runtime.py``),
* ``_pin_contained`` containment pins,
* ``unpack_pinned`` zero-copy view creation / finalize
  (``core/serialization.py``),
* shm arena slot alloc / pin / release / delete
  (``core/object_store.py``).

Each event is stamped ``(seq, oid, holder, kind, stack_hash, extra)``.
Worker ledgers are flushed to the driver over the same control channel
the flight recorder uses (``gcs_call("refsan_push", ...)``); the driver
folds a per-object state machine over the merged stream and reports:

* **leaked pins** — a store pin still open at shutdown with no live
  zero-copy view backing it (evaluated for the driver's own ledger
  only: a killed worker's truncated journal must not fabricate leaks),
* **double-release** — a slot release with no pin outstanding,
* **negative counts** — a reference drop on a count that is already
  gone,
* **grace violations** — a borrow registration landing *after* the
  owner already reclaimed the object (the Sebulba class:
  release-before-grace with an in-flight borrow),
* **use-after-release** — a live ``unpack_pinned`` view reading a
  poisoned arena range (the early-release class), made deterministic by the
  *eviction canary* below instead of waiting for a flaky aliased read.

**Eviction canary** (``RAY_TPU_REFSAN_CANARY=1``): when a store slot is
deleted while its refsan shadow pin count is zero, the payload range is
poisoned with ``0xDB`` bytes first, and every registered live view is
verified against the poison — a view created by a buggy early-release
path (pin dropped while the value is alive) reads the canary the
moment the slot is freed, not whenever the arena happens to reuse it.

**Hostile eviction** (``system_config={"refsan_hostile_eviction": 1}``
or ``RTPU_REFSAN_HOSTILE_EVICTION=1``): shrinks the owner's borrow
grace window to ~0 so deferred reclaims fire at the earliest legal
moment — tier-1 uses it to force the grace-violation races
deterministically.

Enable with::

    RAY_TPU_REFSAN=1 python my_driver.py
    RAY_TPU_REFSAN=1 RAY_TPU_REFSAN_CANARY=1 pytest ...

With ``RAY_TPU_REFSAN`` unset every hook is two loads and a compare::

    led = refsan.LEDGER
    if led is not None:
        led.record(...)

Like everything in devtools, importing this module must stay cheap:
no jax, no runtime imports.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_ENV_FLAG = "RAY_TPU_REFSAN"
_CANARY_ENV = "RAY_TPU_REFSAN_CANARY"

#: single poison byte; a 16-byte run of it marks a freed arena range.
POISON_BYTE = 0xDB
_POISON_PROBE = bytes([POISON_BYTE]) * 16

# event kinds folded into findings (the rest are narrative)
KIND_REF_ADD = "ref_add"
KIND_REF_DROP = "ref_drop"
KIND_REF_DROP_MISSING = "ref_drop_missing"
KIND_REF_ZERO = "ref_zero"
KIND_REF_DEFER = "ref_defer"
KIND_RECLAIM_SKIP = "reclaim_skip"
KIND_DELETED = "deleted"
KIND_PIN_CONTAINED = "pin_contained"
KIND_BORROW_SEND = "borrow_send"
KIND_SLOT_ALLOC = "slot_alloc"
KIND_SLOT_PIN = "slot_pin"
KIND_SLOT_RELEASE = "slot_release"
KIND_SLOT_DELETE = "slot_delete"
KIND_VIEW_CREATE = "view_create"
KIND_CANARY_HIT = "canary_hit"


def enabled() -> bool:
    return os.environ.get(_ENV_FLAG, "").strip().lower() in (
        "1", "true", "yes", "on")


def canary_enabled() -> bool:
    return os.environ.get(_CANARY_ENV, "").strip().lower() in (
        "1", "true", "yes", "on")


def _stack_hash(depth: int = 5) -> int:
    """Compact fingerprint of the caller's stack: a hash over the
    (filename, lineno) pairs of the next few frames. Cheap enough for
    an opt-in tool; rich enough to attribute a leak to its call site."""
    frames = []
    try:
        f = sys._getframe(2)
    except ValueError:
        return 0
    while f is not None and len(frames) < depth:
        frames.append((f.f_code.co_filename, f.f_lineno))
        f = f.f_back
    return hash(tuple(frames)) & 0xFFFFFFFF


class _ViewRec:
    """A live zero-copy view registered by ``unpack_pinned``."""

    __slots__ = ("oid", "wref", "size", "stack", "holder")

    def __init__(self, oid: str, holder_obj: Any, size: int, stack: int):
        self.oid = oid
        self.wref = weakref.ref(holder_obj)
        self.size = size
        self.stack = stack


_view_ctx = threading.local()


class view_context:
    """Context manager naming the object whose buffers ``unpack_pinned``
    is about to hand out, so view registration can attribute them."""

    def __init__(self, oid_hex: str):
        self._oid = oid_hex

    def __enter__(self):
        self._prev = getattr(_view_ctx, "oid", None)
        _view_ctx.oid = self._oid
        return self

    def __exit__(self, *exc):
        _view_ctx.oid = self._prev
        return False


class Ledger:
    """Per-process reference ledger. ``record`` appends one tuple per
    lifetime transition (list.append is atomic under the GIL); the
    shadow pin table and view registry back the canary checker."""

    def __init__(self, label: str = "", canary: Optional[bool] = None):
        self.label = label or f"pid:{os.getpid()}"
        self.canary = canary_enabled() if canary is None else bool(canary)
        self._events: List[tuple] = []
        self._seq = itertools.count()
        self._lock = threading.Lock()
        # shadow store pins per (store_name, oid_hex): +1 get_buffer,
        # -1 release. Drives the poison-on-delete decision.
        self._pins: Dict[Tuple[str, str], int] = {}
        # last known arena range per (store_name, oid_hex)
        self._ranges: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._views: List[_ViewRec] = []

    # -- event stream ---------------------------------------------------

    def record(self, kind: str, oid_hex: str,
               extra: Optional[dict] = None) -> None:
        # lock-free hot path: list.append is atomic under the GIL and
        # the itertools ticket orders events; readers only slice the
        # append-only list (flight-recorder discipline)
        self._events.append((next(self._seq), oid_hex, self.label, kind,  # graftlint: disable=GL001
                             _stack_hash(), extra))

    def snapshot(self, since: int = 0) -> List[tuple]:
        """Events with index >= ``since`` (the list is append-only)."""
        return self._events[since:]

    def event_count(self) -> int:
        return len(self._events)

    # -- reference-counter hooks (called under the counter's lock) ------

    def ref_event(self, kind: str, oid_bin: bytes, count: int,
                  role: str) -> None:
        self.record(kind, oid_bin.hex(), {"count": count, "role": role})

    # -- store hooks ------------------------------------------------------

    def slot_alloc(self, store: str, oid_bin: bytes, off: int,
                   size: int) -> None:
        oid = oid_bin.hex()
        with self._lock:
            self._ranges[(store, oid)] = (off, size)
        self.record(KIND_SLOT_ALLOC, oid, {"store": store, "size": size})

    def slot_pin(self, store: str, oid_bin: bytes, off: int,
                 size: int) -> None:
        oid = oid_bin.hex()
        with self._lock:
            self._pins[(store, oid)] = self._pins.get((store, oid), 0) + 1
            self._ranges[(store, oid)] = (off, size)
        self.record(KIND_SLOT_PIN, oid, {"store": store})

    def slot_release(self, store: str, oid_bin: bytes) -> None:
        oid = oid_bin.hex()
        with self._lock:
            self._pins[(store, oid)] = self._pins.get((store, oid), 0) - 1
            if self._pins[(store, oid)] <= 0:
                count = self._pins.pop((store, oid))
            else:
                count = self._pins[(store, oid)]
        self.record(KIND_SLOT_RELEASE, oid,
                    {"store": store, "pins": count})

    def on_slot_delete(self, store: str,
                       oid_bin: bytes) -> Optional[Tuple[int, int]]:
        """Record the delete; in canary mode, return the payload range
        to poison when no shadow pin is outstanding (a legitimately
        pinned slot is left untouched — the native store defers its
        free, and poisoning it would corrupt a correct reader)."""
        oid = oid_bin.hex()
        with self._lock:
            pins = self._pins.get((store, oid), 0)
            rng = self._ranges.pop((store, oid), None)
        self.record(KIND_SLOT_DELETE, oid, {"store": store, "pins": pins})
        if self.canary and pins <= 0:
            return rng
        return None

    def pin_count(self, store: str, oid_bin: bytes) -> int:
        with self._lock:
            return self._pins.get((store, oid_bin.hex()), 0)

    # -- view registry / canary ------------------------------------------

    def register_view(self, holder_obj: Any, size: int) -> None:
        """Register a buffer-holder handed out by ``unpack_pinned``.
        The weakref tracks the VALUE's lifetime (arrays keep their
        holder alive through ``.base`` chains), independent of whether
        ``on_release`` was wired correctly — which is the point."""
        oid = getattr(_view_ctx, "oid", None)
        if oid is None:
            return
        try:
            rec = _ViewRec(oid, holder_obj, size, _stack_hash())
        except TypeError:
            return  # holder type not weakref-able; nothing to track
        with self._lock:
            self._views.append(rec)
        self.record(KIND_VIEW_CREATE, oid, {"size": size})

    def live_views(self) -> Dict[str, int]:
        """oid_hex -> number of live registered views (dead weakrefs
        are compacted as a side effect)."""
        out: Dict[str, int] = {}
        with self._lock:
            alive = [r for r in self._views if r.wref() is not None]
            self._views = alive
        for rec in alive:
            out[rec.oid] = out.get(rec.oid, 0) + 1
        return out

    def verify_views(self) -> int:
        """Check every live view against the poison pattern; a hit
        means its arena range was freed under it (use-after-release).
        Each hit is recorded once. Returns the number of new hits."""
        with self._lock:
            views = list(self._views)
        hits = 0
        dead: List[_ViewRec] = []
        for rec in views:
            holder = rec.wref()
            if holder is None:
                continue
            try:
                probe = bytes(memoryview(holder)[:len(_POISON_PROBE)])
            except (ValueError, TypeError, SystemError):
                continue  # buffer no longer exportable; nothing to read
            if probe == _POISON_PROBE:
                self.record(KIND_CANARY_HIT, rec.oid,
                            {"view_stack": rec.stack, "size": rec.size})
                dead.append(rec)
                hits += 1
        if dead:
            with self._lock:
                self._views = [r for r in self._views if r not in dead]
        return hits


# The module-level gate. Hot paths read this once and None-check it;
# rebinding is atomic under the GIL so enable/disable race nothing.
LEDGER: Optional[Ledger] = None


def enable(label: str = "", canary: Optional[bool] = None) -> Ledger:
    global LEDGER
    LEDGER = Ledger(label=label, canary=canary)
    return LEDGER


def disable() -> None:
    global LEDGER
    LEDGER = None


# --- driver-side collector ----------------------------------------------

class _RefsanStore:
    """Driver-held worker ledgers pushed over ``refsan_push``."""

    def __init__(self):
        self.lock = threading.Lock()
        self._procs: Dict[str, List[tuple]] = {}

    def push(self, label: str, events: List[tuple]) -> None:
        # Brief and lock-only: runs in the GCS dispatch path, which may
        # be the head's IO-loop thread.
        with self.lock:
            bucket = self._procs.setdefault(label, [])
            last = bucket[-1][0] if bucket else -1
            for ev in events:
                if ev[0] > last:
                    bucket.append(tuple(ev))
                    last = ev[0]

    def journals(self) -> Dict[str, List[tuple]]:
        with self.lock:
            return {label: list(evs)
                    for label, evs in sorted(self._procs.items())}


_STORE: Optional[_RefsanStore] = None
_final_findings: Optional[List[dict]] = None


def get_store() -> _RefsanStore:
    global _STORE
    if _STORE is None:
        _STORE = _RefsanStore()
    return _STORE


def store_push(label: str, events: List[tuple]) -> None:
    get_store().push(label, events)


def merged_events() -> List[tuple]:
    """Every collected worker event plus the local ledger's, in a
    per-holder seq-consistent order."""
    out: List[tuple] = []
    store = _STORE
    if store is not None:
        for events in store.journals().values():
            out.extend(events)
    led = LEDGER
    if led is not None:
        out.extend(led.snapshot())
    return out


# --- process wiring ------------------------------------------------------

def init_driver() -> None:
    """Reset collector state and (when ``RAY_TPU_REFSAN`` is set)
    enable the driver's ledger. Called from ``Runtime.__init__``; the
    env flag itself rides into forked workers untouched."""
    global _STORE, _final_findings
    _STORE = _RefsanStore()
    _final_findings = None
    stop_flusher()
    if enabled():
        enable(label=f"driver:{os.getpid()}")
    else:
        disable()


def init_worker(rt, worker_id) -> None:
    """Enable the ledger and start the push flusher in a worker process
    (no-op unless the driver session runs with ``RAY_TPU_REFSAN``)."""
    if not enabled():
        return
    led = enable(label=f"worker:{worker_id.hex()[:12]}:pid:{os.getpid()}")
    start_flusher(rt, led)


class _Flusher(threading.Thread):
    """Worker-side daemon: periodically push the ledger increment to
    the driver over the control channel (same route as flight_push;
    replies are delivered by the worker's main recv loop)."""

    def __init__(self, rt, ledger: Ledger, interval_s: float = 0.25):
        super().__init__(name="refsan-flush", daemon=True)
        self._rt = rt
        self._ledger = ledger
        self._interval = max(0.02, float(interval_s))
        self._sent = 0
        self._stop = threading.Event()

    def flush_once(self) -> None:
        events = self._ledger.snapshot(since=self._sent)
        if not events:
            return
        self._rt.gcs_call("refsan_push", self._ledger.label, events)
        self._sent += len(events)

    def run(self) -> None:
        from ray_tpu_torch.util.backoff import Backoff

        # Failed pushes back off with jitter (util/backoff.py) instead
        # of re-hammering a struggling control channel every interval.
        backoff = Backoff(initial_s=self._interval,
                          max_s=8 * self._interval)
        failures = 0
        delay = self._interval
        while not self._stop.wait(delay):
            try:
                self.flush_once()
                failures = 0
                backoff.reset()
                delay = self._interval
            except Exception:  # noqa: BLE001 — channel gone at shutdown
                failures += 1
                if failures >= 3:
                    return
                delay = backoff.next_delay()

    def stop(self) -> None:
        self._stop.set()
        try:
            self.flush_once()  # final increment, best effort
        except Exception:  # graftlint: disable=GL004
            pass  # shutdown race: the control channel may be gone


_flusher: Optional[_Flusher] = None


def start_flusher(rt, ledger: Ledger) -> None:
    global _flusher
    _flusher = _Flusher(rt, ledger)
    _flusher.start()


def stop_flusher() -> None:
    global _flusher
    if _flusher is not None:
        _flusher.stop()
        _flusher = None


# --- the fold -------------------------------------------------------------

def fold(events: List[tuple],
         live_views: Optional[Dict[str, int]] = None,
         local_label: Optional[str] = None) -> List[dict]:
    """Fold the merged event stream into findings. Each finding is a
    dict: ``{"kind", "oid", "holder", "detail"}``.

    ``live_views`` (oid -> live view count, from the local ledger) and
    ``local_label`` scope the leak check to the process we can actually
    observe — a worker killed mid-test truncates its journal, and a
    truncated journal must not read as a leak."""
    findings: List[dict] = []
    # per-holder event streams stay seq-ordered; sort per holder
    by_holder: Dict[str, List[tuple]] = {}
    for ev in events:
        by_holder.setdefault(ev[2], []).append(ev)
    for holder, evs in by_holder.items():
        evs.sort(key=lambda e: e[0])
        deleted_at: Dict[str, int] = {}
        pins: Dict[Tuple[str, str], int] = {}
        added: set = set()
        for seq, oid, _h, kind, _stack, extra in evs:
            if kind == KIND_REF_ADD:
                added.add(oid)
            if kind == KIND_REF_DROP_MISSING:
                # only a double-drop: a drop on an oid this holder never
                # registered is a cross-epoch artifact (an ObjectRef
                # surviving a runtime restart __del__s into the fresh
                # counter), not a count gone negative
                if oid in added:
                    findings.append({
                        "kind": "negative_count", "oid": oid,
                        "holder": holder,
                        "detail": "reference dropped below zero (second "
                                  "drop on a count already at zero)"})
            elif kind == KIND_DELETED:
                deleted_at[oid] = seq
            elif kind == KIND_REF_ADD:
                role = (extra or {}).get("role")
                if role == "owner" and oid in deleted_at:
                    findings.append({
                        "kind": "grace_violation", "oid": oid,
                        "holder": holder,
                        "detail": "borrow registered after the owner "
                                  "reclaimed the object (release-before-"
                                  "grace with an in-flight borrow)"})
                    del deleted_at[oid]  # report once per reclaim
            elif kind == KIND_SLOT_PIN:
                store = (extra or {}).get("store", "")
                pins[(store, oid)] = pins.get((store, oid), 0) + 1
            elif kind == KIND_SLOT_RELEASE:
                store = (extra or {}).get("store", "")
                n = pins.get((store, oid), 0)
                if n <= 0:
                    findings.append({
                        "kind": "double_release", "oid": oid,
                        "holder": holder,
                        "detail": f"store pin released with none "
                                  f"outstanding (store={store})"})
                else:
                    pins[(store, oid)] = n - 1
            elif kind == KIND_CANARY_HIT:
                findings.append({
                    "kind": "use_after_release", "oid": oid,
                    "holder": holder,
                    "detail": "live zero-copy view read the eviction "
                              "canary: its arena range was freed while "
                              "the deserialized value was still alive"})
        # leaked pins: only judged for the local (driver) holder, whose
        # live-view registry we can consult.
        if local_label is not None and holder == local_label:
            views = dict(live_views or {})
            for (store, oid), n in pins.items():
                if n <= 0:
                    continue
                backing = views.get(oid, 0)
                if n > backing:
                    findings.append({
                        "kind": "leaked_pin", "oid": oid,
                        "holder": holder,
                        "detail": f"{n} store pin(s) still open with "
                                  f"{backing} live view(s) backing them "
                                  f"(store={store})"})
    return findings


def report() -> List[dict]:
    """Fold the merged journals into findings (plus anything a
    shutdown-time fold already caught). Empty when refsan is off."""
    led = LEDGER
    if led is None and _STORE is None:
        return list(_final_findings or [])
    if led is not None:
        led.verify_views()
    findings = fold(
        merged_events(),
        live_views=led.live_views() if led is not None else None,
        local_label=led.label if led is not None else None)
    if _final_findings:
        seen = {(f["kind"], f["oid"], f["holder"]) for f in findings}
        findings.extend(f for f in _final_findings
                        if (f["kind"], f["oid"], f["holder"]) not in seen)
    return findings


def on_shutdown() -> None:
    """Runtime shutdown hook: fold once while worker journals and the
    store state are still current, and keep the result for late
    ``report()`` calls (the ledger itself is torn down with the
    session)."""
    global _final_findings
    stop_flusher()
    if LEDGER is None:
        return
    findings = report()
    _final_findings = findings
    # the session's ledger goes with it: a ledger left on would record
    # the next session's (or no session's) references under this one
    disable()
    for f in findings:
        logger.warning("refsan: %s oid=%s holder=%s: %s",
                       f["kind"], f["oid"][:12], f["holder"], f["detail"])


def format_findings(findings: List[dict]) -> str:
    return "\n".join(
        f"refsan: {f['kind']} oid={f['oid'][:12]} holder={f['holder']}: "
        f"{f['detail']}" for f in findings)
