"""Flight recorder: a per-process ring-buffer event journal with no lock
on its record path (port of ray_tpu/util/flight_recorder.py).

The copy keeps the recorder itself: a fixed-capacity list of slots
claimed by an ``itertools.count`` ticket (``next()`` on a count is one
C call, atomic under the GIL) and written with one tuple store. When
the recorder is disabled a hot path pays two loads and a compare::

    rec = flight_recorder.RECORDER
    if rec is not None:
        rec.record("serve", "engine_step", t0_ns, dur_ns, args)

The driver-side collector, the worker flusher and the trace export run
on the port's runtime (``ray_tpu_torch.core``), as the reference's do on
its own: ``init_driver`` / ``init_worker`` wire them when the runtime's
``flight_recorder_enabled`` is set.

Event slot layout (plain tuple; one allocation per record)::

    (seq, t0_ns, dur_ns, category, name, args_or_None)
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_CAPACITY = 4096
# per-process events the driver-side collector keeps
STORE_CAPACITY = 16384
# journal lines kept by ``tail``
TAIL_EVENTS = 40


def clock_ns() -> int:
    """This process's journal clock: monotonic, arbitrary epoch."""
    return time.perf_counter_ns()


class Recorder:
    """Bounded journal with no lock. Writers from any thread; a snapshot
    may see a slot overwritten mid-wrap (the journal is best-effort
    observability, never a consistency anchor)."""

    __slots__ = ("capacity", "label", "_slots", "_seq")

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 label: str = ""):
        self.capacity = max(16, int(capacity))
        self.label = label or f"pid:{os.getpid()}"
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._seq = itertools.count()

    def record(self, cat: str, name: str, t0_ns: int, dur_ns: int,
               args: Optional[dict] = None) -> None:
        seq = next(self._seq)
        self._slots[seq % self.capacity] = (
            seq, t0_ns, dur_ns, cat, name, args)

    def instant(self, cat: str, name: str,
                args: Optional[dict] = None) -> None:
        self.record(cat, name, clock_ns(), 0, args)

    def clock(self) -> int:
        return clock_ns()

    def snapshot(self, since_seq: int = -1) -> List[tuple]:
        """Events with seq > since_seq, oldest first."""
        slots = list(self._slots)
        events = [s for s in slots if s is not None and s[0] > since_seq]
        events.sort()
        return events

    def tail(self, n: int = TAIL_EVENTS) -> List[tuple]:
        return self.snapshot()[-n:]


# The module-level gate. Hot paths read it once and None-check it;
# rebinding is atomic under the GIL.
RECORDER: Optional[Recorder] = None


def enabled() -> bool:
    return RECORDER is not None


def enable(label: str = "",
           capacity: int = DEFAULT_CAPACITY) -> Recorder:
    """Start a fresh journal (the reference reads its capacity from the
    runtime's config; here it is an argument)."""
    global RECORDER
    RECORDER = Recorder(capacity=capacity, label=label)
    _get_anchor()  # pin the wall/perf anchor while both clocks are live
    return RECORDER


def disable() -> None:
    global RECORDER
    RECORDER = None


def record(cat: str, name: str, t0_ns: int, dur_ns: int,
           args: Optional[dict] = None) -> None:
    """Gate for cold paths; hot loops inline the ``RECORDER`` check."""
    rec = RECORDER
    if rec is not None:
        rec.record(cat, name, t0_ns, dur_ns, args)


def instant(cat: str, name: str, args: Optional[dict] = None) -> None:
    rec = RECORDER
    if rec is not None:
        rec.record(cat, name, clock_ns(), 0, args)


# --- wall-clock anchoring -----------------------------------------------
# perf_counter_ns has an arbitrary per-process epoch. The driver pins
# one (wall, perf) pair; every aligned journal timestamp is rendered as
# wall_anchor + (t_ns - perf_anchor), putting flight events on the same
# wall-clock microsecond scale the task-event timeline already uses.

_anchor: Optional[Tuple[float, int]] = None


def _get_anchor() -> Tuple[float, int]:
    global _anchor
    if _anchor is None:
        _anchor = (time.time(), clock_ns())
    return _anchor


# --- driver-side collector ----------------------------------------------

class FlightStore:
    """Driver-held journals pushed by worker flushers. Bounded per
    process; survives the process that pushed it — the post-mortem
    source for actor deaths."""

    def __init__(self):
        self.lock = threading.Lock()
        self._procs: Dict[str, dict] = {}

    def push(self, label: str, events: List[tuple],
             offset_ns: int) -> None:
        # Brief and lock-only: this runs in the GCS dispatch path,
        # which may be the head's IO-loop thread.
        with self.lock:
            entry = self._procs.get(label)
            if entry is None:
                entry = {"events": deque(maxlen=STORE_CAPACITY),
                         "offset": 0, "last_seq": -1}
                self._procs[label] = entry
            entry["offset"] = int(offset_ns)
            for ev in events:
                if ev[0] > entry["last_seq"]:
                    entry["events"].append(tuple(ev))
                    entry["last_seq"] = ev[0]

    def journals(self) -> List[Tuple[str, int, List[tuple]]]:
        """(label, offset_ns, events) per pushed process."""
        with self.lock:
            return [(label, entry["offset"], list(entry["events"]))
                    for label, entry in sorted(self._procs.items())]

    def tail(self, label_substr: str,
             n: int = TAIL_EVENTS) -> Optional[List[str]]:
        """Formatted last-n events of the journal whose label contains
        ``label_substr`` — the supervisor's post-mortem lookup."""
        with self.lock:
            for label, entry in self._procs.items():
                if label_substr in label:
                    events = list(entry["events"])[-n:]
                    break
            else:
                return None
        return format_events(events)


_STORE: Optional[FlightStore] = None


def get_store() -> FlightStore:
    global _STORE
    if _STORE is None:
        _STORE = FlightStore()
    return _STORE


def store_push(label: str, events: List[tuple], offset_ns: int) -> None:
    get_store().push(label, events, offset_ns)


# --- process wiring ------------------------------------------------------

# The variables ``init_driver`` sets or pops, so that workers forked
# later inherit the session's configuration.
_ENV_FLAGS = ("RTPU_FLIGHT_RECORDER_ENABLED", "RTPU_FLIGHT_RECORDER_CAPACITY",
              "RTPU_FLIGHT_FLUSH_INTERVAL_S")
# Their values before the session's ``init_driver`` (None: unset), put
# back by ``shutdown_driver``; None outside a session.
_saved_env: Optional[Dict[str, Optional[str]]] = None


def init_driver() -> None:
    """Reset collector state and (when configured) enable the driver's
    own recorder. Called from Runtime.__init__; env flags are mirrored
    so workers forked later inherit the same configuration, and
    ``shutdown_driver`` puts them back as they were."""
    global _STORE, _anchor, _saved_env
    from ray_tpu_torch.core.config import get_config
    cfg = get_config()
    _STORE = FlightStore()
    _anchor = None
    stop_flusher()
    if _saved_env is None:
        _saved_env = {k: os.environ.get(k) for k in _ENV_FLAGS}
    if cfg.flight_recorder_enabled:
        os.environ["RTPU_FLIGHT_RECORDER_ENABLED"] = "1"
        os.environ["RTPU_FLIGHT_RECORDER_CAPACITY"] = str(
            cfg.flight_recorder_capacity)
        os.environ["RTPU_FLIGHT_FLUSH_INTERVAL_S"] = str(
            cfg.flight_flush_interval_s)
        enable(label=f"driver:{os.getpid()}",
               capacity=cfg.flight_recorder_capacity)
    else:
        os.environ.pop("RTPU_FLIGHT_RECORDER_ENABLED", None)
        disable()


def shutdown_driver() -> None:
    """Runtime shutdown: stop the flusher, disable the recorder and put
    the ``RTPU_FLIGHT_*`` variables back as they were before
    ``init_driver``. The collected journals stay readable
    (``merged_journals``) until the next session's ``init_driver``."""
    global _saved_env
    stop_flusher()
    disable()
    if _saved_env is not None:
        for key, value in _saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        _saved_env = None


def init_worker(rt, worker_id) -> None:
    """Enable the recorder and start the flusher thread in a worker
    process (no-op unless the driver enabled recording — the flag rides
    the inherited environment)."""
    from ray_tpu_torch.core.config import get_config
    cfg = get_config()
    if not cfg.flight_recorder_enabled:
        return
    label = f"worker:{worker_id.hex()[:12]}:pid:{os.getpid()}"
    rec = enable(label=label, capacity=cfg.flight_recorder_capacity)
    start_flusher(rt, rec, interval_s=cfg.flight_flush_interval_s)


class _Flusher(threading.Thread):
    """Worker-side daemon: every interval, ping-pong the driver clock
    then push the journal increment. Runs gcs_call from a non-main
    thread — safe: replies are delivered by the worker's main recv
    loop (the same channel metrics forwarding uses)."""

    def __init__(self, rt, recorder: Recorder, interval_s: float):
        super().__init__(name="flight-flush", daemon=True)
        self._rt = rt
        self._recorder = recorder
        self._interval = max(0.02, float(interval_s))
        self._last_seq = -1
        self._stop = threading.Event()

    def flush_once(self) -> None:
        t0 = clock_ns()
        t_driver = self._rt.gcs_call("flight_sync")
        t1 = clock_ns()
        # driver_clock ≈ worker_clock + offset, assuming the symmetric-
        # delay midpoint is when the driver sampled its clock.
        offset = int(t_driver) - (t0 + t1) // 2
        events = self._recorder.snapshot(since_seq=self._last_seq)
        if events:
            self._last_seq = events[-1][0]
        self._rt.gcs_call("flight_push", self._recorder.label, events,
                          offset)

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
            except Exception:  # noqa: BLE001 — slow env setup, or the
                failures += 1  # channel is gone at shutdown
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


def start_flusher(rt, recorder: Recorder, interval_s: float) -> None:
    global _flusher
    _flusher = _Flusher(rt, recorder, interval_s)
    _flusher.start()


def stop_flusher() -> None:
    global _flusher
    if _flusher is not None:
        _flusher.stop()
        _flusher = None


def flush_now() -> None:
    """Push the local journal increment immediately (worker-side; used
    right before surfacing an error so the driver's copy is current)."""
    if _flusher is not None:
        try:
            _flusher.flush_once()
        except Exception:  # graftlint: disable=GL004
            pass  # observability must never mask the original error


# --- merge + export ------------------------------------------------------

def merged_journals() -> Dict[str, List[tuple]]:
    """label -> clock-aligned events (driver perf_counter_ns domain),
    including the driver's own journal at offset 0."""
    out: Dict[str, List[tuple]] = {}
    store = _STORE
    if store is not None:
        for label, offset, events in store.journals():
            out[label] = [(seq, t0 + offset, dur, cat, name, args)
                          for seq, t0, dur, cat, name, args in events]
    rec = RECORDER
    if rec is not None:
        out[rec.label] = rec.snapshot()
    return out


def _role_for_label(label: str) -> str:
    """Human track name for a journal label: ``driver:4242`` → driver,
    ``worker:ab12cd34ef56:pid:77`` → worker-ab12cd34."""
    if label.startswith("driver"):
        return "driver"
    if label.startswith("worker:"):
        return "worker-" + label.split(":")[1][:8]
    return label.split(":")[0] or label


def chrome_events() -> List[Dict[str, Any]]:
    """Merged journals as Chrome-trace/Perfetto events: one ``pid``
    track per process, one ``tid`` row per category, complete ``X``
    slices for spans and ``i`` instants for point events. Each track
    leads with ``process_name``/``thread_name`` metadata (``ph: M``) so
    Perfetto labels rows by role (driver / worker-N / io-loop) instead
    of bare journal labels."""
    wall_anchor, perf_anchor = _get_anchor()
    out: List[Dict[str, Any]] = []
    for label, events in merged_journals().items():
        pid = f"flight:{label}"
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0,
                    "args": {"name": _role_for_label(label),
                             "label": label}})
        for cat in sorted({ev[3] for ev in events}):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": cat, "args": {"name": cat}})
        for seq, t0, dur, cat, name, args in events:
            ts_us = (wall_anchor + (t0 - perf_anchor) / 1e9) * 1e6
            ev: Dict[str, Any] = {
                "name": name, "cat": f"flight:{cat}", "ts": ts_us,
                "pid": pid, "tid": cat,
                "args": dict(args) if args else {"seq": seq},
            }
            if dur > 0:
                ev["ph"] = "X"
                ev["dur"] = dur / 1e3
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            out.append(ev)
    return out


def dump_journals(filename: Optional[str] = None) -> Dict[str, Any]:
    """Write the merged (clock-aligned) journals as JSON for offline
    analysis."""
    import json
    payload = {
        "anchor": list(_get_anchor()),
        "journals": {label: [list(ev) for ev in events]
                     for label, events in merged_journals().items()},
    }
    if filename:
        with open(filename, "w") as f:
            json.dump(payload, f)
    return payload


# --- post-mortem ---------------------------------------------------------

def format_events(events: List[tuple]) -> List[str]:
    """Human lines for an error report, newest last, timestamps
    relative to the newest event."""
    if not events:
        return []
    t_end = max(ev[1] + ev[2] for ev in events)
    lines = []
    for seq, t0, dur, cat, name, args in events:
        rel_ms = (t0 - t_end) / 1e6
        line = f"[{rel_ms:+10.3f}ms] {cat}:{name}"
        if dur > 0:
            line += f" dur={dur / 1e6:.3f}ms"
        if args:
            line += f" {args}"
        lines.append(line)
    return lines


def local_tail(n: int = TAIL_EVENTS) -> Optional[List[str]]:
    """Formatted tail of THIS process's journal, or None when the
    recorder is off. Attached to exceptions at raise time (the tuple
    rides the pickled exception's __dict__ back to the driver)."""
    rec = RECORDER
    if rec is None:
        return None
    return format_events(rec.tail(n))


def attach_tail(exc: BaseException, n: int = TAIL_EVENTS) -> None:
    """Stamp the local journal tail onto ``exc`` (picklable: plain
    strings in __dict__) and push the increment to the driver so the
    supervisor's copy includes the final moments."""
    tail = local_tail(n)
    if tail is not None:
        exc._flight_tail = tail  # type: ignore[attr-defined]
    flush_now()


def tail_text(exc_or_lines, limit: int = TAIL_EVENTS) -> str:
    """Render a journal tail (from an exception's ``_flight_tail`` or a
    raw line list) as an indented block for error messages. Empty
    string when there is nothing to show."""
    lines = (getattr(exc_or_lines, "_flight_tail", None)
             if isinstance(exc_or_lines, BaseException) else exc_or_lines)
    if not lines:
        return ""
    lines = lines[-limit:]
    return ("\n  flight recorder (last %d events):\n    " % len(lines)
            + "\n    ".join(lines))


def store_tail_text(label_substr: str, n: int = TAIL_EVENTS) -> str:
    """Post-mortem text from the driver-side collector for a process
    that died (matched by label substring, e.g. a worker id prefix)."""
    store = _STORE
    if store is None:
        return ""
    lines = store.tail(label_substr, n)
    return tail_text(lines) if lines else ""
