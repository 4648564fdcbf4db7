"""Trace context, named spans and profile spans (port of
ray_tpu/util/tracing.py).

A W3C-traceparent-shaped (``trace_id``, ``span_id``) pair lives in a
context variable. Every ``.remote()`` stamps the active context into
its task spec, and a worker re-establishes it before user code runs, so
one ``trace_id`` follows a request across the Serve proxy, router,
replica and engine. ``span()`` opens a child of the active context (or
a fresh root) for the duration of a with-block and, when it ends,
ships the span to the runtime's trace store in the GCS
(``gcs.spans_for_trace``): a direct append on the driver, one
control-plane call on a worker, nothing without a runtime. The proxy
parses and echoes ``traceparent`` headers (``parse_traceparent``,
``format_traceparent``). ``profile(name)`` records a span on the
running task's timeline track.
"""

from __future__ import annotations

import time
import uuid
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class TraceContext:
    """One hop of a distributed trace: ``trace_id`` names the whole
    request tree, ``span_id`` the current operation within it."""
    trace_id: str
    span_id: str

    def traceparent(self) -> str:
        return format_traceparent(self)


_trace_var: ContextVar[Optional[TraceContext]] = ContextVar(
    "ray_tpu_torch_trace_context", default=None)


def new_trace_id() -> str:
    """32 lowercase hex chars (W3C traceparent trace-id width)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """16 lowercase hex chars (W3C traceparent parent-id width)."""
    return uuid.uuid4().hex[:16]


def task_span_id(task_id) -> str:
    """A task's execution is a span; its span id derives from the task
    id, so task events and recorded spans correlate."""
    return task_id.hex()[:16]


def get_trace_context() -> Optional[TraceContext]:
    return _trace_var.get()


def set_trace_context(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the current trace context; returns the token
    for ``reset_trace_context``. The runtime's workers call it around
    each task, so spans and nested ``.remote()`` calls join the
    submitter's trace."""
    return _trace_var.set(ctx)


def reset_trace_context(token) -> None:
    _trace_var.reset(token)


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Parse a W3C ``traceparent`` header (``00-<trace>-<span>-<flags>``).
    Returns None on absent or malformed input: a bad client header
    degrades to a fresh root trace, never a 500."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _version, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None  # all-zero ids are invalid per the spec
    return TraceContext(trace_id.lower(), span_id.lower())


def format_traceparent(ctx: TraceContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


_UNSET = object()


def record_span(name: str, component: str, t_start: float,
                duration: float, ctx: TraceContext,
                parent_span_id: Optional[str] = None,
                tags: Optional[Dict[str, Any]] = None) -> None:
    """Ship one finished span to the GCS trace store (driver: direct
    append; worker: one control-plane call; no runtime: dropped).
    Best-effort: tracing never fails the traced operation."""
    span_tuple = (ctx.trace_id, ctx.span_id, parent_span_id, str(name),
                  str(component), t_start, duration,
                  dict(tags) if tags else None)
    try:
        from ray_tpu_torch.core import runtime as runtime_mod
        rt = runtime_mod.get_runtime_or_none()
        if rt is None:
            return
        if getattr(rt, "is_driver", False):
            rt.gcs.add_trace_span(span_tuple)
        else:
            rt.gcs_call("trace_add_span", span_tuple)
    except Exception:
        pass  # span export is best-effort observability


@contextmanager
def span(name: str, component: str = "app",
         tags: Optional[Dict[str, Any]] = None, parent=_UNSET):
    """A named span under the active trace (a fresh root trace when none
    is active), current for the with-block, so nested spans and
    ``.remote()`` calls made inside attach as children; yields its
    TraceContext. ``parent``: an explicit parent context (or None for a
    new root), for ingress points such as the Serve proxy that carry
    the parent in a ``traceparent`` header."""
    parent_ctx = _trace_var.get() if parent is _UNSET else parent
    ctx = TraceContext(
        parent_ctx.trace_id if parent_ctx is not None else new_trace_id(),
        new_span_id())
    token = _trace_var.set(ctx)
    wall0 = time.time()
    p0 = time.perf_counter()
    try:
        yield ctx
    finally:
        duration = time.perf_counter() - p0
        _trace_var.reset(token)
        record_span(name, component, wall0, duration, ctx,
                    parent_span_id=(parent_ctx.span_id
                                    if parent_ctx is not None else None),
                    tags=tags)


@contextmanager
def profile(name: str):
    """Record a named span for the duration of the with-block on the
    running task's timeline track; a no-op outside a worker task (on
    the driver, for instance). The duration is measured on the
    monotonic ``perf_counter`` clock, the start stays wall-clock."""
    from ray_tpu_torch.core import runtime as runtime_mod
    rt = runtime_mod.get_runtime_or_none()
    spans = getattr(rt, "_profile_spans", None) if rt is not None else None
    items = spans.value if spans is not None else None
    wall0 = time.time()
    p0 = time.perf_counter()
    try:
        yield
    finally:
        if items is not None:
            items.append((str(name), wall0,
                          wall0 + (time.perf_counter() - p0)))
