"""Span export to the port's trace store (port of
ray_tpu/util/tracing.py's ``record_span``).

With the port's runtime up, a span closed on the driver is appended to
the GCS trace store directly, and one closed inside a task goes there
through one control-plane call, both under the submitter's trace id and
with the reference's parent links: a task's spans hang off the task's
own span id (derived from its task id), and the task's event carries the
trace. Without a runtime a span is dropped. The reference's
``record_span`` is driven through the same stubs, so both packages ship
the same tuple layout. After ``shutdown()`` no runtime, trace context or
``RTPU_`` variable of the session is left behind.
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu.util import tracing as ref_tracing
from ray_tpu_torch.core import runtime as runtime_mod
from ray_tpu_torch.util import tracing


class _Gcs:
    def __init__(self):
        self.spans = []

    def add_trace_span(self, span):
        self.spans.append(span)


class _Driver:
    is_driver = True

    def __init__(self):
        self.gcs = _Gcs()


class _Worker:
    is_driver = False

    def __init__(self):
        self.calls = []

    def gcs_call(self, method, *args):
        self.calls.append((method, args))


def _shape(span):
    """A span tuple without its ids and times: (has parent, name,
    component, tags)."""
    _trace, _span, parent, name, component, _t0, duration, tags = span
    assert duration >= 0.0
    return (parent is not None, name, component, tags)


def _nested(module):
    with module.span("outer", component="test", tags={"k": "v"}) as outer:
        with module.span("inner", component="test.inner") as inner:
            pass
    return outer, inner


@pytest.mark.parametrize("kind", ["driver", "worker"])
def test_record_span_ships_the_reference_tuple(monkeypatch, kind):
    stubs = {}
    for name, mod in (("ref", "ray_tpu.core.runtime"),
                      ("port", "ray_tpu_torch.core.runtime")):
        stub = _Driver() if kind == "driver" else _Worker()
        stubs[name] = stub
        monkeypatch.setattr(f"{mod}.get_runtime_or_none",
                            lambda stub=stub: stub)
    got = {"ref": _nested(ref_tracing), "port": _nested(tracing)}
    shipped = {}
    for name, stub in stubs.items():
        if kind == "driver":
            shipped[name] = stub.gcs.spans
        else:
            assert [m for m, _ in stub.calls] == ["trace_add_span"] * 2
            assert all(len(args) == 1 for _, args in stub.calls)
            shipped[name] = [args[0] for _, args in stub.calls]
    assert [_shape(s) for s in shipped["port"]] == \
        [_shape(s) for s in shipped["ref"]]
    for name, (outer, inner) in got.items():
        first, second = shipped[name]  # inner closes first
        assert first[:3] == (outer.trace_id, inner.span_id, outer.span_id)
        assert second[:3] == (outer.trace_id, outer.span_id, None)
        assert len(outer.trace_id) == 32 and len(inner.span_id) == 16


def test_no_runtime_drops_the_span(monkeypatch):
    monkeypatch.setattr("ray_tpu_torch.core.runtime.get_runtime_or_none",
                        lambda: None)
    with tracing.span("alone") as ctx:
        pass
    assert len(ctx.trace_id) == 32 and tracing.get_trace_context() is None


def test_span_raising_store_does_not_fail_the_operation(monkeypatch):
    class Broken:
        is_driver = True

        @property
        def gcs(self):
            raise RuntimeError("store down")

    monkeypatch.setattr("ray_tpu_torch.core.runtime.get_runtime_or_none",
                        lambda: Broken())
    with tracing.span("still-runs"):
        value = 42
    assert value == 42


@pytest.mark.parametrize("header,want", [
    ("00-" + "ab" * 16 + "-" + "cd" * 8 + "-01", ("ab" * 16, "cd" * 8)),
    ("00-" + "AB" * 16 + "-" + "CD" * 8 + "-00", ("ab" * 16, "cd" * 8)),
    (None, None), ("", None), ("garbage", None),
    ("00-" + "0" * 32 + "-" + "cd" * 8 + "-01", None),
    ("00-" + "ab" * 16 + "-" + "0" * 16 + "-01", None),
    ("00-" + "zz" * 16 + "-" + "cd" * 8 + "-01", None),
    ("00-" + "ab" * 15 + "-" + "cd" * 8 + "-01", None),
])
def test_traceparent_parse_and_format_match_the_reference(header, want):
    got = tracing.parse_traceparent(header)
    ref = ref_tracing.parse_traceparent(header)
    if want is None:
        assert got is None and ref is None
        return
    assert (got.trace_id, got.span_id) == want == (ref.trace_id,
                                                    ref.span_id)
    assert tracing.format_traceparent(got) == \
        ref_tracing.format_traceparent(ref)
    assert got.traceparent() == tracing.format_traceparent(got)
    assert len(tracing.new_span_id()) == len(ref_tracing.new_span_id()) == 16


def _env():
    return {k: v for k, v in os.environ.items() if k.startswith("RTPU_")}


def _traced_task():
    from ray_tpu_torch.util import tracing as t
    task_ctx = t.get_trace_context()
    with t.span("in_task", component="test.worker") as ctx:
        pass
    return task_ctx.trace_id, task_ctx.span_id, ctx.span_id


def test_driver_and_worker_spans_reach_the_store():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    env_before = _env()
    rt = ray_tpu_torch.init(num_cpus=1)
    try:
        f = ray_tpu_torch.remote(num_cpus=1)(_traced_task)
        with tracing.span("driver_op", component="test") as outer:
            ref = f.remote()
            task_trace, task_span, inner_span = ray_tpu_torch.get(
                ref, timeout=60)
        assert task_trace == outer.trace_id
        spans = {s[1]: s for s in rt.gcs.spans_for_trace(outer.trace_id)}
        assert spans[outer.span_id][2:5] == (None, "driver_op", "test")
        # the worker's span hangs off the task's span, the task's span
        # is the one its task id names, and the task's event carries
        # the driver's trace
        assert spans[inner_span][2:5] == (task_span, "in_task",
                                          "test.worker")
        events = rt.gcs.events_for_trace(outer.trace_id)
        assert any(tracing.task_span_id(ev.task_id) == task_span
                   for ev in events), events
        assert outer.trace_id in rt.gcs.recent_trace_ids()
    finally:
        ray_tpu_torch.shutdown()
    assert runtime_mod.get_runtime_or_none() is None
    assert tracing.get_trace_context() is None
    assert _env() == env_before
    with tracing.span("after_shutdown"):
        pass  # dropped: no runtime, no error
