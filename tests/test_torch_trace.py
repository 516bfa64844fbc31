"""The port's in-program spans and counters (``runtime.trace``).

Off, a span is one shared object and nothing is recorded.  On, a tiny
X-Engine flowgraph step and a tiny fused FX step on the CPU record their
spans nested as the code nests them, the decode counts its bytes, the
buffer's bound drops what does not fit, and a span's ``time.time_ns()``
stamps hold the profiler's record of an operation run inside it once
both are placed on the profiler trace's clock (µs from its start).
"""

import threading

import numpy as np
import pytest
import torch

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.runtime import trace
from clenabled_tpu_torch.streaming import Flowgraph

S, P_, F, T = 4, 2, 8, 16


@pytest.fixture(autouse=True)
def clean_trace():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _tree(spans):
    """{name: [parent name, ...]} of drained span records."""
    out = {}
    for name, _, _, parent, _ in spans:
        out.setdefault(name, []).append(
            spans[parent][0] if parent >= 0 else None)
    return out


def test_off_span_is_one_shared_object_and_records_nothing():
    a, b = trace.span("x"), trace.span("y")
    assert a is b
    with a:
        with b:
            trace.count("c", 5)
    got = trace.drain()
    assert got.spans == [] and got.counters == {} and got.dropped == 0


def _xengine_runner(data_type):
    xe = blocks.XEngine(data_type=data_type, polarization=P_, num_inputs=S,
                        num_channels=F, integration=T, planar=True)
    graph = Flowgraph()
    for i in range(S):
        graph.external_input(xe, i)
    return xe, graph.compile(xe.quantum, device="cpu")


@pytest.mark.parametrize("data_type", [5, 6], ids=["ichar", "packedxy"])
def test_xengine_step_records_nested_spans_and_decode_bytes(data_type):
    xe, runner = _xengine_runner(data_type)
    got = []
    runner.on_message("xengine.xcorr", got.append)
    rng = np.random.default_rng(7)
    dtype = np.int8 if data_type == 5 else np.uint8
    feeds = [torch.from_numpy(rng.integers(-100, 100, xe.quantum)
                              .astype(dtype)) for _ in range(S)]
    trace.enable()
    runner.step(*feeds)
    trace.disable()
    d = trace.drain()
    assert len(got) == 1 and d.dropped == 0
    tree = _tree(d.spans)
    assert tree["runner.step"] == [None]
    assert tree["block.xengine"] == ["runner.step"]
    assert tree["runner.deliver"] == ["runner.step"]
    assert tree["xengine.decode"] == ["block.xengine"]
    assert tree["xengine.gram"] == ["block.xengine"]
    # the cast, scale and output order; then the integration's add
    assert tree["xengine.emit"] == ["block.xengine"] * 2
    for name, start, end, parent, thread in d.spans:
        assert start <= end and thread == threading.get_ident()
        if parent >= 0:
            _, ps, pe, _, _ = d.spans[parent]
            assert ps <= start and end <= pe
    in_bytes = S * xe.quantum
    planes = 2 * F * T * S * P_
    assert d.counters == {"xengine.decode_bytes": in_bytes + planes}


def test_fused_fx_step_records_step_and_finish():
    fn, (x, _, tr, ti) = P.make_fx_pipeline_fused(
        P.FxPipelineConfig(num_antennas=2, num_channels=16,
                           samples_per_step=4096), device="cpu")
    trace.enable()
    fn(torch.randn_like(x), torch.randn_like(x), tr, ti)
    trace.disable()
    tree = _tree(trace.drain().spans)
    # on the CPU the wrapper runs its plain form: no launch to prepare
    assert tree == {"fx.step": [None], "fx.finish": ["fx.step"]}


def test_bound_stops_recording_and_counts_dropped(monkeypatch):
    monkeypatch.setattr(trace, "_LIMIT", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("a"):
            with trace.span("b"):
                pass
    d = trace.drain()
    assert [s[0] for s in d.spans] == ["a", "b", "a"]
    assert d.dropped == 7
    assert all(s[2] is not None for s in d.spans)
    with trace.span("c"):
        pass
    assert [s[0] for s in trace.drain().spans] == ["c"]


def test_parents_are_per_thread_and_a_drain_leaves_open_spans_behind():
    trace.enable()
    inner = []

    def other():
        with trace.span("other"):
            inner.append(1)

    with trace.span("outer"):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        first = trace.drain()
        with trace.span("after"):
            pass
    second = trace.drain()
    assert _tree(first.spans) == {"outer": [None], "other": [None]}
    assert first.spans[0][2] is None          # still open when drained
    assert _tree(second.spans) == {"after": [None]}


def test_count_adds_only_when_on_and_drain_clears():
    trace.count("n", 2)
    trace.enable()
    trace.count("n", 3)
    trace.count("n", 4)
    trace.disable()
    trace.count("n", 5)
    assert trace.drain().counters == {"n": 7}
    assert trace.drain().counters == {}


def test_span_holds_a_profiled_op_on_the_profiler_clock():
    a = torch.randn(192, 192)
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("mm"):
            a @ a
    trace.disable()
    (name, start, end, _, _), = trace.drain().spans
    origin = prof.profiler.kineto_results.trace_start_ns()
    lo, hi = (start - origin) / 1e3, (end - origin) / 1e3
    ops = [e for e in prof.events() if e.name == "aten::mm"]
    assert ops
    for e in ops:
        assert lo <= e.time_range.start
        assert e.time_range.start + e.time_range.elapsed_us() <= hi
