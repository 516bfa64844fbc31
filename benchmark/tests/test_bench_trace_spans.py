"""``benchmark.program_spans``: device time given to the program's spans by
launch, the idle gaps named by span, the clock check, the readings on
synthetic traces (each None without its span or counter), and a tiny
traced run of each kind on the CPU with the program's tracing on."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark import program_spans as ps
from benchmark.roofline import HBM_BPS
from benchmark.tests.helpers import SEED, CpuCard, tiny_cell
from benchmark.trace import Trace
from clenabled_tpu_torch.runtime import trace as program

# (name, start µs, end µs, parent, thread): a step holding a block
# holding the decode and the Gram, and a span of another thread laid
# across them
SPANS = [("runner.step", 0.0, 100.0, -1, 1),
         ("block.xengine", 10.0, 90.0, 0, 1),
         ("xengine.decode", 12.0, 40.0, 1, 1),
         ("xengine.gram", 40.0, 60.0, 1, 1),
         ("other", 30.0, 200.0, -1, 2)]


def _drained(spans_ns, counters=None):
    return program.Drained(spans_ns, counters or {}, 0)


def test_innermost_is_the_last_opened_span_holding_the_time():
    got = ps.innermost(SPANS, [5.0, 11.0, 20.0, 35.0, 40.0, 95.0, 150.0,
                               250.0, -1.0])
    assert got == [0, 1, 2, 4, 3, 4, 4, None, None]


def test_device_time_goes_to_the_span_open_at_the_launch():
    # launched inside the decode, run long after every span closed; one
    # launched between spans, one the profiler linked to no call
    ops = [("copy", 13.0, 400.0), ("gram", 45.0, 30.0),
           ("take", 91.0, 2.0), ("lost", None, 5.0), ("late", 300.0, 1.0)]
    by = ps.device_by_span(ops, SPANS[:4])
    assert by == {"xengine.decode": 400.0, "xengine.gram": 30.0,
                  "runner.step": 2.0, ps.OUTSIDE: 6.0}
    assert sum(by.values()) == sum(d for _, _, d in ops)


def _trace(device_ops, window):
    return Trace(window, device_ops, {}, [], 4, {})


def test_idle_spans_name_the_breakdowns_gaps():
    tr = _trace([("k", 0.0, 10.0), ("k", 30.0, 5.0), ("k", 80.0, 20.0)],
                (0.0, 100.0))
    got = ps.idle_spans(tr, SPANS[:4])
    assert [s for _, s in got] == [s for _, s in tr.breakdown()["idle_gaps"]]
    # gaps 35-80 (middle 57.5, in the Gram) and 10-30 (middle 20, decode)
    assert got == [["xengine.gram", 45e-6], ["xengine.decode", 20e-6]]


def test_clock_check_reports_the_offset_and_anchors_past_50_us():
    stamps = (1_000_000, 1_100_000)
    near = ps.clock_check([(1_010_000, 1_090_000), (5_000_000, 5_000_100)],
                          stamps)
    assert near == {"offset_us": 0.0, "inside": True, "anchored": False,
                    "shift_ns": 0}
    far = ps.clock_check([(1_070_000, 1_230_000)], stamps)
    assert far["offset_us"] == pytest.approx(100.0)
    assert not far["inside"] and far["anchored"]
    assert far["shift_ns"] == 100_000
    assert ps.clock_check([], stamps) == {}
    spans = ps.on_clock([("a", 2_000, 5_000, -1, 1), ("b", 3_000, None, 0, 1)],
                        1_000, far["shift_ns"])
    assert spans == [("a", 101.0, 104.0, -1, 1)]


def test_readings_by_hand_and_none_without_their_spans():
    before = 10_000_000
    spans = [("runner.step", 0, 2_000_000, -1, 1),
             ("xengine.decode", 0, 1_000_000, 0, 1),
             ("runner.step", 2_000_000, 6_000_000, -1, 1),
             ("xengine.decode", 2_000_000, 3_000_000, 2, 1),
             ("fx.prepare", 0, 100_000, -1, 1),
             ("fx.prepare", 0, 300_000, -1, 1),
             ("fx.finish", 0, 50_000, -1, 1),
             # after the profiler's start: left out of the host means
             ("fx.prepare", before, before + 9_000_000, -1, 1),
             ("fx.step", 0, 500_000, -1, 1)]
    nbytes = 2 * 3_350_000_000          # 1 ms at HBM_BPS an integration
    drained = _drained(spans, {"xengine.decode_bytes": nbytes})
    by = {"xengine.decode": 8000.0, "xengine.emit": 400.0}
    host = {"bench.fx.forward": [400.0, 600.0]}
    got = ps.readings(by, drained, 2, before, host)
    assert got["decode_ms.xe"] == pytest.approx(4.0)
    assert got["emit_ms.xe"] == pytest.approx(0.2)
    assert got["decode_bytes"] == nbytes / 2
    assert nbytes / 2 / HBM_BPS == pytest.approx(1e-3)
    assert got["roofline_pct.xe_decode"] == pytest.approx(25.0)
    assert got["prepare_ms.fx"] == pytest.approx(0.2)
    assert got["finish_ms.fx"] == pytest.approx(0.05)
    assert got["on_ms.fx.step"] == pytest.approx(0.5)
    assert got["off_ms.fx.step"] == pytest.approx(0.5)
    assert got["on_ms.runner.step"] == pytest.approx(3.0)
    assert got["off_ms.runner.step"] is None
    none = ps.readings({}, _drained([]), 2, before, {})
    assert none == {"decode_ms.xe": None, "emit_ms.xe": None,
                    "decode_bytes": None, "roofline_pct.xe_decode": None,
                    "prepare_ms.fx": None, "finish_ms.fx": None}
    # a decode without its counter, a counter without its decodes
    assert ps.readings(by, _drained(spans), 2, before,
                       {})["roofline_pct.xe_decode"] is None
    assert ps.readings({}, drained, 2, before,
                       {})["roofline_pct.xe_decode"] is None


@pytest.mark.parametrize("workload", ["fx4x16.f32.resident",
                                      "xe64x256.ichar.resident"])
def test_tiny_traced_run_records_the_programs_spans(workload):
    cell = tiny_cell(workload)
    # program tracing from 0.9 s, the profiler from 1.8 s: room for a few
    # tiny CPU steps (0.1-0.3 s each on a busy host) in between
    cell.traffic.update(trace_after=0.6, trace_steps=2)
    out, tracer = ps.traced(harness.run, cell, SEED, 3.0, True, CpuCard(),
                            time.perf_counter())
    assert out["correct"] and tracer is not None
    assert not program.enabled()
    view = tracer.program_view(tracer.read())
    names = {s[0] for s in tracer.drained.spans}
    host = tracer.read().spans
    # the benchmark's own spans stop where the program's begin
    assert tracer.program_from is not None
    assert tracer.profile_from >= tracer.program_from
    got = view["readings"]
    if cell.kind == "fx":
        assert {"fx.step", "fx.finish"} <= names
        assert host["bench.fx.forward"]
        assert got["finish_ms.fx"] > 0 and got["on_ms.fx.step"] > 0
    else:
        assert {"runner.step", "runner.deliver", "block.xengine",
                "xengine.decode", "xengine.gram", "xengine.emit"} <= names
        c = cell.config
        per = (c["stations"] * c["integration"] * c["channels"]
               * c["polarizations"] * 4)
        assert got["decode_bytes"] == per
    # a CPU run has no device operations to give to spans
    assert view["ops"] == 0 and got["decode_ms.xe"] is None
