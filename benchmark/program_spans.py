"""The program's own spans on a traced run's timeline, and what they read.

    python3 -m benchmark.program_spans --workload xe64x256.ichar.resident \\
        --seed 7 --seconds 10

runs the cell as ``--trace 1`` does, with ``SpanTracer`` in the place of
``trace.Tracer``: halfway to the profiler's start it switches on the
program's tracing (``clenabled_tpu_torch.runtime.trace``), from when the
benchmark's own spans stop, so these time only steps an untraced run
would; it stays on through the profiled sub-window, and is drained when
that closes.  Standard output gets the run's result line, then one JSON
object, ``{"program": ...}``:

- ``clock``: the ``cudaDeviceSynchronize`` record of the closing wait
  against ``time.time_ns()`` stamps taken around it (``offset_us``, the
  record's middle less the stamps'; ``inside``); past 50 µs the spans
  are placed by that anchor (``anchored``);
- ``device_by_span``: device seconds of the profiled sub-window, each
  operation given to the innermost program span open when its launch call
  began (linked by the profiler's correlation id), else to
  ``OUTSIDE``; ``attributed_pct`` the share in a span; ``idle_spans``:
  ``Trace.breakdown``'s idle gaps named by the innermost span at their
  middle;
- ``readings``: ``decode_ms.xe`` (device time in ``xengine.decode`` an
  integration), ``emit_ms.xe``, ``roofline_pct.xe_decode``
  (``xengine.decode_bytes`` an integration at ``roofline.HBM_BPS`` over
  ``decode_ms.xe``), ``prepare_ms.fx`` and ``finish_ms.fx`` (mean host
  spans taken before the profiler started), and the mean root span with
  tracing on beside the benchmark's span around the same call with it off
  (``on_ms`` / ``off_ms``); a reading with nothing to read is None.

It needs a program with ``runtime.trace``; none of this is read by
``benchmark.run``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from unittest import mock

from benchmark import trace as bench_trace
from benchmark.roofline import HBM_BPS

OUTSIDE = "outside the program"
ANCHOR_US = 50.0
# the benchmark's span around the call each root program span times
ROOTS = {"fx.step": "bench.fx.forward", "runner.step": "bench.xe.step"}


def innermost(spans: list, times: list) -> list:
    """For each of ``times``, the index in ``spans`` ((name, start, end,
    ...) on one clock, closed) of the innermost span open at it, the one
    opened last among those with start ≤ t < end; None where none is."""
    by_start = sorted(range(len(spans)), key=lambda i: (spans[i][1], i))
    out = [None] * len(times)
    stack, j = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(by_start) and spans[by_start[j]][1] <= t:
            stack.append(by_start[j])
            j += 1
        # a span above another opened after it: once ended, it is gone
        # for every later time too
        while stack and spans[stack[-1]][2] <= t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def device_by_span(ops: list, spans: list) -> dict:
    """Device µs of ``ops`` ((name, launch, duration): ``launch`` the
    start of the call that launched it, None where the profiler linked
    none) by the name of the innermost span open at the launch."""
    at = innermost(spans, [t for _, t, _ in ops if t is not None])
    it = iter(at)
    out = {}
    for _, t, d in ops:
        i = next(it) if t is not None else None
        key = spans[i][0] if i is not None else OUTSIDE
        out[key] = out.get(key, 0.0) + d
    return out


def idle_spans(trace, spans: list, top: int = 10) -> list:
    """``Trace.breakdown``'s idle gaps (the ``top`` longest in the window),
    each as [span at its middle, seconds]: the breakdown run with the
    program's spans as its host events, which names a gap by the shortest
    one holding its middle, the innermost where spans nest."""
    named = dataclasses.replace(
        trace, host_ops=[(n, s, e - s) for n, s, e, *_ in spans])
    return [[OUTSIDE if n == "host idle" else n, sec]
            for n, sec in named.breakdown(top)["idle_gaps"]]


def on_clock(drained_spans: list, origin_ns: int, shift_ns: int = 0) -> list:
    """Closed program spans as (name, start µs, end µs, parent, thread)
    on the trace's clock (µs from ``origin_ns``), moved by
    ``shift_ns``."""
    return [(n, (s + shift_ns - origin_ns) / 1e3,
             (e + shift_ns - origin_ns) / 1e3, p, th)
            for n, s, e, p, th in drained_spans if e is not None]


def clock_check(syncs: list, stamps: tuple) -> dict:
    """Where the runtime's ``cudaDeviceSynchronize`` records ((start_ns,
    end_ns)) nearest the host stamps ``stamps`` taken around the wait lie:
    ``offset_us`` (the record's middle less the stamps'), ``inside`` and
    the ``shift_ns`` that places spans by it where the offset passes
    ``ANCHOR_US`` (else 0).  Empty without such a record."""
    if not syncs or stamps is None:
        return {}
    mid = (stamps[0] + stamps[1]) / 2
    s, e = min(syncs, key=lambda r: abs((r[0] + r[1]) / 2 - mid))
    offset = ((s + e) / 2 - mid) / 1e3
    anchored = abs(offset) > ANCHOR_US
    return {"offset_us": offset,
            "inside": stamps[0] <= s and e <= stamps[1],
            "anchored": anchored,
            "shift_ns": round(offset * 1e3) if anchored else 0}


def _mean_ms(durations: list):
    return statistics.fmean(durations) / 1e3 if durations else None


def readings(by_span: dict, drained, steps: int, before_ns, host: dict):
    """The per-layer readings of one traced run (see the module's
    docstring): ``by_span`` from ``device_by_span``, ``drained`` the
    program's, ``before_ns`` the profiler's start on their clock,
    ``host`` the benchmark's own spans (µs)."""
    def per_step_ms(name):
        us = by_span.get(name)
        return us / 1e3 / steps if us and steps else None

    closed = [r for r in drained.spans if r[2] is not None]

    def early_ms(name):
        return _mean_ms([(e - s) / 1e3 for n, s, e, _, _ in closed
                         if n == name and before_ns and e < before_ns])

    decode = per_step_ms("xengine.decode")
    decodes = sum(1 for r in closed if r[0] == "xengine.decode")
    nbytes = drained.counters.get("xengine.decode_bytes")
    per = nbytes / decodes if decodes and nbytes else None
    out = {"decode_ms.xe": decode, "emit_ms.xe": per_step_ms("xengine.emit"),
           "decode_bytes": per,
           "roofline_pct.xe_decode": (100.0 * (per / HBM_BPS * 1e3) / decode
                                      if per and decode else None),
           "prepare_ms.fx": early_ms("fx.prepare"),
           "finish_ms.fx": early_ms("fx.finish")}
    for root, bench in ROOTS.items():
        on = early_ms(root)
        if on is not None:
            out["on_ms." + root] = on
            out["off_ms." + root] = _mean_ms(host.get(bench, []))
    return out


class SpanTracer(bench_trace.Tracer):
    """``trace.Tracer`` with the program's tracing on from ``after / 2``
    of the window through the profiled sub-window."""

    last = None

    def __init__(self, card, steps, after, params):
        super().__init__(card, steps, after, params)
        from clenabled_tpu_torch.runtime import trace as program

        self.program = program
        self.program_from = None       # time.time_ns() when switched on
        self.profile_from = None       # time.time_ns() before the profiler
        self.stamps = None             # around the closing wait
        self.drained = None
        SpanTracer.last = self

    def step(self, k: int, elapsed: float) -> float:
        if not self.done:
            if self.program_from is None and elapsed >= self.after / 2:
                self.program.enable()
                self.program_from = time.time_ns()
            if self.prof is None and elapsed >= self.after:
                self.profile_from = time.time_ns()
        return super().step(k, elapsed)

    def span(self, name: str):
        if self.program_from is not None:
            return bench_trace._UNTIMED
        return super().span(name)

    def finish(self, k: int) -> None:
        if self.prof is None or self.done:
            return
        t0 = time.time_ns()
        self.card.sync()
        self.stamps = (t0, time.time_ns())
        super().finish(k)
        self.program.disable()
        self.drained = self.program.drain()

    def program_view(self, trace) -> dict:
        """``program`` of the tool's line, from this tracer's profile and
        ``trace``, its ``read()``."""
        if self.drained is None or trace is None:
            return {}
        kr = self.prof.profiler.kineto_results
        origin = kr.trace_start_ns()
        cuda = bench_trace.torch.autograd.DeviceType.CUDA
        launch, syncs, dev = {}, [], []
        for e in kr.events():
            if e.device_type() == cuda:
                dev.append(e)
                continue
            if e.correlation_id():
                launch.setdefault(e.correlation_id(), e.start_ns())
            if e.name() == "cudaDeviceSynchronize":
                syncs.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        clock = clock_check(syncs, self.stamps)
        spans = on_clock(self.drained.spans, origin, clock.get("shift_ns", 0))
        ops = []
        for e in dev:
            t = launch.get(e.correlation_id())
            ops.append((e.name(), None if t is None else (t - origin) / 1e3,
                        e.duration_ns() / 1e3))
        by = device_by_span(ops, spans)
        total = sum(by.values())
        return {
            "clock": clock,
            "spans": len(self.drained.spans),
            "dropped": self.drained.dropped,
            "counters": self.drained.counters,
            "ops": len(ops),
            "ops_linked": sum(1 for _, t, _ in ops if t is not None),
            "device_by_span": {k: v / 1e6 for k, v in
                               sorted(by.items(), key=lambda kv: -kv[1])},
            "device_s": total / 1e6,
            "trace_device_s": trace.device_us(lambda n: True) / 1e6,
            "attributed_pct": (100.0 * (1 - by.get(OUTSIDE, 0.0) / total)
                               if total else None),
            "idle_spans": idle_spans(trace, spans) if dev else [],
            "readings": readings(by, self.drained, trace.steps,
                                 self.profile_from, trace.spans),
        }


def traced(fn, *args):
    """``fn(*args)`` with ``SpanTracer`` in ``trace.Tracer``'s place (the
    harness takes its tracer from there at each run): (its result, the
    run's tracer or None)."""
    SpanTracer.last = None
    try:
        with mock.patch.object(bench_trace, "Tracer", SpanTracer):
            res = fn(*args)
    finally:
        tracer = SpanTracer.last
        if tracer is not None and tracer.drained is None:
            # the window closed before the profiler began
            tracer.program.disable()
            tracer.program.drain()
    return res, tracer


def main(argv=None) -> int:
    """``benchmark.run``'s arguments; prints its result line, then the
    tool's.  The run's ``setup_s`` starts after this module's imports."""
    from benchmark import run

    argv = list(sys.argv[1:] if argv is None else argv)
    rc, tracer = traced(run.main, argv + ["--trace", "1"])
    if rc or tracer is None:
        return rc or 1
    view = tracer.program_view(tracer.read())
    clock = view.get("clock", {})
    print(f"clock_offset_us {clock.get('offset_us')!r} inside "
          f"{clock.get('inside')!r} anchored {clock.get('anchored')!r}",
          file=sys.stderr)
    print(json.dumps({"program": view}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
