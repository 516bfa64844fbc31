"""The traced sub-window of a ``--trace 1`` run, and what is read from it.

A driver calls ``Tracer.step(k, elapsed)`` before each step of its window
and lengthens the window by the seconds it returns.  Once ``after`` of the
window has passed, the tracer waits for the card and starts
``torch.profiler`` with the CUDA activity alone (kernels, copies and the
CUDA runtime calls, without a record of every host operation); ``steps``
steps later it waits for the card again and stops.  The profiler's first
start in a process sets up its tracing library, which takes seconds: that
is the time ``step`` returns, so the traced steps still run.
``span(name)`` times a driver's call into a layer on the host clock, in
each step before the profiler starts: once started in a process, it
slows every later launch on the host (an H100 host's FX step issued in
0.336 ms after a profiler session against 0.239 ms before), so spans
taken after it would not read what an untraced run pays.

``Trace`` holds what the readers in ``metrics/`` see: the device
operations (name, start, duration in µs) of the profiled sub-window,
which runs from the first device operation to the end of the last, the
benchmark's spans (durations in µs), the host events the profiler
recorded (for naming idle gaps), the number of steps profiled and the
cell's shapes (``params``).  Where no device operation was recorded (the
CPU tests' stand-in profiles host operations), the window is its host
time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

_UNTIMED = contextlib.nullcontext()


@dataclasses.dataclass
class Trace:
    window: tuple          # (start, end) µs on the trace's clock
    device_ops: list       # (name, start, duration) µs, inside the window
    spans: dict            # name -> [duration µs]: the benchmark's spans
    host_ops: list         # (name, start, duration) µs: every host event
    steps: int
    params: dict

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def device_us(self, keep) -> float:
        """Summed device time of the operations whose name ``keep`` takes."""
        return sum(d for name, _, d in self.device_ops if keep(name))

    def span_us(self, name: str) -> list:
        return self.spans.get(name, [])

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted (start, end) µs."""
        lo, hi = self.window
        merged = []
        for _, s, d in sorted(self.device_ops, key=lambda e: e[1]):
            s, e = max(s, lo), min(s + d, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host event at their middle."""
        by_name = defaultdict(float)
        for name, _, d in self.device_ops:
            by_name[name[:160]] += d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (s + e) / 2
            inside = [(d, n) for n, hs, d in self.host_ops
                      if hs <= mid <= hs + d]
            named.append([min(inside)[1][:160] if inside else "host idle",
                          (e - s) / 1e6])
        return {"device_ops": [[n, d / 1e6] for n, d in ops],
                "idle_gaps": named}


class _Timed:
    """A span on the host clock."""

    def __init__(self, into: list):
        self.into = into

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.into.append((time.perf_counter() - self.t0) * 1e6)


class Tracer:
    def __init__(self, card, steps: int, after: float, params: dict):
        self.card, self.steps, self.after = card, steps, after
        self.params = params
        self.prof = None
        self.first = None
        self.done = False
        self.t_start = 0.0
        self.profiled = (0, 0.0)     # steps, host µs of the sub-window
        self.host = defaultdict(list)

    def step(self, k: int, elapsed: float) -> float:
        """Called before step ``k``, ``elapsed`` seconds into the window;
        returns the seconds spent starting the profiler (else 0)."""
        if self.done:
            return 0.0
        if self.prof is None and elapsed >= self.after:
            t = time.perf_counter()
            self.card.sync()
            self.prof = torch.profiler.profile(activities=self.card.profiled())
            self.prof.start()
            self.t_start = time.perf_counter()
            self.first = k
            return self.t_start - t
        if self.prof is not None and k - self.first >= self.steps:
            self.finish(k)
        return 0.0

    def span(self, name: str):
        if self.prof is not None:
            return _UNTIMED
        return _Timed(self.host[name])

    def finish(self, k: int) -> None:
        """Close the traced sub-window (if open) at step ``k``."""
        if self.prof is None or self.done:
            return
        self.card.sync()
        host_us = (time.perf_counter() - self.t_start) * 1e6
        self.prof.stop()
        self.done = True
        self.profiled = (k - self.first, host_us)

    def read(self):
        """The ``Trace`` of the profiled sub-window, or None where the
        window closed before it began; read once the window has closed."""
        if not self.done:
            return None
        steps, host_us = self.profiled
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self.prof.events():
            rec = (e.name, e.time_range.start, e.time_range.elapsed_us())
            (dev if e.device_type == cuda else host).append(rec)
        window = ((min(s for _, s, _ in dev), max(s + d for _, s, d in dev))
                  if dev else (0.0, host_us))
        return Trace(window, dev, dict(self.host), host, steps, self.params)
