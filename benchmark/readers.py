"""What the per-layer readers in ``metrics/`` share.  Each returns None
where the trace holds nothing to read, so the harness leaves the metric
out of the line."""

from __future__ import annotations


def idle_pct(trace):
    """Share of the traced sub-window in which no operation ran on the
    card (%): 1 − the union of the device operations' intervals over the
    window."""
    if not trace.device_ops or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)


def span_ms(trace, name: str):
    """The mean of the benchmark's host-clock spans ``name`` (ms)."""
    spans = trace.span_us(name)
    return sum(spans) / len(spans) / 1e3 if spans else None


def device_ms_per_step(trace, keep):
    """Device time of the operations whose name ``keep`` takes, summed
    and divided by the steps traced (ms)."""
    us = trace.device_us(keep)
    if not us or not trace.steps:
        return None
    return us / 1e3 / trace.steps
