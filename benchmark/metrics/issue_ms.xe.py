"""Host time to issue one integration (ms): the mean of the benchmark's
``bench.xe.step`` spans around ``Runner.step`` (the blocks' calls, the
message delivery and the copy's enqueue), taken in the integrations
before the profiler starts."""

from benchmark.readers import span_ms


def read(trace):
    return span_ms(trace, "bench.xe.step")
