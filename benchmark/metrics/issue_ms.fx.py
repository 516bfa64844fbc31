"""Host time to issue one FX step (ms): the mean of the benchmark's
``bench.fx.forward`` spans around ``FxPipelineFused.forward``,
taken in the steps before the profiler starts."""

from benchmark.readers import span_ms


def read(trace):
    return span_ms(trace, "bench.fx.forward")
