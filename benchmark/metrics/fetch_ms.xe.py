"""Device time of the product's copy to host memory per dump (ms): the
traced ``Memcpy DtoH`` operations (the planes of each ``xcorr`` matrix)
summed and divided by the integrations traced."""

from benchmark.readers import device_ms_per_step


def read(trace):
    return device_ms_per_step(trace, lambda name: "DtoH" in name)
