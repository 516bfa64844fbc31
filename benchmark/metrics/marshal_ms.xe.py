"""Device time of the X-Engine's marshal per integration (ms): every
device operation of the traced integrations other than the Gram kernels
(``csrc/xengine_gram_int8.cu``, ``xengine_gram_bf16.cu``) and the
product's copy to the host, summed and divided by the integrations traced
(the byte stack, the cell transpose, the decode, the triangular takes,
the scale and the emission's adds)."""

from benchmark.readers import device_ms_per_step

GRAM = ("gram_int8_", "gram_bf16_")


def _marshal(name):
    return not any(g in name for g in GRAM) and "DtoH" not in name


def read(trace):
    return device_ms_per_step(trace, _marshal)
