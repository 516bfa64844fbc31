"""Share of its roofline that the int8 Gram reaches (%): the bound of the
stacked Gram's ``_tri`` form over the cell's [F, T, S·P] int8 operands
(``roofline.gram_bound``) over the device time per integration of the
kernels of ``csrc/xengine_gram_int8.cu``.  Nothing to read where none
ran."""

from benchmark import roofline
from benchmark.readers import device_ms_per_step

KERNEL = "gram_int8_"


def read(trace):
    ms = device_ms_per_step(trace, lambda name: KERNEL in name)
    if ms is None:
        return None
    p = trace.params
    bound_ms, _ = roofline.gram_bound(p["channels"], p["integration"],
                                      p["inputs"], 1)
    return 100.0 * bound_ms / ms
