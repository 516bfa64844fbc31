"""Share of its roofline that the fused FX kernel reaches (%).

Device time per step of the kernels of ``csrc/fx_correlate.cu`` (its
bodies and the reduce of their partial rows), by name, over the traced
steps; the bound is ``roofline.fx_bound`` of the cell's shapes (the frame
and tail read once, the M-point transforms counted as FFTs).  Nothing to
read where no FX kernel ran.
"""

from benchmark import roofline
from benchmark.readers import device_ms_per_step

KERNELS = ("fx_reg_kernel", "fx_wide_kernel", "fx_tile_kernel",
           "fx_reduce_kernel")


def read(trace):
    ms = device_ms_per_step(trace, lambda n: any(k in n for k in KERNELS))
    if ms is None:
        return None
    p = trace.params
    bound_ms, _ = roofline.fx_bound(
        p["samples_per_step"], p["tail_len"], p["num_channels"],
        p["tap_rows"], p["num_antennas"], p["fd_pairs"], p["xe_pairs"],
        p["ingest_bytes"])
    return 100.0 * bound_ms / ms
