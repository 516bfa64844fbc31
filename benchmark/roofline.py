"""The least time the card could take for a kernel's work.

Peaks are NVIDIA's data sheet for the H100 SXM (dense rates, the full
700 W limit): HBM 3.35 TB/s, FP32 outside the tensor cores 67 TFLOP/s,
int8 on the tensor cores 1,979 TOP/s.  A bound is the larger of the bytes
the inputs need (each input byte read once, each output byte written once)
at the memory rate and the operations they need at the compute rate.
"""

from __future__ import annotations

import math

HBM_BPS = 3.35e12
FP32_OPS = 67e12
INT8_OPS = 1979e12


def bound(nbytes: float, ops: float, rate: float = FP32_OPS) -> tuple:
    """(bound_ms, bound_by): the larger of ``nbytes`` at the memory rate
    and ``ops`` at ``rate``."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def fx_ops(n: int, m: int, w: int, a: int, nfd: int, nb: int,
           fft: bool = True) -> float:
    """Operations of one fused FX step over ``a`` streams of ``n`` samples,
    ``m`` channels, ``w`` tap rows, ``nfd`` FD pairs and ``nb`` Gram
    baselines: the branch FIR (2·w a sample and component), the stage-1
    and lag M-point transforms as FFTs (5·M·log2 M real flops each) or as
    dense DFTs (8·M²), the lag products and magnitudes (10 a bin) and the
    Gram products (8 a bin and baseline)."""
    dft = 5 * m * math.log2(m) if fft else 8 * m * m
    return (4 * a * n * w + a * (n // m) * dft
            + nfd * (n // m) * (10 * m + dft) + nb * n * 8)


def fx_bound(n: int, h: int, m: int, w: int, a: int, nfd: int, nb: int,
             elem: int) -> tuple:
    """(bound_ms, bound_by) of one fused FX step: the frame and the carried
    tail (``elem`` bytes a sample, two components) and the taps read once,
    against ``fx_ops`` with the transforms as FFTs."""
    nbytes = elem * 2 * a * (n + h) + 4 * w * m
    return bound(nbytes, fx_ops(n, m, w, a, nfd, nb))


def gram_bound(f: int, t: int, width: int, elem: int,
               rate: float = INT8_OPS) -> tuple:
    """(bound_ms, bound_by) of the stacked Gram's ``_tri`` form over
    [f, t, width] operands of ``elem`` bytes: zr and zi read once, the a
    and gi blocks (4 bytes) written once; a's lower triangle and gi below
    the diagonal, 4·width² operations a frame."""
    nbt = (width // 128) * (width // 128 + 1) // 2
    return bound(2 * elem * f * t * width + 4 * 2 * f * nbt * 128 * 128,
                 4 * f * width * width * t, rate)
