"""Window functions (parity with lib/window.{h,cc} of the reference).

These are the standard GNU Radio window definitions — symmetric cosine-series
windows with denominator ``ntaps-1``, Kaiser via the I0 Bessel series, etc.
Host-side (NumPy): windows are computed once at block construction and then
live on-device as constants, exactly like the reference uploads the window
buffer once (lib/clFFT_impl.cc:137-140).  A copy of
``clenabled_tpu.dsp.window``: importing the JAX package would import jax.

Window-type integer codes follow the reference enum (lib/firdes.h:45-56):
HAMMING=0 HANN=1 BLACKMAN=2 RECTANGULAR=3 KAISER=4 BLACKMAN_HARRIS=5
BARTLETT=6 FLATTOP=7.
"""

from __future__ import annotations

import numpy as np

# win_type codes, parity with lib/firdes.h:45-56 / lib/window.h
WIN_NONE = -1
WIN_HAMMING = 0
WIN_HANN = 1
WIN_BLACKMAN = 2
WIN_RECTANGULAR = 3
WIN_KAISER = 4
WIN_BLACKMAN_HARRIS = 5
WIN_BARTLETT = 6
WIN_FLATTOP = 7


def _coswindow(ntaps: int, *coeffs: float) -> np.ndarray:
    """Symmetric cosine-series window: sum_k (-1)^k c_k cos(2 pi k n/(N-1))."""
    n = np.arange(ntaps, dtype=np.float64)
    m = float(ntaps - 1)
    acc = np.zeros(ntaps, dtype=np.float64)
    for k, c in enumerate(coeffs):
        acc += ((-1.0) ** k) * c * np.cos(2.0 * np.pi * k * n / m)
    return acc.astype(np.float32)


def rectangular(ntaps: int) -> np.ndarray:
    return np.ones(ntaps, dtype=np.float32)


def hamming(ntaps: int) -> np.ndarray:
    return _coswindow(ntaps, 0.54, 0.46)


def hann(ntaps: int) -> np.ndarray:
    return _coswindow(ntaps, 0.5, 0.5)


hanning = hann


def blackman(ntaps: int) -> np.ndarray:
    return _coswindow(ntaps, 0.42, 0.5, 0.08)


def blackman2(ntaps: int) -> np.ndarray:
    return _coswindow(ntaps, 0.34401, 0.49755, 0.15844)


def blackman3(ntaps: int) -> np.ndarray:
    return _coswindow(ntaps, 0.21747, 0.45325, 0.28256, 0.04672)


def blackman4(ntaps: int) -> np.ndarray:
    return _coswindow(ntaps, 0.084037, 0.29145, 0.375696, 0.20762, 0.041194)


def blackman_harris(ntaps: int, atten: int = 92) -> np.ndarray:
    tables = {
        61: (0.42323, 0.49755, 0.07922),
        67: (0.44959, 0.49364, 0.05677),
        74: (0.40271, 0.49703, 0.09392, 0.00183),
        92: (0.35875, 0.48829, 0.14128, 0.01168),
    }
    if atten not in tables:
        raise ValueError("blackman_harris attenuation must be 61, 67, 74, or 92")
    return _coswindow(ntaps, *tables[atten])


blackmanharris = blackman_harris


def nuttall(ntaps: int) -> np.ndarray:
    return _coswindow(ntaps, 0.3635819, 0.4891775, 0.1365995, 0.0106411)


nuttal = nuttall
blackman_nuttall = nuttall
blackman_nuttal = nuttall


def nuttall_cfd(ntaps: int) -> np.ndarray:
    return _coswindow(ntaps, 0.355768, 0.487396, 0.144232, 0.012604)


nuttal_cfd = nuttall_cfd


def flattop(ntaps: int) -> np.ndarray:
    scale = 4.63867
    return _coswindow(
        ntaps, 1.0 / scale, 1.93 / scale, 1.29 / scale, 0.388 / scale, 0.028 / scale
    )


def _izero(x: float) -> float:
    """Zeroth-order modified Bessel I0 by its power series (same convergence
    criterion as the reference's Izero, tolerance 1e-21 relative)."""
    s = u = 1.0
    n = 1
    halfx = x / 2.0
    while True:
        t = halfx / n
        n += 1
        u *= t * t
        s += u
        if u < 1e-21 * s:
            return s


def kaiser(ntaps: int, beta: float) -> np.ndarray:
    if beta < 0:
        raise ValueError("kaiser: beta must be >= 0")
    inv_ibeta = 1.0 / _izero(beta)
    inm1 = 1.0 / (ntaps - 1)
    t = 2.0 * np.arange(ntaps) * inm1 - 1.0
    vals = [ _izero(beta * np.sqrt(max(0.0, 1.0 - ti * ti))) * inv_ibeta for ti in t ]
    return np.asarray(vals, dtype=np.float32)


def bartlett(ntaps: int) -> np.ndarray:
    m = float(ntaps - 1)
    n = np.arange(ntaps, dtype=np.float64)
    w = np.where(n < ntaps / 2, 2 * n / m, 2 - 2 * n / m)
    return w.astype(np.float32)


def welch(ntaps: int) -> np.ndarray:
    m1 = (ntaps - 1.0) / 2.0
    p1 = (ntaps + 1.0) / 2.0
    w = np.zeros(ntaps, dtype=np.float64)
    for i in range(int(ntaps / 2.0) + 1):
        w[i] = 1.0 - ((i - m1) / p1) ** 2
        w[ntaps - i - 1] = w[i]
    return w.astype(np.float32)


def parzen(ntaps: int) -> np.ndarray:
    m1 = (ntaps - 1.0) / 2.0
    m = ntaps / 2.0
    w = np.zeros(ntaps, dtype=np.float64)
    for i in range(ntaps // 4, 3 * ntaps // 4):
        w[i] = 1.0 - 6.0 * ((i - m1) / m) ** 2 * (1.0 - abs(i - m1) / m)
    for i in range(3 * ntaps // 4, ntaps):
        w[i] = 2.0 * (1.0 - abs(i - m1) / m) ** 3
        w[ntaps - i - 1] = w[i]
    return w.astype(np.float32)


def exponential(ntaps: int, d: float) -> np.ndarray:
    """Exponential window; d = decay in dB over half the window."""
    m = (ntaps - 1.0) / 2.0
    tau = m * 8.69 / d
    n = np.arange(ntaps, dtype=np.float64)
    return np.exp(-np.abs(n - m) / tau).astype(np.float32)


def riemann(ntaps: int) -> np.ndarray:
    m = (ntaps - 1.0) / 2.0
    w = np.zeros(ntaps, dtype=np.float64)
    for i in range(ntaps):
        if i == m:
            w[i] = 1.0
        else:
            x = 2.0 * np.pi * (i - m) / m
            w[i] = np.sin(x) / x
    return w.astype(np.float32)


def max_attenuation(wintype: int, beta: float = 6.76) -> float:
    """Stopband attenuation used to size filters (lib/window.cc:77-92)."""
    table = {
        WIN_HAMMING: 53.0,
        WIN_HANN: 44.0,
        WIN_BLACKMAN: 74.0,
        WIN_RECTANGULAR: 21.0,
        WIN_BLACKMAN_HARRIS: 92.0,
        WIN_BARTLETT: 27.0,
        WIN_FLATTOP: 93.0,
    }
    if wintype == WIN_KAISER:
        return beta / 0.1102 + 8.7
    if wintype not in table:
        raise ValueError(f"max_attenuation: unknown window type {wintype}")
    return table[wintype]


def build(wintype: int, ntaps: int, beta: float = 6.76) -> np.ndarray:
    """Dispatch by type code (lib/window.cc:353-367)."""
    dispatch = {
        WIN_RECTANGULAR: lambda: rectangular(ntaps),
        WIN_HAMMING: lambda: hamming(ntaps),
        WIN_HANN: lambda: hann(ntaps),
        WIN_BLACKMAN: lambda: blackman(ntaps),
        WIN_BLACKMAN_HARRIS: lambda: blackman_harris(ntaps),
        WIN_KAISER: lambda: kaiser(ntaps, beta),
        WIN_BARTLETT: lambda: bartlett(ntaps),
        WIN_FLATTOP: lambda: flattop(ntaps),
    }
    if wintype not in dispatch:
        raise ValueError(f"window.build: type {wintype} out of range")
    return dispatch[wintype]()
