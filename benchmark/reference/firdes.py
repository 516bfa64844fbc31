"""GNU Radio's windowed-sinc low-pass designer (gr::filter::firdes::low_pass
with a Hamming window), in NumPy: the prototype of the channelizer.

The tap count is the harris estimate ``53 · fs / (22 · tw)`` forced odd;
the taps are the windowed sinc normalised to unit gain at DC, computed in
float64 and rounded to float32.
"""

from __future__ import annotations

import numpy as np

HAMMING_ATTENUATION_DB = 53.0


def hamming(ntaps: int) -> np.ndarray:
    n = np.arange(ntaps, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (ntaps - 1))
    return w.astype(np.float32)


def low_pass(gain: float, fs: float, cutoff: float,
             transition: float) -> np.ndarray:
    ntaps = int(HAMMING_ATTENUATION_DB * fs / (22.0 * transition))
    ntaps += 1 - ntaps % 2
    w = hamming(ntaps).astype(np.float64)
    half = (ntaps - 1) // 2
    n = np.arange(-half, half + 1, dtype=np.float64)
    fw = 2.0 * np.pi * cutoff / fs
    taps = np.where(n == 0, fw / np.pi,
                    np.sin(n * fw) / np.where(n == 0, 1.0, n * np.pi)) * w
    dc = taps[half] + 2.0 * np.sum(taps[half + 1:])
    return (taps * (gain / dc)).astype(np.float32)


def branch_taps(prototype: np.ndarray, m: int) -> np.ndarray:
    """[W, m] float32 with [w, j] = prototype[j + w·m], zero-padded to a
    whole number of rows."""
    w = -(-len(prototype) // m)
    padded = np.zeros(w * m, np.float32)
    padded[:len(prototype)] = prototype
    return padded.reshape(w, m)
