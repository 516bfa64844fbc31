"""FIR filter designers (parity with lib/firdes.{h,cc} of the reference).

Windowed-sinc designers with GNU Radio's normalization conventions:
low/high/band-pass, band-reject (and their ``_2`` explicit-attenuation
variants), complex band-pass, Hilbert, root-raised-cosine and Gaussian
(lib/firdes.h:75-340).  Host-side NumPy — tap design runs once at block
construction.  A copy of ``clenabled_tpu.dsp.firdes``: importing the JAX
package would import jax.

Tap counts follow the harris approximation
``ntaps = atten_dB * fs / (22 * transition_width)`` forced odd
(lib/firdes.cc:662-686), with the attenuation implied by the window type for
the plain variants and explicit for ``*_2``.
"""

from __future__ import annotations

import numpy as np

from clenabled_tpu_torch.dsp import window as win

# Re-export window-type codes so callers can say firdes.WIN_HAMMING.
WIN_NONE = win.WIN_NONE
WIN_HAMMING = win.WIN_HAMMING
WIN_HANN = win.WIN_HANN
WIN_BLACKMAN = win.WIN_BLACKMAN
WIN_RECTANGULAR = win.WIN_RECTANGULAR
WIN_KAISER = win.WIN_KAISER
WIN_BLACKMAN_HARRIS = win.WIN_BLACKMAN_HARRIS
WIN_BARTLETT = win.WIN_BARTLETT
WIN_FLATTOP = win.WIN_FLATTOP


def window(wintype: int, ntaps: int, beta: float) -> np.ndarray:
    return win.build(wintype, ntaps, beta)


def compute_ntaps(sampling_freq: float, transition_width: float,
                  window_type: int, beta: float = 6.76) -> int:
    a = win.max_attenuation(window_type, beta)
    ntaps = int(a * sampling_freq / (22.0 * transition_width))
    return ntaps + 1 if ntaps % 2 == 0 else ntaps


def compute_ntaps_windes(sampling_freq: float, transition_width: float,
                         attenuation_db: float) -> int:
    ntaps = int(attenuation_db * sampling_freq / (22.0 * transition_width))
    return ntaps + 1 if ntaps % 2 == 0 else ntaps


def _sanity_1f(fs, fc, tw):
    if fs <= 0:
        raise ValueError("firdes: sampling frequency must be > 0")
    if fc <= 0 or fc > fs / 2:
        raise ValueError("firdes: cutoff must be in (0, fs/2]")
    if tw <= 0:
        raise ValueError("firdes: transition width must be > 0")


def _sanity_2f(fs, f_lo, f_hi, tw, complex_ok=False):
    if fs <= 0:
        raise ValueError("firdes: sampling frequency must be > 0")
    lo_bound = -fs / 2 if complex_ok else 0
    if f_lo <= lo_bound or f_lo > fs / 2:
        raise ValueError("firdes: low cutoff out of range")
    if f_hi <= f_lo:
        raise ValueError("firdes: high cutoff must be > low cutoff")
    if tw <= 0:
        raise ValueError("firdes: transition width must be > 0")


def _low_pass_taps(gain, fs, fc, ntaps, wintype, beta):
    w = win.build(wintype, ntaps, beta).astype(np.float64)
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    fw = 2.0 * np.pi * fc / fs
    taps = np.where(n == 0, fw / np.pi, np.sin(n * fw) / np.where(n == 0, 1.0, n * np.pi)) * w
    # normalize so gain at DC == `gain`
    fmax = taps[m] + 2.0 * np.sum(taps[m + 1:])
    return (taps * (gain / fmax)).astype(np.float32)


def low_pass(gain, sampling_freq, cutoff_freq, transition_width,
             window_type: int = WIN_HAMMING, beta: float = 6.76) -> np.ndarray:
    _sanity_1f(sampling_freq, cutoff_freq, transition_width)
    ntaps = compute_ntaps(sampling_freq, transition_width, window_type, beta)
    return _low_pass_taps(gain, sampling_freq, cutoff_freq, ntaps, window_type, beta)


def low_pass_2(gain, sampling_freq, cutoff_freq, transition_width,
               attenuation_db, window_type: int = WIN_HAMMING,
               beta: float = 6.76) -> np.ndarray:
    _sanity_1f(sampling_freq, cutoff_freq, transition_width)
    ntaps = compute_ntaps_windes(sampling_freq, transition_width, attenuation_db)
    return _low_pass_taps(gain, sampling_freq, cutoff_freq, ntaps, window_type, beta)


def _high_pass_taps(gain, fs, fc, ntaps, wintype, beta):
    w = win.build(wintype, ntaps, beta).astype(np.float64)
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    fw = 2.0 * np.pi * fc / fs
    taps = np.where(n == 0, 1.0 - fw / np.pi,
                    -np.sin(n * fw) / np.where(n == 0, 1.0, n * np.pi)) * w
    # normalize so gain at fs/2 == `gain`
    k = np.arange(1, m + 1, dtype=np.float64)
    fmax = taps[m] + 2.0 * np.sum(taps[m + 1:] * np.cos(k * np.pi))
    return (taps * (gain / fmax)).astype(np.float32)


def high_pass(gain, sampling_freq, cutoff_freq, transition_width,
              window_type: int = WIN_HAMMING, beta: float = 6.76) -> np.ndarray:
    _sanity_1f(sampling_freq, cutoff_freq, transition_width)
    ntaps = compute_ntaps(sampling_freq, transition_width, window_type, beta)
    return _high_pass_taps(gain, sampling_freq, cutoff_freq, ntaps, window_type, beta)


def high_pass_2(gain, sampling_freq, cutoff_freq, transition_width,
                attenuation_db, window_type: int = WIN_HAMMING,
                beta: float = 6.76) -> np.ndarray:
    _sanity_1f(sampling_freq, cutoff_freq, transition_width)
    ntaps = compute_ntaps_windes(sampling_freq, transition_width, attenuation_db)
    return _high_pass_taps(gain, sampling_freq, cutoff_freq, ntaps, window_type, beta)


def _band_pass_taps(gain, fs, f_lo, f_hi, ntaps, wintype, beta):
    w = win.build(wintype, ntaps, beta).astype(np.float64)
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    fw0 = 2.0 * np.pi * f_lo / fs
    fw1 = 2.0 * np.pi * f_hi / fs
    safe_n = np.where(n == 0, 1.0, n)
    taps = np.where(n == 0, (fw1 - fw0) / np.pi,
                    (np.sin(n * fw1) - np.sin(n * fw0)) / (safe_n * np.pi)) * w
    # normalize so gain at band center == `gain`
    k = np.arange(1, m + 1, dtype=np.float64)
    fmax = taps[m] + 2.0 * np.sum(taps[m + 1:] * np.cos(k * (fw0 + fw1) * 0.5))
    return (taps * (gain / fmax)).astype(np.float32)


def band_pass(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
              transition_width, window_type: int = WIN_HAMMING,
              beta: float = 6.76) -> np.ndarray:
    _sanity_2f(sampling_freq, low_cutoff_freq, high_cutoff_freq, transition_width)
    ntaps = compute_ntaps(sampling_freq, transition_width, window_type, beta)
    return _band_pass_taps(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                           ntaps, window_type, beta)


def band_pass_2(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                transition_width, attenuation_db,
                window_type: int = WIN_HAMMING, beta: float = 6.76) -> np.ndarray:
    _sanity_2f(sampling_freq, low_cutoff_freq, high_cutoff_freq, transition_width)
    ntaps = compute_ntaps_windes(sampling_freq, transition_width, attenuation_db)
    return _band_pass_taps(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                           ntaps, window_type, beta)


def _complex_band_pass_taps(gain, fs, f_lo, f_hi, ntaps, wintype, beta):
    lp = _low_pass_taps(gain, fs, (f_hi - f_lo) / 2.0, ntaps, wintype, beta).astype(np.float64)
    freq = np.pi * (f_hi + f_lo) / fs
    if ntaps % 2 == 1:
        phase0 = -freq * (ntaps >> 1)
    else:
        phase0 = -freq / 2.0 * ((1 + 2 * ntaps) >> 1)
    phases = phase0 + freq * np.arange(ntaps)
    return (lp * (np.cos(phases) + 1j * np.sin(phases))).astype(np.complex64)


def complex_band_pass(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                      transition_width, window_type: int = WIN_HAMMING,
                      beta: float = 6.76) -> np.ndarray:
    _sanity_2f(sampling_freq, low_cutoff_freq, high_cutoff_freq,
               transition_width, complex_ok=True)
    ntaps = compute_ntaps(sampling_freq, transition_width, window_type, beta)
    return _complex_band_pass_taps(gain, sampling_freq, low_cutoff_freq,
                                   high_cutoff_freq, ntaps, window_type, beta)


def complex_band_pass_2(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                        transition_width, attenuation_db,
                        window_type: int = WIN_HAMMING,
                        beta: float = 6.76) -> np.ndarray:
    _sanity_2f(sampling_freq, low_cutoff_freq, high_cutoff_freq,
               transition_width, complex_ok=True)
    ntaps = compute_ntaps_windes(sampling_freq, transition_width, attenuation_db)
    return _complex_band_pass_taps(gain, sampling_freq, low_cutoff_freq,
                                   high_cutoff_freq, ntaps, window_type, beta)


def _band_reject_taps(gain, fs, f_lo, f_hi, ntaps, wintype, beta):
    w = win.build(wintype, ntaps, beta).astype(np.float64)
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    fw0 = 2.0 * np.pi * f_lo / fs
    fw1 = 2.0 * np.pi * f_hi / fs
    safe_n = np.where(n == 0, 1.0, n)
    taps = np.where(n == 0, 1.0 + (fw0 - fw1) / np.pi * w,
                    (np.sin(n * fw0) - np.sin(n * fw1)) / (safe_n * np.pi) * w)
    # normalize so gain at DC == `gain`
    fmax = taps[m] + 2.0 * np.sum(taps[m + 1:])
    return (taps * (gain / fmax)).astype(np.float32)


def band_reject(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                transition_width, window_type: int = WIN_HAMMING,
                beta: float = 6.76) -> np.ndarray:
    _sanity_2f(sampling_freq, low_cutoff_freq, high_cutoff_freq, transition_width)
    ntaps = compute_ntaps(sampling_freq, transition_width, window_type, beta)
    return _band_reject_taps(gain, sampling_freq, low_cutoff_freq,
                             high_cutoff_freq, ntaps, window_type, beta)


def band_reject_2(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                  transition_width, attenuation_db,
                  window_type: int = WIN_HAMMING, beta: float = 6.76) -> np.ndarray:
    _sanity_2f(sampling_freq, low_cutoff_freq, high_cutoff_freq, transition_width)
    ntaps = compute_ntaps_windes(sampling_freq, transition_width, attenuation_db)
    return _band_reject_taps(gain, sampling_freq, low_cutoff_freq,
                             high_cutoff_freq, ntaps, window_type, beta)


def hilbert(ntaps: int, window_type: int = WIN_RECTANGULAR,
            beta: float = 6.76) -> np.ndarray:
    if ntaps % 2 == 0:
        raise ValueError("hilbert: must have odd number of taps")
    w = win.build(window_type, ntaps, beta).astype(np.float64)
    h = (ntaps - 1) // 2
    taps = np.zeros(ntaps, dtype=np.float64)
    gain = 0.0
    for i in range(1, h + 1):
        if i % 2 == 1:
            x = 1.0 / i
            taps[h + i] = x * w[h + i]
            taps[h - i] = -x * w[h - i]
            gain = taps[h + i] - gain
    gain = 2.0 * abs(gain)
    return (taps / gain).astype(np.float32)


def root_raised_cosine(gain, sampling_freq, symbol_rate, alpha,
                       ntaps: int) -> np.ndarray:
    """RRC pulse-shaping taps (lib/firdes.cc root_raised_cosine)."""
    ntaps |= 1  # force odd
    spb = sampling_freq / symbol_rate
    taps = np.zeros(ntaps, dtype=np.float64)
    for i in range(ntaps):
        xindx = i - ntaps // 2
        x1 = np.pi * xindx / spb
        x2 = 4.0 * alpha * xindx / spb
        x3 = x2 * x2 - 1.0
        if abs(x3) >= 1e-6:
            if i != ntaps // 2:
                num = np.cos((1 + alpha) * x1) + np.sin((1 - alpha) * x1) / (
                    4 * alpha * xindx / spb)
            else:
                num = np.cos((1 + alpha) * x1) + (1 - alpha) * np.pi / (4 * alpha)
            den = x3 * np.pi
        else:
            if alpha == 1:
                taps[i] = -1.0
                continue
            x3 = (1 - alpha) * x1
            x2 = (1 + alpha) * x1
            num = (np.sin(x2) * (1 + alpha) * np.pi
                   - np.cos(x3) * ((1 - alpha) * np.pi * spb) / (4 * alpha * xindx)
                   + np.sin(x3) * spb * spb / (4 * alpha * xindx * xindx))
            den = -32.0 * np.pi * alpha * alpha * xindx / spb
        taps[i] = 4.0 * alpha * num / den
    scale = np.sum(taps)
    return (taps * gain / scale).astype(np.float32)


def gaussian(gain, spb, bt, ntaps: int) -> np.ndarray:
    """Gaussian pulse-shaping taps (lib/firdes.cc gaussian)."""
    dt = 1.0 / spb
    s = 1.0 / (np.sqrt(np.log(2.0)) / (2 * np.pi * bt))
    t = (np.arange(ntaps, dtype=np.float64) + 1.0) - 0.5 * ntaps
    ts = s * dt * t
    taps = np.exp(-0.5 * ts * ts)
    return (taps / np.sum(taps) * gain).astype(np.float32)
