"""Time- and frequency-domain cross-correlators.

The port of ``clenabled_tpu.dsp.xcorr``.

- ``td_xcorr`` replaces clXCorrelate's lag-scan kernel
  (lib/clXCorrelate_impl.cc:843-903): the normalized cross-correlation of
  magnitude sequences over lags [-max_shift, max_shift), one value a lag,
      corr[l] = sum(x·y over the overlap) / sqrt(sum x² · sum y²),
  with -2.0 where the denominator is zero, and the lag of the first
  maximum.  As in JAX, one FFT cross-correlation gives every lag's
  numerator, prefix sums give every lag's window energies, and the
  reference's max-reduction (find_max, :1011-1068) is an argmax.  The
  batched forms transform every window of every signal in one call and
  take one cumsum over them all.
- ``fd_xcorr`` replaces clxcorrelate_fft_vcf: each signal's spectrum times
  the conjugate of the reference's (signal 0), inverse transformed with
  scale 1.0 (lib/clXCorrelate_impl.cc:731) and returned as an fftshifted
  magnitude.

The planar forms run the transforms as ``planar.fft``'s DFT matmuls, with
TF32 off on the card.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from clenabled_tpu_torch.dsp import planar


class XCorrResult(NamedTuple):
    """The PDU payload of clXCorrelate (:1594-1601): per non-reference
    signal, the best correlation and the corrective lag."""
    corr: torch.Tensor            # [nsignals-1, ...] float32: max correlation
    lag: torch.Tensor             # [nsignals-1, ...] int32: lag index - max_shift
    corr_vectors: torch.Tensor    # [nsignals-1, ..., 2*max_shift] full scans


def _mag(x) -> torch.Tensor:
    """Reference semantics: complex input → |x|; float input used as-is
    (lib/clXCorrelate_impl.cc:1483-1489)."""
    x = torch.as_tensor(x)
    if x.is_complex():
        return torch.abs(x).float()
    return x.float()


def _fft_len(n: int, max_shift: int) -> int:
    """The least power of two >= n + max_shift."""
    p = 1
    while p < n + max_shift:
        p <<= 1
    return p


@lru_cache(maxsize=None)
def _lag_index(n: int, max_shift: int, device: torch.device):
    """The scan's gather indices on ``device``, each over the lags g -
    max_shift: (num [2·max_shift], x [2, 2·max_shift], y [2, 2·max_shift]).

    The numerator of lag > 0 is cc[shift], of lag <= 0 cc[p - |shift|]
    (lag 0: cc[0]).  The window energies (reference :875-888) come from
    the prefix sums c (a leading 0) as c[hi] - c[lo], rows x and y:
      shift > 0:  sum xx[s:] = cx[n] - cx[s],  sum yy[:n-s] = cy[n-s] - cy[0]
      shift <= 0: sum xx[:n-s] = cx[n-s] - cx[0],  sum yy[s:] = cy[n] - cy[s]
    Indices follow JAX's gather: a negative one counts from the end, and
    what is still out of range is clamped (max_shift > n)."""
    p = _fft_len(n, max_shift)
    shift = np.arange(2 * max_shift) - max_shift
    pos = shift > 0
    s = np.abs(shift)

    def jax_index(i):
        return np.clip(np.where(i < 0, i + n + 1, i), 0, n)

    num = np.where(pos, shift, np.where(s == 0, 0, p - s))
    x = np.stack([np.where(pos, n, jax_index(n - s)),
                  np.where(pos, jax_index(s), 0)])
    y = np.stack([np.where(pos, jax_index(n - s), n),
                  np.where(pos, 0, jax_index(s))])
    return tuple(torch.as_tensor(i, device=device) for i in (num, x, y))


def _scan(mags: torch.Tensor, max_shift: int, use_planar: bool) -> torch.Tensor:
    """The normalized lag scan of mags[1:] against mags[0]: mags [nsig,
    ..., n] float32 → [nsig-1, ..., 2*max_shift] float32, lags g -
    max_shift for g in range."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    n = mags.shape[-1]
    p = _fft_len(n, max_shift)
    num_i, x_i, y_i = _lag_index(n, max_shift, mags.device)
    # every lag's numerator from one FFT cross-correlation:
    # cc[l] = sum_i ref[i+l]·sig[i] (mod p)
    if use_planar:
        padded = F.pad(mags, (0, p - n))
        with hopper_kernels._full_f32():
            f = planar.fft(planar.PC(padded, torch.zeros_like(padded)))
            cc = planar.ifft(planar.mul_conj(
                planar.PC(f.re[0], f.im[0]),
                planar.PC(f.re[1:], f.im[1:]))).re
    else:
        f = torch.fft.rfft(mags, n=p, dim=-1)
        cc = torch.fft.irfft(f[0] * torch.conj(f[1:]), n=p, dim=-1)
    # inclusive prefix sums with a leading 0: c[k] = sum of the first k
    c = F.pad(torch.cumsum(mags * mags, dim=-1), (1, 0))
    ex, ey = c[0][..., x_i], c[1:][..., y_i]
    denom = (ex[..., 0, :] - ex[..., 1, :]) * (ey[..., 0, :] - ey[..., 1, :])
    return torch.where(denom != 0.0, cc[..., num_i] * torch.rsqrt(denom), -2.0)


def _result(scan: torch.Tensor, max_shift: int) -> XCorrResult:
    best = torch.argmax(scan, dim=-1)          # the first maximum
    return XCorrResult(
        corr=torch.gather(scan, -1, best[..., None])[..., 0],
        lag=(best - max_shift).to(torch.int32),
        corr_vectors=scan)


def td_xcorr(signals, max_shift: int) -> XCorrResult:
    """Correlate signals[1:] against signals[0].

    Args:
      signals: [nsignals, ..., signal_length] complex64 or float32; any
        middle dims (such as B analysis windows) are batched.
      max_shift: lag half-range (forced pow2 by the reference, :739-745 —
        not required here).

    Returns an XCorrResult with leading [nsignals-1, ...] dims.
    """
    return _result(_scan(_mag(signals), max_shift, False), max_shift)


def td_xcorr_planar(mags, max_shift: int) -> XCorrResult:
    """Complex-free td_xcorr over magnitude (or real float) sequences
    [nsignals, ..., n]; for complex streams, take planar.pabs first."""
    return _result(_scan(torch.as_tensor(mags).float(), max_shift, True),
                   max_shift)


# Many analysis windows a call ([nsignals, B, n] → leading [nsignals-1, B]
# dims): the lag scan already batches over every middle dim.
td_xcorr_batched = td_xcorr
td_xcorr_planar_batched = td_xcorr_planar


def fd_xcorr_planar(vectors: planar.PC,
                    perform_fft_first: bool = False) -> torch.Tensor:
    """vectors: planar.PC of [nsignals, ..., fft_size] → [nsignals-1, ...,
    fft_size] float32 fftshifted correlation magnitudes."""
    v = vectors
    if perform_fft_first:
        v = planar.fft(v)
    n = v.re.shape[-1]
    ref = planar.PC(v.re[0], v.im[0])
    sig = planar.PC(v.re[1:], v.im[1:])
    mag = planar.pabs(planar.ifft_unscaled(planar.mul_conj(ref, sig)))
    return torch.roll(mag, n // 2, dims=-1)  # fftshift


def fd_xcorr(vectors: torch.Tensor,
             perform_fft_first: bool = False) -> torch.Tensor:
    """vectors: [nsignals, ..., fft_size] complex64 spectra (or raw series
    with perform_fft_first) → [nsignals-1, ..., fft_size] float32."""
    v = vectors.to(torch.complex64)
    if perform_fft_first:
        v = torch.fft.fft(v, dim=-1)
    n = v.shape[-1]
    prod = v[0] * torch.conj(v[1:])
    z = torch.fft.ifft(prod, dim=-1) * n   # reverse scale forced 1.0
    return torch.fft.fftshift(torch.abs(z).float(), dim=-1)
