"""Frequency-domain cross-correlator (the clxcorrelate_fft_vcf role).

The port of ``fd_xcorr`` and ``fd_xcorr_planar`` from
``clenabled_tpu.dsp.xcorr``: each signal's spectrum is multiplied by the
conjugate of the reference's (signal 0), inverse transformed with scale
1.0 (lib/clXCorrelate_impl.cc:731) and returned as an fftshifted
magnitude.  The time-domain correlator is not ported yet (ROADMAP.md A.7).
"""

from __future__ import annotations

import torch

from clenabled_tpu_torch.dsp import planar


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
