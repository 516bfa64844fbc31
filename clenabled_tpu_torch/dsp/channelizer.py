"""Polyphase filterbank channelizer — the critically sampled part.

The port of ``clenabled_tpu.dsp.channelizer`` for R == M (one output
vector per M input samples), the case the FX receive step runs.  Per
output vector i and subfilter j (reference kernel ``filterpfb2``,
lib/clPolyphaseChannelizer_impl.cc:156-167)

    acc[i, j] = Σ_{k ≡ j mod M} taps[k] · in[i·M + T−1 − k]

followed by the batched M-point reverse FFT with scale 1.0.  Padding the
taps to W·M and shifting the stream by δ = W·M − T zeros turns the
commutator into a reshape with reversed lanes and the branch filter into W
shifted multiply-adds over the block axis — no gather.

The oversampled case (R < M) is not ported yet (ROADMAP.md, queue A.5).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from clenabled_tpu_torch.dsp import planar


def _pfb_constants(taps, num_channels: int, ninputs_per_iter: int):
    """(taps_rm [W, M] float32 with taps_rm[w, j] = taps[j + w·M], ntaps)."""
    taps = np.asarray(taps, np.float32)
    ntaps = len(taps)
    m, r = num_channels, ninputs_per_iter
    if r > m:
        raise ValueError("ninputs_per_iter must be <= num_channels")
    nbranch_taps = -(-ntaps // m)  # taps per branch, ceil
    padded = np.zeros(nbranch_taps * m, np.float32)
    padded[:ntaps] = taps
    return padded.reshape(nbranch_taps, m), ntaps


def _as_taps(taps_rm, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(taps_rm, dtype=torch.float32, device=like.device)


def _packed_branch_sums(y: torch.Tensor, hr: torch.Tensor,
                        nout: int) -> torch.Tensor:
    """acc[..., i, ℓ] = Σ_wp hr[wp, ℓ] · y[..., i + wp, ℓ]."""
    acc = hr[0] * y[..., 0:nout, :]
    for wp in range(1, hr.shape[0]):
        acc = acc + hr[wp] * y[..., wp:wp + nout, :]
    return acc


def _branch_sums_critical(comp, taps_rm, m: int, t: int, nout: int):
    """Gather-free branch sums for R == M.

    comp: [..., T-1 + nout·M] float32 → [..., nout, M] float32."""
    taps = _as_taps(taps_rm, comp)
    w = taps.shape[0]
    delta = w * m - t
    xp = F.pad(comp, (delta, 0))[..., : (nout + w - 1) * m]
    y = xp.reshape(comp.shape[:-1] + (nout + w - 1, m)).flip(-1)
    return _packed_branch_sums(y, taps.flip(0), nout)


def _pack_streams(comps, taps_rm, m: int, t: int, nout: int):
    """Lane-pack G parallel streams for the critically sampled PFB.

    comps [G, T-1+nout·M] → (y [nout+W-1, G·M], hr [W, G·M]) such that
    acc[i, g·M+j] = Σ_wp hr[wp, g·M+j] · y[i+wp, g·M+j] equals the branch
    sums of stream g, subfilter j."""
    taps = _as_taps(taps_rm, comps)
    g = comps.shape[0]
    w = taps.shape[0]
    delta = w * m - t
    nblk = nout + w - 1
    xp = F.pad(comps, (delta, 0))[:, : nblk * m]
    y = xp.reshape(g, nblk, m).flip(-1).transpose(0, 1).reshape(nblk, g * m)
    hr = taps.flip(0).repeat(1, g)                     # [W, G*M]
    return y, hr


def _branch_sums_critical_batched(comps, taps_rm, m: int, t: int, nout: int):
    """Lane-packed branch sums for G parallel streams (antennas × re/im):
    comps [G, T-1+nout·M] → [G, nout, M]."""
    g = comps.shape[0]
    y, hr = _pack_streams(comps, taps_rm, m, t, nout)
    acc = _packed_branch_sums(y, hr, nout)
    return acc.reshape(nout, g, m).transpose(0, 1)


def _check_critical(num_channels: int, ninputs_per_iter: int) -> None:
    if ninputs_per_iter != num_channels:
        raise NotImplementedError(
            "only the critically sampled channelizer (R == M) is ported; "
            "the oversampled path is queued in ROADMAP.md (A.5)")


def _channelize(x, taps_rm, ch_map, i_offset=0, *, num_channels,
                ninputs_per_iter, ntaps):
    """x: [..., T-1 + buf_items] complex64 (history at the front) →
    [..., buf_items/M, len(ch_map)] complex64."""
    del i_offset  # the rotation phase matters only for R < M
    _check_critical(num_channels, ninputs_per_iter)
    m = num_channels
    nout = (x.shape[-1] - (ntaps - 1)) // m
    acc = torch.complex(
        _branch_sums_critical(x.real.float(), taps_rm, m, ntaps, nout),
        _branch_sums_critical(x.imag.float(), taps_rm, m, ntaps, nout))
    # batched reverse FFT, scale forced 1.0 (clFFT BACKWARD with scale=1)
    z = torch.fft.ifft(acc, dim=-1) * m
    return z[..., ch_map].to(torch.complex64)


def _channelize_planar(x: planar.PC, taps_rm, ch_map, i_offset=0, *,
                       num_channels, ninputs_per_iter, ntaps) -> planar.PC:
    """Planar-complex channelize: x is a planar.PC of [..., T-1+buf]
    streams; the reverse FFT is the unscaled inverse DFT matmul."""
    del i_offset
    _check_critical(num_channels, ninputs_per_iter)
    m = num_channels
    nout = (x.re.shape[-1] - (ntaps - 1)) // m
    acc = planar.PC(_branch_sums_critical(x.re, taps_rm, m, ntaps, nout),
                    _branch_sums_critical(x.im, taps_rm, m, ntaps, nout))
    z = planar.ifft_unscaled(acc)
    return planar.PC(z.re[..., ch_map], z.im[..., ch_map])
