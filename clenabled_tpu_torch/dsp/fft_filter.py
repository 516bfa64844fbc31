"""Overlap-add fast convolution (FFT filter) with explicit carried tail.

The port of ``clenabled_tpu.dsp.fft_filter``: the reference's
``fft_filter_ccf`` (lib/fft_filter.cc:133-175) and the clFilter
frequency-domain path (lib/clFilter_impl.cc:592-681).  Sizing matches the
reference exactly (lib/fft_filter.cc:77-78):

    fftsize  = 2 * next_pow2(ntaps)
    nsamples = fftsize - ntaps + 1            (samples consumed per chunk)
    tailsize = ntaps - 1                      (carried between calls)

Because ``tailsize < nsamples`` a tail only reaches the next chunk, so a
frame of B chunks is one batched ``torch.fft`` transform pair and the
overlap-add is a shifted add between neighbouring rows; only the final
tail is carried state.  Decimation keeps the frame a multiple of
``lcm(nsamples, decimation)``, so the phase is zero at frame boundaries.

``make_fft_filter_planar`` has a second form, as in JAX: the overlap-save
kernel (``hopper_kernels.ofs_filter_planar``), with the same output
samples but an input-domain tail and the frame quantum of its plan.  JAX
takes it on non-CPU backends; the port takes it when a CUDA card is
visible (``fused=None``), and ``fused=`` forces either form.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.runtime.device import per_device


def compute_sizes(ntaps: int) -> tuple[int, int]:
    """(fftsize, nsamples) per lib/fft_filter.cc:77-78."""
    fftsize = int(2 * (2 ** math.ceil(math.log2(ntaps))))
    return fftsize, fftsize - ntaps + 1


class FftFilterPlan(NamedTuple):
    """Design-time constants (the analogue of the baked clFFT plan +
    pre-transformed taps, lib/fft_filter.cc:40-68).  xformed_taps stays a
    host numpy array; each streaming form uploads it once per device."""
    xformed_taps: np.ndarray  # [fftsize] complex64: FFT of zero-padded taps
    ntaps: int
    fftsize: int
    nsamples: int
    decimation: int


def plan_fft_filter(taps, decimation: int = 1) -> FftFilterPlan:
    taps = np.asarray(taps)
    ntaps = int(taps.shape[-1])
    fftsize, nsamples = compute_sizes(ntaps)
    padded = np.zeros(fftsize, dtype=np.complex64)
    padded[:ntaps] = taps.astype(np.complex64)
    xt = np.fft.fft(padded).astype(np.complex64)
    return FftFilterPlan(xformed_taps=xt, ntaps=ntaps, fftsize=fftsize,
                         nsamples=nsamples, decimation=decimation)


def frame_quantum(plan) -> int:
    """Smallest valid frame length: a multiple of the plan's chunk grain
    whose output count is integral (lcm with the decimation).  Accepts an
    FftFilterPlan or a hopper_kernels.OfsPlan (which exposes .quantum)."""
    base = getattr(plan, "quantum", None) or plan.nsamples
    q = base
    while q % plan.decimation:
        q += base
    return q


def _ofa_filter(x, tail, xformed_taps, *, nsamples, fftsize, ntaps,
                decimation):
    """One frame of overlap-add: (y, new_tail), complex64."""
    nchunks = x.shape[-1] // nsamples
    xb = x.reshape(nchunks, nsamples)
    pad = xb.new_zeros((nchunks, fftsize - nsamples))
    spect = torch.fft.fft(torch.cat([xb, pad], dim=-1), dim=-1)
    z = torch.fft.ifft(spect * xformed_taps, dim=-1)
    tails = z[:, nsamples:]                                 # [nchunks, ntaps-1]
    prev_tails = torch.cat([tail[None, :], tails[:-1]], dim=0)
    body = z[:, :nsamples].clone()
    body[:, : ntaps - 1] += prev_tails
    y = body.reshape(-1)
    if decimation > 1:
        y = y[::decimation]
    return y, tails[-1].clone()


def _ofa_filter_planar(xr, xi, tail_r, tail_i, xformed_taps, **sizes):
    """Planar overlap-add: the complex form on (re, im) pairs — the
    framework's FFT serves here, as the JAX package's matmul DFTs serve a
    backend without complex64."""
    y, t = _ofa_filter(torch.complex(xr, xi), torch.complex(tail_r, tail_i),
                       xformed_taps, **sizes)
    return (y.real.contiguous(), y.imag.contiguous(), t.real.contiguous(),
            t.imag.contiguous())


def make_fft_filter_planar(taps, decimation: int = 1,
                           fused: bool | None = None):
    """Planar streaming filter: (init_state, apply, plan) with
    apply((tail_r, tail_i), frame: planar.PC) → (state, planar.PC).

    fused (the JAX package's ``use_pallas``; default: on when a CUDA card
    is visible) selects the overlap-save kernel
    (``hopper_kernels.ofs_filter_planar``, which runs its ``torch.fft``
    form on CPU tensors); identical output samples, an input-domain tail of
    ``plan.tail_len`` samples and another frame quantum (use
    ``frame_quantum(plan)``).  Taps of fewer than 2 entries always take the
    overlap-add form."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    if fused is None:
        fused = torch.cuda.is_available()
    if fused:
        try:
            oplan = hopper_kernels.OfsPlan(taps)
        except ValueError:
            oplan = None
        if oplan is not None:
            oplan.decimation = decimation
            quantum2 = frame_quantum(oplan)
            tl = oplan.tail_len

            def init_state2(frame_size: int | None = None):
                del frame_size
                z = torch.zeros(tl)
                return (z, z.clone())

            def apply2(state, frame):
                xr, xi = frame.re.contiguous(), frame.im.contiguous()
                if xr.shape[-1] % quantum2:
                    raise ValueError(
                        f"frame length {xr.shape[-1]} must be a multiple of "
                        f"{quantum2}")
                yr, yi = hopper_kernels.ofs_filter_planar(
                    xr, xi, state[0], state[1], oplan, decimation=decimation)
                n = xr.shape[-1]
                return (xr[n - tl:].clone(), xi[n - tl:].clone()), \
                    planar.PC(yr, yi)

            return init_state2, apply2, oplan

    plan = plan_fft_filter(taps, decimation)
    quantum = frame_quantum(plan)
    xformed = per_device(plan.xformed_taps)

    def init_state(frame_size: int | None = None):
        del frame_size
        z = torch.zeros(plan.ntaps - 1)
        return (z, z.clone())

    def apply(state, frame):
        if frame.re.shape[-1] % quantum:
            raise ValueError(
                f"frame length {frame.re.shape[-1]} must be a multiple of "
                f"{quantum}")
        yr, yi, tr, ti = _ofa_filter_planar(
            frame.re, frame.im, state[0], state[1],
            xformed(frame.re.device), nsamples=plan.nsamples,
            fftsize=plan.fftsize, ntaps=plan.ntaps,
            decimation=plan.decimation)
        return (tr, ti), planar.PC(yr, yi)

    return init_state, apply, plan


def make_fft_filter(taps, decimation: int = 1):
    """Streaming overlap-add filter: (init_state, apply, plan).

    apply(tail, frame) -> (new_tail, out).  ``frame`` length must be a
    multiple of ``frame_quantum(plan)``; out has len(frame)/decimation
    samples.
    """
    plan = plan_fft_filter(taps, decimation)
    quantum = frame_quantum(plan)
    xformed = per_device(plan.xformed_taps)

    def init_state(frame_size: int | None = None):
        del frame_size
        return torch.zeros(plan.ntaps - 1, dtype=torch.complex64)

    def apply(tail, frame):
        frame = torch.as_tensor(frame).to(torch.complex64)
        if frame.shape[-1] % quantum:
            raise ValueError(
                f"frame length {frame.shape[-1]} must be a multiple of "
                f"{quantum} (nsamples={plan.nsamples}, decim={decimation})"
            )
        out, new_tail = _ofa_filter(
            frame, tail, xformed(frame.device),
            nsamples=plan.nsamples, fftsize=plan.fftsize,
            ntaps=plan.ntaps, decimation=plan.decimation,
        )
        return new_tail, out

    return init_state, apply, plan


def fft_filter(x, taps, decimation: int = 1):
    """One-shot convenience over a zero initial tail (reference
    ``fft_filter_ccf::filter`` on a fresh object)."""
    init, apply, plan = make_fft_filter(taps, decimation)
    x = torch.as_tensor(x)
    _, y = apply(init().to(x.device), x)
    return y
