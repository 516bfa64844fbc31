"""The fused FX step, plainly: channelizer, FD cross-correlation, Gram.

Per antenna the critically sampled polyphase channelizer of
clPolyphaseChannelizer (M channels, W·M taps, the kernel ``filterpfb2``)

    acc[i, j] = Σ_{k ≡ j mod M} taps[k] · x[i·M + W·M − 1 − k]
    z[i, c]   = Σ_j acc[i, j] · exp(+2πi·j·c/M)        (unscaled inverse)

then, for each FD pair (p, q), the lag spectrum of z_p · conj(z_q) (the
same unscaled inverse transform), its magnitude averaged over the frame's
N/M vectors and rolled by M/2 (clxcorrelate_fft_vcf), and for each Gram
baseline (s, u) the sum over the frame of z_s · conj(z_u) (clXEngine, one
polarisation).

The step's input is the stream delayed by a fixed latency: the last H
samples of the previous frame (zeros before the first) followed by the
frame, of which the first W·M − 1 + N samples are used.  H is the step's
documented carried tail: 8, 16 or 32 rows of 128 samples for 4-, 2- and
1-byte ingest, doubled until it covers the tap reach (``tail_len``).

All arithmetic is in ``dtype`` (float64 for the judge).  ``rnd``, when
given, rounds the operands of every product first: the control passes
``round_tf32`` with float32.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128
_TAIL_ROWS = {4: 8, 2: 16, 1: 32}


def tail_len(elem_bytes: int, m: int, ntaps: int) -> int:
    rows = _TAIL_ROWS[elem_bytes]
    need = ((-(-ntaps // m) - 1) * m) // LANES + 2
    while rows < need:
        rows *= 2
    return rows * LANES


def _dft(m: int, dtype, device, rnd):
    ang = 2.0 * np.pi * np.outer(np.arange(m), np.arange(m)) / m
    c = torch.as_tensor(np.cos(ang), dtype=dtype, device=device)
    s = torch.as_tensor(np.sin(ang), dtype=dtype, device=device)
    return rnd(c), rnd(s)


def _idft(re, im, c, s, rnd):
    """Unscaled inverse DFT over the last axis: (re + i·im) · (c + i·s)."""
    re, im = rnd(re), rnd(im)
    return re @ c - im @ s, re @ s + im @ c


def fx_step(frame_r, frame_i, prev_r, prev_i, taps_rm, tail: int,
            fd_pairs, xe_pairs, *, dtype=torch.float64, rnd=None,
            chunk: int = 1 << 16):
    """One step's answers: (fd [nfd, M], gram_re [nb, M], gram_im [nb, M])
    in ``dtype``.  frame_* [A, N] (any real dtype) on the device the work
    runs on; prev_* the previous frame, or None for the first step;
    taps_rm [W, M] float32 (NumPy); pairs as lists of (p, q)."""
    rnd = rnd or (lambda x: x)
    a, n = frame_r.shape
    dev = frame_r.device
    taps = rnd(torch.as_tensor(taps_rm, device=dev).to(dtype))
    w, m = taps.shape
    nout = n // m
    cos, sin = _dft(m, dtype, dev, rnd)

    def stream(frame, prev):
        head = (torch.zeros((a, tail), dtype=frame.dtype, device=dev)
                if prev is None else prev[:, n - tail:])
        return torch.cat([head, frame], -1)[:, : w * m - 1 + n]

    v = torch.stack([stream(frame_r, prev_r), stream(frame_i, prev_i)])
    fd_sum = torch.zeros((len(fd_pairs), m), dtype=dtype, device=dev)
    g_re = torch.zeros((len(xe_pairs), m), dtype=dtype, device=dev)
    g_im = torch.zeros_like(g_re)
    for i0 in range(0, nout, chunk):
        i1 = min(nout, i0 + chunk)
        rows = i1 - i0 + w - 1
        # u[.., r, j] = x[(i0 + r)·M + M − 1 − j]: a commutator row, lanes
        # reversed, so that acc[i, j] = Σ_w taps[w, j] · u[i − i0 + W−1−w, j]
        u = rnd(v[..., i0 * m:(i0 + rows) * m].to(dtype)
                .reshape(2, a, rows, m).flip(-1))
        acc = taps[0] * u[:, :, w - 1:w - 1 + i1 - i0]
        for k in range(1, w):
            acc = acc + taps[k] * u[:, :, w - 1 - k:w - 1 - k + i1 - i0]
        zr, zi = _idft(acc[0], acc[1], cos, sin, rnd)   # [A, C, M]
        zr, zi = rnd(zr), rnd(zi)
        for p, (s, q) in enumerate(fd_pairs):
            pr = zr[s] * zr[q] + zi[s] * zi[q]
            pi = zi[s] * zr[q] - zr[s] * zi[q]
            lr, li = _idft(pr, pi, cos, sin, rnd)
            fd_sum[p] += torch.sqrt(lr * lr + li * li).sum(0)
        for b, (s, q) in enumerate(xe_pairs):
            g_re[b] += (zr[s] * zr[q] + zi[s] * zi[q]).sum(0)
            g_im[b] += (zi[s] * zr[q] - zr[s] * zi[q]).sum(0)
    fd = torch.roll(fd_sum / nout, m // 2, dims=-1)
    return fd, g_re, g_im
