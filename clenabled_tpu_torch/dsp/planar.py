"""Planar complex arithmetic: complex streams as (re, im) float32 pairs.

The port of ``clenabled_tpu.dsp.planar``.  The fused kernels work on
planar float32 components, so the plain torch forms beside them do too.
FFTs are DFT matmuls written with ``torch.einsum`` (single stage for small
N, two-stage Cooley-Tukey N = N1·N2 otherwise), with the framework's sign
and scale conventions: forward unscaled, inverse unscaled (the reference
forces clFFT's backward scale to 1.0, lib/clFFT_impl.cc:121-122); ``ifft``
is the scaled inverse.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch


class PC(NamedTuple):
    """A planar complex tensor: two same-shape float32 tensors."""
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape


def from_complex(x, device=None) -> PC:
    """Split a complex array or tensor into float32 (re, im) tensors, on
    ``device`` (a tensor's own device by default; the CPU for arrays)."""
    if torch.is_tensor(x):
        dev = x.device if device is None else torch.device(device)
        return PC(x.real.float().to(dev), x.imag.float().to(dev))
    x = np.asarray(x)
    dev = "cpu" if device is None else device
    return PC(torch.as_tensor(x.real.astype(np.float32), device=dev),
              torch.as_tensor(x.imag.astype(np.float32), device=dev))


def to_complex(x: PC) -> torch.Tensor:
    """Join (re, im) into a complex64 tensor on their device."""
    return torch.complex(x.re.float(), x.im.float())


def zeros(shape, *_args, device=None) -> PC:
    """Zero float32 (re, im) of ``shape`` (on the CPU by default); further
    positional arguments are ignored, as JAX's ``planar.zeros`` ignores
    them."""
    return PC(torch.zeros(shape, device=device),
              torch.zeros(shape, device=device))


def add(a: PC, b: PC) -> PC:
    return PC(a.re + b.re, a.im + b.im)


def sub(a: PC, b: PC) -> PC:
    return PC(a.re - b.re, a.im - b.im)


def conj(a: PC) -> PC:
    return PC(a.re, -a.im)


def scale(a: PC, s) -> PC:
    return PC(a.re * s, a.im * s)


def mul(a: PC, b: PC) -> PC:
    return PC(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def mul_conj(a: PC, b: PC) -> PC:
    """a * conj(b) — the correlator primitive (cxmac form)."""
    return PC(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def abs2(a: PC) -> torch.Tensor:
    return a.re * a.re + a.im * a.im


def pabs(a: PC) -> torch.Tensor:
    return torch.sqrt(abs2(a))


def _fft_factors(n: int) -> tuple[int, int]:
    """Split n into two near-sqrt factors (n must be composite for the
    two-stage path; powers of two always are)."""
    best = (1, n)
    for f in range(2, int(math.isqrt(n)) + 1):
        if n % f == 0:
            best = (f, n // f)
    return best


@lru_cache(maxsize=None)
def _dft_np(n: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """(Fr, Fi) for W[k,m] = exp(sign·2πi·k·m/n), float64 then cast."""
    k = np.arange(n)
    ang = sign * 2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """T[k2, n1] = exp(sign·2πi·n1·k2/(n1·n2))."""
    ang = sign * 2.0 * np.pi * np.outer(np.arange(n2), np.arange(n1)) / (n1 * n2)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=None)
def _on(fn, device: torch.device, *args) -> tuple[torch.Tensor, torch.Tensor]:
    """A cached (re, im) constant pair from ``fn(*args)`` on ``device``."""
    fr, fi = fn(*args)
    return (torch.as_tensor(fr, device=device),
            torch.as_tensor(fi, device=device))


def _cmatmul_right(x: PC, fr: torch.Tensor, fi: torch.Tensor) -> PC:
    """y[..., k] = Σ_n F[k,n] x[..., n] as 4 real matmuls."""
    yr = (torch.einsum("...n,kn->...k", x.re, fr)
          - torch.einsum("...n,kn->...k", x.im, fi))
    yi = (torch.einsum("...n,kn->...k", x.re, fi)
          + torch.einsum("...n,kn->...k", x.im, fr))
    return PC(yr, yi)


# Below this size a single dense DFT matmul replaces the two-stage form.
_SINGLE_STAGE_MAX = 256


def fft(x: PC, inverse: bool = False) -> PC:
    """Unscaled DFT along the last axis (inverse = conjugate kernel, still
    unscaled, matching the framework's clFFT convention)."""
    n = x.re.shape[-1]
    sign = 1 if inverse else -1
    dev = x.re.device
    if n <= _SINGLE_STAGE_MAX or _fft_factors(n)[0] == 1:
        return _cmatmul_right(x, *_on(_dft_np, dev, n, sign))
    n1, n2 = _fft_factors(n)
    # x[..., n] with n = N1*m2 + m1  →  x2[..., m2, m1]
    lead = x.re.shape[:-1]
    x2r = x.re.reshape(lead + (n2, n1))
    x2i = x.im.reshape(lead + (n2, n1))
    # stage 1: DFT_N2 over m2 → y[..., k2, m1]
    f2r, f2i = _on(_dft_np, dev, n2, sign)
    yr = (torch.einsum("kn,...nm->...km", f2r, x2r)
          - torch.einsum("kn,...nm->...km", f2i, x2i))
    yi = (torch.einsum("kn,...nm->...km", f2i, x2r)
          + torch.einsum("kn,...nm->...km", f2r, x2i))
    # twiddle: × exp(sign·2πi·m1·k2/N)
    y = mul(PC(yr, yi), PC(*_on(_twiddle_np, dev, n1, n2, sign)))
    # stage 2: DFT_N1 over m1 → X[..., k2, k1]
    f1r, f1i = _on(_dft_np, dev, n1, sign)
    zr = (torch.einsum("kn,...mn->...mk", f1r, y.re)
          - torch.einsum("kn,...mn->...mk", f1i, y.im))
    zi = (torch.einsum("kn,...mn->...mk", f1i, y.re)
          + torch.einsum("kn,...mn->...mk", f1r, y.im))
    # output order k = N2*k1 + k2: [..., k2, k1] → [..., k1, k2] → flat
    return PC(zr.transpose(-1, -2).reshape(x.re.shape),
              zi.transpose(-1, -2).reshape(x.im.shape))


def ifft_unscaled(x: PC) -> PC:
    """Inverse kernel without 1/N — the reference's backward transform
    with scale forced 1.0."""
    return fft(x, inverse=True)


def ifft(x: PC) -> PC:
    """The conventional scaled inverse (1/N), for callers that need numpy's
    semantics."""
    return scale(fft(x, inverse=True), 1.0 / x.re.shape[-1])


def fftshift(x: PC, axis: int = -1) -> PC:
    n = x.re.shape[axis]
    return PC(torch.roll(x.re, n // 2, axis), torch.roll(x.im, n // 2, axis))
