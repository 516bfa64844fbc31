"""Demodulators: the quadrature (FM/FSK) demodulator.

The port of the quadrature half of ``clenabled_tpu.dsp.demod``:
``quadrature_demod`` replaces clQuadratureDemod
(lib/clQuadratureDemod_impl.cc:108-181), out[i] = gain·arg(x[i]·conj(x[i-1]))
with one sample of history carried between frames (set_history(2), :81).
The Costas loop forms wait for their kernel (ROADMAP.md B.9).
"""

from __future__ import annotations

import torch

from clenabled_tpu_torch.dsp import planar


def quadrature_demod(x, gain: float, last_sample=None):
    """FM discriminator over a frame.

    Args:
      x: [n] complex64 frame.
      gain: demod gain (baked as #define GAIN in the reference kernel).
      last_sample: carried x[-1] of the previous frame (None → first frame
        behaves as if preceded by x[0], producing 0 for the first output).

    Returns: (y, new_last_sample) with y: [n] float32.
    """
    x = torch.as_tensor(x).to(torch.complex64)
    if last_sample is None:
        last_sample = x[..., :1]
    prev = torch.cat([last_sample, x[..., :-1]], dim=-1)
    prod = x * torch.conj(prev)
    y = torch.atan2(prod.imag, prod.real) * gain
    return y, x[..., -1:].clone()


def _qdemod_xla(xr, xi, lr, li, gain: float):
    """The JAX package's XLA form: gain·atan2 of x[i]·conj(x[i-1]) with the
    one-sample shift on sliced views and the carried sample (lr, li)
    [..., 1] at the front."""
    pr_b, pi_b = xr[..., :-1], xi[..., :-1]
    cr = xr[..., 1:] * pr_b + xi[..., 1:] * pi_b
    ci = xi[..., 1:] * pr_b - xr[..., 1:] * pi_b
    ybody = torch.atan2(ci, cr) * gain
    c0r = xr[..., :1] * lr + xi[..., :1] * li
    c0i = xi[..., :1] * lr - xr[..., :1] * li
    y0 = torch.atan2(c0i, c0r) * gain
    return torch.cat([y0, ybody], dim=-1)


def quadrature_demod_planar(x, gain: float, last_sample=None):
    """Planar quadrature demod: x is a planar.PC frame; identical math
    (gain·atan2 of x[i]·conj(x[i-1])), complex-free.  Runs the hand-written
    kernel (``hopper_kernels.qdemod_fused``, any frame length) on CUDA
    tensors and its plain form, the JAX package's XLA form, on the CPU; the
    JAX function's ``use_pallas`` engine selector has no counterpart."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    if last_sample is None:
        last_sample = planar.PC(x.re[..., :1], x.im[..., :1])
    y = hopper_kernels.qdemod_fused(x.re.contiguous(), x.im.contiguous(),
                                    last_sample.re.contiguous(),
                                    last_sample.im.contiguous(), gain)
    return y, planar.PC(x.re[..., -1:].clone(), x.im[..., -1:].clone())
