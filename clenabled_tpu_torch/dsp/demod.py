"""Demodulators: the quadrature (FM/FSK) demodulator and the Costas loop.

The port of ``clenabled_tpu.dsp.demod``:

- ``quadrature_demod`` replaces clQuadratureDemod
  (lib/clQuadratureDemod_impl.cc:108-181), out[i] =
  gain·arg(x[i]·conj(x[i-1])) with one sample of history carried between
  frames (set_history(2), :81).
- ``make_costas_loop{,_planar,_scalar}`` replace clCostasLoop
  (lib/clCostasLoop_impl.cc:151-312).  The loop is sequential by nature;
  all three forms run the same exact recurrence (``_costas_step_planar``)
  through one hand-written kernel (``hopper_kernels.costas_scalar``) on
  the card, and through its per-sample plain form on the CPU.  The
  carried state is a ``CostasState`` of three 0-d float32 tensors.
  The speculative chunk-parallel form (``make_costas_loop_chunked``) is
  not ported yet (ROADMAP.md A.9).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.runtime.device import get_device

TWO_PI = 2.0 * math.pi


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


class CostasState(NamedTuple):
    """phase/freq/error — the reference's persistent device buffers, as
    0-d float32 tensors."""
    phase: torch.Tensor
    freq: torch.Tensor
    error: torch.Tensor


def costas_init(device=None) -> CostasState:
    """A zero state on ``device`` (None: ``cuda:0``, raising when no card
    is visible)."""
    dev = get_device("cuda") if device is None else torch.device(device)
    z = torch.zeros(3, device=dev)
    return CostasState(phase=z[0], freq=z[1], error=z[2])


def costas_gains(loop_bw: float) -> tuple[float, float]:
    """alpha/beta from loop bandwidth, per GR blocks::control_loop
    (critically damped 2nd-order loop; the reference bakes these as
    #defines, lib/clCostasLoop_impl.cc:134-137)."""
    damping = math.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = (4.0 * damping * loop_bw) / denom
    beta = (4.0 * loop_bw * loop_bw) / denom
    return alpha, beta


def _costas_step_planar(order: int, alpha, beta, f_min, f_max):
    """The per-sample recurrence, as the JAX package writes it:
    (carry, (s_r, s_i)) → (carry', (o_r, o_i)) on 0-d float32 tensors.
    alpha, beta, f_min, f_max: 0-d float32 tensors on the samples' device.
    2π divides as a tensor, so every device divides (a scalar divisor may
    become a multiply by its reciprocal).  The kernel rounds each product
    and sum as these separate ops do."""
    two_pi = torch.full_like(alpha, TWO_PI)

    def step(carry, sample):
        phase, freq, _ = carry
        s_r, s_i = sample
        n_r = torch.cos(-phase)
        n_i = torch.sin(-phase)
        o_r = s_r * n_r - s_i * n_i
        o_i = s_r * n_i + s_i * n_r
        if order == 2:
            error = o_r * o_i
        else:
            error = (torch.where(o_r > 0, o_i, -o_i)
                     - torch.where(o_i > 0, o_r, -o_r))
        error = 0.5 * ((error + 1.0).abs() - (error - 1.0).abs())
        freq = freq + beta * error
        phase = phase + freq + alpha * error
        q = phase / two_pi
        phase = torch.where((phase > two_pi) | (phase < -two_pi),
                            (q - torch.trunc(q)) * two_pi, phase)
        freq = torch.minimum(torch.maximum(freq, f_min), f_max)
        return (phase, freq, error), (o_r, o_i)

    return step


def _costas_runner(loop_bw: float, order: int, max_freq: float,
                   min_freq: float):
    """run(state, xr, xi) → (state', o_r, o_i) on the kernel."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    if order not in (2, 4):
        raise ValueError("costas loop order must be 2 or 4")
    alpha, beta = costas_gains(loop_bw)

    def run(state: CostasState, xr, xi):
        o_r, o_i, ph, fr, er = hopper_kernels.costas_scalar(
            xr.contiguous(), xi.contiguous(), state.phase, state.freq,
            state.error, order, alpha, beta, min_freq, max_freq)
        return CostasState(phase=ph, freq=fr, error=er), o_r, o_i

    return run


def make_costas_loop_planar(loop_bw: float, order: int,
                            max_freq: float = 1.0, min_freq: float = -1.0):
    """Planar Costas loop: run(state, frame: planar.PC) → (state',
    planar.PC), the exact recurrence on the kernel (CUDA) or its plain
    form (CPU)."""
    run3 = _costas_runner(loop_bw, order, max_freq, min_freq)

    def run(state: CostasState, frame):
        state, o_r, o_i = run3(state, frame.re, frame.im)
        return state, planar.PC(o_r, o_i)

    return run


def make_costas_loop_scalar(loop_bw: float, order: int,
                            max_freq: float = 1.0, min_freq: float = -1.0):
    """The JAX package's scalar-core form: on the card the same kernel as
    ``make_costas_loop_planar`` (one thread runs the recurrence), so the
    two are one function here.  Its ``chunk`` and ``interpret`` have no
    counterpart."""
    return make_costas_loop_planar(loop_bw, order, max_freq, min_freq)


def make_costas_loop(loop_bw: float, order: int,
                     max_freq: float = 1.0, min_freq: float = -1.0):
    """Per-frame Costas loop over complex64 frames: run(state, frame) →
    (state', out complex64).  order must be 2 or 4 (validated like
    lib/clCostasLoop_impl.cc:67-82).  The frame is split into planar
    components for the kernel; the NCO products are rounded one by one,
    as the JAX package's complex form rounds them to float32."""
    run3 = _costas_runner(loop_bw, order, max_freq, min_freq)

    def run(state: CostasState, frame):
        frame = torch.as_tensor(frame).to(torch.complex64)
        state, o_r, o_i = run3(state, frame.real.float(), frame.imag.float())
        return state, torch.complex(o_r, o_i)

    return run
