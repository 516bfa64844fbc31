"""Elementwise math and conversions.

The port of ``clenabled_tpu.dsp.elementwise``: the reference's generated
one-work-item-per-sample OpenCL kernels (clMathOp, clMathConst,
clComplexToMag/Arg/MagPhase, clMagPhaseToComplex, clLog, clSNR —
lib/cl*_impl.cc) as torch expressions, every op also on planar.PC pairs.
Op codes match include/clenabled/clMathOpTypes.h:11-20.
"""

from __future__ import annotations

import math

import torch

from clenabled_tpu_torch.dsp import planar

# Op codes, parity with include/clenabled/clMathOpTypes.h
MATHOP_MULTIPLY = 1
MATHOP_ADD = 2
MATHOP_SUBTRACT = 3
MATHOP_COMPLEX_CONJUGATE = 4
MATHOP_MULTIPLY_CONJUGATE = 5
MATHOP_LOG10 = 6
MATHOP_LOG = 7
MATHOP_SNR_HELPER = 8
MATHOP_EMPTY = 255        # no-op kernels used for baseline timing
MATHOP_EMPTY_W_COPY = 254

_PLANAR_OPS = {
    MATHOP_MULTIPLY: planar.mul,
    MATHOP_ADD: planar.add,
    MATHOP_SUBTRACT: planar.sub,
    MATHOP_MULTIPLY_CONJUGATE: planar.mul_conj,
}


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a).float()


def math_op(op: int, a, b=None):
    """Two-input (or one-input for conjugate/log) math op by code
    (lib/clMathOp_impl.cc:104-238 kernel codegen)."""
    if isinstance(a, planar.PC):
        if op in _PLANAR_OPS:
            return _PLANAR_OPS[op](a, b)
        if op == MATHOP_COMPLEX_CONJUGATE:
            return planar.conj(a)
        if op in (MATHOP_EMPTY, MATHOP_EMPTY_W_COPY):
            return a
        raise ValueError(f"op {op} undefined for planar input")
    if op == MATHOP_MULTIPLY:
        return a * b
    if op == MATHOP_ADD:
        return a + b
    if op == MATHOP_SUBTRACT:
        return a - b
    if op == MATHOP_COMPLEX_CONJUGATE:
        return torch.conj(a).resolve_conj()
    if op == MATHOP_MULTIPLY_CONJUGATE:
        return a * torch.conj(b)
    if op == MATHOP_LOG10:
        return torch.log10(a)
    if op == MATHOP_LOG:
        return torch.log(a)
    if op == MATHOP_SNR_HELPER:
        return snr_helper(a, b)
    if op in (MATHOP_EMPTY, MATHOP_EMPTY_W_COPY):
        return a
    raise ValueError(f"unknown math op code {op}")


def multiply(a, b):
    return math_op(MATHOP_MULTIPLY, a, b)


def add(a, b):
    return math_op(MATHOP_ADD, a, b)


def subtract(a, b):
    return math_op(MATHOP_SUBTRACT, a, b)


def multiply_conjugate(a, b):
    """a * conj(b) (clMultiplyConjugate)."""
    return math_op(MATHOP_MULTIPLY_CONJUGATE, a, b)


def complex_conjugate(a):
    return math_op(MATHOP_COMPLEX_CONJUGATE, a)


def multiply_const(a, k):
    """Multiply by a scalar.  The reference's complex variant multiplies
    both components by a real float scalar (lib/clMathConst_impl.cc:100-190),
    so a float ``k`` against a complex stream scales it."""
    if isinstance(a, planar.PC):
        return planar.scale(a, k)
    return a * k


def _parts(k):
    """(real, imag) of a scalar constant: a number or a 0-d tensor."""
    if torch.is_tensor(k):
        return (k.real, k.imag) if k.is_complex() else (k, 0.0)
    return (k.real, k.imag) if isinstance(k, complex) else (k, 0.0)


def add_const(a, k):
    if isinstance(a, planar.PC):
        kr, ki = _parts(k)
        return planar.PC(a.re + kr, a.im + ki)
    return a + k


def complex_to_mag(a):
    """sqrt(re²+im²) (lib/clComplexToMag_impl.cc:132-148)."""
    if isinstance(a, planar.PC):
        return planar.pabs(a)
    return torch.abs(a).float()


def complex_to_arg(a):
    """atan2(im, re) (lib/clComplexToArg_impl.cc:132-151)."""
    if isinstance(a, planar.PC):
        return torch.atan2(a.im, a.re).float()
    return torch.angle(a).float()


def complex_to_mag_phase(a):
    """(mag, phase) in one pass (lib/clComplexToMagPhase_impl.cc:143-165)."""
    return complex_to_mag(a), complex_to_arg(a)


def mag_phase_to_complex(mag, phase, planar_out: bool = False):
    """mag·(cos φ + j sin φ) (lib/clMagPhaseToComplex_impl.cc:162-192)."""
    mag, phase = _f32(mag), _f32(phase)
    re, im = mag * torch.cos(phase), mag * torch.sin(phase)
    if planar_out:
        return planar.PC(re, im)
    return torch.complex(re, im)


_LOG2_10_INV = 1.0 / math.log2(10.0)


def log10(a, n: float = 1.0, k: float = 0.0):
    """n·log10(a)+k, computed as (n/log2 10)·log2(a)+k exactly like the
    reference's log2-based kernel (lib/clLog_impl.cc:101-148)."""
    return n * _LOG2_10_INV * torch.log2(_f32(a)) + k


def log(a):
    """Natural log (clLog's MATHOP_LOG variant)."""
    return torch.log(_f32(a))


def snr_helper(a, b, n: float = 1.0, k: float = 0.0):
    """|n·log10(a/b)+k| — fused divide→log→abs (lib/clSNR_impl.cc:99-113)."""
    return torch.abs(n * torch.log10(_f32(a) / _f32(b)) + k)


def char_to_complex(a):
    """Interleaved signed-byte I/Q → complex64 scaled by 1/127
    (lib/clXEngine_impl.cc CharToComplex, byte path)."""
    a = torch.as_tensor(a).to(torch.int8).float() * (1.0 / 127.0)
    pairs = a.reshape(a.shape[:-1] + (-1, 2))
    return torch.complex(pairs[..., 0], pairs[..., 1])
