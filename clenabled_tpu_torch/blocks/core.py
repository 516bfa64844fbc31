"""Core blocks: source, FFT, elementwise math, conversions, custom kernels.

The port of ``clenabled_tpu.blocks.core``.  On a CUDA Runner a planar
``Fft`` of a covered size runs the hand-written FFT kernel
(``hopper_kernels.fft_batched_fused``), as the JAX block takes its fused
kernel on a TPU.  ``Kernel1To1`` and ``Kernel2To1`` take a user torch
callable where the JAX blocks take a JAX one.
"""

from __future__ import annotations

import importlib.util
from typing import Callable

import numpy as np
import torch

from clenabled_tpu_torch.blocks._legacy import strip_legacy_kwargs
from clenabled_tpu_torch.dsp import elementwise as ew
from clenabled_tpu_torch.dsp import fft as dsp_fft
from clenabled_tpu_torch.dsp import planar as pl_mod
from clenabled_tpu_torch.dsp import siggen
from clenabled_tpu_torch.runtime.device import per_device
from clenabled_tpu_torch.streaming.block import Block


class SignalSource(Block):
    """clSignalSource (lib/clSignalSource_impl.cc): sin/cos source with
    carried phase.  dtype complex64/float32/int32 per the reference's
    DTYPE_COMPLEX/FLOAT/INT variants; planar=True emits planar.PC frames.
    Frames come out on the Runner's device (the state's)."""

    n_inputs = 0
    n_outputs = 1

    def __init__(self, samp_rate: float, waveform: int, freq: float,
                 amplitude: float, frame_size: int = 8192,
                 dtype=torch.complex64, planar: bool = False, name: str = "",
                 **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.source_frame = frame_size
        self._params = dict(samp_rate=samp_rate, waveform=waveform,
                            amplitude=amplitude, frame_size=frame_size,
                            dtype=dtype, planar=planar)
        self._frequency = freq
        self._build()

    def _build(self):
        p = self._params
        self._init, self._gen = siggen.make_signal_source(
            p["samp_rate"], p["waveform"], self._frequency, p["amplitude"],
            p["frame_size"], dtype=p["dtype"], planar=p["planar"],
            device="cpu")

    def frequency(self) -> float:
        return self._frequency

    def set_frequency(self, freq: float) -> None:
        """Runtime retune (lib/clSignalSource_impl.cc:250-258).  Rebuilds
        the phase ramp; the carried phase in the Runner's state stays valid,
        so the waveform is phase-continuous at the retune (inside a running
        flowgraph call ``Runner.refresh()`` after it)."""
        self._frequency = freq
        self._build()

    def init_state(self):
        """A zero phase on the CPU; the Runner moves it to its device."""
        return self._init()

    def apply(self, state, inputs):
        state, frame = self._gen(state)
        return state, (frame,), {}


class Fft(Block):
    """clFFT (lib/clFFT_impl.cc): stream→stream FFT over fft_size vectors
    with window taps and shift semantics.  ``num_streams`` gives the block
    N parallel in/out ports, each transformed like the reference's
    multi-stream loop (lib/clFFT_impl.cc:537).  A planar.PC stream stays
    planar; ``planar=True`` also splits a complex64 stream into planar.PC
    pairs, so the block always emits the planar form.  ``use_pallas``
    routes planar streams as ``dsp.fft.fft_stream_planar`` does ("auto":
    the kernel when a card is visible and the size is covered)."""

    stateless = True

    def __init__(self, fft_size: int, direction: int = dsp_fft.FORWARD,
                 window=None, shift: bool = False, num_streams: int = 1,
                 name: str = "", use_pallas: bool | str = "auto",
                 planar: bool = False, **legacy):
        strip_legacy_kwargs(legacy, self)
        if window is not None and len(window) != fft_size:
            raise ValueError("window length must equal fft_size")
        self.name = name
        self.fft_size = fft_size
        self.direction = direction
        self.window = (None if window is None
                       else np.asarray(window, np.float32))
        self._window_on = None if window is None else per_device(self.window)
        self.shift = shift
        self.quantum = fft_size
        self.n_inputs = num_streams
        self.n_outputs = num_streams
        self.use_pallas = use_pallas
        self.planar = planar

    def apply(self, state, inputs):
        def one(x):
            if self.planar and not isinstance(x, pl_mod.PC):
                x = pl_mod.PC(x.real.contiguous(), x.imag.contiguous())
            planar_in = isinstance(x, pl_mod.PC)
            dev = (x.re if planar_in else x).device
            win = None if self._window_on is None else self._window_on(dev)
            if planar_in:
                return dsp_fft.fft_stream_planar(
                    x, self.fft_size, direction=self.direction, window=win,
                    shift=self.shift, use_pallas=self.use_pallas)
            return dsp_fft.fft_stream(x, self.fft_size,
                                      direction=self.direction, window=win,
                                      shift=self.shift)

        return state, tuple(one(x) for x in inputs), {}


class MathOp(Block):
    """clMathOp (lib/clMathOp_impl.cc): elementwise op by clMathOpTypes
    code."""

    stateless = True

    def __init__(self, op: int, name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.op = op
        self.n_inputs = 1 if op in (
            ew.MATHOP_COMPLEX_CONJUGATE, ew.MATHOP_LOG, ew.MATHOP_LOG10,
            ew.MATHOP_EMPTY, ew.MATHOP_EMPTY_W_COPY,
        ) else 2

    def apply(self, state, inputs):
        return state, (ew.math_op(self.op, *inputs),), {}


def Multiply(name: str = "multiply", **legacy):
    return MathOp(ew.MATHOP_MULTIPLY, name=name, **legacy)


def Add(name: str = "add", **legacy):
    return MathOp(ew.MATHOP_ADD, name=name, **legacy)


def Subtract(name: str = "subtract", **legacy):
    return MathOp(ew.MATHOP_SUBTRACT, name=name, **legacy)


def MultiplyConjugate(name: str = "multiply_conjugate", **legacy):
    return MathOp(ew.MATHOP_MULTIPLY_CONJUGATE, name=name, **legacy)


def ComplexConjugate(name: str = "complex_conjugate", **legacy):
    return MathOp(ew.MATHOP_COMPLEX_CONJUGATE, name=name, **legacy)


class MultiplyConst(Block):
    """clMathConst multiply (lib/clMathConst_impl.cc): the complex variant
    multiplies by a real float scalar.  ``set_k`` mirrors the reference's
    runtime-updatable constant."""

    stateless = True   # the constant lives in state but is never updated

    def __init__(self, k: float, name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self._k = k

    def k(self):
        return self._k

    def set_k(self, k: float):
        """A new constant: a Runner takes it at ``refresh()``, a wrapped
        block (``gr_compat.wrap``) at its next work call."""
        self._k = k
        self._retuned = True

    def init_state(self):
        dtype = torch.complex64 if isinstance(self._k, complex) else torch.float32
        return torch.tensor(self._k, dtype=dtype)

    def migrate_state(self, old_state):
        """The constant is the whole state: after ``set_k`` it is the new
        one, otherwise the old state is kept."""
        if not getattr(self, "_retuned", False):
            return old_state
        self._retuned = False
        return self.init_state()

    def apply(self, state, inputs):
        return state, (ew.multiply_const(inputs[0], state),), {}


class AddConst(MultiplyConst):
    """clMathConst add variant."""

    def apply(self, state, inputs):
        return state, (ew.add_const(inputs[0], state),), {}


class _UnaryFn(Block):
    stateless = True
    _fn = None

    def __init__(self, name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name

    def apply(self, state, inputs):
        return state, (type(self)._fn(inputs[0]),), {}


class ComplexToMag(_UnaryFn):
    out_kinds = ("f",)
    _fn = staticmethod(ew.complex_to_mag)


class ComplexToArg(_UnaryFn):
    out_kinds = ("f",)
    _fn = staticmethod(ew.complex_to_arg)


class ComplexToMagPhase(Block):
    """c → (mag, phase), two output streams."""

    stateless = True
    n_outputs = 2
    out_kinds = ("f", "f")

    def __init__(self, name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name

    def apply(self, state, inputs):
        m, p = ew.complex_to_mag_phase(inputs[0])
        return state, (m, p), {}


class MagPhaseToComplex(Block):
    """(mag, phase) → c (planar=True emits a planar.PC stream)."""

    stateless = True
    n_inputs = 2
    in_kinds = ("f", "f")

    def __init__(self, planar: bool = False, name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.planar = planar

    def apply(self, state, inputs):
        out = ew.mag_phase_to_complex(*inputs, planar_out=self.planar)
        return state, (out,), {}


class Log(Block):
    """clLog (lib/clLog_impl.cc): n·log10(a)+k via log2."""

    stateless = True
    in_kinds = ("f",)
    out_kinds = ("f",)

    def __init__(self, nValue: float = 1.0, kValue: float = 0.0,
                 name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.n = nValue
        self.k = kValue

    def apply(self, state, inputs):
        return state, (ew.log10(inputs[0], n=self.n, k=self.k),), {}


class SNRHelper(Block):
    """clSNR (lib/clSNR_impl.cc): |n·log10(a/b)+k|."""

    stateless = True
    n_inputs = 2
    in_kinds = ("f", "f")
    out_kinds = ("f",)

    def __init__(self, nValue: float = 1.0, kValue: float = 0.0,
                 name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.n = nValue
        self.k = kValue

    def apply(self, state, inputs):
        return state, (ew.snr_helper(*inputs, n=self.n, k=self.k),), {}


def _load_fn_from_file(filename: str, fn_name: str) -> Callable:
    spec = importlib.util.spec_from_file_location("user_kernel_module", filename)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    try:
        return getattr(mod, fn_name)
    except AttributeError:
        raise ValueError(f"{filename} does not define {fn_name!r}") from None


class Kernel1To1(Block):
    """clKernel1To1 (lib/clKernel1To1_impl.cc): user-supplied elementwise
    kernel.  The reference loads OpenCL C from a file; here it is a user
    torch callable on the block's tensors (on the Runner's device) — pass
    the callable, or a Python file path + function name like the
    reference's (filename, kernelFnName) pair.  The torch twins of the
    reference's two example kernels are in ``clenabled_tpu_torch.examples``."""

    stateless = True   # user kernels are per-sample maps, like the
    # reference's (no state surface exists in either API)

    def __init__(self, fn: Callable | None = None, *,
                 filename: str | None = None, kernelFnName: str | None = None,
                 name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        if fn is None:
            if filename is None or kernelFnName is None:
                raise ValueError("pass fn, or filename + kernelFnName")
            fn = _load_fn_from_file(filename, kernelFnName)
        self.fn = fn

    def apply(self, state, inputs):
        return state, (self.fn(inputs[0]),), {}


class Kernel2To1(Kernel1To1):
    """clKernel2To1: user-supplied 2-in 1-out kernel."""

    n_inputs = 2

    def apply(self, state, inputs):
        return state, (self.fn(inputs[0], inputs[1]),), {}
