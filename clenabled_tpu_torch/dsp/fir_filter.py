"""Direct-form FIR filtering with decimation.

The port of ``clenabled_tpu.dsp.fir_filter``: the reference's time-domain
``td_FIR_complex`` kernels (lib/clFilter_impl.cc:152-243) and its CPU
``fir_filter_*`` classes.  Convention (GNU Radio): the caller supplies
``ntaps-1`` history samples at the FRONT of the input, and

    y[n] = sum_j taps[j] * x[n + ntaps-1 - j]          (a "valid" convolution)
    out[m] = y[m * decimation]

The plain forms are real ``conv1d`` calls (complex data splits into real
convolutions, as in JAX), float32 without TF32.  ``make_fir_filter_planar``
runs the hand-written kernel (``hopper_kernels.fir_direct``) on CUDA
tensors: both planar components in one launch, only the kept outputs
computed, the history read beside the frame without a concatenation.

The typed variants (``make_fir_filter_typed``, ``fir_filter_scc``/``fsf``)
and the interpolating FIR are not ported yet (ROADMAP.md A.8).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.runtime.device import per_device


def _conv_valid_real(x, taps, stride: int = 1):
    """Real 'valid' convolution (correlation with reversed taps), every
    ``stride``-th output.  x: [L] f32, taps: [K] f32 → [⌈(L−K+1)/stride⌉]."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    w = taps.flip(-1).reshape(1, 1, -1)
    with hopper_kernels._full_f32():
        return F.conv1d(x.reshape(1, 1, -1), w, stride=stride)[0, 0]


def _split_taps(taps, device):
    """(real part, imaginary part or None) of numpy or tensor taps as
    float32 tensors on ``device``."""
    t = torch.as_tensor(np.asarray(taps) if not torch.is_tensor(taps) else taps)
    t = t.to(device)
    if t.is_complex():
        return t.real.float().contiguous(), t.imag.float().contiguous()
    return t.float(), None


def fir_filter(x, taps, decimation: int = 1):
    """Filter one frame.

    Args:
      x: [ntaps-1 + n] samples (history at the front); float32 or complex64.
      taps: [ntaps] float32 or complex64.
      decimation: keep every decimation-th output.

    Returns: [n // decimation] filtered samples (complex64 if either input
      is complex, else float32).  ``n`` must be a multiple of ``decimation``.
    """
    x = torch.as_tensor(x)
    tr, ti = _split_taps(taps, x.device)
    n = x.shape[-1] - (tr.shape[-1] - 1)
    if n <= 0:
        raise ValueError("input shorter than filter history")
    if n % decimation:
        raise ValueError(f"frame length {n} not a multiple of decimation {decimation}")

    def conv(a, t):
        return _conv_valid_real(a, t, decimation)

    if not x.is_complex():
        xr = x.float()
        if ti is None:
            return conv(xr, tr)
        return torch.complex(conv(xr, tr), conv(xr, ti))
    xr, xi = x.real.float(), x.imag.float()
    if ti is None:
        return torch.complex(conv(xr, tr), conv(xi, tr))
    return torch.complex(conv(xr, tr) - conv(xi, ti),
                         conv(xr, ti) + conv(xi, tr))


def fir_filter_planar(x, taps, decimation: int = 1):
    """Planar fir_filter: x is a planar.PC with history at the front; taps
    real or complex (numpy).  The plain conv form (``make_fir_filter_planar``
    has the kernel)."""
    tr, ti = _split_taps(taps, x.re.device)
    n = x.re.shape[-1] - (tr.shape[-1] - 1)
    if n % decimation:
        raise ValueError(f"frame length {n} not a multiple of decimation")

    def conv(a, t):
        return _conv_valid_real(a, t, decimation)

    if ti is not None:
        return planar.PC(conv(x.re, tr) - conv(x.im, ti),
                         conv(x.re, ti) + conv(x.im, tr))
    return planar.PC(conv(x.re, tr), conv(x.im, tr))


def _history(full: torch.Tensor, keep: int) -> torch.Tensor:
    """The last ``keep`` samples as a tensor of their own (not a view that
    would pin the frame, or change with a caller's reused buffer)."""
    return full[full.shape[-1] - keep:].clone()


def make_fir_filter_planar_xla(taps, decimation: int = 1):
    """Streaming planar FIR on the plain conv form, real or complex taps:
    (init_state, apply) with apply((hist_r, hist_i), frame: planar.PC) →
    (state, planar.PC).  The JAX package's portable XLA form."""
    taps_np = np.asarray(taps)
    ntaps = int(taps_np.shape[-1])

    def init_state(frame_size: int | None = None):
        del frame_size
        z = torch.zeros(ntaps - 1)
        return (z, z.clone())

    def apply(state, frame):
        fr = torch.cat([state[0], frame.re])
        fi = torch.cat([state[1], frame.im])
        y = fir_filter_planar(planar.PC(fr, fi), taps_np, decimation)
        return (_history(fr, ntaps - 1), _history(fi, ntaps - 1)), y

    return init_state, apply


def make_fir_filter_planar(taps, decimation: int = 1):
    """Streaming planar direct FIR on the hand-written kernel
    (``hopper_kernels.fir_direct``, the port of both the VPU and the MXU
    Pallas FIR): (init_state, apply) with apply((hist_r, hist_i), frame:
    planar.PC) → (state, planar.PC).  Real taps only (complex taps: the
    plain ``make_fir_filter_planar_xla``).  Frame lengths need only be
    multiples of ``decimation``: the kernel has no tile quantum.  On CPU
    tensors the wrapper runs its conv1d form."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    taps_np = np.asarray(taps, np.float32)
    ntaps = int(taps_np.shape[-1])
    taps_on = per_device(taps_np)

    def init_state(frame_size: int | None = None):
        del frame_size
        z = torch.zeros(ntaps - 1)
        return (z, z.clone())

    def apply(state, frame):
        y = hopper_kernels.fir_direct(
            planar.PC(frame.re.contiguous(), frame.im.contiguous()),
            taps_on(frame.re.device), decimation=decimation,
            history=planar.PC(*state))
        k = ntaps - 1
        if frame.re.shape[-1] >= k:
            new = (_history(frame.re, k), _history(frame.im, k))
        else:                             # a frame shorter than the history
            new = (_history(torch.cat([state[0], frame.re]), k),
                   _history(torch.cat([state[1], frame.im]), k))
        return new, y

    return init_state, apply


def make_fir_filter(taps, decimation: int = 1, complex_input: bool = True):
    """Streaming form: (init_state, apply) where state is the carried
    ``ntaps-1``-sample history (the role of GR's set_history).

    apply(history, frame) -> (new_history, out); frame length must be a
    multiple of ``decimation``.
    """
    taps_np = np.asarray(taps)
    ntaps = int(taps_np.shape[-1])
    hist_dtype = torch.complex64 if complex_input else torch.float32

    def init_state(frame_size: int | None = None):
        del frame_size
        return torch.zeros(ntaps - 1, dtype=hist_dtype)

    def apply(history, frame):
        frame = torch.as_tensor(frame).to(hist_dtype)
        full = torch.cat([history, frame], dim=-1)
        out = fir_filter(full, taps_np, decimation)
        return _history(full, ntaps - 1), out

    return init_state, apply
