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

The typed variants (``fir_filter_scc``/``fsf``, ``make_fir_filter_typed``)
carry the history in the input dtype and widen each frame to float32;
narrowing to int16 truncates toward zero and saturates, as JAX's cast does
(``torch``'s own cast wraps).  The polyphase interpolating FIR
(``interp_fir_filter``, ``make_interp_fir_filter{,_planar}``) is one
``conv1d`` with L output channels of reversed branch taps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.runtime.device import get_device, per_device


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


def _split_taps_on(taps):
    """``get(device)``: (real part, imaginary part or None) of the taps as
    float32 tensors on ``device``, split and uploaded once a device."""
    t = np.asarray(taps)
    re = per_device(np.array(t.real, np.float32))
    im = (per_device(np.array(t.imag, np.float32))
          if np.iscomplexobj(t) else None)
    return lambda device: (re(device), None if im is None else im(device))


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
    return _fir(x, *_split_taps(taps, x.device), decimation)


def _fir(x: torch.Tensor, tr: torch.Tensor, ti, decimation: int):
    """fir_filter on taps already split into float32 parts on x's device."""
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
    ``ntaps-1``-sample history (the role of GR's set_history), starting on
    the CPU.

    apply(history, frame) -> (new_history, out); frame length must be a
    multiple of ``decimation``.
    """
    return make_fir_filter_typed(
        taps, decimation,
        torch.complex64 if complex_input else torch.float32, device="cpu")


def to_int16(y: torch.Tensor) -> torch.Tensor:
    """float → int16 as JAX casts it: truncation toward zero (C's
    ``(int16_t)``), saturating at ±32767/−32768, NaN → 0.  ``torch``'s
    own cast wraps out-of-range values."""
    y = torch.nan_to_num(y.float(), nan=0.0)
    return y.trunc().clamp(-32768.0, 32767.0).to(torch.int16)


def fir_filter_scc(x, taps, decimation: int = 1):
    """short→complex FIR (reference fir_filter_scc, lib/fir_filter.h:160):
    int16 samples widened to float32, complex taps, complex64 output.

    x: [ntaps-1 + n] int16 (history at the front); taps: [ntaps] complex64.
    """
    x = torch.as_tensor(x).to(torch.int16).float()
    return fir_filter(x, np.asarray(taps, np.complex64), decimation)


def fir_filter_fsf(x, taps, decimation: int = 1):
    """float→short FIR (reference fir_filter_fsf, lib/fir_filter.h:192):
    float32 dot product, the output cast to int16 with C's truncation
    toward zero (volk_32f_x2_dot_prod_16i's ``(int16_t)dotProduct``),
    saturating as JAX's cast does."""
    x = torch.as_tensor(x).float()
    return to_int16(fir_filter(x, np.asarray(taps, np.float32), decimation))


def _state_device(device) -> torch.device:
    """The device a factory's initial state lives on (None: ``cuda:0``,
    raising when no card is visible)."""
    return get_device("cuda") if device is None else torch.device(device)


def make_fir_filter_typed(taps, decimation: int = 1,
                          in_dtype=torch.complex64, out_dtype=None,
                          device=None):
    """Streaming FIR with explicit torch stream dtypes — the reference's
    six CPU variants fff/ccf/fcc/ccc/scc/fsf (lib/fir_filter.h:32-192).

    The carried history keeps the INPUT dtype (an int16 history costs half
    a float32 one) and starts on ``device`` (None: ``cuda:0``, raising
    when no card is visible); each frame is widened on its device.
    ``out_dtype=torch.int16`` is fsf's narrowing (``to_int16``)."""
    ntaps = int(np.shape(taps)[-1])
    taps_on = _split_taps_on(taps)
    dev = _state_device(device)

    def init_state(frame_size: int | None = None):
        del frame_size
        return torch.zeros(ntaps - 1, dtype=in_dtype, device=dev)

    def apply(history, frame):
        frame = torch.as_tensor(frame).to(in_dtype)
        full = torch.cat([history, frame], dim=-1)
        xf = full.float() if in_dtype == torch.int16 else full
        out = _fir(xf, *taps_on(full.device), decimation)
        if out_dtype == torch.int16:
            out = to_int16(out)
        elif out_dtype is not None:
            out = out.to(out_dtype)
        return _history(full, ntaps - 1), out

    return init_state, apply


# ---------------------------------------------------------------------------
# Interpolating FIR (polyphase) — GR's interp_fir_filter contract, which the
# reference lacks (its blocks only decimate), so that flowgraphs cover GR's
# interpolators as well as its decimators.
# ---------------------------------------------------------------------------


def _branch_taps(taps, interp: int) -> np.ndarray:
    """taps [T] → branch matrix [L, Kb] with h_p[j] = taps[p + L·j]."""
    taps = np.asarray(taps, np.float32)
    kb = -(-len(taps) // interp)
    padded = np.zeros(kb * interp, np.float32)
    padded[: len(taps)] = taps
    return padded.reshape(kb, interp).T.copy()   # [L, Kb]


def _interp_weight(taps, interp: int) -> np.ndarray:
    """conv1d's weight [O=L, I=1, Kb]: the branch taps reversed."""
    return _branch_taps(taps, interp)[:, None, ::-1].copy()


def _interp(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Real rows x [R, Kb−1 + n] → [R, n·L]: y[r, i·L + p] = out[r, p, i]."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    with hopper_kernels._full_f32():
        out = F.conv1d(x.float()[:, None, :], weight)        # [R, L, n]
    return out.transpose(1, 2).reshape(x.shape[0], -1)


def interp_fir_filter(x, taps, interp: int):
    """Polyphase interpolating FIR over one real frame.

    The input carries Kb−1 = ceil(T/L)−1 history samples at the front;
    y[i·L + p] = Σ_j taps[p + L·j] · x[i + Kb−1 − j]  (the polyphase
    decomposition of zero-stuff-by-L → FIR(taps)).
    x: [Kb−1 + n] float32 → [n·L] float32.
    """
    x = torch.as_tensor(x).float()
    w = torch.as_tensor(_interp_weight(taps, interp), device=x.device)
    return _interp(x[None], w)[0]


def make_interp_fir_filter_planar(taps, interp: int, device=None):
    """Streaming planar interpolating FIR: (init_state, apply) with
    apply((hr, hi), frame: planar.PC[n]) -> (state, planar.PC[n·L]);
    the state is Kb−1 input samples a component, starting on ``device``
    (None: ``cuda:0``, raising when no card is visible).  Both components
    run in one conv1d call."""
    taps_np = np.asarray(taps, np.float32)
    kb = -(-len(taps_np) // interp)
    weight = per_device(_interp_weight(taps_np, interp))
    dev = _state_device(device)

    def init_state(frame_size: int | None = None):
        del frame_size
        z = torch.zeros(kb - 1, device=dev)
        return (z, z.clone())

    def apply(state, frame):
        full = torch.stack([torch.cat([state[0], frame.re]),
                            torch.cat([state[1], frame.im])])
        y = _interp(full, weight(full.device))
        return ((_history(full[0], kb - 1), _history(full[1], kb - 1)),
                planar.PC(y[0], y[1]))

    return init_state, apply


def make_interp_fir_filter(taps, interp: int, device=None):
    """Complex-stream variant (float taps — GR interp_fir_filter_ccf):
    (init_state, apply) with a complex64 state of Kb−1 input samples on
    ``device`` (None: ``cuda:0``, raising when no card is visible)."""
    taps_np = np.asarray(taps, np.float32)
    kb = -(-len(taps_np) // interp)
    weight = per_device(_interp_weight(taps_np, interp))
    dev = _state_device(device)

    def init_state(frame_size: int | None = None):
        del frame_size
        return torch.zeros(kb - 1, dtype=torch.complex64, device=dev)

    def apply(state, frame):
        full = torch.cat([state, torch.as_tensor(frame).to(torch.complex64)])
        y = _interp(torch.stack([full.real, full.imag]), weight(full.device))
        return _history(full, kb - 1), torch.complex(y[0], y[1])

    return init_state, apply
