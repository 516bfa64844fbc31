"""FFT with gr-clenabled's window/shift/hermitian semantics.

The port of ``clenabled_tpu.dsp.fft`` (reference lib/clFFT_impl.cc):

- Forward and backward transforms are UNSCALED — the reference forces both
  clFFT scales to 1.0 (lib/clFFT_impl.cc:121-122), so "reverse" is the
  plain inverse-DFT sum (``torch.fft.ifft(x) * N``).
- Optional window taps multiply the input before the transform
  (lib/clFFT_impl.cc:202-271, applied :567-580).
- ``shift`` differs by direction (lib/clFFT_impl.cc:544-607): forward+shift
  applies an output fftshift (complex input only); reverse+shift swaps the
  input halves on load BEFORE the window multiply and transform.
- Float (real) input, forward: the mathematically exact full spectrum by
  hermitian mirror of the half spectrum (the JAX package's choice; the
  reference's off-by-one at the Nyquist bin is not reproduced).

The complex64 and real-input forms run on ``torch.fft``, as the JAX package
runs them outside Pallas.  The planar stream form ``fft_stream_planar``
takes the hand-written kernel (``hopper_kernels.fft_batched_fused``) when
a card is visible and the size is covered, as JAX takes its kernel on a
TPU backend, and the two-stage planar DFT otherwise.
"""

from __future__ import annotations

import torch

from clenabled_tpu_torch.dsp import planar

FORWARD = 1   # mirrors clFFT CLFFT_FORWARD semantics
REVERSE = -1  # mirrors CLFFT_BACKWARD


def _check_window(window, fft_size: int, device):
    if window is None:
        return None
    window = torch.as_tensor(window, dtype=torch.float32, device=device)
    if window.shape[-1] != fft_size:
        # reference validates window length against fft size (clFFT_impl.cc:74-76)
        raise ValueError(
            f"window length {window.shape[-1]} != fft_size {fft_size}")
    return window


def _swap_halves(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    return torch.cat([x[..., n // 2:], x[..., : n // 2]], dim=-1)


def _fft_complex_forward(x, window, shift: bool):
    if window is not None:
        x = x * window
    y = torch.fft.fft(x, dim=-1)
    if shift:
        y = torch.fft.fftshift(y, dim=-1)
    return y.to(torch.complex64)


def _fft_complex_reverse(x, window, shift: bool):
    n = x.shape[-1]
    if shift:
        x = _swap_halves(x)       # swap halves on buffer load (:549-563)
    if window is not None:
        x = x * window
    return (torch.fft.ifft(x, dim=-1) * n).to(torch.complex64)


def _fft_real_forward(x, window):
    n = x.shape[-1]
    if window is not None:
        x = x * window
    half = torch.fft.rfft(x, dim=-1)                     # [..., n//2+1]
    # full spectrum by hermitian mirror: y[k] = conj(y[n-k]) for k > n/2
    mirror = torch.conj(half[..., 1: n // 2]).flip(-1)
    return torch.cat([half, mirror], dim=-1).to(torch.complex64)


def fft_planar(x: planar.PC, direction: int = FORWARD, window=None,
               shift: bool = False) -> planar.PC:
    """Planar-complex fft() with the same clFFT semantics; x is a planar.PC
    of [..., fft_size] (the two-stage planar DFT)."""
    n = x.re.shape[-1]
    window = _check_window(window, n, x.re.device)
    if direction == FORWARD:
        if window is not None:
            x = planar.PC(x.re * window, x.im * window)
        y = planar.fft(x)
        return planar.fftshift(y) if shift else y
    if shift:
        x = planar.PC(_swap_halves(x.re), _swap_halves(x.im))
    if window is not None:
        x = planar.PC(x.re * window, x.im * window)
    return planar.ifft_unscaled(x)


def _fused_fft_supported(x: planar.PC, fft_size: int) -> bool:
    """The JAX package's routing rule for its fused kernel: 1-D planar
    streams, fft_size = n2·128 with n2 a power of two ≥ 8."""
    if x.re.dim() != 1:
        return False
    n2 = fft_size // 128
    return fft_size % 128 == 0 and n2 >= 8 and (n2 & (n2 - 1)) == 0


def fft_stream_planar(x: planar.PC, fft_size: int, direction: int = FORWARD,
                      window=None, shift: bool = False,
                      use_pallas: bool | str = "auto") -> planar.PC:
    """Planar fft_stream: a PC of streams [..., n] chopped into fft_size
    vectors along the last axis.

    use_pallas: ``"auto"`` takes the hand-written kernel
    (``hopper_kernels.fft_batched_fused``) when a CUDA card is visible and
    ``_fused_fft_supported`` holds — the JAX rule, with the card in the
    TPU backend's place; ``True`` forces the kernel wherever its envelope
    (n2 a power of two in [2, 128]) covers the size, a stream of any rank
    folding its leading axes into the kernel's vectors; ``False`` pins the
    two-stage planar DFT.  The kernel runs its plain form on CPU
    tensors."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    if x.re.shape[-1] % fft_size:
        raise ValueError("stream length must be a multiple of fft_size")
    if use_pallas == "auto":
        use_pallas = (torch.cuda.is_available()
                      and _fused_fft_supported(x, fft_size))
    if use_pallas and not hopper_kernels.fft_size_covered(fft_size):
        use_pallas = False
    if use_pallas:
        yr, yi = hopper_kernels.fft_batched_fused(
            x.re.reshape(-1), x.im.reshape(-1), fft_size,
            inverse=direction != FORWARD,
            window=_check_window(window, fft_size, x.re.device), shift=shift)
        return planar.PC(yr.reshape(x.re.shape), yi.reshape(x.im.shape))
    shp = x.re.shape[:-1] + (-1, fft_size)
    out = fft_planar(planar.PC(x.re.reshape(shp), x.im.reshape(shp)),
                     direction=direction, window=window, shift=shift)
    flat = x.re.shape[:-1] + (-1,)
    return planar.PC(out.re.reshape(flat), out.im.reshape(flat))


def fft(x, direction: int = FORWARD, window=None, shift: bool = False):
    """Transform batched vectors with the reference block's semantics.

    Args:
      x: [..., fft_size] tensor; complex (DTYPE_COMPLEX) or real
        (DTYPE_FLOAT).
      direction: FORWARD or REVERSE.
      window: optional float32 taps of length fft_size.
      shift: center-DC behavior (see module docstring).

    Returns complex64 [..., fft_size]."""
    x = torch.as_tensor(x)
    fft_size = x.shape[-1]
    window = _check_window(window, fft_size, x.device)
    if x.is_complex():
        x = x.to(torch.complex64)
        if direction == FORWARD:
            return _fft_complex_forward(x, window, shift)
        return _fft_complex_reverse(x, window, shift)
    x = x.float()
    if direction == FORWARD:
        # shift is not applied on the float/hermitian path (:594-630)
        return _fft_real_forward(x, window)
    # float reverse: hermitian→real inverse, unscaled, returned as complex
    y = torch.fft.ifft(x.to(torch.complex64), dim=-1) * fft_size
    return y.to(torch.complex64)


def fft_stream(x, fft_size: int, direction: int = FORWARD, window=None,
               shift: bool = False):
    """Stream form: 1-D sample stream chopped into fft_size vectors
    (the reference block is stream→vector with vlen=fft_size)."""
    x = torch.as_tensor(x)
    if x.shape[-1] % fft_size:
        raise ValueError("stream length must be a multiple of fft_size")
    batched = x.reshape(x.shape[:-1] + (-1, fft_size))
    out = fft(batched, direction=direction, window=window, shift=shift)
    return out.reshape(x.shape[:-1] + (-1,))
