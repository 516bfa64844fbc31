"""DSP library: NumPy design-time code (window, firdes), planar complex
arithmetic, the polyphase channelizer (critically sampled and
oversampled), the TD and FD correlators, the X-Engine, the FFT, the FIR
(typed and interpolating too) and FFT filters, the demodulators (quadrature and Costas), the signal source, the
elementwise math, and the Hopper kernels (FX step, packed and oversampled
PFB, Gram, FFT, FIR, overlap-save filter, demodulator, Costas loop) with
their plain forms."""

from clenabled_tpu_torch.dsp import (  # noqa: F401
    channelizer,
    demod,
    elementwise,
    fft,
    fft_filter,
    fir_filter,
    firdes,
    hopper_kernels,
    planar,
    siggen,
    window,
    xcorr,
    xengine,
)
