"""DSP library: NumPy design-time code (window, firdes), planar complex
arithmetic, the critically sampled channelizer, the FD correlator, the
X-Engine, the FIR and FFT filters, the quadrature demodulator, and the
Hopper kernels (FX step, Gram, FIR, overlap-save filter, demodulator) with
their plain forms."""

from clenabled_tpu_torch.dsp import (  # noqa: F401
    channelizer,
    demod,
    fft_filter,
    fir_filter,
    firdes,
    hopper_kernels,
    planar,
    window,
    xcorr,
    xengine,
)
