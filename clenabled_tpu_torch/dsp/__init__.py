"""DSP library: NumPy design-time code (window, firdes), planar complex
arithmetic, the critically sampled channelizer, the FD correlator, the
X-Engine, and the Hopper kernels (FX step, Gram) with their plain forms."""

from clenabled_tpu_torch.dsp import (  # noqa: F401
    channelizer,
    firdes,
    hopper_kernels,
    planar,
    window,
    xcorr,
    xengine,
)
