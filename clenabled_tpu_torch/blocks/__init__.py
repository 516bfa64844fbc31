"""User-facing blocks mirroring gr-clenabled's block set — the ported ones.

The port of ``clenabled_tpu.blocks``: constructor parameters mirror the
reference ``make()`` signatures (include/clenabled/*.h) minus the OpenCL
device-selection tuple, which each constructor accepts and ignores
(``_legacy.strip_legacy_kwargs``); the device is the Runner's.

Reference block → class (ported so far):
  clxcorrelate_fft_vcf      → XCorrelateFFTVCF
  clXEngine                 → XEngine (message port "xcorr")

The other blocks wait their turn (ROADMAP.md A.11).
"""

from clenabled_tpu_torch.blocks.correlators import (  # noqa: F401
    XCorrelateFFTVCF,
    XEngine,
)

# Reference-name aliases for one-to-one discoverability.
clxcorrelate_fft_vcf = XCorrelateFFTVCF
clXEngine = XEngine
