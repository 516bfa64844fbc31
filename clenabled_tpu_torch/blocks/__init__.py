"""User-facing blocks mirroring gr-clenabled's block set — the ported ones.

The port of ``clenabled_tpu.blocks``: constructor parameters mirror the
reference ``make()`` signatures (include/clenabled/*.h) minus the OpenCL
device-selection tuple, which each constructor accepts and ignores
(``_legacy.strip_legacy_kwargs``); the device is the Runner's.

Reference block → class (ported so far):
  clFilter (+GRC wrappers)  → Filter, LowPassFilter, HighPassFilter,
                              BandPassFilter, BandRejectFilter,
                              RootRaisedCosineFilter, FIRTapFilter
  clComplexFilter           → ComplexFilter
  clQuadratureDemod         → QuadratureDemod
  clxcorrelate_fft_vcf      → XCorrelateFFTVCF
  clXEngine                 → XEngine (message port "xcorr")

The other blocks (core math, PolyphaseChannelizer, CostasLoop, XCorrelate,
the typed and interpolating FIRs) wait their turn (ROADMAP.md A.11).
"""

from clenabled_tpu_torch.blocks.correlators import (  # noqa: F401
    XCorrelateFFTVCF,
    XEngine,
)
from clenabled_tpu_torch.blocks.demod import QuadratureDemod  # noqa: F401
from clenabled_tpu_torch.blocks.filters import (  # noqa: F401
    Filter,
    ComplexFilter,
    LowPassFilter,
    HighPassFilter,
    BandPassFilter,
    BandRejectFilter,
    RootRaisedCosineFilter,
    FIRTapFilter,
)

# Reference-name aliases for one-to-one discoverability.
clFilter = Filter
clComplexFilter = ComplexFilter
clLowPassFilter = LowPassFilter
clHighPassFilter = HighPassFilter
clBandPassFilter = BandPassFilter
clBandRejectFilter = BandRejectFilter
clRootRaisedCosine = RootRaisedCosineFilter
clFIRTapFilter = FIRTapFilter
clQuadratureDemod = QuadratureDemod
clxcorrelate_fft_vcf = XCorrelateFFTVCF
clXEngine = XEngine
