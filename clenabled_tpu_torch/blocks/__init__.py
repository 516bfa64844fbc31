"""User-facing blocks mirroring gr-clenabled's block set — the ported ones.

The port of ``clenabled_tpu.blocks``: constructor parameters mirror the
reference ``make()`` signatures (include/clenabled/*.h) minus the OpenCL
device-selection tuple, which each constructor accepts and ignores
(``_legacy.strip_legacy_kwargs``); the device is the Runner's.

Reference block → class (ported so far):
  clSignalSource            → SignalSource
  clFFT (fwd/rev)           → Fft
  clMultiply/clAdd/...      → Multiply, Add, Subtract, MultiplyConjugate,
                              ComplexConjugate, MathOp
  clMultConst/clAddConst    → MultiplyConst, AddConst
  clFilter (+GRC wrappers)  → Filter, LowPassFilter, HighPassFilter,
                              BandPassFilter, BandRejectFilter,
                              RootRaisedCosineFilter, FIRTapFilter
  clComplexFilter           → ComplexFilter
  clPolyphaseChannelizer    → PolyphaseChannelizer
  clQuadratureDemod         → QuadratureDemod
  clCostasLoop              → CostasLoop (exact sequential shapes)
  clComplexToMag/Arg/...    → ComplexToMag, ComplexToArg, ComplexToMagPhase,
                              MagPhaseToComplex
  clLog/clLog10             → Log
  clSNR                     → SNRHelper
  clKernel1To1/clKernel2To1 → Kernel1To1, Kernel2To1 (a user torch callable)
  clXCorrelate              → XCorrelate (message port "corr")
  clxcorrelate_fft_vcf      → XCorrelateFFTVCF
  clXEngine                 → XEngine (message port "xcorr")
  fir_filter_scc/fsf (CPU)  → FirFilterSCC, FirFilterFSF (int16 streams)
  (GR interp_fir_filter)    → InterpFirFilter
"""

from clenabled_tpu_torch.blocks.core import (  # noqa: F401
    SignalSource,
    Fft,
    MathOp,
    Multiply,
    Add,
    Subtract,
    MultiplyConjugate,
    ComplexConjugate,
    MultiplyConst,
    AddConst,
    ComplexToMag,
    ComplexToArg,
    ComplexToMagPhase,
    MagPhaseToComplex,
    Log,
    SNRHelper,
    Kernel1To1,
    Kernel2To1,
)
from clenabled_tpu_torch.blocks.correlators import (  # noqa: F401
    XCorrelate,
    XCorrelateFFTVCF,
    XEngine,
)
from clenabled_tpu_torch.blocks.demod import (  # noqa: F401
    CostasLoop,
    QuadratureDemod,
)
from clenabled_tpu_torch.blocks.filters import (  # noqa: F401
    Filter,
    ComplexFilter,
    LowPassFilter,
    HighPassFilter,
    BandPassFilter,
    BandRejectFilter,
    RootRaisedCosineFilter,
    FIRTapFilter,
    FirFilterSCC,
    FirFilterFSF,
    InterpFirFilter,
    PolyphaseChannelizer,
)

# Reference-name aliases for one-to-one discoverability.
clSignalSource = SignalSource
clFFT = Fft
clMathOp = MathOp
clMultiply = Multiply
clAdd = Add
clSubtract = Subtract
clMultiplyConjugate = MultiplyConjugate
clComplexConjugate = ComplexConjugate
clMathConst = MultiplyConst
clMultConst = MultiplyConst
clAddConst = AddConst
clFilter = Filter
clComplexFilter = ComplexFilter
clLowPassFilter = LowPassFilter
clHighPassFilter = HighPassFilter
clBandPassFilter = BandPassFilter
clBandRejectFilter = BandRejectFilter
clRootRaisedCosine = RootRaisedCosineFilter
clFIRTapFilter = FIRTapFilter
clPolyphaseChannelizer = PolyphaseChannelizer
clQuadratureDemod = QuadratureDemod
clCostasLoop = CostasLoop
clComplexToMag = ComplexToMag
clComplexToArg = ComplexToArg
clComplexToMagPhase = ComplexToMagPhase
clMagPhaseToComplex = MagPhaseToComplex
clLog = Log
clLog10 = Log
clSNR = SNRHelper
clKernel1To1 = Kernel1To1
clKernel2To1 = Kernel2To1
clXCorrelate = XCorrelate
clxcorrelate_fft_vcf = XCorrelateFFTVCF
clXEngine = XEngine
