"""clenabled_tpu_torch — the PyTorch / CUDA port of clenabled_tpu.

The same streaming SDR library, written for an NVIDIA Hopper GPU:

- ``runtime``   — explicit device selection, the sm_90 probe, the
                  stream dtype codes and the frame-size policy.
- ``dsp``       — windows and firdes designers (NumPy, copied from the JAX
                  package), planar complex arithmetic, the polyphase
                  channelizer (critically sampled, oversampled and fused),
                  the TD and FD correlators, the X-Engine (unpacking, time-major,
                  channel-major and stacked engines, pipeline
                  integration), the FFT, the FIR (typed and interpolating
                  too) and FFT filters, the
                  quadrature demodulator and the Costas loop, the signal
                  source and the elementwise math in torch, and
                  ``hopper_kernels``: the wrappers of the hand-written CUDA
                  kernels beside their plain torch versions.
- ``pipelines`` — the 4-antenna FX receive step in its complex64, planar
                  and fused forms, and the hand-over of JAX state.
- ``streaming`` — the block protocol, ``Flowgraph`` and its ``Runner``
                  (with the live ``set_taps`` retune), and ``HostIngest``,
                  the pinned-memory host feed.
- ``blocks``    — the ported named blocks: the core math blocks
                  (``SignalSource``, ``Fft``, ``MathOp`` and its forms,
                  the constants and conversions, ``Log``, ``SNRHelper``),
                  the ``Filter`` family, ``PolyphaseChannelizer``,
                  ``QuadratureDemod``, ``CostasLoop``, ``XEngine``,
                  ``XCorrelate``, ``XCorrelateFFTVCF``, ``FirFilterSCC``,
                  ``FirFilterFSF`` and ``InterpFirFilter``.
- ``sharding``  — the mesh over ``torch.distributed``, the halo filters
                  and the window-parallel correlators.
- ``tools``     — ``test_clxengine``, ``test_clfilter``,
                  ``test_clenabled_fft`` and ``test_clxcorrelate``, the
                  X-Engine, filter, FFT and correlator benchmarks.

The kernels in ``csrc/`` are compiled by ``_build`` at their first launch,
never at import: importing this package touches no GPU.
"""

__version__ = "0.1.0"
