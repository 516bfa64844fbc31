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
                  (with the live ``set_taps`` retune), ``HostIngest``,
                  the pinned-memory host feed, and ``SynchronizedIngest``,
                  which aligns tagged capture streams.
- ``blocks``    — the ported named blocks: the core math blocks
                  (``SignalSource``, ``Fft``, ``MathOp`` and its forms,
                  the constants and conversions, ``Log``, ``SNRHelper``),
                  the ``Filter`` family, ``PolyphaseChannelizer``,
                  ``QuadratureDemod``, ``CostasLoop``, ``XEngine``,
                  ``XCorrelate``, ``XCorrelateFFTVCF``, ``FirFilterSCC``,
                  ``FirFilterFSF``, ``InterpFirFilter`` and the
                  custom-kernel ``Kernel1To1``/``Kernel2To1``.
- ``sharding``  — the mesh over ``torch.distributed``, the halo filters,
                  the window-parallel correlators, the station-sharded
                  X-Engines on ``all_to_all`` and ``ShardedChain``.
- ``gr_compat`` — ``wrap``: any block as a GNU Radio ``gr.basic_block``,
                  for the descriptors in ``grc/``.
- ``native``    — the ring buffer, unpacks, X-Engine marshal and rolling
                  file writer in C++, built with g++ at first use.
- ``tools``     — the reference's CLIs (``clview``, ``test_clenabled``,
                  ``test_clkernel``, ``test_clfilter``, ``test_clxengine``,
                  ``test_clenabled_fft``, ``test_clxcorrelate``), the
                  ingest, scaling, multi-host and profiling tools, the
                  GRC generators and the kernels' A/B tools.
- ``examples``  — the reference's four custom-kernel examples as user
                  torch functions for ``Kernel1To1``/``Kernel2To1``, and
                  ``examples/grc``: demo flowgraphs on the descriptors.

The kernels in ``csrc/`` are compiled by ``_build`` at their first launch,
never at import: importing this package touches no GPU.
"""

__version__ = "0.1.0"

import contextlib


@contextlib.contextmanager
def exact_f32():
    """Context manager for exact float32 matmuls and convolutions on the
    card: TF32 off for cuBLAS and cuDNN inside, the previous flags restored
    on exit, an exception included.  It nests.

    On an H100, PyTorch may run float32 matmuls and convolutions on the
    tensor cores in TF32 (a 10-bit mantissa), which moves sums by about
    1e-3 relative; the port's float32 sections take this context so that
    they hold their 1e-4 tolerance whatever the process set::

        with clenabled_tpu_torch.exact_f32():
            out = step(x)

    It is the JAX package's ``exact_f32`` (which asks XLA for
    ``float32`` matmul precision on a TPU) read for the card."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
