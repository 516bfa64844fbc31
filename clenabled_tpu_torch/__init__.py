"""clenabled_tpu_torch — the PyTorch / CUDA port of clenabled_tpu.

The same streaming SDR library, written for an NVIDIA Hopper GPU:

- ``runtime``   — explicit device selection and the sm_90 probe.
- ``dsp``       — windows and firdes designers (NumPy, copied from the JAX
                  package), planar complex arithmetic, the critically
                  sampled polyphase channelizer, the FD correlator and the
                  X-Engine (unpacking, time-major, channel-major and
                  stacked engines, pipeline integration) in torch, and
                  ``hopper_kernels``: the wrappers of the hand-written CUDA
                  kernels beside their plain torch versions.
- ``pipelines`` — the 4-antenna FX receive step in its complex64, planar
                  and fused forms, and the hand-over of JAX state.
- ``streaming`` — the block protocol, ``Flowgraph`` and its ``Runner``,
                  and ``HostIngest``, the pinned-memory host feed.
- ``blocks``    — the ported named blocks: ``XEngine`` and
                  ``XCorrelateFFTVCF``.
- ``tools``     — ``test_clxengine``, the X-Engine benchmark.

The kernels in ``csrc/`` are compiled by ``_build`` at their first launch,
never at import: importing this package touches no GPU.
"""

__version__ = "0.1.0"
