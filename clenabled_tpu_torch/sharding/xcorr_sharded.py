"""Window-parallel sharded cross-correlators.

The port of ``clenabled_tpu.sharding.xcorr_sharded``.  The TD lag scan and
the FD conj-mult correlator are per-analysis-window computations with no
carried state (the reference runs one window per work() call,
lib/clXCorrelate_impl.cc:843-903, lib/clxcorrelate_fft_vcf_impl.cc:886-937),
so their multi-card form is plain data parallelism over the window batch
axis B: rank i of the mesh axis takes windows [i·B/D, (i+1)·B/D) and runs
the planar function on them, with no collective.

``apply`` takes the global batch, as JAX's caller passes the global array;
only this rank's windows are moved to its device, and the result is this
rank's part of JAX's B-sharded output.  B must be a multiple of the axis
size D.
"""

from __future__ import annotations

import torch

from clenabled_tpu_torch.dsp import planar, xcorr
from clenabled_tpu_torch.runtime.device import mesh_device
from clenabled_tpu_torch.sharding.collectives import axis_index, axis_size


def _window_block(mesh, axis: str):
    """``take(x)``: this rank's windows of a global [nsig, B, ...] array or
    tensor as a float32 tensor on its device; raises when D does not
    divide B."""
    d, i = axis_size(mesh, axis), axis_index(mesh, axis)
    dev = mesh_device(mesh)

    def take(x):
        b = x.shape[1]
        if b % d:
            raise ValueError(f"window batch {b} must be a multiple of the "
                             f"mesh axis size {d}")
        k = b // d
        return torch.as_tensor(x[:, i * k:(i + 1) * k]).to(
            dev, torch.float32)

    return take


def make_sharded_td_xcorr(mesh, max_shift: int, axis: str = "shard"):
    """Batch-sharded TD lag scan: apply(mags) with mags the global
    [nsignals, B, n] float32 batch → this rank's XCorrResult, leading
    [nsignals-1, B/D] dims (``xcorr.td_xcorr_planar_batched`` on its
    windows).  Complex streams: take planar.pabs first (the reference's
    magnitude pre-pass, lib/clXCorrelate_impl.cc:1483-1489)."""
    take = _window_block(mesh, axis)

    def apply(mags) -> xcorr.XCorrResult:
        return xcorr.td_xcorr_planar_batched(take(mags), max_shift)

    return apply


def make_sharded_fd_xcorr(mesh, axis: str = "shard",
                          perform_fft_first: bool = False):
    """Batch-sharded FD correlator: apply(vectors) with vectors the global
    planar.PC [nsignals, B, fft_size] → this rank's [nsignals-1, B/D,
    fft_size] float32 (``xcorr.fd_xcorr_planar``: conj-mult → unscaled
    inverse DFT → magnitude → half-swap, reference semantics
    lib/clxcorrelate_fft_vcf_impl.cc:886-937, 1131-1141; input_type=2
    through ``perform_fft_first``)."""
    take = _window_block(mesh, axis)

    def apply(vectors: planar.PC) -> torch.Tensor:
        v = planar.PC(take(vectors.re), take(vectors.im))
        return xcorr.fd_xcorr_planar(v, perform_fft_first=perform_fft_first)

    return apply
