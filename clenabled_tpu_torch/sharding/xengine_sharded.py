"""Station-sharded X-Engines: one ``all_to_all`` from station sharding to
channel sharding, then the local per-channel Gram.

The port of ``clenabled_tpu.sharding.xengine_sharded``.  Capture is
station-sharded (each rank ingests its antennas' streams, the reference's
per-antenna input ports, lib/clXEngine_impl.cc:88-90), but the
cross-multiply needs every station of a channel.  One ``all_to_all`` over
the mesh axis re-shards [T, S/D, F, P] → [T, S, F/D, P] (or, channel-major,
lanes [F, T, S·P/D] → [F/D, T, S·P]); each rank then owns the whole
correlation of its channel slice, and its integration state stays on it.

Each rank passes its own station (lane) block and gets back its own channel
slice: the shape checks are on the local block.  The integration count is a
host int and ``ready`` a host bool, as in the unsharded engines
(``dsp.xengine._pipeline_emit``).  With D = 1 each function is the
unsharded engine, bit for bit.
"""

from __future__ import annotations

import torch

from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.dsp import xengine as dsp_xengine
from clenabled_tpu_torch.runtime.device import mesh_device
from clenabled_tpu_torch.sharding.collectives import all_to_all, axis_size


def _channel_shard(z: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's [T, S/D, F, P] stations → [T, S, F/D, P]: split the
    channels, join the stations."""
    return all_to_all(z, mesh, split_dim=2, concat_dim=1, axis=axis)


def _check_time_major(shape, d: int) -> None:
    s, f = shape[1] * d, shape[2]
    if f % d:
        raise ValueError(f"stations ({s}) and channels ({f}) must divide "
                         f"mesh size {d}")


def sharded_xengine(z, mesh, axis: str = "shard", npol: int = 2,
                    output_format: int = dsp_xengine.CLXCORR_TRIANGULAR_ORDER):
    """One-shot correlate: this rank's stations z [T, S/D, F, P] complex64
    → this rank's channels [F/D, nb, npol²] (or [F/D, S·P, S·P])."""
    d = axis_size(mesh, axis)
    z = torch.as_tensor(z, device=mesh_device(mesh)).to(torch.complex64)
    _check_time_major(z.shape, d)
    return dsp_xengine.xengine_correlate(_channel_shard(z, mesh, axis),
                                         npol=npol,
                                         output_format=output_format)


def make_sharded_xengine(num_inputs: int, num_channels: int, npol: int,
                         integration_time: int, mesh, axis: str = "shard",
                         output_format: int =
                         dsp_xengine.CLXCORR_TRIANGULAR_ORDER,
                         pipeline_integration: int = 0):
    """Streaming form with channel-sharded accumulation: (init_state,
    apply).  apply(state, frames [T, S/D, F, P] this rank's stations) →
    (state', (matrix [F/D, ...] this rank's channels, ready)); the sum is
    emitted every ``pipeline_integration`` calls, zeros in between."""
    d = axis_size(mesh, axis)
    if num_inputs % d or num_channels % d:
        raise ValueError("stations and channels must divide mesh size")
    out_shape = dsp_xengine._out_shape(num_inputs, num_channels // d, npol,
                                       output_format)
    pipe = max(1, pipeline_integration)
    expected = (integration_time, num_inputs // d, num_channels, npol)
    dev = mesh_device(mesh)

    def init_state() -> dsp_xengine.XEngineState:
        return dsp_xengine.XEngineState(
            accum=torch.zeros(out_shape, dtype=torch.complex64, device=dev),
            count=0)

    def apply(state, frames):
        frames = torch.as_tensor(frames, device=dev).to(torch.complex64)
        if tuple(frames.shape) != expected:
            raise ValueError(f"frames shape {tuple(frames.shape)} != "
                             f"{expected}")
        corr = dsp_xengine.xengine_correlate(
            _channel_shard(frames, mesh, axis), npol=npol,
            output_format=output_format)
        accum, count, out, ready = dsp_xengine._pipeline_emit(
            state.accum, corr, state.count, pipe)
        return dsp_xengine.XEngineState(accum=accum, count=count), (out,
                                                                    ready)

    return init_state, apply


def make_sharded_xengine_stacked(num_inputs: int, num_channels: int,
                                 npol: int, integration_time: int, mesh,
                                 axis: str = "shard",
                                 output_format: int =
                                 dsp_xengine.CLXCORR_TRIANGULAR_ORDER,
                                 pipeline_integration: int = 0,
                                 compute_dtype=None, scale: float = 1.0,
                                 use_kernel: bool | None = None):
    """The stacked-Gram X-Engine over a lane-sharded capture mesh:
    (init_state, apply).

    Each rank passes its lanes zr/zi [F, T, S·P/D] (float32, bfloat16 or
    int8; int8 stays int8 on the wire).  One ``all_to_all`` a component
    re-shards them to [F/D, T, S·P], station lanes rank-major, and
    ``dsp.xengine.xengine_correlate_stacked`` correlates this rank's
    channels: through the Gram kernel (``use_kernel``, default auto: a
    CUDA tensor, S·P a multiple of 128, int8 or bfloat16), else batched
    products.  apply(state, (zr, zi)) → (state', (planar.PC [F/D, ...],
    ready)), the reference's pipeline_integration emission
    (lib/clXEngine_impl.cc:289-292, :779-812)."""
    d = axis_size(mesh, axis)
    sp = num_inputs * npol
    if sp % d or num_channels % d:
        raise ValueError("stations·pols and channels must divide mesh size")
    out_shape = dsp_xengine._out_shape(num_inputs, num_channels // d, npol,
                                       output_format)
    pipe = max(1, pipeline_integration)
    expected = (num_channels, integration_time, sp // d)
    dev = mesh_device(mesh)

    def init_state() -> dsp_xengine.XEngineState:
        return dsp_xengine.XEngineState(
            accum=planar.zeros(out_shape, device=dev), count=0)

    def apply(state, frames):
        zr, zi = (torch.as_tensor(z, device=dev) for z in frames)
        if tuple(zr.shape) != expected:
            raise ValueError(f"frames shape {tuple(zr.shape)} != {expected}")
        # lane shard -> channel shard: split the channels, join the lanes
        zr, zi = (all_to_all(z, mesh, split_dim=0, concat_dim=2, axis=axis)
                  for z in (zr, zi))
        corr = dsp_xengine.xengine_correlate_stacked(
            zr.contiguous(), zi.contiguous(), npol=npol,
            output_format=output_format, compute_dtype=compute_dtype,
            scale=scale, use_kernel=use_kernel)
        accum, count, out, ready = dsp_xengine._pipeline_emit(
            state.accum, corr, state.count, pipe)
        return dsp_xengine.XEngineState(accum=accum, count=count), (out,
                                                                    ready)

    return init_state, apply
