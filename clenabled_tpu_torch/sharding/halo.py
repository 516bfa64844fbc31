"""Time-sharded filtering with a ring halo exchange.

The port of ``clenabled_tpu.sharding.halo``.  The sample stream is split
into D consecutive time blocks, one per rank of the mesh axis; each rank
holds its own block of L samples.  Sequential carried state becomes
communication:

- FIR and PFB channelizer: rank i needs the last ``ntaps-1`` INPUT samples
  of rank i-1, one ``ring_forward`` of each block's input tail;
- overlap-add: rank i's first ``ntaps-1`` OUTPUT samples need the additive
  tail of rank i-1's last chunk, one ``ring_forward`` of each block's
  final tail.

Rank 0 consumes the PREVIOUS frame's tail, which is what the ring
delivered to it from rank D-1 in this step, so the state carried to the
next step is "what rank 0 received".  Each rank keeps its row of JAX's
[D, ntaps-1] sharded state: ``init_state()`` gives this rank's [1, ntaps-1]
and ``apply(state, x_local)`` returns ``(state, y_local)``.  With D = 1
each is the sequential filter, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from clenabled_tpu_torch.dsp import channelizer as dsp_chan
from clenabled_tpu_torch.dsp import fft_filter as dsp_ofa
from clenabled_tpu_torch.dsp import fir_filter as dsp_fir
from clenabled_tpu_torch.runtime.device import mesh_device
from clenabled_tpu_torch.sharding.collectives import axis_index, ring_forward


def _local(x, dev: torch.device, halo: int = 0) -> torch.Tensor:
    """This rank's block as complex64 on ``dev``; a block shorter than the
    ``halo`` its neighbour needs raises."""
    x = torch.as_tensor(x, device=dev).to(torch.complex64)
    if x.shape[-1] < halo:
        raise ValueError(f"per-shard block {x.shape[-1]} must be >= the "
                         f"{halo}-sample halo")
    return x


def _carry(state, recv, idx: int):
    """(halo, new state) of a rank: rank 0 consumes its state and keeps
    what the ring delivered; the others consume the delivery and keep
    their state."""
    if idx == 0:
        return state[0], recv.clone()[None]
    return recv, state


def make_sharded_fir_filter(taps, mesh, axis: str = "shard",
                            decimation: int = 1):
    """(init_state, apply): apply(state, x_local [L]) -> (state,
    y_local [L / decimation]).  L must be a multiple of ``decimation`` and
    at least ntaps-1; the state is this rank's [1, ntaps-1] complex64 row."""
    taps_np = np.asarray(taps)
    k = int(taps_np.shape[-1])
    dev = mesh_device(mesh)
    idx = axis_index(mesh, axis)

    def init_state():
        return torch.zeros((1, k - 1), dtype=torch.complex64, device=dev)

    def apply(state, x):
        x = _local(x, dev, k - 1)
        recv = ring_forward(x[x.shape[-1] - (k - 1):], mesh, axis)
        halo, new_state = _carry(state, recv, idx)
        y = dsp_fir.fir_filter(torch.cat([halo, x]), taps_np, decimation)
        return new_state, y

    return init_state, apply


def make_sharded_fft_filter(taps, mesh, axis: str = "shard",
                            decimation: int = 1):
    """Overlap-add across time blocks, with an additive output-tail halo:
    (init_state, apply, plan).  The block L must be a multiple of the
    plan's nsamples AND of ``decimation``."""
    plan = dsp_ofa.plan_fft_filter(taps, decimation=1)
    k = plan.ntaps
    dev = mesh_device(mesh)
    idx = axis_index(mesh, axis)
    xformed = torch.as_tensor(plan.xformed_taps, device=dev)
    zeros = torch.zeros(k - 1, dtype=torch.complex64, device=dev)

    def init_state():
        return torch.zeros((1, k - 1), dtype=torch.complex64, device=dev)

    def apply(state, x):
        x = _local(x, dev)
        local = x.shape[-1]
        if local % plan.nsamples or local % decimation:
            raise ValueError(
                f"per-shard block {local} must be a multiple of nsamples="
                f"{plan.nsamples} and decimation={decimation}")
        # the block's overlap-add at full rate from a zero boundary tail
        y, end_tail = dsp_ofa._ofa_filter(
            x, zeros, xformed, nsamples=plan.nsamples, fftsize=plan.fftsize,
            ntaps=k, decimation=1)
        recv = ring_forward(end_tail, mesh, axis)
        halo, new_state = _carry(state, recv, idx)
        y[: k - 1] += halo
        if decimation > 1:
            y = y[::decimation]
        return new_state, y

    return init_state, apply, plan


def make_sharded_channelizer(taps, num_channels: int, ninputs_per_iter: int,
                             ch_map, mesh, axis: str = "shard"):
    """Time-sharded PFB channelizer: an input halo of ntaps-1 samples,
    out [L / R, len(ch_map)] a rank.  The oversampling rotation's phase is
    global, so rank i's output groups start at i · L / R.  L must be a
    multiple of num_channels and R, and at least ntaps-1.  Returns
    (init_state, apply)."""
    taps_rm, ntaps = dsp_chan._pfb_constants(taps, num_channels,
                                              ninputs_per_iter)
    dev = mesh_device(mesh)
    idx = axis_index(mesh, axis)
    ch = torch.as_tensor(np.asarray(ch_map, np.int64), device=dev)

    def init_state():
        return torch.zeros((1, ntaps - 1), dtype=torch.complex64, device=dev)

    def apply(state, x):
        x = _local(x, dev, ntaps - 1)
        local = x.shape[-1]
        if local % ninputs_per_iter or local % num_channels:
            raise ValueError(
                f"per-shard block {local} must be a multiple of "
                f"num_channels={num_channels} and R={ninputs_per_iter}")
        recv = ring_forward(x[local - (ntaps - 1):], mesh, axis)
        halo, new_state = _carry(state, recv, idx)
        out = dsp_chan._channelize(
            torch.cat([halo, x]), taps_rm, ch, idx * (local // ninputs_per_iter),
            num_channels=num_channels, ninputs_per_iter=ninputs_per_iter,
            ntaps=ntaps)
        return new_state, out

    return init_state, apply

