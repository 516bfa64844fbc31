"""Planar (complex-free) time-sharded filters and channel-parallel Costas
loops over a ``DeviceMesh``.

The port of ``clenabled_tpu.sharding.planar_halo``: the ring halos of
``halo.py`` with streams and states as (re, im) float32 pairs.

- ``make_sharded_fft_filter_planar``: overlap-add with an additive
  output-tail halo, or the overlap-save kernel
  (``hopper_kernels.ofs_filter_planar``) with an input-tail halo;
- ``make_sharded_channelizer_planar``: the PFB channelizer with an
  ntaps−1 input halo;
- ``make_sharded_channelizer_fused_oversampled``: the fused oversampled
  PFB kernel (``hopper_kernels.pfb_oversampled_fused``) with an
  os_tail_len input halo;
- ``make_sharded_costas_channels``: C independent streams, C/D a rank,
  each running the chunked Costas loop, with no collective;
- ``sharded_xengine_planar``: the station-sharded X-Engine on (re, im),
  one ``all_to_all`` a component.

Time-sharded functions take this rank's block of L samples (a planar.PC)
and keep this rank's row of JAX's [D, K] state, ``((1, K), (1, K))``;
rank 0 consumes the carried state and keeps what the ring delivered, as in
``halo.py``.  The channel-parallel loops take the GLOBAL [C, n] frames, as
JAX's caller passes them, and move only this rank's channels to its
device (the convention of ``xcorr_sharded``); their state is this rank's
C/D rows.  The X-Engine takes this rank's stations and returns its
channels, as ``xengine_sharded`` does.  With D = 1 each is the sequential
form, bit for bit.
"""

from __future__ import annotations

import torch

from clenabled_tpu_torch.dsp import channelizer as dsp_chan
from clenabled_tpu_torch.dsp import demod
from clenabled_tpu_torch.dsp import fft_filter as dsp_ofa
from clenabled_tpu_torch.dsp import hopper_kernels, planar
from clenabled_tpu_torch.dsp import xengine as dsp_xengine
from clenabled_tpu_torch.runtime.device import mesh_device
from clenabled_tpu_torch.sharding.collectives import (axis_index, axis_size,
                                                      ring_forward)
from clenabled_tpu_torch.sharding.xengine_sharded import (_channel_shard,
                                                          _check_time_major)


def _block(x, dev: torch.device) -> planar.PC:
    """This rank's block as a float32 planar.PC on ``dev``."""
    return planar.PC(*(torch.as_tensor(v, device=dev).to(torch.float32)
                       for v in x))


def _need(x: planar.PC, halo: int) -> None:
    """A block shorter than the ``halo`` its neighbour needs raises."""
    if x.re.shape[-1] < halo:
        raise ValueError(f"per-shard block {x.re.shape[-1]} must be >= the "
                         f"{halo}-sample halo")


def _zeros_pair(k: int, dev: torch.device):
    z = torch.zeros((1, k), device=dev)
    return (z, z.clone())


def _carry(send_r, send_i, state, mesh, axis: str, idx: int):
    """(halo pair, new state): the previous rank's (send_r, send_i), or
    rank 0's carried state, which then keeps what the ring delivered."""
    recv = (ring_forward(send_r, mesh, axis), ring_forward(send_i, mesh, axis))
    if idx == 0:
        return (state[0][0], state[1][0]), (recv[0].clone()[None],
                                            recv[1].clone()[None])
    return recv, state


def _tail(x: planar.PC, k: int):
    n = x.re.shape[-1]
    return x.re[n - k:], x.im[n - k:]


def make_sharded_fft_filter_planar(taps, mesh, axis: str = "shard",
                                   decimation: int = 1,
                                   use_pallas: bool | None = None):
    """Planar fast-convolution filter across time blocks: (init_state,
    apply), apply(state, x_local: PC[L]) → (state, PC[L / decimation]).

    ``use_pallas`` (JAX's name; default: on when the mesh's device is a
    CUDA card, as ``make_fft_filter_planar(fused=None)`` decides) takes
    the overlap-save kernel with an INPUT-tail ring halo (rank i consumes
    rank i−1's last ``tail_len`` samples, rank 0 the carried state); L must
    be a multiple of the kernel's frame quantum and of ``decimation``.
    Otherwise the overlap-add form with the additive OUTPUT-tail halo; L a
    multiple of the plan's nsamples and of ``decimation``.  Both give the
    sequential filter's output samples."""
    dev = mesh_device(mesh)
    if use_pallas is None:
        use_pallas = dev.type == "cuda"
    if use_pallas:
        try:
            oplan = hopper_kernels.OfsPlan(taps)
        except ValueError:
            oplan = None
        if oplan is not None:
            return _make_sharded_ofs(oplan, mesh, axis, decimation)
    plan = dsp_ofa.plan_fft_filter(taps, decimation=1)
    k = plan.ntaps
    idx = axis_index(mesh, axis)
    xformed = torch.as_tensor(plan.xformed_taps, device=dev)
    zeros = torch.zeros(k - 1, device=dev)

    def init_state():
        return _zeros_pair(k - 1, dev)

    def apply(state, x):
        x = _block(x, dev)
        local = x.re.shape[-1]
        if local % plan.nsamples or local % decimation:
            raise ValueError(
                f"per-shard block {local} must be a multiple of nsamples="
                f"{plan.nsamples} and decimation={decimation}")
        # the block's overlap-add at full rate from a zero boundary tail
        yr, yi, tr, ti = dsp_ofa._ofa_filter_planar(
            x.re, x.im, zeros, zeros, xformed, nsamples=plan.nsamples,
            fftsize=plan.fftsize, ntaps=k, decimation=1)
        halo, new_state = _carry(tr, ti, state, mesh, axis, idx)
        yr[: k - 1] += halo[0]
        yi[: k - 1] += halo[1]
        if decimation > 1:
            yr, yi = yr[::decimation], yi[::decimation]
        return new_state, planar.PC(yr, yi)

    return init_state, apply


def _make_sharded_ofs(oplan, mesh, axis: str, decimation: int):
    """The overlap-save kernel on each time block, with an input-tail ring
    halo."""
    oplan.decimation = decimation
    tl = oplan.tail_len
    quantum = dsp_ofa.frame_quantum(oplan)
    dev = mesh_device(mesh)
    idx = axis_index(mesh, axis)

    def init_state():
        return _zeros_pair(tl, dev)

    def apply(state, x):
        x = _block(x, dev)
        local = x.re.shape[-1]
        if local % quantum or local % decimation:
            raise ValueError(
                f"per-shard block {local} must be a multiple of the fused "
                f"kernel quantum {quantum} and decimation={decimation}")
        _need(x, tl)
        tail, new_state = _carry(*_tail(x, tl), state, mesh, axis, idx)
        yr, yi = hopper_kernels.ofs_filter_planar(
            x.re.contiguous(), x.im.contiguous(), tail[0].contiguous(),
            tail[1].contiguous(), oplan, decimation=decimation)
        return new_state, planar.PC(yr, yi)

    return init_state, apply


def make_sharded_channelizer_planar(taps, num_channels: int,
                                    ninputs_per_iter: int, ch_map, mesh,
                                    axis: str = "shard"):
    """Planar time-sharded PFB channelizer: an input halo of ntaps−1
    samples of both components; rank i's output groups start at i·L/R
    (the oversampling rotation's phase is global).  (init_state, apply),
    apply(state, x_local: PC[L]) → (state, PC[L/R, len(ch_map)]); L a
    multiple of num_channels and R, and at least ntaps−1."""
    taps_rm, ntaps = dsp_chan._pfb_constants(taps, num_channels,
                                              ninputs_per_iter)
    dev = mesh_device(mesh)
    idx = axis_index(mesh, axis)
    ch = torch.as_tensor([int(c) for c in ch_map], device=dev)

    def init_state():
        return _zeros_pair(ntaps - 1, dev)

    def apply(state, x):
        x = _block(x, dev)
        local = x.re.shape[-1]
        if local % ninputs_per_iter or local % num_channels:
            raise ValueError(
                f"per-shard block {local} must be a multiple of "
                f"num_channels={num_channels} and R={ninputs_per_iter}")
        _need(x, ntaps - 1)
        halo, new_state = _carry(*_tail(x, ntaps - 1), state, mesh, axis, idx)
        full = planar.PC(torch.cat([halo[0], x.re]),
                         torch.cat([halo[1], x.im]))
        out = dsp_chan._channelize_planar(
            full, taps_rm, ch, idx * (local // ninputs_per_iter),
            num_channels=num_channels, ninputs_per_iter=ninputs_per_iter,
            ntaps=ntaps)
        return new_state, out

    return init_state, apply


def make_sharded_channelizer_fused_oversampled(taps, num_channels: int,
                                               ninputs_per_iter: int, mesh,
                                               axis: str = "shard"):
    """Time-sharded fused oversampled PFB (``hopper_kernels.
    pfb_oversampled_fused``) with an os_tail_len input halo.

    The rotation needs no per-rank constant: a rank's first output group
    is idx·L/R, a multiple of M/R (checked), and any advance by a multiple
    of M/R groups leaves the rotation (j + i·(M−R)) mod M as it is, since
    (M/R)·(M−R) ≡ 0 (mod M) — the invariance the streaming form relies on
    between calls.  Outputs lag the stream by os_tail_len samples, as the
    single-card streaming kernel's do.  (init_state, apply),
    apply(state, x_local: PC[L]) → (state, PC[L/R, M]); L a multiple of
    1024 and of R·(M/R) (JAX's frame rule per shard)."""
    m, r = num_channels, ninputs_per_iter
    taps_rm, ntaps = dsp_chan._pfb_constants(taps, m, r)
    dev = mesh_device(mesh)
    if not dsp_chan.fused_oversampled_supported(m, r, ntaps, dev):
        raise ValueError(f"fused oversampled kernel unsupported for "
                         f"M={m}, R={r}, ntaps={ntaps}")
    h = hopper_kernels.os_tail_len(m, r, ntaps)
    ell = m // r
    idx = axis_index(mesh, axis)
    taps_on = torch.as_tensor(taps_rm, dtype=torch.float32, device=dev)

    def init_state():
        return _zeros_pair(h, dev)

    def apply(state, x):
        x = _block(x, dev)
        local = x.re.shape[-1]
        if (local // r) % ell or local % 1024:
            raise ValueError(
                f"per-shard block {local} must be a multiple of 1024 and "
                f"of R·L")
        _need(x, h)
        tail, new_state = _carry(*_tail(x, h), state, mesh, axis, idx)
        zr, zi = hopper_kernels.pfb_oversampled_fused(
            x.re.contiguous(), x.im.contiguous(), tail[0].contiguous(),
            tail[1].contiguous(), taps_on, m, r)
        return new_state, planar.PC(zr, zi)

    return init_state, apply


def make_sharded_costas_channels(loop_bw: float, order: int, mesh,
                                 axis: str = "shard", chunk: int = 1024,
                                 warmup: int = 512,
                                 exact_fallback_residual: float | None = None):
    """Channel-parallel chunked Costas loops: C independent streams (e.g. a
    channelizer's outputs) split over the mesh axis, C/D a rank, each
    running the speculative chunk-parallel loop
    (``demod.make_costas_loop_chunked``) with no collective.  All of a
    rank's channels × chunks are rows of the same three batched launches a
    frame.

    (init_state, apply): init_state(num_channels) → this rank's
    (CostasState of [C/D], tail PC [C/D, warmup]); apply(state, x) with x
    the global PC[C, n] → (state, this rank's PC[C/D, n], diag of [C/D]
    tensors: "residual", "exact", "branch_hops", "fell_back").  C must be
    a multiple of the axis size."""
    run = demod._make_costas_chunked_rows(loop_bw, order, 1.0, -1.0, chunk,
                                          warmup, exact_fallback_residual)
    d, i = axis_size(mesh, axis), axis_index(mesh, axis)
    dev = mesh_device(mesh)

    def rows_of(num_channels: int) -> slice:
        if num_channels % d:
            raise ValueError(f"channels {num_channels} not a multiple of "
                             f"mesh size {d}")
        k = num_channels // d
        return slice(i * k, (i + 1) * k)

    def init_state(num_channels: int):
        k = rows_of(num_channels)
        k = k.stop - k.start
        z = torch.zeros((3, k), device=dev)
        w = torch.zeros((k, warmup), device=dev)
        return (demod.CostasState(*z), planar.PC(w, w.clone()))

    def apply(state, x):
        mine = rows_of(x.re.shape[0])
        x = planar.PC(*(torch.as_tensor(v[mine], device=dev).to(
            torch.float32).contiguous() for v in x))
        return run(state, x)

    return init_state, apply


def sharded_xengine_planar(z, mesh, axis: str = "shard", npol: int = 2):
    """Planar station-sharded X-Engine: this rank's stations z PC[T, S/D,
    F, P] → this rank's channels, triangular PC[F/D, nb, npol²]."""
    z = _block(z, mesh_device(mesh))
    _check_time_major(z.re.shape, axis_size(mesh, axis))
    return dsp_xengine.xengine_correlate_planar(
        planar.PC(*(_channel_shard(v, mesh, axis) for v in z)), npol=npol)
