"""The FX receive step — the port of ``clenabled_tpu.pipelines``.

Per antenna a 16-channel critically sampled polyphase channelizer, a
frequency-domain cross-correlation of every antenna against antenna 0
(clxcorrelate_fft_vcf role) and an X-Engine Gram integration over the
baselines (clXEngine role), with the input tail carried between steps.

Each ``make_*`` returns ``(fn, example_args)`` like its JAX counterpart:
``fn`` is an ``nn.Module`` whose constants are buffers on ``device`` and
whose ``forward`` takes and returns the same tensors as the JAX step.
``device=None`` means ``cuda:0`` and raises when no card is visible;
pass ``device="cpu"`` to run the plain torch forms on the host.

The TPU engine selectors of the JAX pipelines (``mxu_dtype``,
``branch_mxu``, ``deep_strategy``, ``karatsuba``, ``interpret``,
``precision``, ``tile_rows``) have no counterpart: the port always
multiplies and accumulates in float32.

The sharded steps (``make_sharded_fx_pipeline[_fused]``) run one rank a
process over a ``torch.distributed`` ``DeviceMesh`` (``sharding``): the
stream is time-sharded, each rank holds its [A, L] block, the carried tail
rides ``ring_forward`` and the sums ``psum``.

The ``*_from_reference`` functions hand state over from the JAX package:
the FX step's tails, an X-Engine integration, and a whole ``Runner``'s
carried states (``runner_state_from_reference``: filter tails, Costas
loop and signal-source states, channelizer histories and fused tails);
and, for the sharded forms, a stacked X-Engine's global integration as
this rank's channel slice (``sharded_xengine_state_from_reference``) and
a ``ShardedChain``'s per-stage [D, K] states as this rank's rows
(``sharded_chain_state_from_reference``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from clenabled_tpu_torch.dsp import channelizer as dsp_chan
from clenabled_tpu_torch.dsp import firdes, hopper_kernels, planar
from clenabled_tpu_torch.dsp import xcorr as dsp_xcorr
from clenabled_tpu_torch.dsp import xengine as dsp_xengine
from clenabled_tpu_torch.runtime import trace
from clenabled_tpu_torch.runtime.device import get_device, mesh_device
from clenabled_tpu_torch.sharding.collectives import (axis_index, axis_size,
                                                      broadcast, pmean, psum,
                                                      ring_forward)

_IN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


class FxPipelineConfig(NamedTuple):
    num_antennas: int = 4
    num_channels: int = 16
    samples_per_step: int = 1 << 17   # per antenna per step
    max_shift: int = 512              # (reserved for TD followups)


def _prototype(m: int, samp_rate: float, proto_taps=None):
    """(taps_rm [W, m], ntaps = W·m) of the step's prototype: the sharp
    Hamming low-pass (385 taps at m=16, zero-padded to 400) by default."""
    if proto_taps is None:
        proto = firdes.low_pass(1.0, samp_rate, samp_rate / (2 * m) * 0.8,
                                samp_rate / (2 * m) * 0.2)
    else:
        proto = np.asarray(proto_taps, np.float32)
    proto = np.concatenate([proto, np.zeros((-len(proto)) % m, np.float32)])
    return dsp_chan._pfb_constants(proto, m, m)


def _device(device) -> torch.device:
    return get_device("cuda") if device is None else torch.device(device)


def _tail(x: torch.Tensor, length: int) -> torch.Tensor:
    """The last ``length`` samples of each row, as a new tensor."""
    return x[:, x.shape[-1] - length:].contiguous()


class FxPipeline(nn.Module):
    """Complex64 form: forward(x [A, N], hist [A, T-1]) → (fd_avg [A-1, M],
    xmat [M, nb, 1] complex64, new_hist [A, T-1])."""

    def __init__(self, taps_rm, ntaps: int, m: int, device: torch.device):
        super().__init__()
        self.m, self.ntaps = m, ntaps
        self.register_buffer("taps_rm", torch.as_tensor(taps_rm, device=device))
        self.register_buffer("ch_map", torch.arange(m, device=device))

    def forward(self, x, hist):
        m = self.m
        full = torch.cat([hist, x], dim=-1)                 # [A, T-1+N]
        spectra = dsp_chan._channelize(
            full, self.taps_rm, self.ch_map, num_channels=m,
            ninputs_per_iter=m, ntaps=self.ntaps)           # [A, N/M, M]
        new_hist = _tail(full, self.ntaps - 1)
        fd_avg = dsp_xcorr.fd_xcorr(spectra).mean(dim=1)    # [A-1, M]
        z = spectra.permute(1, 0, 2)[..., None]             # [T, S, F, 1]
        xmat = dsp_xengine.xengine_correlate(z, npol=1)
        return fd_avg, xmat, new_hist


def make_fx_pipeline(cfg: FxPipelineConfig = FxPipelineConfig(),
                     samp_rate: float = 100e6, device=None):
    """Complex64 step with ``torch.fft``: fn(x, hist) with x [A, N] and
    hist [A, T-1] complex64 → (fd_corr [A-1, F], xmatrix [F, nb, 1],
    new_hist)."""
    dev = _device(device)
    a, m, n = cfg.num_antennas, cfg.num_channels, cfg.samples_per_step
    taps_rm, ntaps = _prototype(m, samp_rate)
    fn = FxPipeline(taps_rm, ntaps, m, dev)
    x = torch.zeros((a, n), dtype=torch.complex64, device=dev)
    hist = torch.zeros((a, ntaps - 1), dtype=torch.complex64, device=dev)
    return fn, (x, hist)


class FxPipelinePlanar(nn.Module):
    """Planar form: forward(xr, xi, hr, hi) → (fd_avg [A-1, M], xmat_re,
    xmat_im [M, nb, 1], new_hr, new_hi), all float32."""

    def __init__(self, taps_rm, ntaps: int, a: int, m: int, n: int,
                 use_kernel: bool | None, device: torch.device):
        super().__init__()
        self.a, self.m, self.ntaps, self.nout = a, m, ntaps, n // m
        self.use_kernel = use_kernel
        self.register_buffer("taps_rm", torch.as_tensor(taps_rm, device=device))

    def forward(self, xr, xi, hr, hi):
        a, m, ntaps, nout = self.a, self.m, self.ntaps, self.nout
        on_cuda = xr.device.type == "cuda"
        use_kernel = on_cuda if self.use_kernel is None else self.use_kernel
        if use_kernel and not on_cuda:
            raise ValueError("use_kernel=True needs CUDA tensors")
        fr = torch.cat([hr, xr], dim=-1)                    # [A, T-1+N]
        fi = torch.cat([hi, xi], dim=-1)
        comps = torch.cat([fr, fi], dim=0)                  # [2A, L]
        if use_kernel:
            y, hrt = dsp_chan._pack_streams(comps, self.taps_rm, m, ntaps, nout)
            z = hopper_kernels.pfb_channelize_packed(y, hrt, a, m)
            zs = z.view(nout, 2 * a, m)
            # spectra in [time, antenna, channel], the layout both consumers use
            spec = planar.PC(zs[:, :a], zs[:, a:])
        else:
            acc = dsp_chan._branch_sums_critical_batched(
                comps, self.taps_rm, m, ntaps, nout)        # [2A, N/M, M]
            z2 = planar.ifft_unscaled(planar.PC(acc[:a], acc[a:]))
            spec = planar.PC(z2.re.transpose(0, 1), z2.im.transpose(0, 1))
        new_hr = _tail(fr, ntaps - 1)
        new_hi = _tail(fi, ntaps - 1)
        # FD xcorr of each antenna vs antenna 0, averaged over time frames
        ref = planar.PC(spec.re[:, :1], spec.im[:, :1])
        sig = planar.PC(spec.re[:, 1:], spec.im[:, 1:])
        prod = planar.mul_conj(ref, sig)                    # [T, A-1, M]
        corr = planar.pabs(planar.ifft_unscaled(prod)).mean(dim=0)
        fd = torch.roll(corr, m // 2, dims=-1)              # [A-1, M]
        xz = planar.PC(spec.re[..., None], spec.im[..., None])
        xmat = dsp_xengine.xengine_correlate_planar(xz, npol=1)
        return fd, xmat.re, xmat.im, new_hr, new_hi


def make_fx_pipeline_planar(cfg: FxPipelineConfig = FxPipelineConfig(),
                            samp_rate: float = 100e6,
                            use_kernel: bool | None = None,
                            proto_taps=None, device=None):
    """Planar-complex step: fn(xr, xi, hr, hi) → (fd_avg, xmat_re,
    xmat_im, new_hr, new_hi), all float32.

    use_kernel: run the channelizer front end as the packed PFB kernel
    (``hopper_kernels.pfb_channelize_packed``).  None: the tensors' device
    decides (kernel for CUDA tensors, plain torch on the CPU); True with
    CPU tensors raises.  proto_taps: override the channelizer prototype."""
    dev = _device(device)
    a, m, n = cfg.num_antennas, cfg.num_channels, cfg.samples_per_step
    taps_rm, ntaps = _prototype(m, samp_rate, proto_taps)
    fn = FxPipelinePlanar(taps_rm, ntaps, a, m, n, use_kernel, dev)
    x = torch.zeros((a, n), dtype=torch.float32, device=dev)
    hist = torch.zeros((a, ntaps - 1), dtype=torch.float32, device=dev)
    return fn, (x, x, hist, hist)


class FxPipelineFused(nn.Module):
    """Fused form: forward(xr, xi, tr, ti) → (fd [nfd, M], xre, xim
    [M, nb, 1], new_tr, new_ti); fd and the Gram planes are float32, the
    tails keep the ingest dtype."""

    def __init__(self, taps_rm, a: int, m: int, n: int, tail_len: int,
                 fd_pairs, xe_pairs, device: torch.device):
        super().__init__()
        self.a, self.m, self.n, self.tail_len = a, m, n, tail_len
        self.fd_pairs, self.xe_pairs = fd_pairs, xe_pairs
        self.register_buffer("taps_rm", torch.as_tensor(taps_rm, device=device))

    def forward(self, xr, xi, tr, ti):
        """One step, traced as ``fx.step`` with ``fx.finish`` around what
        follows the kernel's wrapper (the mean, the shift, the Gram
        planes and the tails)."""
        a, m, n = self.a, self.m, self.n
        with trace.span("fx.step"):
            if xr.shape[-1] != n:
                raise ValueError(
                    f"frame length {xr.shape[-1]} != samples_per_step {n}")
            # the kernel takes contiguous rows; a no-op for the usual frames
            xr, xi, tr, ti = (t.contiguous() for t in (xr, xi, tr, ti))
            fd_sum, gram = hopper_kernels.fx_correlate_streams_v2(
                xr, xi, tr, ti, self.taps_rm, a, m, fd_pairs=self.fd_pairs,
                xe_pairs=self.xe_pairs)
            with trace.span("fx.finish"):
                fd = torch.roll(fd_sum / (n // m), m // 2, dims=-1)
                xre = gram[:, :m].T[:, :, None]
                xim = gram[:, m:].T[:, :, None]
                return (fd, xre, xim, _tail(xr, self.tail_len),
                        _tail(xi, self.tail_len))


def make_fx_pipeline_fused(cfg: FxPipelineConfig = FxPipelineConfig(),
                           samp_rate: float = 100e6,
                           in_dtype=torch.float32, proto_taps=None,
                           fd_pairs=None, xe_pairs=None, device=None):
    """The fused step: ONE kernel (``hopper_kernels.fx_correlate_streams_v2``)
    does PFB → DFT → FD-xcorr sums → X-Engine Gram sums, reading each input
    sample once, with no host-side concat of tail and frame.

    Outputs equal ``make_fx_pipeline_planar``'s on the stream delayed by
    ``fx_tail_len(in_dtype, m, ntaps) − (ntaps − 1)`` samples (a fixed
    pipeline latency, the same as the JAX step's).  in_dtype: float32,
    bfloat16 or int8 (the reference's IChar ingest, used raw).
    proto_taps overrides the prototype (any depth; the carried tail grows
    with it).  fd_pairs / xe_pairs restrict the antenna pairs; the output
    rows then follow the given pair order."""
    dev = _device(device)
    a, m, n = cfg.num_antennas, cfg.num_channels, cfg.samples_per_step
    dtype = _IN_DTYPES[hopper_kernels._dtype_name(in_dtype)]
    taps_rm, ntaps = _prototype(m, samp_rate, proto_taps)
    big_h = hopper_kernels.fx_tail_len(dtype, m, ntaps)
    if n < big_h or n % m:
        raise ValueError(f"samples_per_step must be a multiple of {m} and at "
                         f"least the {big_h}-sample carried tail")
    fn = FxPipelineFused(taps_rm, a, m, n, big_h, fd_pairs, xe_pairs, dev)
    x = torch.zeros((a, n), dtype=dtype, device=dev)
    tail = torch.zeros((a, big_h), dtype=dtype, device=dev)
    return fn, (x, x, tail, tail)


class ShardedFxPipeline(nn.Module):
    """The complex64 step on one rank: forward(x [A, L] this rank's
    block, hist [A, T-1] replicated) → (fd_avg [A-1, M], xmat [M, nb, 1],
    new_hist [A, T-1]), the same on every rank of the axis."""

    def __init__(self, taps_rm, ntaps: int, m: int, mesh, axis: str,
                 device: torch.device):
        super().__init__()
        self.m, self.ntaps, self.mesh, self.axis = m, ntaps, mesh, axis
        self.idx = axis_index(mesh, axis)
        self.register_buffer("taps_rm", torch.as_tensor(taps_rm, device=device))
        self.register_buffer("ch_map", torch.arange(m, device=device))

    def forward(self, x, hist):
        m, mesh, axis = self.m, self.mesh, self.axis
        recv = ring_forward(_tail(x, self.ntaps - 1), mesh, axis)
        full = torch.cat([hist if self.idx == 0 else recv, x], dim=-1)
        spectra = dsp_chan._channelize(
            full, self.taps_rm, self.ch_map, num_channels=m,
            ninputs_per_iter=m, ntaps=self.ntaps)           # [A, L/M, M]
        fd = pmean(dsp_xcorr.fd_xcorr(spectra).mean(dim=1), mesh, axis)
        z = spectra.permute(1, 0, 2)[..., None]             # [T, S, F, 1]
        xmat = psum(dsp_xengine.xengine_correlate(z, npol=1), mesh, axis)
        # the frame's tail, for the next step: what rank 0 received
        return fd, xmat, broadcast(recv, mesh, 0, axis)


def make_sharded_fx_pipeline(mesh, axis: str = "shard",
                             cfg: FxPipelineConfig = FxPipelineConfig(),
                             samp_rate: float = 100e6):
    """The complex64 step time-sharded over ``axis`` of ``mesh``: each rank
    channelizes its block with the previous rank's input tail as its halo
    (``hist`` on rank 0), averages its FD cross-correlation and integrates
    its Gram, then ``pmean`` and ``psum`` over the axis.  Collectives a
    step: one ring hop, two all-reduces and one broadcast.

    ``cfg.samples_per_step`` is the block L a rank; the global frame is
    D · L.  Returns (fn, example_args): fn an ``nn.Module`` on this rank's
    device, the arguments this rank's zero [A, L] block and hist."""
    dev = mesh_device(mesh)
    a, m, n_local = cfg.num_antennas, cfg.num_channels, cfg.samples_per_step
    taps_rm, ntaps = _prototype(m, samp_rate)
    if n_local < ntaps - 1:
        raise ValueError(
            f"per-shard block ({n_local}) must be >= the channelizer halo "
            f"({ntaps - 1} samples)")
    fn = ShardedFxPipeline(taps_rm, ntaps, m, mesh, axis, dev)
    x = torch.zeros((a, n_local), dtype=torch.complex64, device=dev)
    hist = torch.zeros((a, ntaps - 1), dtype=torch.complex64, device=dev)
    return fn, (x, hist)


class ShardedFxPipelineFused(nn.Module):
    """The fused step on one rank: forward(xr, xi [A, L] this rank's
    block, tr, ti [A, H] the global stream's tail, replicated) → (fd
    [A-1, M], xre, xim [M, nb, 1], new_tr, new_ti), the same on every rank
    of the axis."""

    def __init__(self, taps_rm, a: int, m: int, n_local: int, tail_len: int,
                 mesh, axis: str, device: torch.device):
        super().__init__()
        self.a, self.m, self.n_local, self.tail_len = a, m, n_local, tail_len
        self.mesh, self.axis = mesh, axis
        self.idx, self.d = axis_index(mesh, axis), axis_size(mesh, axis)
        self.nout_total = n_local * self.d // m
        self.register_buffer("taps_rm", torch.as_tensor(taps_rm, device=device))

    def forward(self, xr, xi, tr, ti):
        a, m, n, h = self.a, self.m, self.n_local, self.tail_len
        mesh, axis = self.mesh, self.axis
        if xr.shape[-1] != n:
            raise ValueError(f"block length {xr.shape[-1]} != samples_per_step "
                             f"{n}")
        xr, xi, tr, ti = (t.contiguous() for t in (xr, xi, tr, ti))
        # this rank's tail: the left neighbour's last samples (rank 0: the
        # previous step's, carried)
        mine = torch.stack([xr[:, n - h:], xi[:, n - h:]])
        recv = ring_forward(mine, mesh, axis)
        my_tr, my_ti = (tr, ti) if self.idx == 0 else (recv[0], recv[1])
        fd_sum, gram = hopper_kernels.fx_correlate_streams_v2(
            xr, xi, my_tr, my_ti, self.taps_rm, a, m)
        sums = psum(torch.cat([fd_sum.reshape(-1), gram.reshape(-1)]),
                    mesh, axis)
        fd_sum, gram = (sums[: fd_sum.numel()].view(fd_sum.shape),
                        sums[fd_sum.numel():].view(gram.shape))
        fd = torch.roll(fd_sum / self.nout_total, m // 2, dims=-1)
        xre = gram[:, :m].T[:, :, None]
        xim = gram[:, m:].T[:, :, None]
        # the next step's tail: the last rank's frame tail, on every rank
        new = broadcast(mine, mesh, self.d - 1, axis)
        return fd, xre, xim, new[0], new[1]


def make_sharded_fx_pipeline_fused(mesh, axis: str = "shard",
                                   cfg: FxPipelineConfig = FxPipelineConfig(),
                                   samp_rate: float = 100e6,
                                   in_dtype=torch.float32):
    """The fused step time-sharded over ``axis`` of ``mesh``, the
    hand-written kernel (``hopper_kernels.fx_correlate_streams_v2``) on
    every rank's block: the carried tail rides the ring (rank i's is rank
    i-1's last ``fx_tail_len(in_dtype, M, ntaps)`` samples; rank 0's the
    previous step's), the FD and Gram sums are summed over the axis, and
    the next tails are the last rank's, broadcast.  Collectives a step: one
    ring hop, one all-reduce and one broadcast.

    ``cfg.samples_per_step`` is the block L a rank: at least the tail, a
    multiple of M.  The tail is the unsharded step's,
    ``fx_tail_len(in_dtype, M, ntaps)``: at 16 channels (400 taps) the
    1024/2048/4096 samples for float32/bfloat16/int8 that JAX's sharded
    step takes (``fx_tail_len(in_dtype)``, which the prototype fits in);
    at 64 channels (1600 taps) 2048/2048/4096, where JAX's would be
    shorter than the tap reach.  JAX's ``tile_rows``
    rule, which also asks L / 128 for a power-of-two factor of at least
    tail / 128 rows, tiles the TPU kernel only and is dropped.  Returns
    (fn, example_args): fn an ``nn.Module`` on this rank's device, the
    arguments this rank's zero [A, L] blocks and the replicated tails."""
    dev = mesh_device(mesh)
    a, m, n_local = cfg.num_antennas, cfg.num_channels, cfg.samples_per_step
    dtype = _IN_DTYPES[hopper_kernels._dtype_name(in_dtype)]
    taps_rm, ntaps = _prototype(m, samp_rate)
    tail_len = hopper_kernels.fx_tail_len(dtype, m, ntaps)
    if n_local < tail_len:
        raise ValueError(f"per-shard block ({n_local}) must be >= the "
                         f"carried tail ({tail_len} samples)")
    if n_local % m:
        raise ValueError(f"per-shard block ({n_local}) must be a multiple "
                         f"of {m}")
    fn = ShardedFxPipelineFused(taps_rm, a, m, n_local, tail_len, mesh, axis,
                                dev)
    x = torch.zeros((a, n_local), dtype=dtype, device=dev)
    tail = torch.zeros((a, tail_len), dtype=dtype, device=dev)
    return fn, (x, x, tail, tail)


def _tensor_from_reference(arr, dtype: torch.dtype | None,
                           device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy refuses: move the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))   # a writable copy
    if dtype is not None:
        t = t.to(dtype)
    return t.to(torch.device(device)).contiguous()


def carry_from_reference(tail_r, tail_i, dtype=None, device=None):
    """The JAX step's carried tails (numpy arrays, bf16 as
    ``ml_dtypes.bfloat16``) as the port's tensors, so a stream begun in the
    JAX package continues in the port.  On the card unless ``device`` says
    otherwise."""
    device = _device(device)
    if dtype is not None:
        dtype = _IN_DTYPES[hopper_kernels._dtype_name(dtype)]
    return (_tensor_from_reference(tail_r, dtype, device),
            _tensor_from_reference(tail_i, dtype, device))


def xengine_state_from_reference(accum_re, accum_im, count, device=None):
    """A JAX ``XEngineState`` of the planar / channel-major X-Engine
    (its accumulator's re and im parts and its count, as numpy arrays) as
    the port's, so an integration begun in the JAX package continues in
    the port.  On the card unless ``device`` says otherwise."""
    device = _device(device)
    accum = planar.PC(_tensor_from_reference(accum_re, torch.float32, device),
                      _tensor_from_reference(accum_im, torch.float32, device))
    return dsp_xengine.XEngineState(accum=accum,
                                    count=int(np.asarray(count)))


def sharded_xengine_state_from_reference(accum_re, accum_im, count, mesh,
                                         axis: str = "shard"):
    """A JAX sharded stacked X-Engine's state (its GLOBAL planar
    accumulator [F, ...] as re and im numpy arrays, and its int32 count)
    as this rank's state of ``sharding.make_sharded_xengine_stacked``: the
    rows of this rank's F/D channels on the mesh's device, the count a
    host int."""
    d, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    dev = mesh_device(mesh)
    f = np.shape(accum_re)[0]
    if f % d:
        raise ValueError(f"channels ({f}) must divide mesh size {d}")
    rows = slice(idx * (f // d), (idx + 1) * (f // d))
    accum = planar.PC(*(_tensor_from_reference(np.asarray(a)[rows],
                                               torch.float32, dev)
                        for a in (accum_re, accum_im)))
    return dsp_xengine.XEngineState(accum=accum,
                                    count=int(np.asarray(count)))


def sharded_chain_state_from_reference(states, mesh, axis: str = "shard"):
    """A JAX ``ShardedChain``'s states (per stage its GLOBAL [D, K]
    complex64 array as numpy, or () for a map) as this rank's state of the
    port's chain built with the same stages: row ``axis_index`` of each,
    [1, K] on the mesh's device."""
    d, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    dev = mesh_device(mesh)
    out = []
    for i, st in enumerate(states):
        if isinstance(st, tuple) and not st:
            out.append(())
            continue
        arr = np.asarray(st)
        if arr.ndim != 2 or arr.shape[0] != d:
            raise ValueError(f"stage {i}: state of shape {arr.shape}, "
                             f"expected [{d}, K]")
        out.append(_tensor_from_reference(arr[idx:idx + 1], torch.complex64,
                                          dev))
    return tuple(out)


def _state_from_reference(ref, like, where: str):
    """``ref`` (numpy leaves) rebuilt in the containers of ``like`` with
    its leaves' dtypes and devices; raises where the two trees differ."""
    if isinstance(like, (tuple, list)):
        if not isinstance(ref, (tuple, list)) or len(ref) != len(like):
            raise ValueError(f"{where}: the state trees differ")
        items = [_state_from_reference(r, x, f"{where}[{i}]")
                 for i, (r, x) in enumerate(zip(ref, like))]
        return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)
    arr = np.array(ref)                   # a writable copy of the leaf
    if not torch.is_tensor(like):
        return type(like)(arr)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{where}: shape {arr.shape} != {tuple(like.shape)}")
    return _tensor_from_reference(arr, like.dtype, like.device)


def runner_state_from_reference(runner, states, state_kinds):
    """A JAX ``Runner``'s carried states as the port ``Runner``'s, for the
    same flowgraph built in both packages, so a stream begun in the JAX
    package continues in the port: ``runner.states = ...`` with the result.

    Args:
      runner: the port's ``Runner`` (its blocks, state layout and device).
      states: the JAX Runner's ``states`` with numpy leaves (e.g.
        ``jax.tree.map(np.asarray, jr.states)``); planar pairs may stay the
        JAX package's ``planar.PC``.
      state_kinds: per block in the JAX Runner's order, its filter state
        kind (``block._state_kind``: "td", "ofa" or "ofs") or None.

    Named tuples move into the port's own (a JAX ``CostasState`` becomes
    the port's ``CostasState``, a ``SigGenState`` its ``SigGenState``) and
    0-d leaves stay 0-d: a chunked ``CostasLoop`` carries (CostasState of
    0-d leaves, planar.PC of its ``warmup``-sample tail), a
    ``CostasLoop(num_streams=N)`` a CostasState of [N] leaves.  A ``PolyphaseChannelizer`` carries (re, im) of
    its ntaps−1 history, or with ``fused=True`` of its os_tail_len tail;
    the tail is always the longer (by at least 130 − R samples), so the
    shape check refuses a hand-over between the two forms.

    Raises ValueError where the trees, a leaf's shape or a block's state
    kind differ — always between an overlap-add (output-domain) and an
    overlap-save (input-domain) filter tail, which have no mapping (the
    rule of ``Filter.migrate_state``).  Filter taps are numpy designs that
    both packages share, so only the states move."""
    blocks = runner._order
    if len(states) != len(blocks) or len(state_kinds) != len(blocks):
        raise ValueError(f"expected the states of {len(blocks)} blocks")
    for i, (b, kind) in enumerate(zip(blocks, state_kinds)):
        mine = getattr(b, "_state_kind", None)
        if kind == mine:
            continue
        if {kind, mine} == {"ofa", "ofs"}:
            raise ValueError(
                f"block {i} ({b}): an overlap-add tail does not map to an "
                f"overlap-save one; build both filters in the same form "
                f"(the port's make_fft_filter_planar(fused=...))")
        raise ValueError(f"block {i} ({b}): state kind {kind!r} != {mine!r}")
    return tuple(_state_from_reference(s, like, f"block {i}")
                 for i, (s, like) in enumerate(zip(states, runner.states)))


def taps_from_reference(taps_rm) -> torch.Tensor:
    """The JAX package's branch-major taps [W, m] as a float32 tensor."""
    return torch.from_numpy(np.array(taps_rm, np.float32))
