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
``precision``) have no counterpart: the port always multiplies and
accumulates in float32.  The sharded pipelines are not ported yet
(ROADMAP.md A.4).
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
from clenabled_tpu_torch.runtime.device import get_device

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
        a, m, n = self.a, self.m, self.n
        if xr.shape[-1] != n:
            raise ValueError(f"frame length {xr.shape[-1]} != samples_per_step {n}")
        # the kernel takes contiguous rows; a no-op for the usual frames
        xr, xi, tr, ti = (t.contiguous() for t in (xr, xi, tr, ti))
        fd_sum, gram = hopper_kernels.fx_correlate_streams_v2(
            xr, xi, tr, ti, self.taps_rm, a, m, fd_pairs=self.fd_pairs,
            xe_pairs=self.xe_pairs)
        fd = torch.roll(fd_sum / (n // m), m // 2, dims=-1)
        xre = gram[:, :m].T[:, :, None]
        xim = gram[:, m:].T[:, :, None]
        return fd, xre, xim, _tail(xr, self.tail_len), _tail(xi, self.tail_len)


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


def _tensor_from_reference(arr, dtype: torch.dtype | None,
                           device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy refuses: move the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(torch.device(device)).contiguous()


def carry_from_reference(tail_r, tail_i, dtype=None, device="cpu"):
    """The JAX step's carried tails (numpy arrays, bf16 as
    ``ml_dtypes.bfloat16``) as the port's tensors, so a stream begun in the
    JAX package continues in the port."""
    if dtype is not None:
        dtype = _IN_DTYPES[hopper_kernels._dtype_name(dtype)]
    return (_tensor_from_reference(tail_r, dtype, device),
            _tensor_from_reference(tail_i, dtype, device))


def xengine_state_from_reference(accum_re, accum_im, count, device="cpu"):
    """A JAX ``XEngineState`` of the planar / channel-major X-Engine
    (its accumulator's re and im parts and its count, as numpy arrays) as
    the port's, so an integration begun in the JAX package continues in
    the port."""
    accum = planar.PC(_tensor_from_reference(accum_re, torch.float32, device),
                      _tensor_from_reference(accum_im, torch.float32, device))
    return dsp_xengine.XEngineState(accum=accum,
                                    count=int(np.asarray(count)))


def taps_from_reference(taps_rm) -> torch.Tensor:
    """The JAX package's branch-major taps [W, m] as a float32 tensor."""
    return torch.from_numpy(np.array(taps_rm, np.float32))
