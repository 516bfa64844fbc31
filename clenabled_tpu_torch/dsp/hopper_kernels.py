"""Hand-written Hopper kernels of the FX receive step, with their plain forms.

The counterpart of ``clenabled_tpu.dsp.pallas_kernels`` for the two kernels
on the port's main path:

- ``fx_correlate_streams_v2`` (``csrc/fx_correlate.cu``): the fused step —
  critically sampled PFB, M-point inverse DFT, FD cross-correlation
  magnitude sums and X-Engine Gram sums, reading each input sample once.
- ``pfb_channelize_packed`` (``csrc/pfb_packed.cu``): the lane-packed PFB
  branch sums plus per-group inverse DFT of the planar pipeline.

Each wrapper keeps the JAX function's argument order, shapes and outputs.
Given CPU tensors it runs its plain torch form (``*_plain``, built from the
channelizer's branch sums and ``planar.ifft_unscaled``); given CUDA tensors
it launches its kernel or raises — it never falls back.  Each wrapper
counts its kernel launches in its ``launches`` attribute.

The TPU engine selectors of the JAX functions (``tile_rows``/``tile``,
``mxu_dtype``, ``branch_mxu``, ``karatsuba``, ``deep_strategy``,
``precision``, ``interpret``) have no counterpart: the kernels pick their
own tiles and always multiply and accumulate in float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from clenabled_tpu_torch.dsp import channelizer, planar, xengine

LANES = 128

_HALO_ROWS = {"float32": 8, "bfloat16": 16, "int8": 32}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@lru_cache(maxsize=None)
def _idft_block_matrix(m: int, num_antennas: int) -> np.ndarray:
    """[G·M, G·M] real matrix computing the unscaled inverse DFT for every
    antenna's (re, im) lane pair (groups a = re, A + a = im):
        z_re = acc_re @ Frᵀ − acc_im @ Fiᵀ
        z_im = acc_re @ Fiᵀ + acc_im @ Frᵀ
    with F[k, n] = exp(+2πi·k·n/m).  The kernel applies the same transform
    from a twiddle table; this matrix is the design-time statement of it."""
    a = num_antennas
    g = 2 * a
    k = np.arange(m)
    ang = 2.0 * np.pi * np.outer(k, k) / m
    fr = np.cos(ang)
    fi = np.sin(ang)
    mat = np.zeros((g * m, g * m), np.float32)
    for ai in range(a):
        re_sl = slice(ai * m, ai * m + m)
        im_sl = slice((a + ai) * m, (a + ai) * m + m)
        mat[re_sl, re_sl] = fr.T
        mat[im_sl, re_sl] = -fi.T
        mat[re_sl, im_sl] = fi.T
        mat[im_sl, im_sl] = fr.T
    return mat


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def fx_tail_len(dtype, m: int | None = None, ntaps: int | None = None) -> int:
    """Carried-tail samples per stream for ``fx_correlate_streams_v2``.

    The same values as the JAX function, so that outputs line up with it:
    8/16/32 rows of 128 samples for float32/bfloat16/int8, grown to the
    next power of two of rows covering the tap reach when the prototype
    (m, ntaps) is given.  The fused step's outputs lag the frame end by
    this many samples."""
    name = _dtype_name(dtype)
    if name not in _HALO_ROWS:
        raise ValueError(f"unsupported input dtype {name}; "
                         f"use float32/bfloat16/int8")
    rows = _HALO_ROWS[name]
    if ntaps is not None:
        if m is None:
            raise ValueError("pass both m and ntaps (or neither)")
        w = -(-ntaps // m)
        need = ((w - 1) * m) // LANES + 2
        while rows < need:
            rows *= 2
    return rows * LANES


def _default_pairs(fd_pairs, xe_pairs, a: int):
    if fd_pairs is None:
        fd_pairs = [(0, p) for p in range(1, a)]
    if xe_pairs is None:
        xe_pairs = xengine.baseline_stations(a)
    fd = np.asarray(fd_pairs, np.int64).reshape(-1, 2)
    xe = np.asarray(xe_pairs, np.int64).reshape(-1, 2)
    for name, p in (("fd_pairs", fd), ("xe_pairs", xe)):
        if p.size and (p.min() < 0 or p.max() >= a):
            raise ValueError(f"{name} index out of range for {a} streams")
    return fd, xe


@lru_cache(maxsize=None)
def _twiddles(m: int, device: torch.device) -> torch.Tensor:
    """[2, m] float32: cos and sin of 2π·i/m (float64, then cast), the
    values of the JAX package's DFT constants."""
    ang = 2.0 * np.pi * np.arange(m) / m
    tw = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    return torch.as_tensor(tw, device=device)


@lru_cache(maxsize=64)
def _pairs_on(pairs: tuple, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(pairs, np.int32).reshape(-1),
                           device=device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")


# --------------------------------------------------------------------------
# Kernel 1: the fused FX step
# --------------------------------------------------------------------------

def _check_fx(xr, xi, tail_r, tail_i, taps, a: int, m: int):
    w = taps.shape[0]
    n = xr.shape[-1]
    h = tail_r.shape[-1]
    if xr.shape != (a, n) or xi.shape != (a, n):
        raise ValueError(f"expected xr/xi of shape {(a, n)}")
    if xi.dtype != xr.dtype or tail_r.dtype != xr.dtype \
            or tail_i.dtype != xr.dtype:
        raise ValueError("xr/xi/tail dtypes must match")
    if xr.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported input dtype {xr.dtype}")
    if tail_r.shape != (a, h) or tail_i.shape != (a, h):
        raise ValueError(f"tails must be [{a}, H]; got {tuple(tail_r.shape)}")
    if taps.shape != (w, m) or LANES % m:
        raise ValueError(f"taps_rm must be [W, m] with m | {LANES}")
    if h < w * m - 1:
        raise ValueError(
            f"tail of {h} samples is shorter than the tap reach {w * m - 1}; "
            f"size it with fx_tail_len(dtype, m, ntaps)")
    if n < m or n % m:
        raise ValueError(f"frame length {n} must be a positive multiple of {m}")
    return w, n, h


def fx_correlate_streams_v2_plain(xr, xi, tail_r, tail_i, taps_rm,
                                  num_antennas: int, m: int, *,
                                  fd_pairs=None, xe_pairs=None):
    """Plain torch form of ``fx_correlate_streams_v2`` (any device)."""
    a = num_antennas
    taps = torch.as_tensor(taps_rm, dtype=torch.float32, device=xr.device)
    w, n, _ = _check_fx(xr, xi, tail_r, tail_i, taps, a, m)
    fd, xe = _default_pairs(fd_pairs, xe_pairs, a)
    nout = n // m
    # the virtual stream tail ++ frame; outputs use its first W·m−1+n samples
    v = torch.cat([torch.cat([tail_r, xr], -1), torch.cat([tail_i, xi], -1)],
                  0).float()[:, : w * m - 1 + n]
    acc = channelizer._branch_sums_critical_batched(v, taps, m, w * m, nout)
    z = planar.ifft_unscaled(planar.PC(acc[:a], acc[a:]))   # [A, nout, m]

    def pick(idx):
        i = torch.as_tensor(idx, device=xr.device)
        return planar.PC(z.re[i], z.im[i])

    prod = planar.mul_conj(pick(fd[:, 0]), pick(fd[:, 1]))
    fd_sum = planar.pabs(planar.ifft_unscaled(prod)).sum(dim=1)
    g = planar.mul_conj(pick(xe[:, 0]), pick(xe[:, 1]))
    gram = torch.cat([g.re.sum(dim=1), g.im.sum(dim=1)], dim=-1)
    return fd_sum, gram


def fx_correlate_streams_v2(xr, xi, tail_r, tail_i, taps_rm,
                            num_antennas: int, m: int, *, fd_pairs=None,
                            xe_pairs=None):
    """Fused FX step over one frame (``csrc/fx_correlate.cu`` on CUDA).

    Args:
      xr, xi: [A, n] float32, bfloat16 or int8 — this frame's planar
        components per stream (int8 used raw, unscaled).  n % m == 0.
      tail_r, tail_i: [A, H] in the same dtype — the previous frame's last
        H samples (zeros for the first step), H ≥ W·m − 1; the pipeline
        sizes H with ``fx_tail_len(dtype, m, ntaps)``.
      taps_rm: [W, m] float32 — branch-major prototype taps.
      fd_pairs / xe_pairs: stream pairs for the FD correlator (default
        every stream against stream 0) and the Gram sums (default the
        triangular baselines, autos included).

    Returns (fd_sum [len(fd_pairs), m], gram [len(xe_pairs), 2m]) float32:
    lag-domain magnitude sums (divide by n/m for the mean, fftshift
    outside) and the re|im Gram sums, over the output vectors of the
    virtual stream tail ++ frame — they lag the frame end by H samples."""
    if xr.device.type == "cpu":
        return fx_correlate_streams_v2_plain(
            xr, xi, tail_r, tail_i, taps_rm, num_antennas, m,
            fd_pairs=fd_pairs, xe_pairs=xe_pairs)
    a = num_antennas
    dev = xr.device
    taps = torch.as_tensor(taps_rm, dtype=torch.float32, device=dev)
    taps = taps.contiguous()
    _require_cuda(xr, xi, tail_r, tail_i, taps)
    w, n, h = _check_fx(xr, xi, tail_r, tail_i, taps, a, m)
    fd, xe = _default_pairs(fd_pairs, xe_pairs, a)
    nfd, nb = len(fd), len(xe)
    fdp = _pairs_on(tuple(fd.reshape(-1).tolist()), dev)
    xep = _pairs_on(tuple(xe.reshape(-1).tolist()), dev)
    tile = max(1, 512 // m)             # output vectors per block
    nblk = -(-(n // m) // tile)
    width = nfd * m + 2 * nb * m
    partial = torch.empty((nblk, width), dtype=torch.float32, device=dev)
    out = torch.empty(width, dtype=torch.float32, device=dev)
    lib = _load()
    err = lib.clen_fx_correlate(
        xr.data_ptr(), xi.data_ptr(), tail_r.data_ptr(), tail_i.data_ptr(),
        _DTYPE_CODE[xr.dtype], taps.data_ptr(), _twiddles(m, dev).data_ptr(),
        fdp.data_ptr(), nfd, xep.data_ptr(), nb, a, m, w, n, h, tile,
        partial.data_ptr(), out.data_ptr(), _stream(dev))
    if err != 0:
        smem = lib.clen_fx_smem_bytes(a, m, w, tile)
        raise RuntimeError(f"fx_correlate launch failed: CUDA error {err} "
                           f"({smem} B of shared memory per block)")
    fx_correlate_streams_v2.launches += 1
    return out[: nfd * m].view(nfd, m), out[nfd * m:].view(nb, 2 * m)


fx_correlate_streams_v2.launches = 0


# --------------------------------------------------------------------------
# Kernel 2: lane-packed PFB + per-group inverse DFT
# --------------------------------------------------------------------------

def _check_packed(y_packed, hr, a: int, m: int):
    w = hr.shape[0]
    nout = y_packed.shape[0] - (w - 1)
    gm = y_packed.shape[1]
    if gm != 2 * a * m:
        raise ValueError(f"lane dim {gm} != 2*{a}*{m}")
    if hr.shape != (w, gm):
        raise ValueError(f"hr must be [W, {gm}]")
    if nout < 1:
        raise ValueError("y_packed is shorter than the tap span")
    return w, nout, gm


def pfb_channelize_packed_plain(y_packed, hr, num_antennas: int, m: int):
    """Plain torch form of ``pfb_channelize_packed`` (any device)."""
    a = num_antennas
    _, nout, gm = _check_packed(y_packed, hr, a, m)
    acc = channelizer._packed_branch_sums(y_packed, hr, nout)
    acc = acc.reshape(nout, 2 * a, m)
    z = planar.ifft_unscaled(planar.PC(acc[:, :a], acc[:, a:]))
    return torch.cat([z.re, z.im], dim=1).reshape(nout, gm)


def pfb_channelize_packed(y_packed, hr, num_antennas: int, m: int):
    """Fused PFB filter + per-group inverse DFT (``csrc/pfb_packed.cu`` on
    CUDA).

    Args:
      y_packed: [nout + W - 1, G·M] float32 — lane-packed reversed block
        stream (G = 2·num_antennas groups of M lanes).
      hr: [W, G·M] float32 — reversed branch taps, lane-tiled.

    Returns [nout, G·M] float32 channelized spectra in the same lane layout
    (groups 0..A-1 real parts, A..2A-1 imaginary parts)."""
    if y_packed.device.type == "cpu":
        return pfb_channelize_packed_plain(y_packed, hr, num_antennas, m)
    a = num_antennas
    dev = y_packed.device
    _require_cuda(y_packed, hr)
    if y_packed.dtype != torch.float32 or hr.dtype != torch.float32:
        raise ValueError("y_packed and hr must be float32")
    w, nout, gm = _check_packed(y_packed, hr, a, m)
    tile = max(1, 4096 // gm)           # output rows per block
    out = torch.empty((nout, gm), dtype=torch.float32, device=dev)
    lib = _load()
    err = lib.clen_pfb_packed(
        y_packed.data_ptr(), hr.data_ptr(), _twiddles(m, dev).data_ptr(),
        out.data_ptr(), nout, w, a, m, tile, _stream(dev))
    if err != 0:
        smem = lib.clen_pfb_smem_bytes(a, m, w, tile)
        raise RuntimeError(f"pfb_packed launch failed: CUDA error {err} "
                           f"({smem} B of shared memory per block)")
    pfb_channelize_packed.launches += 1
    return out


pfb_channelize_packed.launches = 0


def reset_launch_counts() -> None:
    fx_correlate_streams_v2.launches = 0
    pfb_channelize_packed.launches = 0


def _load():
    from clenabled_tpu_torch import _build

    return _build.load()
