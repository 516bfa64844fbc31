"""Hand-written Hopper kernels, with their plain forms.

The counterpart of ``clenabled_tpu.dsp.pallas_kernels`` for the kernels
ported so far:

- ``fx_correlate_streams_v2`` (``csrc/fx_correlate.cu``): the fused step —
  critically sampled PFB, M-point inverse DFT, FD cross-correlation
  magnitude sums and X-Engine Gram sums, reading each input sample once.
  ``fx_correlate_streams`` is the same kernel fed the JAX function's
  history-concatenated flat layout.  Three ``__global__`` bodies, chosen
  in ``fx_body``: ``fx_reg_kernel`` (register-tiled FIR, in-register
  M-point DFTs) for M in {2, 4, 8, 16}, ``fx_wide_kernel`` (a register FIR
  from device memory, M-point DFTs in two in-register passes) for M in
  {32, 64, 128} where its block fits, ``fx_tile_kernel`` otherwise.
- ``pfb_channelize_packed`` (``csrc/pfb_packed.cu``): the lane-packed PFB
  branch sums plus per-group inverse DFT of the planar pipeline.  Three
  ``__global__`` bodies, chosen in ``pfb_packed_body``:
  ``pfb_packed_reg_kernel`` (register-tiled column FIR, in-register M-point
  DFTs) for M in {2, 4, 8, 16} where its block fits,
  ``pfb_packed_wide_kernel`` (the same column FIR over both components a
  lane, M-point DFTs in two in-register passes) for M in {32, 64, 128}
  where its block fits, ``pfb_packed_kernel`` otherwise.
- ``xengine_gram_stacked`` with its ``_blocks`` and ``_tri`` forms
  (``csrc/xengine_gram.cu``'s entry, on the tensor cores in
  ``csrc/xengine_gram_int8.cu`` for int8 and ``csrc/xengine_gram_bf16.cu``
  for bfloat16): the X-Engine's per-channel stacked Gram, lower
  block-triangle only, int8 exact.
- ``fir_direct`` (``csrc/fir_direct.cu``), also bound as
  ``fir_direct_mxu``: the real-tap direct FIR of both planar components in
  one launch, decimating in the kernel.  Two ``__global__`` bodies, chosen
  in ``fir_body``: ``fir_reg_kernel`` (register-tiled sliding window) at
  decimation 1 where its block fits, ``fir_direct_kernel`` otherwise.
- ``ofs_filter_planar`` with ``OfsPlan`` (``csrc/ofs_filter.cu``): the
  overlap-save FFT filter with complex taps and a carried input tail.
- ``qdemod_fused`` (``csrc/qdemod.cu``): the quadrature demodulator with one
  carried sample.
- ``pfb_oversampled_fused`` (``csrc/pfb_oversampled.cu``): the oversampled
  (R < M, R | M) PFB channelizer step — branch sums over the virtual stream
  tail ++ frame, the output rotation and the unscaled inverse DFT.  Three
  ``__global__`` bodies, chosen in ``os_body``:
  ``pfb_os_reg_kernel`` (register-tiled phase FIR, in-register M-point
  DFTs, the rotation as an L-th-root twiddle) for M in {2, 4, 8, 16},
  ``pfb_os_wide_kernel`` (the same stages, M-point DFTs in two in-register
  passes, chunks behind one staged window) for M in {32, 64, 128} at
  L = M/R in {2, 4, 8, 16} where its block fits, ``pfb_os_kernel``
  otherwise.
- ``fft_batched_fused`` (``csrc/fft_batched.cu``): the batched unscaled FFT
  of the ``Fft`` block, windowed, in natural order.
- ``costas_scalar`` (``csrc/costas.cu``): the exact sequential Costas loop,
  its (phase, freq, error) state in a 3-float device tensor;
  ``costas_batched``, the same recurrence over B independent rows, for
  the chunked and multi-stream loops.  Two ``__global__`` bodies, chosen
  in ``costas_body``: ``costas_kernel`` (one block a row) up to two of
  its blocks an SM, ``costas_lanes_kernel`` (one lane a row, 32 loops a
  warp) above.

Each wrapper keeps the JAX function's argument order, shapes and outputs.
Given CPU tensors it runs its plain torch form (``*_plain``: the
channelizer's branch sums and ``planar.ifft_unscaled`` for the FX kernels
and the oversampled PFB, batched products for the Gram, ``conv1d`` for the
FIR, ``torch.fft`` overlap-save for the OFS filter, ``torch.atan2`` for the
demodulator, the two-stage DFT of ``dsp.fft.fft_planar`` for the FFT, a
per-sample loop for the Costas recurrence);
given CUDA tensors it launches its kernel or raises — it never falls back.
Each wrapper counts its kernel launches in its ``launches`` attribute.

The TPU engine selectors of the JAX functions (``tile_rows``/``tile``,
``t_tile``, ``mxu_dtype``, ``branch_mxu``, ``karatsuba``,
``deep_strategy``, ``precision``, ``interpret``) have no counterpart: the
kernels pick their own tiles; the FX, FIR and OFS kernels multiply and
accumulate in float32, the Gram kernel in int32 (int8) or float32
(bfloat16).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from clenabled_tpu_torch import exact_f32
from clenabled_tpu_torch.dsp import (channelizer, demod, fft as dsp_fft,
                                     fir_filter, planar, xengine)
from clenabled_tpu_torch.runtime import trace
from clenabled_tpu_torch.runtime.device import per_device

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


OS_TAIL_LEN = 8 * LANES      # the fused oversampled PFB's default tail


def os_tail_len(m: int, r: int, ntaps: int) -> int:
    """Carried-tail samples of ``pfb_oversampled_fused`` for an (M, R,
    ntaps) configuration: OS_TAIL_LEN (1024) unless the tap reach
    (W−1)·M + (L−1)·R needs a deeper halo; always a multiple of 128.  The
    JAX package's values, so that states and output latency line up."""
    w = -(-ntaps // m)
    reach = (w - 1) * m + (m // r - 1) * r
    return max(OS_TAIL_LEN, (reach // LANES + 2) * LANES)


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


# the three __global__ bodies of csrc/fx_correlate.cu, by their C body code
FX_BODIES = ("fx_tile_kernel", "fx_reg_kernel", "fx_wide_kernel")
FX_REG_M = (2, 4, 8, 16)
FX_WIDE_M = (32, 64, 128)
# samples a component a block of each body (the C entry checks tile·m)
_FX_BLOCK_SAMPLES = {"fx_tile_kernel": 512, "fx_reg_kernel": 1024,
                     "fx_wide_kernel": 4096}


def _pick_fx_body(m: int, wide_smem: int, optin: int) -> str:
    """``fx_body``'s rule: ``fx_reg_kernel`` for m in {2, 4, 8, 16};
    ``fx_wide_kernel`` for m in {32, 64, 128} where its block's
    ``wide_smem`` bytes of shared memory fit the card's opt-in ``optin``;
    ``fx_tile_kernel`` otherwise."""
    if m in FX_REG_M:
        return FX_BODIES[1]
    if m in FX_WIDE_M and wide_smem <= optin:
        return FX_BODIES[2]
    return FX_BODIES[0]


def fx_body(m: int, num_antennas: int = 4, w: int = 25, device=None) -> str:
    """The kernel body an FX call with ``m`` channels, ``num_antennas``
    streams and ``w`` tap rows launches on the CUDA ``device`` (the
    current card when None): ``fx_reg_kernel`` (register-tiled FIR,
    in-register M-point DFTs) for m in {2, 4, 8, 16}, where 16 points a
    thread hold 16/m vectors; ``fx_wide_kernel`` (a register FIR from
    device memory, each M-point DFT in two in-register passes over m/16
    lanes) for m in {32, 64, 128} wherever its block
    (``clen_fx_smem_bytes``, body 2) fits the card's opt-in shared memory;
    ``fx_tile_kernel`` (shared-memory operands, dense DFTs) for every other
    m dividing 128.  A pure choice made before the launch; only the wide
    m ask the card, once for each (antennas, m, w, card).  A CPU call runs
    the plain form, which has no body."""
    if m < 1 or LANES % m:
        raise ValueError(f"m must divide {LANES}; got {m}")
    if m not in FX_WIDE_M:
        return _pick_fx_body(m, 0, 0)
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"fx_body names a CUDA kernel body; got {device}")
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return FX_BODIES[_fx_body_code(num_antennas, m, w, index)]


@lru_cache(maxsize=None)
def _fx_body_code(a: int, m: int, w: int, index: int) -> int:
    """``fx_body``'s choice on card ``index`` at m in {32, 64, 128}, as the
    C body code, made once for each (a, m, w, card)."""
    wide = FX_BODIES[2]
    wide_smem = _load().clen_fx_smem_bytes(
        a, m, w, _FX_BLOCK_SAMPLES[wide] // m, FX_BODIES.index(wide))
    return FX_BODIES.index(_pick_fx_body(m, wide_smem, _smem_optin(index)))


def fx_tile(m: int, body: str | None = None) -> int:
    """Output vectors per block of ``body`` (default: the one
    ``fx_body(m)`` names): 512 samples a component for
    ``fx_tile_kernel``, 1024 for ``fx_reg_kernel``, 4096 for
    ``fx_wide_kernel``."""
    return max(1, _FX_BLOCK_SAMPLES[body or fx_body(m)] // m)


def _launch_fx(xr, xi, tail_r, tail_i, taps_rm, a: int, m: int, fd_pairs,
               xe_pairs, body: str | None = None):
    """Launch ``csrc/fx_correlate.cu`` on CUDA tensors on ``body`` (default:
    the one ``fx_body`` names; tests and ``chip_smoke.py`` name another to
    hold the bodies to each other); (fd_sum, gram).  Traced as
    ``fx.prepare`` (the checks, pair tables, body choice and buffers) and
    ``fx.launch`` (the C call)."""
    with trace.span("fx.prepare"):
        dev = xr.device
        taps = torch.as_tensor(taps_rm, dtype=torch.float32, device=dev)
        taps = taps.contiguous()
        _require_cuda(xr, xi, tail_r, tail_i, taps)
        w, n, h = _check_fx(xr, xi, tail_r, tail_i, taps, a, m)
        fd, xe = _default_pairs(fd_pairs, xe_pairs, a)
        nfd, nb = len(fd), len(xe)
        fdp = _pairs_on(tuple(fd.reshape(-1).tolist()), dev)
        xep = _pairs_on(tuple(xe.reshape(-1).tolist()), dev)
        name = body or fx_body(m, a, w, dev)
        tile = fx_tile(m, name)             # output vectors per block
        code = FX_BODIES.index(name)
        nblk = -(-(n // m) // tile)
        lib = _load()
        partial = torch.empty(
            (nblk, lib.clen_fx_partial_width(m, nfd, nb, code)),
            dtype=torch.float32, device=dev)
        out = torch.empty(nfd * m + 2 * nb * m, dtype=torch.float32,
                          device=dev)
        twiddles, stream = _twiddles(m, dev), _stream(dev)
    with trace.span("fx.launch"):
        err = lib.clen_fx_correlate(
            xr.data_ptr(), xi.data_ptr(), tail_r.data_ptr(),
            tail_i.data_ptr(), _DTYPE_CODE[xr.dtype], taps.data_ptr(),
            twiddles.data_ptr(), fdp.data_ptr(), nfd, xep.data_ptr(), nb, a,
            m, w, n, h, tile, code, partial.data_ptr(), out.data_ptr(),
            stream)
    if err != 0:
        smem = lib.clen_fx_smem_bytes(a, m, w, tile, code)
        raise RuntimeError(f"fx_correlate launch failed ({name}): "
                           f"CUDA error {err} ({smem} B of shared memory "
                           f"per block)")
    return out[: nfd * m].view(nfd, m), out[nfd * m:].view(nb, 2 * m)


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
    out = _launch_fx(xr, xi, tail_r, tail_i, taps_rm, num_antennas, m,
                     fd_pairs, xe_pairs)
    fx_correlate_streams_v2.launches += 1
    return out


fx_correlate_streams_v2.launches = 0


def _split_flat(comps, hist, a: int, m: int, w: int, tile_rows: int):
    """The flat layout's argument checks (those of the JAX function), then
    its [2A, ·] arrays as the (re, im) row halves of the v2 layout."""
    n = comps.shape[-1]
    if comps.shape[0] != 2 * a:
        raise ValueError(f"expected {2 * a} component streams")
    if tuple(hist.shape) != (2 * a, w * m - 1):
        raise ValueError(f"hist shape {tuple(hist.shape)} != "
                         f"{(2 * a, w * m - 1)}")
    if n % (LANES * tile_rows):
        raise ValueError(
            f"frame length {n} must be a multiple of {LANES * tile_rows}")
    return comps[:a], comps[a:], hist[:a], hist[a:]


def fx_correlate_streams_plain(comps, hist, taps_rm, num_antennas: int,
                               m: int, tile_rows: int = 64, *, fd_pairs=None,
                               xe_pairs=None):
    """Plain torch form of ``fx_correlate_streams`` (any device)."""
    parts = _split_flat(comps, hist, num_antennas, m, len(taps_rm), tile_rows)
    return fx_correlate_streams_v2_plain(*parts, taps_rm, num_antennas, m,
                                         fd_pairs=fd_pairs, xe_pairs=xe_pairs)


def fx_correlate_streams(comps, hist, taps_rm, num_antennas: int, m: int,
                         tile_rows: int = 64, *, fd_pairs=None,
                         xe_pairs=None):
    """The flat-layout entry of the fused FX step: the same kernel
    (``csrc/fx_correlate.cu``) as ``fx_correlate_streams_v2``, fed the
    history-concatenated layout of the JAX function of this name.

    Args:
      comps: [2A, n] float32 — this frame's samples, stream re parts then
        im parts.  n must be a multiple of 128·tile_rows (``tile_rows`` is
        kept only for this check, which the JAX function makes).
      hist: [2A, W·m − 1] — the carried stream history.
      taps_rm, fd_pairs, xe_pairs: as for ``fx_correlate_streams_v2``.

    Returns (fd_sum [len(fd_pairs), m], gram [len(xe_pairs), 2m]) over the
    n/m output vectors of hist ++ comps: the v2 step with a tail of exactly
    the tap reach, so its outputs do not lag the frame."""
    if comps.device.type == "cpu":
        return fx_correlate_streams_plain(comps, hist, taps_rm, num_antennas,
                                          m, tile_rows, fd_pairs=fd_pairs,
                                          xe_pairs=xe_pairs)
    parts = _split_flat(comps, hist, num_antennas, m, len(taps_rm), tile_rows)
    out = _launch_fx(*parts, taps_rm, num_antennas, m, fd_pairs, xe_pairs)
    fx_correlate_streams.launches += 1
    return out


fx_correlate_streams.launches = 0


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


# the three __global__ bodies of csrc/pfb_packed.cu, by their C body code
PFB_PACKED_BODIES = ("pfb_packed_kernel", "pfb_packed_reg_kernel",
                     "pfb_packed_wide_kernel")
PFB_REG_M = (2, 4, 8, 16)
PFB_WIDE_M = (32, 64, 128)
PFB_REG_ROWS = 32       # pfb_packed_reg_kernel's kPkRows: its C entry
                        # refuses any other rows a block
PFB_WIDE_OUTS = 4096    # pfb_packed_wide_kernel's outputs of a component a
                        # block: 4096 / m rows, the only rows its C entry takes


def pfb_packed_tile(a: int, m: int, body: int) -> int:
    """Output rows a block of the body with C code ``body``:
    ``PFB_REG_ROWS`` for ``pfb_packed_reg_kernel`` (one 128-column chunk
    of min(a, 64/m) antennas), 4096 / m for ``pfb_packed_wide_kernel``
    (the 2·m columns of one antenna), 4096 / (2·a·m) for
    ``pfb_packed_kernel`` (all lanes)."""
    if body == 1:
        return PFB_REG_ROWS
    if body == 2:
        return PFB_WIDE_OUTS // m
    return max(1, 4096 // (2 * a * m))


def _pick_pfb_body(m: int, smem: int, optin: int) -> str:
    """``pfb_packed_reg_kernel`` for m in {2, 4, 8, 16} and
    ``pfb_packed_wide_kernel`` for m in {32, 64, 128}, each where its
    block's ``smem`` bytes of shared memory fit the card's opt-in
    ``optin``; ``pfb_packed_kernel`` otherwise."""
    if m in PFB_REG_M and smem <= optin:
        return PFB_PACKED_BODIES[1]
    if m in PFB_WIDE_M and smem <= optin:
        return PFB_PACKED_BODIES[2]
    return PFB_PACKED_BODIES[0]


def pfb_packed_body(m: int, w: int, device) -> str:
    """The kernel body a ``pfb_channelize_packed`` call with ``m`` channels
    and ``w`` tap rows launches on the CUDA ``device``:
    ``pfb_packed_reg_kernel`` (register-tiled column FIR, in-register
    M-point DFTs) for m in {2, 4, 8, 16} and ``pfb_packed_wide_kernel``
    (the column FIR over both components a lane, each M-point DFT in two
    in-register passes) for m in {32, 64, 128}, each wherever its block
    fits the card's opt-in shared memory, ``pfb_packed_kernel`` otherwise.
    A pure choice made before the launch.  A CPU call runs the plain form,
    which has no body."""
    if m < 1 or w < 1:
        raise ValueError(f"need m >= 1 and w >= 1; got {m}, {w}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"pfb_packed_body names a CUDA kernel body; got "
                         f"{device}")
    return PFB_PACKED_BODIES[_pfb_body_code(m, w, device.index or 0)]


@lru_cache(maxsize=None)
def _pfb_body_code(m: int, w: int, index: int) -> int:
    """``pfb_packed_body``'s choice on card ``index``, as the C body code,
    made once for each (m, w, card)."""
    if m in PFB_REG_M:
        body = 1
    elif m in PFB_WIDE_M:
        body = 2
    else:
        return 0
    smem = _load().clen_pfb_smem_bytes(1, m, w, pfb_packed_tile(1, m, body),
                                       body)
    return PFB_PACKED_BODIES.index(_pick_pfb_body(m, smem,
                                                  _smem_optin(index)))


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
    CUDA, the body ``pfb_packed_body`` names).

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
    body = _pfb_body_code(m, w, dev.index)
    tile = pfb_packed_tile(a, m, body)
    out = torch.empty((nout, gm), dtype=torch.float32, device=dev)
    lib = _load()
    err = lib.clen_pfb_packed(
        y_packed.data_ptr(), hr.data_ptr(), _twiddles(m, dev).data_ptr(),
        out.data_ptr(), nout, w, a, m, tile, body, _stream(dev))
    if err != 0:
        smem = lib.clen_pfb_smem_bytes(a, m, w, tile, body)
        raise RuntimeError(f"pfb_packed launch failed "
                           f"({PFB_PACKED_BODIES[body]}): CUDA error {err} "
                           f"({smem} B of shared memory per block)")
    pfb_channelize_packed.launches += 1
    return out


pfb_channelize_packed.launches = 0


# --------------------------------------------------------------------------
# Kernel 4: the X-Engine stacked Gram
# --------------------------------------------------------------------------

_GRAM_DTYPES = {torch.int8: 0, torch.bfloat16: 1}


def _check_gram(zr, zi):
    """The JAX launcher's checks; returns (f, t, sp, kb, tri_blocks)."""
    if zr.dim() != 3 or zi.shape != zr.shape:
        raise ValueError("zr/zi must be [F, T, S·P] of one shape")
    f, t, sp = zr.shape
    if sp % LANES:
        raise ValueError(f"S·P must be a multiple of {LANES} (got {sp})")
    if zr.dtype != zi.dtype:
        raise ValueError("zr/zi dtypes must match")
    sub = 32 if zr.dtype == torch.int8 else 16
    if t < sub or t % sub:
        raise ValueError(f"T={t} not tileable at {zr.dtype} granularity")
    kb = sp // LANES
    return f, t, sp, kb, tuple((i, j) for i in range(kb) for j in range(i + 1))


# float32 matmuls and convolutions without TF32 on the card, restored
# afterwards: the package's public context
_full_f32 = exact_f32


def gram_products(zr, zi):
    """(a, b) = (zr·zrᵀ + zi·ziᵀ, zi·zrᵀ) per channel over T, [F, SP, SP]:
    int32 for integer inputs, else float32 — the plain form of the Gram.
    Integer sums are exact: int64 on the CPU; float64 on the card (exact
    below 2^53), which has no integer batched matmul.  Float inputs are
    multiplied in float32 (bf16 products are exact there) without TF32."""
    integer = not zr.dtype.is_floating_point
    if integer:
        wt = torch.int64 if zr.device.type == "cpu" else torch.float64
    else:
        wt = torch.float32
    r, i = zr.to(wt), zi.to(wt)
    with _full_f32():
        a = (torch.einsum("ftk,ftl->fkl", r, r)
             + torch.einsum("ftk,ftl->fkl", i, i))
        b = torch.einsum("ftk,ftl->fkl", i, r)
    out = torch.int32 if integer else torch.float32
    return a.to(out), b.to(out)


def _to_blocks(g, kb: int) -> torch.Tensor:
    """[F, SP, SP] → [F, kb, kb, 128, 128] with g[bi·128+r, bj·128+c] =
    blocks[bi, bj, r, c]."""
    f = g.shape[0]
    return g.reshape(f, kb, LANES, kb, LANES).transpose(2, 3)


def _lower(blocks, tri) -> torch.Tensor:
    """The tri_blocks-order lower blocks [F, nbt, 128, 128]."""
    i = torch.as_tensor([ij[0] for ij in tri], device=blocks.device)
    j = torch.as_tensor([ij[1] for ij in tri], device=blocks.device)
    return blocks[:, i, j]


def xengine_gram_stacked_blocks_plain(zr, zi):
    """Plain torch form of ``xengine_gram_stacked_blocks`` (any device)."""
    *_, kb, tri = _check_gram(zr, zi)
    a, b = gram_products(zr, zi)
    return (_lower(_to_blocks(a, kb), tri),
            _to_blocks(b, kb).contiguous(), tri)


def xengine_gram_stacked_tri_plain(zr, zi):
    """Plain torch form of ``xengine_gram_stacked_tri`` (any device)."""
    *_, kb, tri = _check_gram(zr, zi)
    a, b = gram_products(zr, zi)
    gi = b - b.transpose(-1, -2)
    return (_lower(_to_blocks(a, kb), tri), _lower(_to_blocks(gi, kb), tri),
            tri)


def xengine_gram_stacked_plain(zr, zi):
    """Plain torch form of ``xengine_gram_stacked`` (any device)."""
    _check_gram(zr, zi)
    return gram_products(zr, zi)


def _launch_gram(zr, zi, emit_gi: bool):
    """Launch ``csrc/xengine_gram.cu``'s entry, which hands int8 to
    ``csrc/xengine_gram_int8.cu`` and bfloat16 to
    ``csrc/xengine_gram_bf16.cu``; (a_blk, b_blk or gi_blk, tri)."""
    _require_cuda(zr, zi)
    f, t, sp, kb, tri = _check_gram(zr, zi)
    if zr.dtype not in _GRAM_DTYPES:
        raise ValueError(f"the Gram kernel takes int8 or bfloat16, not "
                         f"{zr.dtype}")
    if f > 65535:
        raise ValueError(f"at most 65535 channels per launch (got {f})")
    if zr.data_ptr() % 16 or zi.data_ptr() % 16:
        raise ValueError("zr/zi must start on a 16-byte boundary")
    dev = zr.device
    acc = torch.int32 if zr.dtype == torch.int8 else torch.float32
    nbt = len(tri)
    a_blk = torch.empty((f, nbt, LANES, LANES), dtype=acc, device=dev)
    b_shape = (f, nbt) if emit_gi else (f, kb, kb)
    b_blk = torch.empty(b_shape + (LANES, LANES), dtype=acc, device=dev)
    lib = _load()
    err = lib.clen_xengine_gram(
        zr.data_ptr(), zi.data_ptr(), _GRAM_DTYPES[zr.dtype], f, t, sp,
        int(emit_gi), a_blk.data_ptr(), b_blk.data_ptr(), _stream(dev))
    if err != 0:
        smem = (lib.clen_gram_int8_smem_bytes() if zr.dtype == torch.int8
                else lib.clen_gram_bf16_smem_bytes())
        raise RuntimeError(f"xengine_gram launch failed: CUDA error {err}"
                           f" ({smem} B of shared memory per block)")
    return a_blk, b_blk, tri


def xengine_gram_stacked_blocks(zr, zi):
    """The block layout of the stacked Gram (``csrc/xengine_gram.cu`` on
    CUDA): (a_blk [F, nbt, 128, 128], b_blk [F, kb, kb, 128, 128],
    tri_blocks).  a_blk holds the lower-triangle (i ≥ j) blocks of
    a = zr·zrᵀ + zi·ziᵀ in tri_blocks order; b = zi·zrᵀ is the full block
    grid, b[bi·128+r, bj·128+c] = b_blk[bi, bj, r, c]."""
    if zr.device.type == "cpu":
        return xengine_gram_stacked_blocks_plain(zr, zi)
    out = _launch_gram(zr, zi, emit_gi=False)
    xengine_gram_stacked_blocks.launches += 1
    return out


xengine_gram_stacked_blocks.launches = 0


def xengine_gram_stacked_tri(zr, zi):
    """The triangular-consumer form (``csrc/xengine_gram.cu`` on CUDA):
    (a_blk [F, nbt, 128, 128], gi_blk [F, nbt, 128, 128], tri_blocks),
    gi_blk holding the lower-triangle blocks of gi = b − bᵀ."""
    if zr.device.type == "cpu":
        return xengine_gram_stacked_tri_plain(zr, zi)
    out = _launch_gram(zr, zi, emit_gi=True)
    xengine_gram_stacked_tri.launches += 1
    return out


xengine_gram_stacked_tri.launches = 0


def xengine_gram_stacked(zr, zi):
    """Stacked-Gram X-Engine contraction (``csrc/xengine_gram.cu`` on CUDA).

    Args:
      zr, zi: [F, T, S·P] int8 or bfloat16 channel-major spectra, S·P a
        multiple of 128, T a multiple of 32 (int8) or 16 (bfloat16).

    Returns (a, b): a = zr·zrᵀ + zi·ziᵀ and b = zi·zrᵀ, each [F, S·P, S·P]
    (int32 for int8 inputs — exact — else float32).  The Gram's re/im
    parts are gr = a, gi = b − bᵀ.  The kernel forms only the lower
    block-triangle of a; the upper blocks are its mirror."""
    if zr.device.type == "cpu":
        return xengine_gram_stacked_plain(zr, zi)
    a_blk, b_blk, tri = _launch_gram(zr, zi, emit_gi=False)
    xengine_gram_stacked.launches += 1
    f, _, sp = zr.shape
    kb = sp // LANES
    b = b_blk.transpose(2, 3).reshape(f, sp, sp)
    if kb == 1:
        return a_blk[:, 0], b
    idx = {ij: n for n, ij in enumerate(tri)}
    rows = [torch.cat([a_blk[:, idx[(i, j)]] if j <= i
                       else a_blk[:, idx[(j, i)]].transpose(-1, -2)
                       for j in range(kb)], dim=-1) for i in range(kb)]
    return torch.cat(rows, dim=-2), b


xengine_gram_stacked.launches = 0


def gram_launches() -> int:
    """Launches of the Gram kernel through any of its three wrappers."""
    return (xengine_gram_stacked.launches
            + xengine_gram_stacked_blocks.launches
            + xengine_gram_stacked_tri.launches)


# --------------------------------------------------------------------------
# Kernels 7 and 8: the direct FIR (one kernel for both TPU engines)
# --------------------------------------------------------------------------

def _fir_args(x, taps, decimation: int, history):
    """The JAX function's checks; returns (components, histories or None,
    float32 taps on the components' device, frame length n)."""
    pc = isinstance(x, planar.PC)
    comps = list(x) if pc else [x]
    hists = None if history is None else (list(history) if pc else [history])
    if taps.is_complex() if torch.is_tensor(taps) else np.iscomplexobj(taps):
        raise ValueError("the direct FIR takes real taps only")
    t = torch.as_tensor(taps, dtype=torch.float32, device=comps[0].device)
    if t.dim() != 1 or t.shape[0] < 1:
        raise ValueError("taps must be one non-empty row")
    k = t.shape[0]
    if any(c.dim() != 1 or c.shape != comps[0].shape for c in comps):
        raise ValueError("x must be one row per component, of one length")
    if hists is None:
        n = comps[0].shape[0] - (k - 1)
    else:
        if any(tuple(h.shape) != (k - 1,) for h in hists):
            raise ValueError(f"history must be [{k - 1}] per component")
        n = comps[0].shape[0]
    if n <= 0 or decimation < 1 or n % decimation:
        raise ValueError(f"frame length {n} must be a positive multiple of "
                         f"the decimation {decimation}")
    return comps, hists, t, n


# the two __global__ bodies of csrc/fir_direct.cu, by their C body code
FIR_BODIES = ("fir_direct_kernel", "fir_reg_kernel")


def _pick_fir_body(decimation: int, reg_smem: int, optin: int) -> str:
    """``fir_reg_kernel`` at decimation 1 where its block's ``reg_smem``
    bytes of shared memory fit the card's opt-in ``optin``,
    ``fir_direct_kernel`` otherwise."""
    return (FIR_BODIES[1] if decimation == 1 and reg_smem <= optin
            else FIR_BODIES[0])


@lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    with torch.cuda.device(index):
        optin = _load().clen_fir_smem_optin()
    if optin < 0:
        raise RuntimeError(f"cannot read cuda:{index}'s shared memory: CUDA "
                           f"error {-optin}")
    return optin


def fir_body(ntaps: int, decimation: int, device) -> str:
    """The kernel body a direct-FIR call with ``ntaps`` taps and
    ``decimation`` launches on the CUDA ``device``: ``fir_reg_kernel``
    (register-tiled sliding window) at decimation 1 wherever its block
    (``clen_fir_smem_bytes``) fits the card's opt-in shared memory,
    ``fir_direct_kernel`` otherwise.  A pure choice made before the launch.
    A CPU call runs the plain form, which has no body."""
    if ntaps < 1 or decimation < 1:
        raise ValueError(f"need ntaps >= 1 and decimation >= 1; got {ntaps}, "
                         f"{decimation}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"fir_body names a CUDA kernel body; got {device}")
    if decimation != 1:
        return FIR_BODIES[0]
    reg_smem = _load().clen_fir_smem_bytes(ntaps, 1, FIR_BODIES.index(
        "fir_reg_kernel"))
    return _pick_fir_body(decimation, reg_smem,
                          _smem_optin(device.index or 0))


def fir_direct_plain(x, taps, *, decimation: int = 1, history=None):
    """Plain torch form of ``fir_direct`` (any device): ``conv1d``."""
    comps, hists, t, _ = _fir_args(x, taps, decimation, history)
    ys = [fir_filter._conv_valid_real(
        c if hists is None else torch.cat([hists[i], c]), t, decimation)
        for i, c in enumerate(comps)]
    return planar.PC(*ys) if isinstance(x, planar.PC) else ys[0]


def fir_direct(x, taps, *, decimation: int = 1, history=None):
    """Direct-form FIR y[n] = Σ_k taps[k]·v[n+K−1−k] with real taps
    (``csrc/fir_direct.cu`` on CUDA); also bound as ``fir_direct_mxu``.

    Args:
      x: [K−1 + n] float32 with the K−1 history samples in front (the JAX
        function's contract) — or, with ``history``, the frame [n] alone —
        or a ``planar.PC`` of two such rows, filtered in one launch.
      taps: [K] real taps.
      decimation: keep every D-th output (the kernel computes only those);
        n must be a multiple of D.
      history: [K−1] (or a ``planar.PC`` pair): the samples before ``x``;
        the kernel reads history ++ x without a concatenation.

    Returns [n // D] float32 (a ``planar.PC`` for planar ``x``)."""
    comps, hists, t, n = _fir_args(x, taps, decimation, history)
    dev = comps[0].device
    if dev.type == "cpu":
        return fir_direct_plain(x, taps, decimation=decimation,
                                history=history)
    k = t.shape[0]
    if hists is None:
        hists = [c[: k - 1] for c in comps]
        comps = [c[k - 1:] for c in comps]
    _require_cuda(*comps, *hists, t)
    if any(c.dtype != torch.float32 for c in comps + hists):
        raise ValueError("the FIR kernel takes float32 streams")
    ys = [torch.empty(n // decimation, dtype=torch.float32, device=dev)
          for _ in comps]
    ptrs = [(h.data_ptr(), c.data_ptr(), y.data_ptr())
            for h, c, y in zip(hists, comps, ys)]
    second = ptrs[1] if len(ptrs) > 1 else (None, None, None)
    body = FIR_BODIES.index(fir_body(k, decimation, dev))
    lib = _load()
    err = lib.clen_fir_direct(*ptrs[0], *second, len(comps), t.data_ptr(), k,
                              n, decimation, body, _stream(dev))
    if err != 0:
        smem = lib.clen_fir_smem_bytes(k, decimation, body)
        raise RuntimeError(f"fir_direct launch failed ({FIR_BODIES[body]}): "
                           f"CUDA error {err} ({smem} B of shared memory per "
                           f"block)")
    fir_direct.launches += 1
    return planar.PC(*ys) if isinstance(x, planar.PC) else ys[0]


fir_direct.launches = 0
fir_direct_mxu = fir_direct


# --------------------------------------------------------------------------
# The FFT core of kernels 5 and 6 (csrc/fft_core.cuh)
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def fft_passes(n: int, reverse: bool = False) -> tuple:
    """(radices, twiddles): the pass schedule of the Stockham core for an
    n-point transform (n a power of two in [256, 16384]) and the pass
    twiddles it is launched with.

    The radices are 16, ..., 16 and one radix 2/4/8 when log2(n) is not a
    multiple of 4 (2048 → (16, 16, 8)), that order reversed when
    ``reverse`` (the overlap-save inverse).  Pass p follows
    NS_p = R_0·…·R_{p−1} points; the table holds, for p ≥ 1 in order,
    exp(−2πi·r·k / (NS_p·R_p)) at [r, k], r < R_p, k < NS_p, computed in
    float64 and stored as complex64.  The inverse uses the conjugates."""
    logn = n.bit_length() - 1
    if n != 1 << logn or not 8 <= logn <= 14:
        raise ValueError(f"the FFT core takes 256 to 16384 points (a power "
                         f"of two), not {n}")
    radices = (16,) * (logn // 4) + ((1 << logn % 4,) if logn % 4 else ())
    if reverse:
        radices = radices[::-1]
    parts, ns = [], radices[0]
    for r in radices[1:]:
        parts.append(np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(ns))
                            / (ns * r)).reshape(-1))
        ns *= r
    return radices, np.concatenate(parts).astype(np.complex64)


# --------------------------------------------------------------------------
# Kernel 6: the overlap-save FFT filter
# --------------------------------------------------------------------------

_OFS_MAX_P = 16384       # 8·P bytes of shared memory: 128 KiB


class OfsPlan:
    """Design-time constants of the overlap-save filter.

    The sizing callers see is the JAX package's (``pallas_kernels.OfsPlan``),
    so frames, tails and outputs line up with it: ``ov_rows`` = ⌈(K−1)/128⌉
    rows of carried input, ``tail_len`` = ov_rows·128 samples, ``quantum``
    = stride·t·128 (32768 for every design from 49 to 1601 taps), and
    ``decimation`` (1 until the caller sets it).  The TPU's MXU matrices have
    no counterpart.  The kernel picks its own transform: ``fft_size`` P, a
    power of two ≥ 4(K−1) between 256 and 16384 (larger only when K is, and
    then the card refuses it), giving ``valid`` = P − (K−1) outputs per
    chunk; ``spectrum`` is the taps' P-point FFT.  The kernel's forms:
    the spectrum / P in natural order (the forward Stockham passes leave
    natural order) and the pass twiddles of ``fft_passes(P)`` followed by
    those of ``fft_passes(P, reverse=True)``."""

    def __init__(self, taps):
        taps = np.asarray(taps, np.complex64)
        ntaps = int(taps.shape[-1])
        if ntaps < 2:
            raise ValueError("ofs kernel needs >= 2 taps")
        ov_rows = max(1, -(-(ntaps - 1) // LANES))
        stride = 4
        while stride < 3 * ov_rows:
            stride *= 2
        n2 = stride + ov_rows
        t = 1                             # the TPU's chunks per tile
        while 2 * t * n2 <= 512:
            t *= 2
        self.ntaps, self.ov_rows, self.stride, self.t = ntaps, ov_rows, stride, t
        self.quantum = stride * t * LANES
        self.tail_len = ov_rows * LANES
        self.decimation = 1
        p = 256
        while p < 4 * (ntaps - 1) and p < _OFS_MAX_P:
            p *= 2
        while p < 2 * ntaps:
            p *= 2
        self.fft_size, self.valid = p, p - (ntaps - 1)
        padded = np.zeros(p, np.complex128)
        padded[:ntaps] = taps
        spec = np.fft.fft(padded)
        self.spectrum = spec.astype(np.complex64)
        tw = np.concatenate([fft_passes(p)[1], fft_passes(p, reverse=True)[1]])
        self._consts = [per_device(a.astype(np.complex64))
                        for a in (spec, spec / p, tw)]

    def consts(self, device: torch.device):
        """(spectrum [P], kernel spectrum / P [P], the two schedules' pass
        twiddles) as complex64 tensors on ``device``, uploaded once per
        device."""
        return tuple(get(device) for get in self._consts)


def _check_ofs(xr, xi, tail_r, tail_i, plan: OfsPlan, decimation: int) -> int:
    n = xr.shape[-1]
    if xr.dim() != 1 or xi.shape != xr.shape:
        raise ValueError("xr/xi must be one row each, of one length")
    if n % plan.quantum:
        raise ValueError(f"frame length {n} must be a multiple of "
                         f"{plan.quantum}")
    if tuple(tail_r.shape) != (plan.tail_len,) or tail_i.shape != tail_r.shape:
        raise ValueError(f"tail must be [{plan.tail_len}]")
    if decimation < 1 or n % decimation:
        raise ValueError(f"frame length {n} is not a multiple of the "
                         f"decimation {decimation}")
    return n


def ofs_filter_planar_plain(xr, xi, tail_r, tail_i, plan: OfsPlan, *,
                            decimation: int = 1):
    """Plain torch form of ``ofs_filter_planar`` (any device): overlap-save
    with ``torch.fft`` at the plan's transform size."""
    n = _check_ofs(xr, xi, tail_r, tail_i, plan, decimation)
    k, p, valid = plan.ntaps, plan.fft_size, plan.valid
    spec = plan.consts(xr.device)[0]
    v = torch.complex(torch.cat([tail_r, xr]), torch.cat([tail_i, xi]))
    v = v[plan.tail_len - (k - 1):]                    # n + K − 1 samples
    nch = -(-n // valid)
    v = torch.cat([v, v.new_zeros((nch - 1) * valid + p - v.shape[0])])
    z = torch.fft.ifft(torch.fft.fft(v.unfold(0, p, valid)) * spec)
    y = z[:, k - 1:].reshape(-1)[:n]
    if decimation > 1:
        y = y[::decimation]
    return y.real.contiguous(), y.imag.contiguous()


def ofs_filter_planar(xr, xi, tail_r, tail_i, plan: OfsPlan, *,
                      decimation: int = 1):
    """Overlap-save FFT filter step (``csrc/ofs_filter.cu`` on CUDA).

    xr/xi: [n] float32, n a multiple of ``plan.quantum``; tail_r/tail_i:
    [plan.tail_len] float32 — the previous frame's last samples (zeros
    initially).  Returns (yr, yi): y[p] = Σ_k taps[k]·x[p−k] with x reaching
    back into the tail — the overlap-add path's samples — for p < n, or
    every ``decimation``-th of them (the JAX function returns full rate and
    leaves the slice to its caller; here the kernel writes only those)."""
    if xr.device.type == "cpu":
        return ofs_filter_planar_plain(xr, xi, tail_r, tail_i, plan,
                                       decimation=decimation)
    n = _check_ofs(xr, xi, tail_r, tail_i, plan, decimation)
    dev = xr.device
    _, kspec, tw = plan.consts(dev)
    _require_cuda(xr, xi, tail_r, tail_i, kspec, tw)
    if any(t.dtype != torch.float32 for t in (xr, xi, tail_r, tail_i)):
        raise ValueError("the OFS kernel takes float32 streams and tails")
    yr = torch.empty(n // decimation, dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    lib = _load()
    err = lib.clen_ofs_filter(
        xr.data_ptr(), xi.data_ptr(), tail_r.data_ptr(), tail_i.data_ptr(),
        kspec.data_ptr(), tw.data_ptr(), yr.data_ptr(), yi.data_ptr(), n,
        plan.tail_len, plan.ntaps, plan.fft_size, decimation, tw.numel(),
        _stream(dev))
    if err != 0:
        smem = lib.clen_ofs_smem_bytes(plan.fft_size)
        raise RuntimeError(f"ofs_filter launch failed: CUDA error {err} "
                           f"({smem} B of shared memory per block)")
    ofs_filter_planar.launches += 1
    return yr, yi


ofs_filter_planar.launches = 0


# --------------------------------------------------------------------------
# Kernel 9: the quadrature demodulator
# --------------------------------------------------------------------------

def _check_qdemod(xr, xi, last_r, last_i) -> tuple:
    """The leading shape (one carried sample per row)."""
    if xr.dim() < 1 or xi.shape != xr.shape or xr.shape[-1] < 1:
        raise ValueError("xr/xi must share one shape with >= 1 sample per row")
    lead = tuple(xr.shape[:-1])
    rows = int(np.prod(lead, dtype=np.int64))
    if last_r.numel() != rows or last_i.numel() != rows:
        raise ValueError(f"one carried sample per row: expected {rows}")
    return lead


def qdemod_fused_plain(xr, xi, last_r, last_i, gain: float):
    """Plain torch form of ``qdemod_fused`` (any device): the JAX package's
    XLA form with ``torch.atan2``."""
    lead = _check_qdemod(xr, xi, last_r, last_i)
    return demod._qdemod_xla(xr, xi, last_r.reshape(lead + (1,)),
                             last_i.reshape(lead + (1,)), gain)


def qdemod_fused(xr, xi, last_r, last_i, gain: float):
    """FM discriminator y[n] = gain·atan2 of x[n]·conj(x[n−1]) over planar
    rows (``csrc/qdemod.cu`` on CUDA).

    xr/xi: [..., n] float32, any n ≥ 1; last_r/last_i: one carried sample
    per row (the previous frame's last; a scalar for a 1-D frame).  Returns
    y [..., n] float32.  atan2 keeps IEEE signed zeros, as the JAX
    package's XLA form does (its Pallas kernel's polynomial maps −0.0 to
    +0.0)."""
    if xr.device.type == "cpu":
        return qdemod_fused_plain(xr, xi, last_r, last_i, gain)
    lead = _check_qdemod(xr, xi, last_r, last_i)
    rows = int(np.prod(lead, dtype=np.int64))
    lr, li = last_r.reshape(rows), last_i.reshape(rows)
    _require_cuda(xr, xi, lr, li)
    if any(t.dtype != torch.float32 for t in (xr, xi, lr, li)):
        raise ValueError("the demod kernel takes float32 samples")
    y = torch.empty_like(xr)
    err = _load().clen_qdemod(xr.data_ptr(), xi.data_ptr(), lr.data_ptr(),
                              li.data_ptr(), y.data_ptr(), rows,
                              xr.shape[-1], float(gain), _stream(xr.device))
    if err != 0:
        raise RuntimeError(f"qdemod launch failed: CUDA error {err}")
    qdemod_fused.launches += 1
    return y


qdemod_fused.launches = 0


# --------------------------------------------------------------------------
# Kernel 3: the fused oversampled PFB
# --------------------------------------------------------------------------

_OS_GROUPS = 2048    # pfb_os_kernel's outputs (groups × channels) a block, at most

# the three __global__ bodies of csrc/pfb_oversampled.cu, by their C body code
OS_BODIES = ("pfb_os_kernel", "pfb_os_reg_kernel", "pfb_os_wide_kernel")
OS_REG_M = (2, 4, 8, 16)
OS_WIDE_M = (32, 64, 128)
OS_WIDE_L = (2, 4, 8, 16)


def _pick_os_body(m: int, r: int, wide_smem: int, optin: int) -> str:
    """``os_body``'s rule: ``pfb_os_reg_kernel`` for m in {2, 4, 8, 16};
    ``pfb_os_wide_kernel`` for m in {32, 64, 128} at L = m/r in {2, 4, 8,
    16} where its one-chunk block's ``wide_smem`` bytes of shared memory
    fit the card's opt-in ``optin``; ``pfb_os_kernel`` otherwise."""
    if m in OS_REG_M:
        return OS_BODIES[1]
    if (m in OS_WIDE_M and m % r == 0 and m // r in OS_WIDE_L
            and wide_smem <= optin):
        return OS_BODIES[2]
    return OS_BODIES[0]


def os_body(m: int, r: int, w: int, device) -> str:
    """The kernel body an oversampled PFB call with ``m`` channels,
    decimation ``r`` and ``w`` tap rows launches on the CUDA ``device``:
    ``pfb_os_reg_kernel`` (register-tiled phase FIR, in-register M-point
    DFTs, the rotation as an L-th-root twiddle) for m in {2, 4, 8, 16},
    where 16 points a thread hold 16/m groups; ``pfb_os_wide_kernel`` (the
    same stages, each M-point DFT in two in-register passes over M/16
    lanes) for m in {32, 64, 128} at L = m/r in {2, 4, 8, 16} wherever its
    one-chunk block (``clen_os_smem_bytes``) fits the card's opt-in shared
    memory; ``pfb_os_kernel`` (shared-memory operands, a dense DFT) for
    every other m dividing 128 and L.  A pure choice made before the
    launch.  A CPU call runs the plain form, which has no body."""
    if m < 1 or LANES % m:
        raise ValueError(f"m must divide {LANES}; got {m}")
    if r < 1 or w < 1:
        raise ValueError(f"need r >= 1 and w >= 1; got {r}, {w}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"os_body names a CUDA kernel body; got {device}")
    return OS_BODIES[_os_body_code(m, r, w, device.index or 0)]


@lru_cache(maxsize=None)
def _os_body_code(m: int, r: int, w: int, index: int) -> int:
    """``os_body``'s choice on card ``index``, as the C body code, made
    once for each (m, r, w, card)."""
    wide_smem = (_load().clen_os_smem_bytes(m, r, w, 1, OS_BODIES.index(
        "pfb_os_wide_kernel")) if m in OS_WIDE_M else 0)
    return OS_BODIES.index(_pick_os_body(m, r, wide_smem, _smem_optin(index)))


def os_window_fits(m: int, r: int, w: int, device) -> bool:
    """Whether the oversampled kernel can run M=m, R=r with W=w tap rows on
    ``device``: the smallest block of the body ``os_body`` names — one
    output group's window, branch sums and twiddles for ``pfb_os_kernel``,
    the fixed block of 2048/m groups for ``pfb_os_reg_kernel``, one chunk
    for ``pfb_os_wide_kernel`` — must fit the card's opt-in shared memory
    per block (``csrc/pfb_oversampled.cu`` sizes them).  The plain form on
    the CPU has no such limit."""
    device = torch.device(device)
    if device.type == "cpu":
        return True
    with torch.cuda.device(device):
        fits = _load().clen_os_fits(m, r, w,
                                    OS_BODIES.index(os_body(m, r, w, device)))
    if fits < 0:
        raise RuntimeError(f"cannot read {device}'s shared memory: CUDA "
                           f"error {-fits}")
    return bool(fits)


def _check_os(xr, xi, tail_r, tail_i, taps, m: int, r: int):
    """The JAX function's semantic checks; returns (W, n, H)."""
    n = xr.shape[-1]
    if m % r:
        raise ValueError("fused oversampled kernel requires R | M")
    ell = m // r
    if ell < 2:
        raise ValueError("use the critical-sampled kernels for R == M")
    if LANES % m:
        raise ValueError(f"m must divide {LANES}")
    if xr.dim() != 1 or xi.shape != xr.shape:
        raise ValueError("xr/xi must be one row each, of one length")
    if tail_r.shape != tail_i.shape or tail_r.dim() != 1 \
            or tail_r.shape[0] % LANES:
        raise ValueError("tails must be 1-D, equal-length, multiple of 128")
    if taps.dim() != 2 or taps.shape[1] != m:
        raise ValueError(f"taps_rm must be [W, {m}]")
    h = tail_r.shape[0]
    w = taps.shape[0]
    if n < m or n % m:
        raise ValueError(f"frame length {n} must be a positive multiple of "
                         f"R·L = {m}")
    reach = (w - 1) * m + (ell - 1) * r
    if reach // LANES + 2 > h // LANES:
        raise ValueError(
            f"tap reach (w={w}, m={m}, r={r}) exceeds the {h // LANES}-row "
            f"halo — size state with os_tail_len(m, r, ntaps)")
    return w, n, h


def pfb_oversampled_fused_plain(xr, xi, tail_r, tail_i, taps_rm, m: int,
                                r: int, i_offset: int = 0):
    """Plain torch form of ``pfb_oversampled_fused`` (any device): the XLA
    phase-split branch sums (``channelizer._pfb_oversampled_planar``) of the
    virtual stream with the padded tap count W·M, then
    ``planar.ifft_unscaled``."""
    taps = torch.as_tensor(taps_rm, dtype=torch.float32, device=xr.device)
    w, n, _ = _check_os(xr, xi, tail_r, tail_i, taps, m, r)
    vr = torch.cat([tail_r, xr]).float()
    vi = torch.cat([tail_i, xi]).float()
    acc = channelizer._pfb_oversampled_planar(vr, vi, taps, m, r, w * m,
                                              n // r, i_offset)
    z = planar.ifft_unscaled(planar.PC(*acc))
    return z.re, z.im


def pfb_oversampled_fused(xr, xi, tail_r, tail_i, taps_rm, m: int, r: int,
                          i_offset: int = 0):
    """Fused oversampled (R < M, R | M) PFB channelizer step
    (``csrc/pfb_oversampled.cu`` on CUDA).

    For the virtual stream v = tail ++ frame, output group i reads
    v[i·R .. i·R + W·M − 1]: acc[i, j] = Σ_c taps[c·M + j] ·
    v[i·R + W·M − 1 − j − c·M], rotated to channel (j + (i + i_offset)·
    (M − R)) mod M and inverse-DFT'd unscaled — the reference pipeline
    (clPolyphaseChannelizer_impl.cc:156-167, :208-225) without the ch_map
    selection.  Outputs lag the frame end by the tail length.

    Args:
      xr, xi: [n] float32, n a multiple of M = R·L (a whole number of
        rotation phases per call).
      tail_r, tail_i: [os_tail_len(M, R, ntaps)] float32 — the previous
        frame's last samples (zeros first).
      taps_rm: [W, M] branch-major prototype taps.
      i_offset: the global output-group index of the first group (the
        rotation phase of time-sharded callers).

    Returns (zr, zi) each [n/R, M] float32, in output-group order.  The
    JAX function's TPU selectors (tile_rows, mxu_dtype, flat_output,
    precision, deep_strategy, interpret) have no counterpart."""
    if xr.device.type == "cpu":
        return pfb_oversampled_fused_plain(xr, xi, tail_r, tail_i, taps_rm, m,
                                           r, i_offset)
    dev = xr.device
    taps = torch.as_tensor(taps_rm, dtype=torch.float32, device=dev)
    taps = taps.contiguous()
    tw = _twiddles(m, dev)
    _require_cuda(xr, xi, tail_r, tail_i, taps, tw)
    if any(t.dtype != torch.float32 for t in (xr, xi, tail_r, tail_i)):
        raise ValueError("the oversampled PFB kernel takes float32 streams")
    w, n, h = _check_os(xr, xi, tail_r, tail_i, taps, m, r)
    nout = n // r
    body = _os_body_code(m, r, w, dev.index or 0)
    lib = _load()
    zr = torch.empty((nout, m), dtype=torch.float32, device=dev)
    zi = torch.empty_like(zr)
    err = lib.clen_pfb_oversampled(
        xr.data_ptr(), xi.data_ptr(), tail_r.data_ptr(), tail_i.data_ptr(),
        taps.data_ptr(), tw.data_ptr(), zr.data_ptr(), zi.data_ptr(), n, h, m,
        r, w, int(i_offset) % m, max(1, _OS_GROUPS // m), body,
        _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"pfb_oversampled launch failed ({OS_BODIES[body]}): CUDA error "
            f"{err} ({lib.clen_os_smem_bytes(m, r, w, 1, body)} B of shared "
            f"memory for its smallest block)")
    pfb_oversampled_fused.launches += 1
    return zr, zi


pfb_oversampled_fused.launches = 0


# --------------------------------------------------------------------------
# Kernel 5: the batched FFT
# --------------------------------------------------------------------------

FFT_MIN, FFT_MAX = 256, 16384      # n2·128 with n2 a power of two in [2, 128]


def fft_size_covered(fft_size: int) -> bool:
    """The JAX kernel's envelope: fft_size = n2·128, n2 a power of two in
    [2, 128]."""
    n2 = fft_size // LANES
    return (fft_size % LANES == 0 and 2 <= n2 <= 128
            and (n2 & (n2 - 1)) == 0)


@lru_cache(maxsize=None)
def _fft_twiddles(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fft_passes(n)[1], device=device)


def _check_fft(xr, xi, fft_size: int, window):
    if not fft_size_covered(fft_size):
        raise ValueError("fft_size/128 must be a power of two in [2, 128]")
    if xr.dim() != 1 or xi.shape != xr.shape:
        raise ValueError("xr/xi must be one row each, of one length")
    n = xr.shape[-1]
    if n % fft_size:
        raise ValueError("stream length must be a multiple of fft_size")
    if window is not None:
        window = torch.as_tensor(window, dtype=torch.float32, device=xr.device)
        if tuple(window.shape) != (fft_size,):
            raise ValueError(f"window length {tuple(window.shape)} != "
                             f"fft_size {fft_size}")
    return n, window


def fft_batched_fused_plain(xr, xi, fft_size: int, inverse: bool = False,
                            window=None, shift: bool = False):
    """Plain torch form of ``fft_batched_fused`` (any device): the two-stage
    DFT of ``dsp.fft.fft_planar`` over [n/fft_size, fft_size] vectors."""
    n, window = _check_fft(xr, xi, fft_size, window)
    x = planar.PC(xr.reshape(-1, fft_size), xi.reshape(-1, fft_size))
    y = dsp_fft.fft_planar(x, dsp_fft.REVERSE if inverse else dsp_fft.FORWARD,
                           window=window, shift=shift)
    return y.re.reshape(n), y.im.reshape(n)


def fft_batched_fused(xr, xi, fft_size: int, inverse: bool = False,
                      window=None, shift: bool = False):
    """Batched unscaled FFT over a planar stream chopped into fft_size
    vectors (``csrc/fft_batched.cu`` on CUDA): optional window on load,
    sign −1 forward and +1 inverse, natural-order output.

    xr/xi: [n] float32, n a multiple of fft_size; fft_size = n2·128 with
    n2 a power of two in [2, 128] (256 to 16384 points).  ``shift`` is the
    ``Fft`` block's: forward, an fftshift of each output vector; inverse,
    the input halves swapped before the window (lib/clFFT_impl.cc:544-607).
    The JAX function leaves the shift to its caller; the kernel does it in
    its load and store indices.  Returns (yr, yi) [n] float32.

    The call goes through the operator ``clenabled_tpu_torch::fft_batched``,
    whose ``torch.func.vmap`` rule folds the batch axes into the stream:
    under ``vmap`` over K frames (the Runner's vectorised dispatch) the K
    frames' vectors are transformed in one launch, bit-equal to K calls
    (the kernel transforms each vector on its own).  The window is shared
    by every frame and may not be batched."""
    _, window = _check_fft(xr, xi, fft_size, window)
    return _fft_op(xr, xi, fft_size, bool(inverse), window, bool(shift))


@torch.library.custom_op("clenabled_tpu_torch::fft_batched", mutates_args=())
def _fft_op(xr: torch.Tensor, xi: torch.Tensor, fft_size: int, inverse: bool,
            window: torch.Tensor | None, shift: bool
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch over the whole stream (the plain form on CPU
    tensors)."""
    if xr.device.type == "cpu":
        return fft_batched_fused_plain(xr, xi, fft_size, inverse, window,
                                       shift)
    n, window = _check_fft(xr, xi, fft_size, window)
    dev = xr.device
    tw = _fft_twiddles(fft_size, dev)
    xr, xi = xr.contiguous(), xi.contiguous()
    ins = (xr, xi, tw) if window is None else (xr, xi, tw, window.contiguous())
    _require_cuda(*ins)
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise ValueError("the FFT kernel takes float32 streams")
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    lib = _load()
    err = lib.clen_fft_batched(
        xr.data_ptr(), xi.data_ptr(),
        None if window is None else ins[3].data_ptr(), tw.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), n, fft_size, int(inverse), int(shift),
        tw.numel(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fft_batched launch failed: CUDA error {err} "
                           f"({lib.clen_fft_smem_bytes(fft_size)} B of shared "
                           f"memory per block)")
    fft_batched_fused.launches += 1
    return yr, yi


@_fft_op.register_vmap
def _fft_op_vmap(info, in_dims, xr, xi, fft_size, inverse, window, shift):
    """The batch rule: every frame's vectors in one stream, one call."""
    if in_dims[4] is not None:
        raise ValueError("fft_batched_fused: the window is shared by every "
                         "frame and cannot be batched")
    b = info.batch_size

    def rows(x, dim):
        x = x.expand(b, *x.shape) if dim is None else x.movedim(dim, 0)
        return x.contiguous().reshape(-1)

    yr, yi = _fft_op(rows(xr, in_dims[0]), rows(xi, in_dims[1]), fft_size,
                     inverse, window, shift)
    return (yr.reshape(b, -1), yi.reshape(b, -1)), (0, 0)


fft_batched_fused.launches = 0


# --------------------------------------------------------------------------
# Kernel 10: the exact sequential Costas loop
# --------------------------------------------------------------------------

def _check_costas(xr, xi, order: int):
    if order not in (2, 4):
        raise ValueError("costas loop order must be 2 or 4")
    if xr.dim() != 1 or xi.shape != xr.shape:
        raise ValueError("xr/xi must be one row each, of one length")


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def costas_scalar_plain(xr, xi, phase, freq, error, order: int, alpha: float,
                        beta: float, f_min: float = -1.0, f_max: float = 1.0):
    """Plain torch form of ``costas_scalar`` (any device):
    ``demod._costas_step_planar`` one sample at a time on 0-d float32
    tensors.  One Python step per sample: for tests and checks."""
    _check_costas(xr, xi, order)
    dev = xr.device
    step = demod._costas_step_planar(
        order, *(_f32(v, dev) for v in (alpha, beta, f_min, f_max)))
    carry = tuple(_f32(v, dev) for v in (phase, freq, error))
    outs_r, outs_i = [], []
    for t in range(xr.shape[0]):
        carry, (o_r, o_i) = step(carry, (xr[t], xi[t]))
        outs_r.append(o_r)
        outs_i.append(o_i)
    if not outs_r:
        return (xr.new_zeros(0), xi.new_zeros(0)) + carry
    return (torch.stack(outs_r), torch.stack(outs_i)) + carry


def costas_scalar(xr, xi, phase, freq, error, order: int, alpha: float,
                  beta: float, f_min: float = -1.0, f_max: float = 1.0):
    """Exact sequential Costas loop over one planar frame
    (``csrc/costas.cu`` on CUDA): the recurrence of
    ``demod._costas_step_planar`` (GR control_loop semantics, reference
    lib/clCostasLoop_impl.cc:151-312), bit for bit the plain form's.

    On the card one warp runs the loop-carried chain, at least 19
    dependent operations a sample (21 for order 4), with the order a
    template parameter.  Its sin/cos is the CUDA math library's
    ``cosf``/``sinf`` written out: the branch-free fast path on the loop's
    domain (|phase| <= 2π or NaN, which the wrap keeps after the first
    sample; ``costas_sincos_probe`` holds it to the library); the first
    sample's carried phase, any float, takes ``cosf``/``sinf``
    themselves.  A bound on the phase's growth lets a group of 16 samples
    run without the wrap test when none of them can need it.  A second
    warp stages the samples through a ring in shared memory.  On the card
    f_min and f_max must not be NaN (the kernel's clamp and bound take
    them as numbers); the plain form takes NaN limits as JAX's does.

    xr/xi: [n] float32, any n; phase, freq, error: the carried state
    (0-d tensors or floats).  The state goes to the kernel as one 3-float
    device tensor and comes back as one, so a stream of frames never waits
    on the host.  Returns (o_r [n], o_i [n], phase', freq', error'), the
    last three 0-d views of the kernel's state tensor.  The JAX function's
    ``chunk`` and ``interpret`` have no counterpart."""
    if xr.device.type == "cpu":
        return costas_scalar_plain(xr, xi, phase, freq, error, order, alpha,
                                   beta, f_min, f_max)
    _check_costas(xr, xi, order)
    if math.isnan(float(f_min)) or math.isnan(float(f_max)):
        raise ValueError("costas loop frequency limits must not be NaN on "
                         "the card")
    dev = xr.device
    st = torch.stack([_f32(v, dev) for v in (phase, freq, error)])
    _require_cuda(xr, xi, st)
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise ValueError("the Costas kernel takes float32 samples")
    o_r = torch.empty_like(xr)
    o_i = torch.empty_like(xi)
    st_out = torch.empty_like(st)
    err = _load().clen_costas(
        xr.data_ptr(), xi.data_ptr(), st.data_ptr(), st_out.data_ptr(),
        o_r.data_ptr(), o_i.data_ptr(), xr.shape[0], order, float(alpha),
        float(beta), float(f_min), float(f_max), _stream(dev))
    if err != 0:
        raise RuntimeError(f"costas launch failed: CUDA error {err}")
    costas_scalar.launches += 1
    return o_r, o_i, st_out[0], st_out[1], st_out[2]


costas_scalar.launches = 0


def _check_costas_rows(xr, xi, order: int):
    if order not in (2, 4):
        raise ValueError("costas loop order must be 2 or 4")
    if xr.dim() not in (2, 3) or xi.shape != xr.shape:
        raise ValueError("xr/xi must be [B, L] or [G, R, L] rows, of one "
                         "shape")


def _rows(v, shape, device) -> torch.Tensor:
    """A per-row state value (a float or a tensor broadcastable to
    ``shape``) as a float32 tensor of ``shape``."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=device).expand(shape)


def costas_batched_plain(xr, xi, phase, freq, error, order: int,
                         alpha: float, beta: float, f_min: float = -1.0,
                         f_max: float = 1.0):
    """Plain torch form of ``costas_batched`` (any device):
    ``demod._costas_step_planar`` one sample at a time on the rows' states
    at once.  One Python step per sample: for tests and checks."""
    _check_costas_rows(xr, xi, order)
    dev, lead = xr.device, xr.shape[:-1]
    step = demod._costas_step_planar(
        order, *(_f32(v, dev) for v in (alpha, beta, f_min, f_max)))
    carry = tuple(_rows(v, lead, dev) for v in (phase, freq, error))
    outs_r, outs_i = [], []
    for t in range(xr.shape[-1]):
        carry, (o_r, o_i) = step(carry, (xr[..., t], xi[..., t]))
        outs_r.append(o_r)
        outs_i.append(o_i)
    if not outs_r:
        return (xr.new_zeros(xr.shape), xi.new_zeros(xi.shape)) + tuple(
            c.clone() for c in carry)
    return (torch.stack(outs_r, -1), torch.stack(outs_i, -1)) + carry


# the two bodies of csrc/costas.cu's batched entry, by their C body code
COSTAS_BODIES = ("block", "lane")
# block-body blocks an SM that each keep one chain's latency: a Hopper SM
# has 4 warp schedulers and a block 2 warps (the chain, its staging warp);
# a third block shares a scheduler with a chain.  On an H100 the block
# body is faster at 264 rows (2 an SM) and slower from 330 rows
# (tools/costas_ab.py --batched)
COSTAS_FULL_RATE_BLOCKS = 2


def _pick_costas_body(rows: int, sm_count: int) -> str:
    """``block`` while every row has a block slot that keeps one chain's
    latency (``COSTAS_FULL_RATE_BLOCKS`` an SM), ``lane`` past that, where
    the block body slows down and then runs in waves and the lane body
    packs 32 rows into a warp."""
    return "lane" if rows > COSTAS_FULL_RATE_BLOCKS * sm_count else "block"


def costas_body(rows: int, device) -> str:
    """The body a ``costas_batched`` call of ``rows`` rows launches on the
    CUDA ``device`` (``_pick_costas_body`` on the card's SM count).  A CPU
    call runs the plain form, which has no body."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"costas_body names a CUDA kernel body; got {device}")
    sms = torch.cuda.get_device_properties(
        device.index or 0).multi_processor_count
    return _pick_costas_body(rows, sms)


def costas_batched(xr, xi, phase, freq, error, order: int, alpha: float,
                   beta: float, f_min: float = -1.0, f_max: float = 1.0,
                   body: str | None = None):
    """B independent exact sequential Costas loops (``csrc/costas.cu``'s
    batched entry on CUDA): row b runs ``costas_scalar`` on its samples
    from its own (phase, freq, error), bit for bit what ``costas_scalar``
    gives on that row alone.

    xr/xi: [B, L] or [G, R, L] float32 views whose last dimension is
    contiguous; the leading strides may be anything (windows of one stream
    that overlap are read where they lie, e.g. from ``as_strided``).
    phase/freq/error: the rows' states, tensors of the leading shape (or
    broadcastable to it).  Returns (o_r, o_i) of xr's shape, contiguous,
    and (phase', freq', error') of the leading shape.  On the card
    ``body`` picks the kernel body: ``"block"`` (one block, the single
    chain's 64 threads and 32 KB of rings, a row), ``"lane"`` (one lane a
    row, 32 loops a warp, samples loaded into registers a group ahead) or
    None, ``costas_body``'s choice by the number of rows; the two agree bit
    for bit.  f_min and f_max must not be NaN there.  The JAX counterpart
    is ``jax.vmap`` of the ``lax.scan`` over ``_costas_step_planar``."""
    if body is not None and body not in COSTAS_BODIES:
        raise ValueError(f"unknown Costas body {body!r}; use one of "
                         f"{COSTAS_BODIES} or None")
    if xr.device.type == "cpu":
        return costas_batched_plain(xr, xi, phase, freq, error, order, alpha,
                                    beta, f_min, f_max)
    _check_costas_rows(xr, xi, order)
    if math.isnan(float(f_min)) or math.isnan(float(f_max)):
        raise ValueError("costas loop frequency limits must not be NaN on "
                         "the card")
    dev, lead, n = xr.device, xr.shape[:-1], xr.shape[-1]
    st = torch.stack([_rows(v, lead, dev) for v in (phase, freq, error)],
                     -1).contiguous()
    if xi.device != dev:
        raise ValueError("all tensors must be on one device")
    _require_cuda(st)
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise ValueError("the Costas kernel takes float32 samples")
    if xr.stride() != xi.stride() or (n > 1 and xr.stride(-1) != 1):
        raise ValueError("xr/xi must share their strides, the last being 1")
    o_r = torch.empty(xr.shape, dtype=torch.float32, device=dev)
    o_i = torch.empty_like(o_r)
    st_out = torch.empty_like(st)
    rows = math.prod(lead)
    if rows == 0:
        return o_r, o_i, st[..., 0], st[..., 1], st[..., 2]
    if xr.dim() == 2:
        group_rows, group_stride, row_stride = rows, 0, xr.stride(0)
    else:
        group_rows, group_stride, row_stride = (xr.shape[1], xr.stride(0),
                                                xr.stride(1))
    body = costas_body(rows, dev) if body is None else body
    err = _load().clen_costas_batched(
        xr.data_ptr(), xi.data_ptr(), rows, group_rows, group_stride,
        row_stride, st.data_ptr(), st_out.data_ptr(), o_r.data_ptr(),
        o_i.data_ptr(), n, order, float(alpha), float(beta), float(f_min),
        float(f_max), COSTAS_BODIES.index(body), _stream(dev))
    if err != 0:
        raise RuntimeError(f"costas_batched launch failed ({body} body): "
                           f"CUDA error {err}")
    costas_batched.launches += 1
    return o_r, o_i, st_out[..., 0], st_out[..., 1], st_out[..., 2]


costas_batched.launches = 0


# float32 patterns of the Costas chain's sin/cos domain: |x| <= float32(2π)
# (bits 0 .. 0x40C90FDB of each sign) or NaN (2^23 - 1 of each sign)
COSTAS_LOOP_PATTERNS = 2 * (0x40C90FDB + 1) + 2 * ((1 << 23) - 1)


def costas_sincos_probe(first: int = 0, count: int = 1 << 32,
                        device=None) -> dict[str, int]:
    """Hold the Costas kernel's sin/cos on its chain to the CUDA math
    library's ``sinf``/``cosf`` on the float32 bit patterns ``first`` ..
    ``first + count - 1`` (all 2^32 by default), on the card (``device``
    None: ``cuda:0``; raises elsewhere).  Returns the counts of patterns
    of the chain's domain (|x| <= 2π, or NaN) where it differs (``loop``),
    of that domain's patterns (``in_domain``; all 2^32 hold
    ``COSTAS_LOOP_PATTERNS``), and of patterns outside it where it differs
    (``loop_outside``: values the loop never keeps).  Two NaNs agree;
    otherwise the bits must be equal."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the sin/cos probe runs on a CUDA device")
    if not (0 <= first and 0 <= count and first + count <= 1 << 32):
        raise ValueError("the probe's range lies within the 2^32 patterns")
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    lib = _load()
    err = lib.clen_costas_sincos_probe(first, count, counts.data_ptr(),
                                       _stream(dev))
    if err != 0:
        raise RuntimeError(f"costas sin/cos probe failed: CUDA error {err}")
    return dict(zip(("loop", "in_domain", "loop_outside"), counts.tolist()))


_COUNTED = (fx_correlate_streams_v2, fx_correlate_streams,
            pfb_channelize_packed, xengine_gram_stacked,
            xengine_gram_stacked_blocks, xengine_gram_stacked_tri, fir_direct,
            ofs_filter_planar, qdemod_fused, pfb_oversampled_fused,
            fft_batched_fused, costas_scalar, costas_batched)


def launch_counts() -> dict[str, int]:
    """Every wrapper's kernel launches since the last reset, by name."""
    return {f.__name__: f.launches for f in _COUNTED}


def reset_launch_counts() -> None:
    for f in _COUNTED:
        f.launches = 0


def _load():
    from clenabled_tpu_torch import _build

    return _build.load()
