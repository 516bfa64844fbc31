"""Hand-written Hopper kernels, with their plain forms.

The counterpart of ``clenabled_tpu.dsp.pallas_kernels`` for the kernels
ported so far:

- ``fx_correlate_streams_v2`` (``csrc/fx_correlate.cu``): the fused step —
  critically sampled PFB, M-point inverse DFT, FD cross-correlation
  magnitude sums and X-Engine Gram sums, reading each input sample once.
  ``fx_correlate_streams`` is the same kernel fed the JAX function's
  history-concatenated flat layout.
- ``pfb_channelize_packed`` (``csrc/pfb_packed.cu``): the lane-packed PFB
  branch sums plus per-group inverse DFT of the planar pipeline.
- ``xengine_gram_stacked`` with its ``_blocks`` and ``_tri`` forms
  (``csrc/xengine_gram.cu``): the X-Engine's per-channel stacked Gram,
  lower block-triangle only, int8 exact.

Each wrapper keeps the JAX function's argument order, shapes and outputs.
Given CPU tensors it runs its plain torch form (``*_plain``: the
channelizer's branch sums and ``planar.ifft_unscaled`` for the FX kernels,
batched products for the Gram); given CUDA tensors
it launches its kernel or raises — it never falls back.  Each wrapper
counts its kernel launches in its ``launches`` attribute.

The TPU engine selectors of the JAX functions (``tile_rows``/``tile``,
``t_tile``, ``mxu_dtype``, ``branch_mxu``, ``karatsuba``,
``deep_strategy``, ``precision``, ``interpret``) have no counterpart: the
kernels pick their own tiles; the FX kernels multiply and accumulate in
float32, the Gram kernel in int32 (int8) or float32 (bfloat16).
"""

from __future__ import annotations

import contextlib
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


def _launch_fx(xr, xi, tail_r, tail_i, taps_rm, a: int, m: int, fd_pairs,
               xe_pairs):
    """Launch ``csrc/fx_correlate.cu`` on CUDA tensors; (fd_sum, gram)."""
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


@contextlib.contextmanager
def _full_f32():
    """float32 matmuls without TF32 on the card, restored afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


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
    """Launch ``csrc/xengine_gram.cu``; (a_blk, b_blk or gi_blk, tri)."""
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
    err = _load().clen_xengine_gram(
        zr.data_ptr(), zi.data_ptr(), _GRAM_DTYPES[zr.dtype], f, t, sp,
        int(emit_gi), a_blk.data_ptr(), b_blk.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"xengine_gram launch failed: CUDA error {err}")
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


def reset_launch_counts() -> None:
    fx_correlate_streams_v2.launches = 0
    fx_correlate_streams.launches = 0
    pfb_channelize_packed.launches = 0
    xengine_gram_stacked.launches = 0
    xengine_gram_stacked_blocks.launches = 0
    xengine_gram_stacked_tri.launches = 0


def _load():
    from clenabled_tpu_torch import _build

    return _build.load()
