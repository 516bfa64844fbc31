"""X-Engine: xGPU-style FX interferometry correlator (the clXEngine role).

The port of ``clenabled_tpu.dsp.xengine``.  Stacking station×pol spectra
over time as Z[t, s·p, f], the correlation matrix of one integration window
is

    G[f, i, j] = Σ_t Z[t, i, f] · conj(Z[t, j, f])

and the triangular xGPU baseline order (lib/clXEngine_impl.cc:744-750) is a
static index into it.  The engines, in the JAX package's order:

- ``xengine_correlate`` / ``_planar``: time-major [T, S, F, P] input;
- ``xengine_correlate_channel_major``: [F, T, S·P] planar input, four real
  batched products;
- ``xengine_correlate_stacked``: [F, T, S·P] float32/bfloat16/int8, one
  stacked Gram — on a CUDA tensor with S·P % 128 == 0 and int8/bfloat16
  operands through the hand-written kernel
  (``hopper_kernels.xengine_gram_stacked_tri``), else batched products
  (int8 sums exact: int64 on the CPU, float64 on the card).

``make_xengine`` / ``make_xengine_channel_major`` integrate on the device
and emit every ``pipeline_integration`` calls (``_pipeline_emit``).  The
integration count stays on the host (a Python int), so deciding whether a
call emits never waits for the card.  Input unpacking matches CharToComplex
(:831-858): signed-byte I/Q scaled by 1/127, packed 4-bit two's-complement
pairs by 1/7.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from clenabled_tpu_torch import _tree
from clenabled_tpu_torch.dsp import planar

# output_format codes (lib/clXEngine_impl.h:28-29)
CLXCORR_TRIANGULAR_ORDER = 1
CLXCORR_FULL_MATRIX = 2

LANES = 128


def num_baselines(num_inputs: int) -> int:
    """N(N+1)/2 including autocorrelations (lib/clXEngine_impl.cc:183)."""
    return num_inputs * (num_inputs + 1) // 2


def baseline_stations(num_inputs: int) -> np.ndarray:
    """[nbaselines, 2] int32 (station1, station2) in xGPU triangular order."""
    k = np.arange(num_baselines(num_inputs))
    s1 = np.floor(-0.5 + np.sqrt(0.25 + 2.0 * k)).astype(np.int32)
    s2 = (k - (s1 + 1) * s1 // 2).astype(np.int32)
    return np.stack([s1, s2], axis=-1)


# --------------------------------------------------------------------------
# Unpacking
# --------------------------------------------------------------------------

def _as_bytes(raw, dtype: torch.dtype) -> torch.Tensor:
    """``raw`` as an int8 or uint8 tensor: the other byte type is
    reinterpreted bit for bit, wider integers wrap as a C cast does."""
    t = torch.as_tensor(raw)
    other = torch.uint8 if dtype == torch.int8 else torch.int8
    if t.dtype == other:
        return t.view(dtype)
    return t.to(dtype)


def unpack_char(raw) -> torch.Tensor:
    """Interleaved signed-byte I/Q → complex64 · (1/127)."""
    z = unpack_char_planar(raw)
    return torch.complex(z.re, z.im)


_TWOS_LUT = np.array([0, 1, 2, 3, 4, 5, 6, 7, 0, -7, -6, -5, -4, -3, -2, -1],
                     dtype=np.float32)


def unpack_char_int8(raw) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved signed-byte I/Q → (re, im) int8 views, UNSCALED — the
    ingest of the int8 stacked engine (the scale 1/127² lands once on the
    integer Gram)."""
    b = _as_bytes(raw, torch.int8)
    pairs = b.reshape(b.shape[:-1] + (-1, 2))
    return pairs[..., 0], pairs[..., 1]


def _nib_signed(nib: torch.Tensor) -> torch.Tensor:
    """4-bit two's-complement nibble (int32 in [0, 15]) → signed value with
    the reference LUT's convention 0b1000 → 0, by arithmetic and a select."""
    v = nib - ((nib & 8) << 1)           # standard sign extension (8 → −8)
    return torch.where(nib == 8, torch.zeros_like(v), v)


def unpack_packed_4bit_int8(raw) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed 4-bit two's-complement I/Q → (re, im) int8, UNSCALED
    (values in [-7, 7]; the scale 1/7² lands on the Gram)."""
    b = _as_bytes(raw, torch.uint8).to(torch.int32)
    return (_nib_signed(b >> 4).to(torch.int8),
            _nib_signed(b & 0xF).to(torch.int8))


def unpack_char_planar(raw) -> planar.PC:
    """Interleaved signed-byte I/Q → planar.PC · (1/127)."""
    f = _as_bytes(raw, torch.int8).float() * np.float32(1.0 / 127.0)
    pairs = f.reshape(f.shape[:-1] + (-1, 2))
    return planar.PC(pairs[..., 0], pairs[..., 1])


def unpack_packed_4bit_planar(raw) -> planar.PC:
    """Packed 4-bit two's-complement I/Q → planar.PC · (1/7)."""
    b = _as_bytes(raw, torch.uint8).to(torch.int32)
    scale = np.float32(1.0 / 7.0)
    return planar.PC(_nib_signed(b >> 4).float() * scale,
                     _nib_signed(b & 0xF).float() * scale)


def unpack_packed_4bit(raw) -> torch.Tensor:
    """Packed 4-bit two's-complement I/Q nibbles (high=I, low=Q) → complex64
    · (1/7); one byte is one complex sample (the reference's X/Y pol pair
    is two consecutive bytes, :846-855)."""
    z = unpack_packed_4bit_planar(raw)
    return torch.complex(z.re, z.im)


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------

def _triangular_index(s: int, npol: int) -> tuple[np.ndarray, np.ndarray]:
    """[nb, npol²] (row, col) indices extracting the xGPU triangular order
    (pol products XX,XY,YX,YY) from a full [S·P, S·P] Gram matrix."""
    st = baseline_stations(s).astype(np.int64)
    p0 = np.repeat(np.arange(npol), npol)
    p1 = np.tile(np.arange(npol), npol)
    rows = st[:, 0:1] * npol + p0[None, :]
    cols = st[:, 1:2] * npol + p1[None, :]
    return rows, cols


@lru_cache(maxsize=32)
def _triangular_index_on(s: int, npol: int, device: torch.device):
    """``_triangular_index`` as tensors, cached on ``device``."""
    return tuple(torch.as_tensor(x, device=device)
                 for x in _triangular_index(s, npol))


def _triangular(g, s: int, npol: int):
    """The xGPU triangular order [F, nb, npol²] of a full Gram (a tensor or
    a planar.PC)."""
    dev = (g.re if isinstance(g, planar.PC) else g).device
    rows, cols = _triangular_index_on(s, npol, dev)
    return _tree.tree_map(lambda x: x[:, rows, cols], g)


def _gram_planar(zr: torch.Tensor, zi: torch.Tensor) -> planar.PC:
    """zr/zi [T, S·P, F] → G [F, S·P, S·P] as 4 real batched matmuls."""
    rr = torch.einsum("tif,tjf->fij", zr, zr)
    ii = torch.einsum("tif,tjf->fij", zi, zi)
    ri = torch.einsum("tif,tjf->fij", zr, zi)
    ir = torch.einsum("tif,tjf->fij", zi, zr)
    return planar.PC(rr + ii, ir - ri)


def _gram(z: torch.Tensor) -> torch.Tensor:
    """z: [T, S, F, P] complex64 → G: [F, S·P, S·P] complex64."""
    t, s, f, p = z.shape
    zz = z.permute(0, 1, 3, 2).reshape(t, s * p, f)
    g = _gram_planar(zz.real.float(), zz.imag.float())
    return torch.complex(g.re, g.im)


def xengine_correlate(z: torch.Tensor, npol: int = 2,
                      output_format: int = CLXCORR_TRIANGULAR_ORDER):
    """z: [T, S, F, P] complex64 → [F, nb, P²] (triangular) or
    [F, S·P, S·P] (full matrix) complex64."""
    z = z.to(torch.complex64)
    t, s, f, p = z.shape
    if p != npol:
        raise ValueError(f"input has {p} pols, expected {npol}")
    g = _gram(z)
    if output_format == CLXCORR_FULL_MATRIX:
        return g
    return _triangular(g, s, p)


def xengine_correlate_planar(z: planar.PC, npol: int = 2,
                             output_format: int = CLXCORR_TRIANGULAR_ORDER
                             ) -> planar.PC:
    """Planar X-Engine: z is a planar.PC of [T, S, F, P]; same output as
    xengine_correlate, as a planar.PC."""
    t, s, f, p = z.re.shape
    if p != npol:
        raise ValueError(f"input has {p} pols, expected {npol}")
    zr = z.re.permute(0, 1, 3, 2).reshape(t, s * p, f)
    zi = z.im.permute(0, 1, 3, 2).reshape(t, s * p, f)
    g = _gram_planar(zr, zi)
    if output_format == CLXCORR_FULL_MATRIX:
        return g
    return _triangular(g, s, p)


def xengine_correlate_channel_major(zr, zi, npol: int = 2,
                                    output_format: int = CLXCORR_TRIANGULAR_ORDER,
                                    compute_dtype=None) -> planar.PC:
    """Channel-major planar X-Engine: zr/zi [F, T, S·P] float32 or
    bfloat16 (stations·pols last, channels batched).  compute_dtype casts
    the operands first; products are formed in float32 (exact for bf16)
    without TF32.  Returns xengine_correlate_planar's planar output."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    f, t, sp = zr.shape
    s = sp // npol
    if compute_dtype is not None:
        zr, zi = zr.to(compute_dtype), zi.to(compute_dtype)
    zr, zi = zr.float(), zi.float()
    with hopper_kernels._full_f32():
        rr = torch.einsum("ftk,ftl->fkl", zr, zr)
        ii = torch.einsum("ftk,ftl->fkl", zi, zi)
        ri = torch.einsum("ftk,ftl->fkl", zr, zi)
        ir = torch.einsum("ftk,ftl->fkl", zi, zr)
    g = planar.PC(rr + ii, ir - ri)
    if output_format == CLXCORR_FULL_MATRIX:
        return g
    return _triangular(g, s, npol)


@lru_cache(maxsize=32)
def _block_takes(s: int, npol: int,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat indices into a_blk / gi_blk [nbt·128·128] (per channel) of the
    triangular order's (row, col) products: the a pick reads the lower
    block (x, y) or, for x < y, the transposed (y, x) block (a is
    symmetric); every gi pick lies in a lower block, since a baseline's
    station1 ≥ station2.  Cached per device."""
    kb = s * npol // LANES
    idx = {}
    for i in range(kb):
        for j in range(i + 1):
            idx[(i, j)] = len(idx)
    rows, cols = _triangular_index(s, npol)
    rows, cols = rows.ravel(), cols.ravel()
    br, ir = rows // LANES, rows % LANES
    bc, ic = cols // LANES, cols % LANES
    pa = np.array([(idx[(x, y)] * LANES + r) * LANES + c if x >= y
                   else (idx[(y, x)] * LANES + c) * LANES + r
                   for x, y, r, c in zip(br, bc, ir, ic)], np.int64)
    pgi = np.array([(idx[(x, y)] * LANES + r) * LANES + c
                    for x, y, r, c in zip(br, bc, ir, ic)], np.int64)
    # kept on the device: uploading them each call would stall the host
    return (torch.as_tensor(pa, device=device),
            torch.as_tensor(pgi, device=device))


def _stacked_use_kernel(zr: torch.Tensor, sp: int) -> bool:
    """The JAX auto rule read for CUDA: the kernel on a CUDA tensor when
    S·P is a multiple of 128 and the operands are int8 or bfloat16."""
    return (zr.device.type == "cuda" and sp % LANES == 0
            and zr.dtype in (torch.int8, torch.bfloat16))


def xengine_correlate_stacked(zr, zi, npol: int = 2,
                              output_format: int = CLXCORR_TRIANGULAR_ORDER,
                              compute_dtype=None, scale: float = 1.0,
                              use_kernel: bool | None = None) -> planar.PC:
    """Channel-major X-Engine on the stacked Gram.

    zr/zi: [F, T, S·P] float32, bfloat16 or int8 (the reference's IChar
    samples used raw).  int8 sums are exact integers and ``scale`` (e.g.
    1/127²) is applied once on the result; bfloat16 products are exact
    and summed in float32.  Returns planar.PC float32, triangular xGPU
    order or full matrix.

    use_kernel (the JAX function's ``use_pallas``; default auto: on for a
    CUDA tensor when S·P is a multiple of 128 and the dtype is int8 or
    bfloat16) routes the contraction through the Gram kernel
    (``hopper_kernels``), which forms only the lower block-triangle; the
    triangular order is then two static-index takes from its block
    outputs.  On a CPU tensor the wrappers run their plain forms."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    f, t, sp = zr.shape
    s = sp // npol
    if compute_dtype is not None:
        zr, zi = zr.to(compute_dtype), zi.to(compute_dtype)
    integer = not zr.dtype.is_floating_point
    if use_kernel is None:
        use_kernel = _stacked_use_kernel(zr, sp)
    if use_kernel:
        if output_format == CLXCORR_TRIANGULAR_ORDER:
            a_blk, gi_blk, _ = hopper_kernels.xengine_gram_stacked_tri(zr, zi)
            pa, pgi = _block_takes(s, npol, a_blk.device)
            gr_t = a_blk.reshape(f, -1)[:, pa]
            gi_t = gi_blk.reshape(f, -1)[:, pgi]
            gr_t, gi_t = gr_t.float(), gi_t.float()
            if scale != 1.0:
                gr_t = gr_t * np.float32(scale)
                gi_t = gi_t * np.float32(scale)
            nb = num_baselines(s)
            return planar.PC(gr_t.reshape(f, nb, npol * npol),
                             gi_t.reshape(f, nb, npol * npol))
        a, b = hopper_kernels.xengine_gram_stacked(zr, zi)
        gr = a.float()
        gi = (b - b.transpose(-1, -2)).float()
    else:
        w = torch.cat([zr, zi], dim=-1)               # [F, T, 2·SP]
        if integer:
            w = w.to(torch.int64 if w.device.type == "cpu" else torch.float64)
        else:
            w = w.float()
        with hopper_kernels._full_f32():
            g2 = torch.einsum("ftk,ftl->fkl", w, w)
        if integer:
            g2 = g2.to(torch.int32)
        rr, ri = g2[:, :sp, :sp], g2[:, :sp, sp:]
        ir, ii = g2[:, sp:, :sp], g2[:, sp:, sp:]
        gr = (rr + ii).float()
        gi = (ir - ri).float()
    if scale != 1.0:
        gr = gr * np.float32(scale)
        gi = gi * np.float32(scale)
    g = planar.PC(gr, gi)
    if output_format == CLXCORR_FULL_MATRIX:
        return g
    return _triangular(g, s, npol)


# --------------------------------------------------------------------------
# Streaming engines with pipeline integration
# --------------------------------------------------------------------------

class XEngineState(NamedTuple):
    """Accumulation state for pipeline integration — the role of the
    reference's GPU-side '+=' kernels and enqueueFillBuffer zeroing
    (lib/clXEngine_impl.cc:289-292, :779-812)."""
    accum: object           # same structure as one correlate() output
    count: int              # integrations accumulated (host-side)


def _pipeline_emit(accum, corr, count: int, pipe: int):
    """Accumulate and emit every ``pipe`` calls, zeros in between.
    accum/corr are matching trees of tensors (a tensor or planar.PC).

    Returns (new_accum, new_count, out, ready): on the emitting call out is
    the sum and the accumulator and count restart at zero; otherwise out
    is zeros and ready is False."""
    accum = _tree.tree_map(torch.add, accum, corr)
    count = count + 1
    ready = count >= pipe
    zeros = _tree.tree_map(torch.zeros_like, accum)
    if ready:
        return zeros, 0, accum, True
    return accum, count, zeros, False


def _out_shape(num_inputs, num_channels, npol, output_format):
    if output_format == CLXCORR_TRIANGULAR_ORDER:
        return (num_channels, num_baselines(num_inputs), npol * npol)
    return (num_channels, num_inputs * npol, num_inputs * npol)


def make_xengine_channel_major(num_inputs: int, num_channels: int, npol: int,
                               integration_time: int,
                               output_format: int = CLXCORR_TRIANGULAR_ORDER,
                               pipeline_integration: int = 0,
                               compute_dtype=None, scale: float = 1.0,
                               device="cpu"):
    """Streaming channel-major X-Engine with pipeline integration:
    (init_state, apply).

    apply(state, (zr, zi)) with zr/zi [F, T, S·P] (float32/bf16/int8)
    returns (state', (out planar.PC, ready)): each call's correlation
    (``xengine_correlate_stacked``) is added to a float32 accumulator on
    ``device`` and emitted every ``pipeline_integration`` calls, zeros in
    between.  init_state() allocates the accumulator on ``device``."""
    if npol not in (1, 2):
        raise ValueError("npol must be 1 or 2")
    out_shape = _out_shape(num_inputs, num_channels, npol, output_format)
    pipe = max(1, pipeline_integration)
    expected = (num_channels, integration_time, num_inputs * npol)
    dev = torch.device(device)

    def init_state() -> XEngineState:
        z = torch.zeros(out_shape, dtype=torch.float32, device=dev)
        return XEngineState(accum=planar.PC(z, z.clone()), count=0)

    def apply(state: XEngineState, frames):
        zr, zi = frames
        if tuple(zr.shape) != expected:
            raise ValueError(f"frames shape {tuple(zr.shape)} != {expected}")
        corr = xengine_correlate_stacked(zr, zi, npol=npol,
                                         output_format=output_format,
                                         compute_dtype=compute_dtype,
                                         scale=scale)
        accum, count, out, ready = _pipeline_emit(
            state.accum, corr, state.count, pipe)
        return XEngineState(accum=accum, count=count), (out, ready)

    return init_state, apply


def make_xengine(num_inputs: int, num_channels: int, npol: int,
                 integration_time: int,
                 output_format: int = CLXCORR_TRIANGULAR_ORDER,
                 pipeline_integration: int = 0, planar: bool = False,
                 device="cpu"):
    """Streaming time-major X-Engine: (init_state, apply).

    apply(state, frames) with frames [integration_time, S, F, P] (complex64,
    or a planar.PC with ``planar``) returns (state', (out, ready)): the
    correlation each call when pipeline_integration ≤ 1, else the sum
    emitted every ``pipeline_integration`` calls (zeros and ready=False in
    between)."""
    from clenabled_tpu_torch.dsp import planar as pl_mod

    if npol not in (1, 2):
        raise ValueError("npol must be 1 or 2")
    out_shape = _out_shape(num_inputs, num_channels, npol, output_format)
    pipe = max(1, pipeline_integration)
    expected = (integration_time, num_inputs, num_channels, npol)
    dev = torch.device(device)

    def init_state() -> XEngineState:
        if planar:
            z = torch.zeros(out_shape, dtype=torch.float32, device=dev)
            return XEngineState(accum=pl_mod.PC(z, z.clone()), count=0)
        return XEngineState(
            accum=torch.zeros(out_shape, dtype=torch.complex64, device=dev),
            count=0)

    def apply(state: XEngineState, frames):
        shape = tuple((frames.re if planar else frames).shape)
        if shape != expected:
            raise ValueError(f"frames shape {shape} != {expected}")
        if planar:
            corr = xengine_correlate_planar(frames, npol=npol,
                                            output_format=output_format)
        else:
            corr = xengine_correlate(frames, npol=npol,
                                     output_format=output_format)
        accum, count, out, ready = _pipeline_emit(
            state.accum, corr, state.count, pipe)
        return XEngineState(accum=accum, count=count), (out, ready)

    return init_state, apply
