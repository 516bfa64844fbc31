"""X-Engine: xGPU-style FX interferometry correlator (the clXEngine role).

The port of the Gram-matrix core of ``clenabled_tpu.dsp.xengine``.
Stacking station×pol spectra over time as Z[t, s·p, f], the correlation
matrix of one integration window is

    G[f, i, j] = Σ_t Z[t, i, f] · conj(Z[t, j, f])

and the triangular xGPU baseline order (lib/clXEngine_impl.cc:744-750)
is a static index into it.  The unpack family, the channel-major and
stacked engines and pipeline integration are not ported yet (ROADMAP.md
A.6).
"""

from __future__ import annotations

import numpy as np
import torch

from clenabled_tpu_torch.dsp import planar

# output_format codes (lib/clXEngine_impl.h:28-29)
CLXCORR_TRIANGULAR_ORDER = 1
CLXCORR_FULL_MATRIX = 2


def num_baselines(num_inputs: int) -> int:
    """N(N+1)/2 including autocorrelations (lib/clXEngine_impl.cc:183)."""
    return num_inputs * (num_inputs + 1) // 2


def baseline_stations(num_inputs: int) -> np.ndarray:
    """[nbaselines, 2] int32 (station1, station2) in xGPU triangular order."""
    k = np.arange(num_baselines(num_inputs))
    s1 = np.floor(-0.5 + np.sqrt(0.25 + 2.0 * k)).astype(np.int32)
    s2 = (k - (s1 + 1) * s1 // 2).astype(np.int32)
    return np.stack([s1, s2], axis=-1)


def _triangular_index(s: int, npol: int) -> tuple[np.ndarray, np.ndarray]:
    """[nb, npol²] (row, col) indices extracting the xGPU triangular order
    (pol products XX,XY,YX,YY) from a full [S·P, S·P] Gram matrix."""
    st = baseline_stations(s).astype(np.int64)
    p0 = np.repeat(np.arange(npol), npol)
    p1 = np.tile(np.arange(npol), npol)
    rows = st[:, 0:1] * npol + p0[None, :]
    cols = st[:, 1:2] * npol + p1[None, :]
    return rows, cols


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
    rows, cols = _triangular_index(s, p)
    return g[:, rows, cols]


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
    rows, cols = _triangular_index(s, p)
    return planar.PC(g.re[:, rows, cols], g.im[:, rows, cols])
