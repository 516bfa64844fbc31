"""The X-Engine's product, plainly (clXEngine, lib/clXEngine_impl.cc).

Each station's raw bytes hold one integration of T frames × F channels ×
P polarisations in [time][channel][pol] order: an IChar sample is two
signed bytes (re, im), a PackedXY sample one byte, re in the high nibble
and im in the low, decoded by CharToComplex's table (0b1000 reads 0).
For every channel the correlation matrix over inputs i = s·P + p is

    G[f, i, j] = Σ_t z[t, i, f] · conj(z[t, j, f])

and the product is G in xGPU's triangular order, baseline k = (s1, s2)
with s1 = floor(−1/2 + sqrt(1/4 + 2k)), s2 = k − s1(s1+1)/2 and the pol
products XX, XY, YX, YY: [F, nb, P²], each exact integer sum rounded to
float32 and multiplied by the float32 scale (1/127² or 1/7²).

The sums are formed in complex128, which holds them exactly.
"""

from __future__ import annotations

import numpy as np
import torch

# CharToComplex's PackedXY nibble table (two's complement, 8 → 0)
TWOS = (0, 1, 2, 3, 4, 5, 6, 7, 0, -7, -6, -5, -4, -3, -2, -1)
SCALE = {5: 1.0 / 127.0 ** 2, 6: 1.0 / 7.0 ** 2}


def baselines(stations: int) -> np.ndarray:
    k = np.arange(stations * (stations + 1) // 2)
    s1 = np.floor(-0.5 + np.sqrt(0.25 + 2.0 * k)).astype(np.int64)
    return np.stack([s1, k - s1 * (s1 + 1) // 2], -1)


def decode(raw: torch.Tensor, data_type: int, t: int, f: int, p: int,
           chans: slice = slice(None)):
    """Raw bytes [S, bytes] → (re, im) float64 [S, T, F', P] of the
    channels ``chans``."""
    s = raw.shape[0]
    if data_type == 5:
        b = raw.view(torch.int8).reshape(s, t, f, p, 2)[:, :, chans].double()
        return b[..., 0], b[..., 1]
    if data_type == 6:
        u = raw.view(torch.uint8).reshape(s, t, f, p)[:, :, chans].long()
        lut = torch.tensor(TWOS, dtype=torch.float64, device=raw.device)
        return lut[u >> 4], lut[u & 0xF]
    raise ValueError(f"no decode for data_type {data_type}")


def product(raw: torch.Tensor, data_type: int, t: int, f: int, p: int, *,
            quantize=None, out_dtype=torch.float32, block: int = 32):
    """(re, im) [F, nb, P²] float32 of one integration of ``raw`` [S,
    bytes].  ``quantize`` maps the decoded samples first, ``out_dtype``
    rounds the product (the controls)."""
    s = raw.shape[0]
    st = baselines(s)
    pp = np.arange(p * p)
    rows = torch.as_tensor(st[:, :1] * p + pp // p, device=raw.device)
    cols = torch.as_tensor(st[:, 1:] * p + pp % p, device=raw.device)
    scale = torch.tensor(SCALE[data_type], dtype=torch.float32)
    out_re, out_im = [], []
    for f0 in range(0, f, block):
        f1 = min(f, f0 + block)
        zr, zi = decode(raw, data_type, t, f, p, slice(f0, f1))
        if quantize is not None:
            zr, zi = quantize(zr), quantize(zi)
        # z[f, t, i] with i = s·P + p
        z = torch.complex(zr, zi).permute(2, 1, 0, 3).reshape(
            f1 - f0, t, s * p)
        g = z.transpose(1, 2) @ z.conj()          # [F, S·P, S·P]
        g = g[:, rows, cols]
        for part, out in ((g.real, out_re), (g.imag, out_im)):
            v = part.to(torch.float32) * scale.to(part.device)
            out.append(v.to(out_dtype).to(torch.float32))
    return torch.cat(out_re), torch.cat(out_im)


def int4(x: torch.Tensor) -> torch.Tensor:
    """int8 samples held at 4 bits: the nearest of 16·{−8, …, 7}."""
    return torch.clamp(torch.round(x / 16.0), -8, 7) * 16.0
