"""Polyphase filterbank channelizer.

The port of ``clenabled_tpu.dsp.channelizer`` (reference
clPolyphaseChannelizer, lib/clPolyphaseChannelizer_impl.cc:84-109): per
output group i and subfilter j (kernel ``filterpfb2`` :156-167)

    acc[i, j] = Σ_{k ≡ j mod M} taps[k] · in[i·R + T−1 − k]

written with the oversampling output rotation
out[i, (j + i·(M−R)) mod M] = acc[i, j] (M = num_channels, R =
ninputs_per_iter ≤ M, T = ntaps), followed by the batched M-point reverse
FFT with scale 1.0 and the output channel selection ``ch_map``.

R == M (critically sampled): padding the taps to W·M and shifting the
stream by δ = W·M − T zeros turns the commutator into a reshape with
reversed lanes and the branch filter into W shifted multiply-adds over the
block axis.  R < M: the output groups split into L = M/gcd(M, R) phases,
each a critically sampled shifted multiply-add with its own lead shift and
a static lane roll (``_pfb_oversampled``, JAX's gather-free phase split).

The fused oversampled step (``make_channelizer_fused_oversampled``) runs
``hopper_kernels.pfb_oversampled_fused`` (``csrc/pfb_oversampled.cu``) on
CUDA tensors, with the JAX package's tail length, output latency and frame
rules.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.runtime.device import get_device, per_device

LANES = 128


def _pfb_constants(taps, num_channels: int, ninputs_per_iter: int):
    """(taps_rm [W, M] float32 with taps_rm[w, j] = taps[j + w·M], ntaps)."""
    taps = np.asarray(taps, np.float32)
    ntaps = len(taps)
    m, r = num_channels, ninputs_per_iter
    if r > m:
        raise ValueError("ninputs_per_iter must be <= num_channels")
    nbranch_taps = -(-ntaps // m)  # taps per branch, ceil
    padded = np.zeros(nbranch_taps * m, np.float32)
    padded[:ntaps] = taps
    return padded.reshape(nbranch_taps, m), ntaps


def _as_taps(taps_rm, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(taps_rm, dtype=torch.float32, device=like.device)


def _packed_branch_sums(y: torch.Tensor, hr: torch.Tensor,
                        nout: int) -> torch.Tensor:
    """acc[..., i, ℓ] = Σ_wp hr[wp, ℓ] · y[..., i + wp, ℓ]."""
    acc = hr[0] * y[..., 0:nout, :]
    for wp in range(1, hr.shape[0]):
        acc = acc + hr[wp] * y[..., wp:wp + nout, :]
    return acc


def _branch_sums_critical(comp, taps_rm, m: int, t: int, nout: int):
    """Gather-free branch sums for R == M.

    comp: [..., T-1 + nout·M] float32 → [..., nout, M] float32."""
    taps = _as_taps(taps_rm, comp)
    w = taps.shape[0]
    delta = w * m - t
    xp = F.pad(comp, (delta, 0))[..., : (nout + w - 1) * m]
    y = xp.reshape(comp.shape[:-1] + (nout + w - 1, m)).flip(-1)
    return _packed_branch_sums(y, taps.flip(0), nout)


def _pack_streams(comps, taps_rm, m: int, t: int, nout: int):
    """Lane-pack G parallel streams for the critically sampled PFB.

    comps [G, T-1+nout·M] → (y [nout+W-1, G·M], hr [W, G·M]) such that
    acc[i, g·M+j] = Σ_wp hr[wp, g·M+j] · y[i+wp, g·M+j] equals the branch
    sums of stream g, subfilter j."""
    taps = _as_taps(taps_rm, comps)
    g = comps.shape[0]
    w = taps.shape[0]
    delta = w * m - t
    nblk = nout + w - 1
    xp = F.pad(comps, (delta, 0))[:, : nblk * m]
    y = xp.reshape(g, nblk, m).flip(-1).transpose(0, 1).reshape(nblk, g * m)
    hr = taps.flip(0).repeat(1, g)                     # [W, G*M]
    return y, hr


def _branch_sums_critical_batched(comps, taps_rm, m: int, t: int, nout: int):
    """Lane-packed branch sums for G parallel streams (antennas × re/im):
    comps [G, T-1+nout·M] → [G, nout, M]."""
    g = comps.shape[0]
    y, hr = _pack_streams(comps, taps_rm, m, t, nout)
    acc = _packed_branch_sums(y, hr, nout)
    return acc.reshape(nout, g, m).transpose(0, 1)


def _phases(m: int, r: int, nout: int) -> tuple[int, int, int]:
    """(L phases, rows per within-phase step, outputs per phase)."""
    ell = m // math.gcd(m, r)
    if nout % ell:
        raise ValueError(
            f"output count {nout} must be a multiple of M/gcd(M,R) = {ell}")
    return ell, (ell * r) // m, nout // ell


def _phase_rows(y, start: int, count: int, step: int):
    """Rows start, start+step, … (count of them) of y [..., rows, lanes]."""
    return y[..., start:start + (count - 1) * step + 1:step, :]


def _pfb_oversampled(comp, taps_rm, m: int, r: int, t: int, nout: int,
                     i_offset: int = 0):
    """Gather-free oversampled (R < M) PFB for one float32 component,
    rotation included: comp [..., T-1 + nout·R] → [..., nout, M].

    Output group i's commutator window starts at i·R; the phase
    p = i mod L has within-phase stride L·R = lcm(M, R), a whole number of
    M-sample blocks, so each phase is the critical shifted multiply-add
    with a phase-specific lead shift, and the rotation (j + i·(M−R)) mod M
    is a static lane roll per phase.  ``i_offset`` is the global
    output-group index of the first local group."""
    taps = _as_taps(taps_rm, comp)
    w = taps.shape[0]
    ell, lp, nph = _phases(m, r, nout)
    hr = taps.flip(0)                    # hr[w', j] = taps[(W−1−w')·M + j]
    lead = comp.shape[:-1]
    outs = []
    for p in range(ell):
        a_p = p * r + t - 1              # window start of phase p, u = 0
        delta = (m - 1 - a_p % m) + (w - 1) * m
        b0 = a_p // m                    # base row after the lead shift
        rows_total = (nph - 1) * lp + b0 + w
        need = rows_total * m
        pad_end = max(0, need - delta - comp.shape[-1])
        zp = F.pad(comp, (delta, pad_end))[..., :need]
        y = zp.reshape(lead + (rows_total, m)).flip(-1)
        acc = hr[0] * _phase_rows(y, b0, nph, lp)
        for wp in range(1, w):
            acc = acc + hr[wp] * _phase_rows(y, b0 + wp, nph, lp)
        outs.append(torch.roll(acc, ((p + i_offset) * (m - r)) % m, dims=-1))
    # output i = p + L·u: interleave the phases along a new axis
    return torch.stack(outs, dim=-2).reshape(lead + (nout, m))


def _pfb_oversampled_planar(xre, xim, taps_rm, m: int, r: int, t: int,
                            nout: int, i_offset: int = 0):
    """Lane-packed planar form of ``_pfb_oversampled``: the 2·L
    (component × phase) groups side by side, so one shifted multiply-add
    per tap row covers all of them.  xre/xim: [T-1 + nout·R] → (acc_re,
    acc_im) each [nout, M], rotation included."""
    taps = _as_taps(taps_rm, xre)
    w = taps.shape[0]
    ell, lp, nph = _phases(m, r, nout)
    b0 = [(p * r + t - 1) // m for p in range(ell)]
    b0max = max(b0)
    rows_total = (nph - 1) * lp + b0max + w
    need = rows_total * m
    groups = []
    for comp in (xre, xim):
        for p in range(ell):
            a_p = p * r + t - 1
            # extra lead rows align every phase's base row to b0max, so the
            # packed multiply-add shares one row offset per tap row
            delta = (m - 1 - a_p % m) + (w - 1) * m + (b0max - b0[p]) * m
            pad_end = max(0, need - delta - comp.shape[-1])
            groups.append(F.pad(comp, (delta, pad_end))[:need])
    g = 2 * ell
    y = torch.stack(groups).reshape(g, rows_total, m).flip(-1)
    y = y.transpose(0, 1).reshape(rows_total, g * m)
    hr = taps.flip(0).repeat(1, g)
    acc = hr[0] * _phase_rows(y, b0max, nph, lp)
    for wp in range(1, w):
        acc = acc + hr[wp] * _phase_rows(y, b0max + wp, nph, lp)
    acc = acc.reshape(nph, g, m).transpose(0, 1)          # [G, nph, M]
    outs = []
    for ci in range(2):
        phases = [torch.roll(acc[ci * ell + p], ((p + i_offset) * (m - r)) % m,
                             dims=-1) for p in range(ell)]
        outs.append(torch.stack(phases, dim=1).reshape(nout, m))
    return outs[0], outs[1]


def _pfb_filter(x, taps_rm, i_offset: int = 0, *, num_channels,
                ninputs_per_iter, ntaps):
    """x: [..., T-1 + buf_items] complex64 (history at the front) → the
    rotated subfilter outputs [..., buf_items/R, M] complex64."""
    m, r, t = num_channels, ninputs_per_iter, ntaps
    nout = (x.shape[-1] - (t - 1)) // r
    re, im = x.real.float(), x.imag.float()
    if r == m:
        return torch.complex(_branch_sums_critical(re, taps_rm, m, t, nout),
                             _branch_sums_critical(im, taps_rm, m, t, nout))
    return torch.complex(
        _pfb_oversampled(re, taps_rm, m, r, t, nout, i_offset),
        _pfb_oversampled(im, taps_rm, m, r, t, nout, i_offset))


def _channelize(x, taps_rm, ch_map, i_offset: int = 0, *, num_channels,
                ninputs_per_iter, ntaps):
    """x: [..., T-1 + buf_items] complex64 (history at the front) →
    [..., buf_items/R, len(ch_map)] complex64."""
    rotated = _pfb_filter(x, taps_rm, i_offset, num_channels=num_channels,
                          ninputs_per_iter=ninputs_per_iter, ntaps=ntaps)
    # batched reverse FFT, scale forced 1.0 (clFFT BACKWARD with scale=1)
    z = torch.fft.ifft(rotated, dim=-1) * num_channels
    return z[..., ch_map].to(torch.complex64)


def _channelize_planar(x: planar.PC, taps_rm, ch_map, i_offset: int = 0, *,
                       num_channels, ninputs_per_iter, ntaps) -> planar.PC:
    """Planar-complex channelize: x is a planar.PC of [..., T-1+buf]
    streams ([T-1+buf] for R < M); the reverse FFT is the unscaled inverse
    DFT matmul."""
    m, r, t = num_channels, ninputs_per_iter, ntaps
    nout = (x.re.shape[-1] - (t - 1)) // r
    if r == m:
        acc = planar.PC(_branch_sums_critical(x.re, taps_rm, m, t, nout),
                        _branch_sums_critical(x.im, taps_rm, m, t, nout))
    else:
        acc = planar.PC(*_pfb_oversampled_planar(x.re, x.im, taps_rm, m, r, t,
                                                 nout, i_offset))
    z = planar.ifft_unscaled(acc)
    return planar.PC(z.re[..., ch_map], z.im[..., ch_map])


def polyphase_channelize(x, taps, num_channels: int, ninputs_per_iter: int,
                         ch_map, device=None):
    """One-shot: x [T-1 + buf_items] with history → [buf_items/R,
    len(ch_map)] complex64.

    buf_items must be a multiple of both num_channels (reference ctor
    check) and ninputs_per_iter.  A tensor ``x`` is channelized where it
    lies; other input goes to ``device`` (None: ``cuda:0``, raising when
    no card is visible)."""
    taps_rm, ntaps = _pfb_constants(taps, num_channels, ninputs_per_iter)
    if not torch.is_tensor(x):
        dev = get_device("cuda") if device is None else torch.device(device)
        x = torch.as_tensor(np.asarray(x), device=dev)
    x = x.to(torch.complex64)
    buf_items = x.shape[-1] - (ntaps - 1)
    if buf_items % num_channels:
        raise ValueError("buf_items must be a multiple of num_channels")
    if buf_items % ninputs_per_iter:
        raise ValueError("buf_items must be a multiple of ninputs_per_iter")
    ch = torch.as_tensor(np.asarray(ch_map, np.int64), device=x.device)
    return _channelize(x, taps_rm, ch, num_channels=num_channels,
                       ninputs_per_iter=ninputs_per_iter, ntaps=ntaps)


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _os_reach(m: int, r: int, ntaps: int) -> int:
    w = -(-ntaps // m)
    return (w - 1) * m + (m // r - 1) * r


def fused_oversampled_supported(num_channels: int, ninputs_per_iter: int,
                                ntaps: int, device=None) -> bool:
    """Whether the fused oversampled kernel covers this configuration on
    ``device`` (None: ``cuda:0`` when a card is visible, else the CPU).

    The JAX package's semantic conditions: R | M, R < M, M | 128, and the
    tap reach within the largest tile's halo (reach//128 + 2 ≤ min(512,
    2048/L)).  Its TPU VMEM budget for the banded matrices is replaced by
    the card's: on a CUDA device, one output group's window, W·M samples
    of both components, must fit a block's shared memory (the CPU's plain
    form has no such limit).  The two packages therefore differ where the
    banded matrices outgrow the TPU budget but the window fits (e.g. M=64,
    R=8 with 1600 taps: JAX refuses, the port accepts)."""
    m, r = num_channels, ninputs_per_iter
    if r >= m or m % r or LANES % m:
        return False
    ell = m // r
    if _os_reach(m, r, ntaps) // LANES + 2 > min(512, 2048 // ell):
        return False
    from clenabled_tpu_torch.dsp import hopper_kernels

    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    return hopper_kernels.os_window_fits(m, r, -(-ntaps // m), device)


def _check_fused_frame(n: int, m: int, r: int, tail_len: int) -> None:
    """The JAX package's frame tiling rule for the fused step (its TPU tile
    rows): the port keeps it so that both packages accept and refuse the
    same frames, though the CUDA kernel picks its own tiles."""
    ell = m // r
    tile = min(512, 2048 // ell)
    halo_rows = tail_len // LANES
    while (n // LANES) % tile:
        if tile // 2 < halo_rows:
            raise ValueError(
                f"frame length {n} cannot be tiled for M={m}, R={r}: "
                f"the {halo_rows}-row halo needs n/128 divisible by a "
                f"tile >= {halo_rows} (use a frame length that is a "
                f"multiple of {LANES * _next_pow2(halo_rows)})")
        tile //= 2
    if n % (LANES * tile):
        raise ValueError(
            f"frame length {n} must be a multiple of {LANES * tile}")


def make_channelizer_fused_oversampled(taps, num_channels: int,
                                       ninputs_per_iter: int, ch_map,
                                       device=None):
    """Streaming oversampled channelizer on the fused kernel
    (``hopper_kernels.pfb_oversampled_fused``): (init_state, apply) over
    planar.PC frames, state = (tail_re, tail_im) of os_tail_len(M, R,
    ntaps) samples, allocated on ``device`` (None: ``cuda:0``, raising when
    no card is visible; ``"cpu"`` runs the kernel's plain form).

    Output timing: the stream equals ``make_channelizer``'s for the input
    delayed by os_tail_len(M, R, ntaps) − ntaps + 1 samples (a fixed
    pipeline latency, as in the JAX package).  Frame lengths follow the
    JAX rule (``_check_fused_frame``) and must give a whole number of L-group
    phases.  apply returns (state', planar.PC of [n/R, len(ch_map)])."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    m, r = num_channels, ninputs_per_iter
    taps_rm, ntaps = _pfb_constants(taps, m, r)
    dev = get_device("cuda") if device is None else torch.device(device)
    if not fused_oversampled_supported(m, r, ntaps, dev):
        raise ValueError(
            f"fused oversampled kernel does not support M={m}, R={r}, "
            f"ntaps={ntaps} (requires R | M, M | 128, the tap reach to fit "
            f"the largest tile: reach//128 + 2 <= min(512, 2048//(M/R)), and "
            f"a W·M-sample window to fit the card's shared memory)")
    h = hopper_kernels.os_tail_len(m, r, ntaps)
    ch_list = [int(c) for c in ch_map]
    identity_map = ch_list == list(range(m))
    taps_on = per_device(taps_rm)

    def init_state(frame_size: int | None = None):
        del frame_size
        z = torch.zeros(h, device=dev)
        return (z, z.clone())

    def apply(state, frame):
        n = frame.re.shape[-1]
        _check_fused_frame(n, m, r, h)
        zr, zi = hopper_kernels.pfb_oversampled_fused(
            frame.re.contiguous(), frame.im.contiguous(), state[0].contiguous(),
            state[1].contiguous(), taps_on(frame.re.device), m, r)
        if not identity_map:
            zr, zi = zr[:, ch_list], zi[:, ch_list]
        new = (frame.re[n - h:].clone(), frame.im[n - h:].clone())
        return new, planar.PC(zr, zi)

    return init_state, apply


def make_channelizer(taps, num_channels: int, ninputs_per_iter: int, ch_map,
                     planar: bool = False, device=None):
    """Streaming form: (init_state, apply); state = T-1 history samples,
    allocated on ``device`` (None: ``cuda:0``, raising when no card is
    visible).

    apply(history, frame[buf_items]) -> (history', out[buf_items/R, C]).
    With ``planar=True`` frames/outputs are planar.PC and the state is an
    (re, im) pair.  Frames are channelized where they lie."""
    from clenabled_tpu_torch.dsp import planar as pl_mod

    taps_rm, ntaps = _pfb_constants(taps, num_channels, ninputs_per_iter)
    dev = get_device("cuda") if device is None else torch.device(device)
    ch_np = np.asarray(ch_map, np.int64)
    kw = dict(num_channels=num_channels, ninputs_per_iter=ninputs_per_iter,
              ntaps=ntaps)

    if planar:
        def init_state(frame_size: int | None = None):
            del frame_size
            z = torch.zeros(ntaps - 1, device=dev)
            return (z, z.clone())

        def apply(history, frame):
            fr = torch.cat([history[0], frame.re], dim=-1)
            fi = torch.cat([history[1], frame.im], dim=-1)
            ch = torch.as_tensor(ch_np, device=fr.device)
            out = _channelize_planar(pl_mod.PC(fr, fi), taps_rm, ch, **kw)
            k = fr.shape[-1] - (ntaps - 1)
            return (fr[k:].clone(), fi[k:].clone()), out

        return init_state, apply

    def init_state(frame_size: int | None = None):
        del frame_size
        return torch.zeros(ntaps - 1, dtype=torch.complex64, device=dev)

    def apply(history, frame):
        frame = torch.as_tensor(frame).to(torch.complex64)
        full = torch.cat([history, frame], dim=-1)
        ch = torch.as_tensor(ch_np, device=full.device)
        out = _channelize(full, taps_rm, ch, **kw)
        return full[full.shape[-1] - (ntaps - 1):].clone(), out

    return init_state, apply
