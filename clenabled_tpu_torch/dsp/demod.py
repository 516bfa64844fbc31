"""Demodulators: the quadrature (FM/FSK) demodulator and the Costas loop.

The port of ``clenabled_tpu.dsp.demod``:

- ``quadrature_demod`` replaces clQuadratureDemod
  (lib/clQuadratureDemod_impl.cc:108-181), out[i] =
  gain·arg(x[i]·conj(x[i-1])) with one sample of history carried between
  frames (set_history(2), :81).
- ``make_costas_loop{,_planar,_scalar}`` replace clCostasLoop
  (lib/clCostasLoop_impl.cc:151-312).  The loop is sequential by nature;
  all three forms run the same exact recurrence (``_costas_step_planar``)
  through one hand-written kernel (``hopper_kernels.costas_scalar``) on
  the card, and through its per-sample plain form on the CPU.  The
  carried state is a ``CostasState`` of three 0-d float32 tensors.
- ``make_costas_loop_chunked`` is the speculative chunk-parallel form with
  its seam certificate: the chunks' overlapping windows run as independent
  chains of the batched kernel (``hopper_kernels.costas_batched``, the
  port's counterpart of JAX's ``vmap`` of the scan), three launches a
  frame, and the certificate, branch correction and carried state are
  tensor code.  ``_make_costas_loop_streams`` runs N independent loops
  (``CostasLoop(num_streams=N)``) in one batched launch a frame.  The
  batched kernel runs a row a block up to two such blocks an SM and a
  row a lane, 32 loops a warp, past it (``costas_body``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.runtime.device import get_device

TWO_PI = 2.0 * math.pi


def quadrature_demod(x, gain: float, last_sample=None):
    """FM discriminator over a frame.

    Args:
      x: [n] complex64 frame.
      gain: demod gain (baked as #define GAIN in the reference kernel).
      last_sample: carried x[-1] of the previous frame (None → first frame
        behaves as if preceded by x[0], producing 0 for the first output).

    Returns: (y, new_last_sample) with y: [n] float32.
    """
    x = torch.as_tensor(x).to(torch.complex64)
    if last_sample is None:
        last_sample = x[..., :1]
    prev = torch.cat([last_sample, x[..., :-1]], dim=-1)
    prod = x * torch.conj(prev)
    y = torch.atan2(prod.imag, prod.real) * gain
    return y, x[..., -1:].clone()


def _qdemod_xla(xr, xi, lr, li, gain: float):
    """The JAX package's XLA form: gain·atan2 of x[i]·conj(x[i-1]) with the
    one-sample shift on sliced views and the carried sample (lr, li)
    [..., 1] at the front."""
    pr_b, pi_b = xr[..., :-1], xi[..., :-1]
    cr = xr[..., 1:] * pr_b + xi[..., 1:] * pi_b
    ci = xi[..., 1:] * pr_b - xr[..., 1:] * pi_b
    ybody = torch.atan2(ci, cr) * gain
    c0r = xr[..., :1] * lr + xi[..., :1] * li
    c0i = xi[..., :1] * lr - xr[..., :1] * li
    y0 = torch.atan2(c0i, c0r) * gain
    return torch.cat([y0, ybody], dim=-1)


def quadrature_demod_planar(x, gain: float, last_sample=None):
    """Planar quadrature demod: x is a planar.PC frame; identical math
    (gain·atan2 of x[i]·conj(x[i-1])), complex-free.  Runs the hand-written
    kernel (``hopper_kernels.qdemod_fused``, any frame length) on CUDA
    tensors and its plain form, the JAX package's XLA form, on the CPU; the
    JAX function's ``use_pallas`` engine selector has no counterpart."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    if last_sample is None:
        last_sample = planar.PC(x.re[..., :1], x.im[..., :1])
    y = hopper_kernels.qdemod_fused(x.re.contiguous(), x.im.contiguous(),
                                    last_sample.re.contiguous(),
                                    last_sample.im.contiguous(), gain)
    return y, planar.PC(x.re[..., -1:].clone(), x.im[..., -1:].clone())


class CostasState(NamedTuple):
    """phase/freq/error — the reference's persistent device buffers, as
    0-d float32 tensors."""
    phase: torch.Tensor
    freq: torch.Tensor
    error: torch.Tensor


def costas_init(device=None) -> CostasState:
    """A zero state on ``device`` (None: ``cuda:0``, raising when no card
    is visible)."""
    dev = get_device("cuda") if device is None else torch.device(device)
    z = torch.zeros(3, device=dev)
    return CostasState(phase=z[0], freq=z[1], error=z[2])


def costas_gains(loop_bw: float) -> tuple[float, float]:
    """alpha/beta from loop bandwidth, per GR blocks::control_loop
    (critically damped 2nd-order loop; the reference bakes these as
    #defines, lib/clCostasLoop_impl.cc:134-137)."""
    damping = math.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = (4.0 * damping * loop_bw) / denom
    beta = (4.0 * loop_bw * loop_bw) / denom
    return alpha, beta


def _costas_step_planar(order: int, alpha, beta, f_min, f_max):
    """The per-sample recurrence, as the JAX package writes it:
    (carry, (s_r, s_i)) → (carry', (o_r, o_i)) on 0-d float32 tensors.
    alpha, beta, f_min, f_max: 0-d float32 tensors on the samples' device.
    2π divides as a tensor, so every device divides (a scalar divisor may
    become a multiply by its reciprocal).  The kernel rounds each product
    and sum as these separate ops do."""
    two_pi = torch.full_like(alpha, TWO_PI)

    def step(carry, sample):
        phase, freq, _ = carry
        s_r, s_i = sample
        n_r = torch.cos(-phase)
        n_i = torch.sin(-phase)
        o_r = s_r * n_r - s_i * n_i
        o_i = s_r * n_i + s_i * n_r
        if order == 2:
            error = o_r * o_i
        else:
            error = (torch.where(o_r > 0, o_i, -o_i)
                     - torch.where(o_i > 0, o_r, -o_r))
        error = 0.5 * ((error + 1.0).abs() - (error - 1.0).abs())
        freq = freq + beta * error
        phase = phase + freq + alpha * error
        q = phase / two_pi
        phase = torch.where((phase > two_pi) | (phase < -two_pi),
                            (q - torch.trunc(q)) * two_pi, phase)
        freq = torch.minimum(torch.maximum(freq, f_min), f_max)
        return (phase, freq, error), (o_r, o_i)

    return step


def _costas_runner(loop_bw: float, order: int, max_freq: float,
                   min_freq: float):
    """run(state, xr, xi) → (state', o_r, o_i) on the kernel."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    if order not in (2, 4):
        raise ValueError("costas loop order must be 2 or 4")
    alpha, beta = costas_gains(loop_bw)

    def run(state: CostasState, xr, xi):
        o_r, o_i, ph, fr, er = hopper_kernels.costas_scalar(
            xr.contiguous(), xi.contiguous(), state.phase, state.freq,
            state.error, order, alpha, beta, min_freq, max_freq)
        return CostasState(phase=ph, freq=fr, error=er), o_r, o_i

    return run


def make_costas_loop_planar(loop_bw: float, order: int,
                            max_freq: float = 1.0, min_freq: float = -1.0):
    """Planar Costas loop: run(state, frame: planar.PC) → (state',
    planar.PC), the exact recurrence on the kernel (CUDA) or its plain
    form (CPU)."""
    run3 = _costas_runner(loop_bw, order, max_freq, min_freq)

    def run(state: CostasState, frame):
        state, o_r, o_i = run3(state, frame.re, frame.im)
        return state, planar.PC(o_r, o_i)

    return run


def make_costas_loop_scalar(loop_bw: float, order: int,
                            max_freq: float = 1.0, min_freq: float = -1.0):
    """The JAX package's scalar-core form: on the card the same kernel as
    ``make_costas_loop_planar`` (one thread runs the recurrence), so the
    two are one function here.  Its ``chunk`` and ``interpret`` have no
    counterpart."""
    return make_costas_loop_planar(loop_bw, order, max_freq, min_freq)


def make_costas_loop(loop_bw: float, order: int,
                     max_freq: float = 1.0, min_freq: float = -1.0):
    """Per-frame Costas loop over complex64 frames: run(state, frame) →
    (state', out complex64).  order must be 2 or 4 (validated like
    lib/clCostasLoop_impl.cc:67-82).  The frame is split into planar
    components for the kernel; the NCO products are rounded one by one,
    as the JAX package's complex form rounds them to float32."""
    run3 = _costas_runner(loop_bw, order, max_freq, min_freq)

    def run(state: CostasState, frame):
        frame = torch.as_tensor(frame).to(torch.complex64)
        state, o_r, o_i = run3(state, frame.real.float(), frame.imag.float())
        return state, torch.complex(o_r, o_i)

    return run


def _costas_runner_rows(loop_bw: float, order: int, max_freq: float,
                        min_freq: float):
    """run(state, xr, xi) → (state', o_r, o_i) on the batched kernel: xr/xi
    [..., L] rows (views whose last dimension is contiguous), the state's
    fields of their leading shape."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    if order not in (2, 4):
        raise ValueError("costas loop order must be 2 or 4")
    alpha, beta = costas_gains(loop_bw)

    def run(state: CostasState, xr, xi):
        o_r, o_i, ph, fr, er = hopper_kernels.costas_batched(
            xr, xi, state.phase, state.freq, state.error, order, alpha, beta,
            min_freq, max_freq)
        return CostasState(phase=ph, freq=fr, error=er), o_r, o_i

    return run


def _make_costas_loop_streams(loop_bw: float, order: int, planar_io: bool,
                              max_freq: float = 1.0, min_freq: float = -1.0):
    """N independent loops in one batched launch a frame: the counterpart
    of ``jax.vmap`` of ``make_costas_loop_planar`` (``planar_io``: frames
    planar.PC of [N, n]) or of ``make_costas_loop`` (complex64 [N, n]).
    run(state, frames) → (state', out) with a ``CostasState`` of [N]
    tensors; each stream is bit for bit the single loop on it."""
    run3 = _costas_runner_rows(loop_bw, order, max_freq, min_freq)

    def run(state: CostasState, frames):
        if planar_io:
            state, o_r, o_i = run3(state, frames.re.contiguous(),
                                   frames.im.contiguous())
            return state, planar.PC(o_r, o_i)
        z = torch.as_tensor(frames).to(torch.complex64)
        state, o_r, o_i = run3(state, z.real.contiguous(),
                               z.imag.contiguous())
        return state, torch.complex(o_r, o_i)

    return run


def _wrap_pm_pi(x, two_pi):
    return x - two_pi * torch.round(x / two_pi)


def _wrap_trunc(p, two_pi):
    """The recurrence's wrap: (p/2π − trunc(p/2π))·2π where |p| > 2π."""
    q = p / two_pi
    return torch.where((p > two_pi) | (p < -two_pi),
                       (q - torch.trunc(q)) * two_pi, p)


def make_costas_loop_chunked(loop_bw: float, order: int,
                             max_freq: float = 1.0, min_freq: float = -1.0,
                             chunk: int = 8192, warmup: int = 1024,
                             unroll: int = 16,
                             exact_fallback_residual: float | None = None):
    """Speculative chunk-parallel Costas loop with an exactness certificate
    (the JAX package's ``make_costas_loop_chunked``).

    A locked loop is contracting, so a frame splits into ``chunk``-sample
    chunks run in parallel, each warm-started ``warmup`` samples early from
    a guess (the carried frequency, the phase predicted from it; chunk 0
    from the exactly carried state, so it is exact).  The seam deltas
    (chunk k's warm-up-end state against chunk k−1's final state) give the
    certificate: ``exact`` when every seam agrees bit for bit (then the
    outputs are bit for bit the sequential loop's), ``residual`` the
    largest deviation after the loop's discrete branch (π for order 2,
    π/2 for order 4) is taken out; outputs are corrected by the
    cumulative branch exactly (sign flips, quadrant swaps).

    The chunks' windows (w + c samples at a stride of c over the carried
    tail ++ frame) go to the batched kernel (``hopper_kernels.
    costas_batched``, one chain a window) as strided views, with no copy
    of the windows, in JAX's three segments (w, c − w, w samples): three
    launches a frame.  ``unroll`` has no counterpart.

    ``exact_fallback_residual=r``: a frame whose residual exceeds ``r``
    reruns through the exact sequential recurrence (``costas_scalar``, two
    launches split where the carried state is taken) and reports
    ``exact`` and ``fell_back``.  JAX decides that on the device
    (``lax.cond``); the port reads the residual to the host once a frame,
    only when ``r`` is set: without it ``run`` never waits on the card.

    Returns run(state, frame: planar.PC) → (state', planar.PC, diag) with
    diag ``exact``, ``residual``, ``branch_hops``, ``fell_back`` (0-d
    tensors); state = (CostasState at frame_start − warmup, tail planar.PC
    of the last ``warmup`` samples), ``run.init_state(device=None)`` zeros
    on ``device`` (None: ``cuda:0``).  Frames are a positive multiple of
    ``chunk``; warmup ≤ chunk.  The certificate is the port's own: its
    sin/cos may differ from JAX's in the last ulp, so ``exact`` holds the
    outputs to the port's sequential form."""
    del unroll
    run_rows = _make_costas_chunked_rows(loop_bw, order, max_freq, min_freq,
                                         chunk, warmup,
                                         exact_fallback_residual)

    def run(state, frame):
        (lag, tail), out, diag = run_rows(
            (CostasState(*(v[None] for v in state[0])),
             planar.PC(state[1].re[None], state[1].im[None])),
            planar.PC(frame.re[None], frame.im[None]))
        return ((CostasState(*(v[0] for v in lag)),
                 planar.PC(tail.re[0], tail.im[0])),
                planar.PC(out.re[0], out.im[0]),
                {k: v[0] for k, v in diag.items()})

    def init_state(device=None):
        dev = get_device("cuda") if device is None else torch.device(device)
        z = torch.zeros(warmup, device=dev)
        return (costas_init(dev), planar.PC(z, z.clone()))

    run.init_state = init_state
    return run


def _make_costas_chunked_rows(loop_bw: float, order: int, max_freq: float,
                              min_freq: float, chunk: int, warmup: int,
                              exact_fallback_residual: float | None):
    """The chunked loop over S streams at once: run((lag, tail), frames)
    with lag a CostasState of [S], tail planar.PC [S, warmup] and frames
    planar.PC [S, n] → ((lag', tail'), planar.PC [S, n], diag of [S]).
    Every stream's chunks are rows of the same three batched launches."""
    from clenabled_tpu_torch.dsp import hopper_kernels

    if order not in (2, 4):
        raise ValueError("costas loop order must be 2 or 4")
    if warmup > chunk:
        raise ValueError("warmup must be <= chunk")
    alpha, beta = costas_gains(loop_bw)
    rows = _costas_runner_rows(loop_bw, order, max_freq, min_freq)
    w, c = warmup, chunk
    # the loop's exact discrete symmetry: phase → phase + κ leaves the
    # error signal invariant, so a chunk may lock κ·k away from the
    # sequential trajectory — detected at the seam and corrected exactly
    kappa = math.pi if order == 2 else math.pi / 2
    nbranch = 2 if order == 2 else 4

    def sequential(lag, ext_r, ext_i, n):
        """The exact recurrence over one stream's tail ++ frame from its
        lag state, split where the carried state is taken."""
        args = (order, alpha, beta, min_freq, max_freq)
        r1, i1, *mid = hopper_kernels.costas_scalar(
            ext_r[:n], ext_i[:n], *lag, *args)
        r2, i2, *_ = hopper_kernels.costas_scalar(ext_r[n:], ext_i[n:], *mid,
                                                  *args)
        return torch.cat([r1[w:], r2]), torch.cat([i1[w:], i2]), mid

    def run(state, frames):
        lag, tail = state
        s, n = frames.re.shape
        if n % c or n < c:
            raise ValueError(f"frame length {n} must be a multiple of {c}")
        nch = n // c
        dev = frames.re.device
        # filled on the device: a host tensor copied to the card would
        # wait for the card's queue
        two_pi = torch.full((), TWO_PI, device=dev)
        kap = torch.full((), kappa, device=dev)
        ext_r = torch.cat([tail.re, frames.re], -1)
        ext_i = torch.cat([tail.im, frames.im], -1)

        def windows(offset: int, length: int):
            # chunk k of stream j: ext[j, k·c + offset : ... + length]
            return tuple(e.as_strided((s, nch, length), (w + n, c, 1),
                                      e.storage_offset() + offset)
                         for e in (ext_r, ext_i))

        first = torch.arange(nch, device=dev) == 0
        offs = (torch.arange(nch, device=dev) * c).to(torch.float32)
        # phase prediction keeps the guess in the carried branch's basin
        pred = _wrap_pm_pi(lag.phase[:, None] + lag.freq[:, None] * offs,
                           two_pi)
        zero = torch.zeros((), device=dev)
        starts = CostasState(
            phase=torch.where(first, lag.phase[:, None], pred),
            freq=lag.freq[:, None].expand(s, nch),
            error=torch.where(first, lag.error[:, None], zero))
        s_w, _, _ = rows(starts, *windows(0, w))
        s_c, a_r, a_i = rows(s_w, *windows(w, c - w))
        s_f, b_r, b_i = rows(s_c, *windows(c, w))
        o_r = torch.cat([a_r, b_r], -1)
        o_i = torch.cat([a_i, b_i], -1)

        # seam deltas: chunk k's warm-up-end state vs chunk k−1's final
        dphi = _wrap_pm_pi(s_w.phase[:, 1:] - s_f.phase[:, :-1], two_pi)
        dfreq = s_w.freq[:, 1:] - s_f.freq[:, :-1]
        k = torch.round(dphi / kap).to(torch.int32)          # branch hops
        z1 = torch.zeros((s, 1), device=dev)
        resid = torch.maximum(
            torch.cat([z1, (dphi - k.to(torch.float32) * kap).abs()],
                      -1).amax(-1),
            torch.cat([z1, dfreq.abs()], -1).amax(-1))
        bits = torch.cat([torch.zeros((s, 1), dtype=torch.int32,
                                      device=dev), k], -1)
        b = torch.remainder(torch.cumsum(bits, -1), nbranch)  # chunk branch
        # exact branch correction: out · e^{+i·b·κ}
        if order == 2:
            sgn = torch.where(b % 2 == 0, 1.0, -1.0).to(torch.float32)
            o_r = o_r * sgn[..., None]
            o_i = o_i * sgn[..., None]
        else:
            b1, b2, b3 = ((b == v)[..., None] for v in (1, 2, 3))
            nr = torch.where(b1, -o_i, torch.where(
                b2, -o_r, torch.where(b3, o_i, o_r)))
            ni = torch.where(b1, o_r, torch.where(
                b2, -o_i, torch.where(b3, -o_r, o_i)))
            o_r, o_i = nr, ni
        # certificate: bitwise seam equality (⇒ output == the sequential
        # loop's bit for bit, by induction from the exactly carried chunk 0)
        exact = ((s_w.phase[:, 1:] == s_f.phase[:, :-1])
                 & (s_w.freq[:, 1:] == s_f.freq[:, :-1])).all(-1)
        # carried state, mapped back to chunk 0's branch
        lag_phase = _wrap_trunc(
            s_c.phase[:, -1] - b[:, -1].to(torch.float32) * kap, two_pi)
        o_r = o_r.reshape(s, n)
        o_i = o_i.reshape(s, n)
        new_lag = CostasState(phase=lag_phase, freq=s_c.freq[:, -1],
                              error=s_c.error[:, -1])
        fell_back = torch.zeros(s, dtype=torch.bool, device=dev)
        if exact_fallback_residual is not None:
            # bit-exactness on demand: a stream whose certificate is
            # suspect reruns the exact sequential recurrence (the host
            # reads the residuals once a frame)
            trip = resid > exact_fallback_residual
            new_lag = CostasState(*(v.clone() for v in new_lag))
            for j in torch.nonzero(trip).flatten().tolist():
                r, i, mid = sequential([v[j] for v in lag], ext_r[j],
                                       ext_i[j], n)
                o_r[j], o_i[j] = r, i
                for field, v in zip(new_lag, mid):
                    field[j] = v
            exact = exact | trip
            fell_back = trip
        new_tail = planar.PC(frames.re[:, n - w:].clone(),
                             frames.im[:, n - w:].clone())
        diag = {"exact": exact, "residual": resid,
                "branch_hops": k.abs().sum(-1, dtype=torch.int32),
                "fell_back": fell_back}
        return (new_lag, new_tail), planar.PC(o_r, o_i), diag

    return run
