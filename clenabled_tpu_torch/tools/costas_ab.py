"""Variants of the Costas kernel's source, timed side by side on the card.

    python -m clenabled_tpu_torch.tools.costas_ab [--n 65536] [--rounds 7] \\
        [name=path/to/costas.cu ...]
    python -m clenabled_tpu_torch.tools.costas_ab --batched 8192 --n 4096 \\
        [name=path/to/costas.cu ...]

Each variant is a ``costas.cu`` (by default only the package's own, as
``tree``), compiled by its own ``nvcc``, all started together, with
``-Xptxas -v``, into a library of its own.  Times are CUDA events around
``--calls`` back-to-back calls, the calls taken in turn (forward, then
backward) for ``--rounds`` rounds (``tools/variant_ab.py``); the table
gives the least, the median and the largest per-call time.  Prints the
ptxas lines, the table, the card's name and power limit, and one JSON
line.  Without a card it exits non-zero.

The single chain (default): ``clen_costas`` as
``hopper_kernels.costas_scalar`` calls it on the same seeded frames: the carrier-recovery path's frame (BPSK with noise
at 0.005 rad/sample of carrier offset, order 2) and QPSK (order 4), at
``CostasLoop(0.00628)``'s gains, from a zero state.  Every variant's
outputs and state are held bit for bit to the first variant's, and each
variant to the plain form on ``clip_two_stream`` (every clipped error 2,
the largest the float32 clip gives).

``--batched B``: ``clen_costas_batched`` at [B, n], order 2, each variant
under both bodies (``block``, ``lane``), as ``hopper_kernels.
costas_batched`` calls it, on two inputs: ``distinct`` rows (each its own
seeded BPSK stream, carrier offset within ±0.005 rad/sample, from its own
phase and frequency: lanes of a warp at unrelated phases, so its wrap
vote seldom passes) and ``lockstep`` rows (one row and one state repeated,
read in place: every lane of a warp in the same state, so the vote passes
as often as the single chain's bound).  Every other call's outputs and
states are held bit for bit to the first variant's block body on the same
input.  Variants need the body argument of the batched entry.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from clenabled_tpu_torch import _build
from clenabled_tpu_torch.dsp import demod
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.runtime.device import card_info
from clenabled_tpu_torch.tools import variant_ab as ab

PATH_BW, OFFSET = 0.00628, 0.005


def clip_two_stream(order: int, n: int, phase: float, freq: float,
                    alpha: float, beta: float, f_min: float = -1.0,
                    f_max: float = 1.0,
                    device="cpu") -> tuple[np.ndarray, np.ndarray]:
    """n float32 samples (re, im) on which every step of the plain
    recurrence from (phase, freq) clips its error to 2.  Each sample is
    the one whose rotation by the carried phase lands near an angle where
    the raw error is about 1.5·2^24 (o_r·o_i for order 2, o_i − o_r for
    order 4); its amplitude is nudged until that error rounds to a value
    of 2 mod 4, which the clip 0.5·(|e+1| − |e−1|) takes to 2.  Built
    one plain step a sample on ``device``, whose cos/sin the stream is
    made for."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    step = demod._costas_step_planar(order, *map(f32, (alpha, beta, f_min,
                                                        f_max)))
    carry = (f32(phase), f32(freq), f32(0.0))
    if order == 2:
        theta, amp = math.pi / 4, math.sqrt(3.0 * 2 ** 24)
    else:
        theta = math.pi / 2 - 0.1
        amp = 1.5 * 2 ** 24 / (math.cos(0.1) - math.sin(0.1))
    xr, xi = np.empty(n, np.float32), np.empty(n, np.float32)
    for t in range(n):
        p = float(carry[0])
        for k in range(64):
            s = np.complex64(amp * (1 + k * 1e-6) * np.exp(1j * (theta + p)))
            nxt, _ = step(carry, (f32(s.real), f32(s.imag)))
            if float(nxt[2]) == 2.0:
                break
        else:
            raise RuntimeError(f"no sample with a clipped error of 2 at {t}")
        xr[t], xi[t] = s.real, s.imag
        carry = nxt
    return xr, xi


def frames(n: int, order: int, seed: int) -> np.ndarray:
    """Seeded BPSK (order 2) or QPSK (order 4) at OFFSET rad/sample of
    carrier offset with noise: float32 [2, n]."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, order, n)
    sym = np.exp(1j * (np.pi * k if order == 2 else np.pi / 4 * (2 * k + 1)))
    x = sym * np.exp(1j * (OFFSET * np.arange(n) + 0.7))
    x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return np.stack([x.real, x.imag]).astype(np.float32)


class Call:
    """One variant's clen_costas on fixed inputs, outputs allocated once."""

    def __init__(self, lib, x, st, order, gains, dev):
        self.lib, self.x, self.st, self.order, self.gains = (
            lib, x, st, order, gains)
        self.o = torch.empty_like(x)
        self.st_out = torch.empty_like(st)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __call__(self):
        err = self.lib.clen_costas(
            self.x[0].data_ptr(), self.x[1].data_ptr(), self.st.data_ptr(),
            self.st_out.data_ptr(), self.o[0].data_ptr(),
            self.o[1].data_ptr(), self.x.shape[1], self.order, *self.gains,
            self.stream)
        if err != 0:
            raise RuntimeError(f"costas launch failed: CUDA error {err}")
        return self.o[0], self.o[1], self.st_out

    def same(self, other) -> bool:
        return (torch.equal(self.o, other.o)
                and torch.equal(self.st_out, other.st_out))


def parse_args(argv=None) -> argparse.Namespace:
    ap = ab.arg_parser("Costas kernel variants A/B", "sources", "name=path")
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--batched", type=int, default=None, metavar="B",
                    help="time the batched entry's two bodies at [B, n]")
    return ap.parse_args(argv)


def build(variants: dict[str, str], entry: str) -> tuple[dict, dict]:
    """Each variant's source into a library of its own; the loaded
    libraries and their ptxas lines."""
    return ab.build(
        {name: ([Path(v).resolve()], []) for name, v in variants.items()},
        _build.BUILD_DIR / "costas_ab", entry, ("ptxas", "bytes stack"))


def single_chain(args, variants: dict[str, str]) -> int:
    dev = torch.device("cuda", 0)
    libs, ptxas = build(variants, "clen_costas")
    alpha, beta = demod.costas_gains(PATH_BW)
    zero = torch.zeros(3, device=dev)
    calls = {}
    for order, seed in ((2, 1), (4, 2)):
        x = torch.as_tensor(frames(args.n, order, seed), device=dev)
        calls[order] = {name: Call(lib, x, zero, order,
                                   (alpha, beta, -1.0, 1.0), dev)
                        for name, lib in libs.items()}

    names = list(libs)
    report = {name: {"ptxas": ptxas[name]} for name in names}
    for order, by_name in calls.items():
        for fn in by_name.values():
            fn()
        torch.cuda.synchronize()
        first = by_name[names[0]]
        for name in names:
            report[name][f"same_as_{names[0]}_order{order}"] = (
                by_name[name].same(first))
        for name, t in ab.time_in_turns(by_name, args.rounds,
                                        args.calls).items():
            report[name][f"order{order}_ms"] = t

    # the clipped-error stream against the plain form, from a phase the
    # bound of |e| <= 1 would clear although the group crosses 2π
    c_alpha, c_beta = demod.costas_gains(0.02)
    for order in (2, 4):
        xr, xi = clip_two_stream(order, 512, 4.8, 0.0, c_alpha, c_beta,
                                 -0.01, 0.01, device=dev)
        x = torch.as_tensor(np.stack([xr, xi]), device=dev)
        want = hk.costas_scalar_plain(x[0], x[1], 4.8, 0.0, 0.0, order,
                                      c_alpha, c_beta, -0.01, 0.01)
        st = torch.tensor([4.8, 0.0, 0.0], device=dev)
        for name, lib in libs.items():
            got = Call(lib, x, st, order, (c_alpha, c_beta, -0.01, 0.01),
                       dev)()
            report[name][f"clip_two_exact_order{order}"] = bool(
                torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(got[2], torch.stack(want[2:])))

    card = card_info()
    print(f"Costas kernel variants, {args.n} samples, {args.rounds} rounds "
          f"of {args.calls} calls (CUDA events), {card}:")
    print("variant | order 2 ms min / median / max | order 4 ms min / median"
          " / max | same outputs as first | exact on clip-2 stream (2, 4)")
    for name in names:
        r = report[name]
        print(f"{name} | {ab.ms_cell(r['order2_ms'])} | "
              f"{ab.ms_cell(r['order4_ms'])} | "
              f"{r[f'same_as_{names[0]}_order2']} "
              f"{r[f'same_as_{names[0]}_order4']} | "
              f"{r['clip_two_exact_order2']} {r['clip_two_exact_order4']}")
    print(json.dumps({"card": card, "n": args.n, "variants": report}))
    return 0


def batched_rows(b: int, n: int, seed: int, dev) -> dict:
    """``distinct`` and ``lockstep`` inputs of [b, n] BPSK rows with their
    [b, 3] states: (xr, xi, st) each, lockstep's rows one row read in
    place (row stride 0)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    t = torch.arange(n, device=dev, dtype=torch.float64)
    ang = ((2 * u(b, 1) - 1) * OFFSET * t + 2 * math.pi * u(b, 1)
           + math.pi * (u(b, n) < 0.5))
    x = [(torch.cos(ang) + 0.05 * torch.randn(b, n, generator=gen,
                                              device=dev)).float(),
         (torch.sin(ang) + 0.05 * torch.randn(b, n, generator=gen,
                                              device=dev)).float()]
    st = torch.stack([(2 * u(b) - 1) * math.pi, (2 * u(b) - 1) * 0.004,
                      torch.zeros(b, device=dev)], -1).float().contiguous()
    lock = [v[:1].expand(b, n) for v in x]
    return {"distinct": (*x, st),
            "lockstep": (*lock, st[:1].expand(b, 3).contiguous())}


class BatchedCall:
    """One variant's clen_costas_batched under one body on one input,
    writing the shared outputs ``out`` ([2, B, n] and [B, 3])."""

    def __init__(self, lib, xr, xi, st, body: int, gains, out, dev):
        self.lib, self.x, self.st, self.body, self.gains = (
            lib, (xr, xi), st, body, gains)
        self.out = out
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __call__(self):
        xr, xi = self.x
        b, n = xr.shape
        y, st_out = self.out
        err = self.lib.clen_costas_batched(
            xr.data_ptr(), xi.data_ptr(), b, b, 0, xr.stride(0),
            self.st.data_ptr(), st_out.data_ptr(), y[0].data_ptr(),
            y[1].data_ptr(), n, 2, *self.gains, self.body, self.stream)
        if err != 0:
            raise RuntimeError(f"costas_batched launch failed: CUDA error "
                               f"{err}")


def batched(args, variants: dict[str, str]) -> int:
    dev = torch.device("cuda", 0)
    b, n = args.batched, args.n
    for name, v in variants.items():
        if "int body, void* stream" not in Path(v).read_text():
            raise SystemExit(f"costas_ab: {name} ({v}) has no body argument "
                             f"in its batched entry")
    libs, ptxas = build(variants, "clen_costas_batched")
    gains = (*demod.costas_gains(PATH_BW), -1.0, 1.0)
    inputs = batched_rows(b, n, 3, dev)
    report = {name: {"ptxas": ptxas[name]} for name in libs}
    rows = []
    for kind, (xr, xi, st) in inputs.items():
        out = (torch.empty(2, b, n, device=dev), torch.empty(b, 3, device=dev))
        calls = {(name, body): BatchedCall(lib, xr, xi, st, k, gains, out,
                                           dev)
                 for name, lib in libs.items()
                 for k, body in enumerate(hk.COSTAS_BODIES)}
        want = None
        for key, fn in calls.items():
            fn()
            got = (out[0].clone(), out[1].clone())
            if want is None:
                want = got
            report[key[0]][f"{kind}_{key[1]}_same"] = all(
                torch.equal(g, w) for g, w in zip(got, want))
            del got
        for key, t in ab.time_in_turns(calls, args.rounds,
                                       args.calls).items():
            report[key[0]][f"{kind}_{key[1]}_ms"] = t
        rows.append(kind)
        del want, out, calls
    card = card_info()
    print(f"Costas batched entry variants, [{b}, {n}] order 2, "
          f"{args.rounds} rounds of {args.calls} calls (CUDA events), "
          f"{card}:")
    print("variant | body | " + " | ".join(
        f"{kind} ms min / median / max | same" for kind in rows))
    for name in libs:
        for body in hk.COSTAS_BODIES:
            r = report[name]
            print(f"{name} | {body} | " + " | ".join(
                f"{ab.ms_cell(r[f'{kind}_{body}_ms'])} | "
                f"{r[f'{kind}_{body}_same']}" for kind in rows))
    print(json.dumps({"card": card, "rows": b, "n": n, "variants": report}))
    same = all(v for r in report.values()
               for k, v in r.items() if k.endswith("_same"))
    return 0 if same else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if not ab.have_card("costas_ab"):
        return 1
    variants = dict(s.split("=", 1) for s in args.sources) or {
        "tree": str(_build.SRC_DIR / "costas.cu")}
    if args.batched is None:
        return single_chain(args, variants)
    return batched(args, variants)


if __name__ == "__main__":
    sys.exit(main())
