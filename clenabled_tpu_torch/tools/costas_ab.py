"""Variants of the Costas kernel's source, timed side by side on the card.

    python -m clenabled_tpu_torch.tools.costas_ab [--n 65536] [--rounds 7] \\
        [name=path/to/costas.cu ...]

Each source (a ``costas.cu`` with the ``clen_costas`` C entry; by default
only the package's own, as ``tree``) is compiled by its own ``nvcc``, all
started together, with ``-Xptxas -v``, into a library of its own, and
called as ``hopper_kernels.costas_scalar`` calls it on the same seeded
frames: the carrier-recovery path's frame (BPSK with noise at 0.005
rad/sample of carrier offset, order 2) and QPSK (order 4), at
``CostasLoop(0.00628)``'s gains, from a zero state.  Times are CUDA events
around ``--calls`` back-to-back calls, the variants taken in turn (forward,
then backward) for ``--rounds`` rounds (``tools/variant_ab.py``); the
table gives the least, the median and the largest per-call time.  Every variant's outputs and state
are held bit for bit to the first variant's, and each variant to the plain
form on ``clip_two_stream`` (every clipped error 2, the largest the float32
clip gives).  Prints the ptxas lines, the table, the card's name and power
limit, and one JSON line.  Without a card it exits non-zero.
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
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not ab.have_card("costas_ab"):
        return 1
    dev = torch.device("cuda", 0)
    sources = dict(s.split("=", 1) for s in args.sources) or {
        "tree": str(_build.SRC_DIR / "costas.cu")}
    libs, ptxas = ab.build(
        {k: ([Path(v).resolve()], []) for k, v in sources.items()},
        _build.BUILD_DIR / "costas_ab", "clen_costas",
        ("ptxas", "bytes stack"))

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


if __name__ == "__main__":
    sys.exit(main())
