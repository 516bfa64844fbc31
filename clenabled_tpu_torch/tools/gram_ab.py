"""Variants of the X-Engine Gram's int8 path, timed side by side on the card.

    python -m clenabled_tpu_torch.tools.gram_ab [--f 256] [--t 8192] \\
        [--sp 128] [--rounds 7] [--calls 10] \\
        [name=path/to/xengine_gram.cu ...] [name=-DGRAM_I8_MMA_ONLY ...]

Each variant is a source that defines the C entry ``clen_xengine_gram``
(a path, such as an earlier commit's ``xengine_gram.cu``, optionally
followed by ``-D`` flags), the package's own Gram sources (``tree``) or
those with extra ``nvcc`` flags (a value starting with ``-D``).  By
default: ``tree`` and three probes that split its time, whose
outputs are wrong by design: ``stage_only`` (``-DGRAM_I8_STAGE_ONLY``:
the ``cp.async`` ring alone), ``compute_only`` (``-DGRAM_I8_COMPUTE_ONLY``:
no copies) and ``mma_only`` (also ``-DGRAM_I8_MMA_ONLY``: no
``ldmatrix`` or ``prmt``, the mma and the barriers alone).  A path variant
is built together with those of the package's ``xengine_gram_int8.cu``
and ``xengine_gram_bf16.cu`` whose launch function it calls but does not
define.  Each variant is compiled by its own ``nvcc`` (all started
together, ``-Xptxas -v``) into a library of its own and called as
``hopper_kernels.xengine_gram_stacked_tri`` calls it, on the same seeded
int8 operands [F, T, S·P] (default the X-Engine's reference width, [256,
8192, 128]).  Times are CUDA events around ``--calls`` back-to-back calls,
the variants in turn (forward, then backward) for ``--rounds`` rounds
(``tools/variant_ab.py``); the table gives the least, the median and the
largest per-call time.  Every
variant but the probes is held to the plain form bit for bit, in the
triangular (a, gi) and the block (a, b) outputs.  Prints the ptxas lines,
the table, the card's name and power limit, and one JSON line.  Without a
card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

from clenabled_tpu_torch import _build
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.runtime.device import card_info
from clenabled_tpu_torch.tools import variant_ab as ab

STAGE_ONLY = "-DGRAM_I8_STAGE_ONLY"
# probes whose outputs are wrong by design, timed but not checked
PARTIAL = (STAGE_ONLY, "-DGRAM_I8_COMPUTE_ONLY")
PROBES = {"stage_only": STAGE_ONLY,
          "compute_only": "-DGRAM_I8_COMPUTE_ONLY",
          "mma_only": "-DGRAM_I8_COMPUTE_ONLY -DGRAM_I8_MMA_ONLY"}
# the package's Gram sources: the C entry, then each launch it may call
ENTRY = "xengine_gram.cu"
LAUNCHES = {"clen_gram_int8_launch": "xengine_gram_int8.cu",
            "clen_gram_bf16_launch": "xengine_gram_bf16.cu"}


def variant_sources(value: str) -> tuple[list[Path], list[str]]:
    """(sources, extra nvcc flags) of one variant: ``tree``, ``-D`` flags
    for the package's sources, or a path and optional flags."""
    if value == "tree" or value.startswith("-D"):
        return ([_build.SRC_DIR / ENTRY]
                + [_build.SRC_DIR / f for f in LAUNCHES.values()],
                [] if value == "tree" else value.split())
    path, *flags = value.split()
    src = Path(path).resolve()
    text = src.read_text()
    # the package's file for each launch the source calls but does not
    # define (a definition's parameter list runs into a brace)
    return [src] + [_build.SRC_DIR / f for fn, f in LAUNCHES.items()
                    if fn + "(" in text and not re.search(
                        rf"\b{fn}\([^;]*\)\s*{{", text)], flags


class Call:
    """One variant's clen_xengine_gram on fixed int8 inputs, as
    ``hopper_kernels._launch_gram`` makes it; outputs allocated once."""

    def __init__(self, lib, zr, zi, emit_gi: bool):
        self.lib, self.zr, self.zi, self.emit_gi = lib, zr, zi, emit_gi
        f, self.t, self.sp = zr.shape
        kb = self.sp // hk.LANES
        nbt = kb * (kb + 1) // 2
        blk = (hk.LANES, hk.LANES)
        self.a = torch.empty((f, nbt, *blk), dtype=torch.int32,
                             device=zr.device)
        self.b = torch.empty(((f, nbt) if emit_gi else (f, kb, kb)) + blk,
                             dtype=torch.int32, device=zr.device)
        self.stream = torch.cuda.current_stream(zr.device).cuda_stream

    def __call__(self):
        err = self.lib.clen_xengine_gram(
            self.zr.data_ptr(), self.zi.data_ptr(), 0, self.zr.shape[0],
            self.t, self.sp, int(self.emit_gi), self.a.data_ptr(),
            self.b.data_ptr(), self.stream)
        if err != 0:
            raise RuntimeError(f"xengine_gram launch failed: CUDA error {err}")
        return self.a, self.b


def parse_args(argv=None) -> argparse.Namespace:
    ap = ab.arg_parser("int8 Gram variants A/B", "variants",
                       "name=path|name=-Dflags")
    ap.add_argument("--f", type=int, default=256)
    ap.add_argument("--t", type=int, default=8192)
    ap.add_argument("--sp", type=int, default=128)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not ab.have_card("gram_ab"):
        return 1
    dev = torch.device("cuda", 0)
    variants = dict(v.split("=", 1) for v in args.variants) or {
        "tree": "tree", **PROBES}
    libs, ptxas = ab.build(
        {name: variant_sources(v) for name, v in variants.items()},
        _build.BUILD_DIR / "gram_ab", "clen_xengine_gram",
        ("gram", "registers", "spill"))

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    zr, zi = (torch.randint(-128, 128, (args.f, args.t, args.sp),
                            generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2))
    want = {True: hk.xengine_gram_stacked_tri_plain(zr, zi)[:2],
            False: hk.xengine_gram_stacked_blocks_plain(zr, zi)[:2]}
    names = list(libs)
    calls = {name: Call(libs[name], zr, zi, True) for name in names}
    report = {name: {"ptxas": ptxas[name], "flags": variants[name]}
              for name in names}
    for name in names:
        if any(p in variants[name] for p in PARTIAL):
            calls[name]()
            continue
        exact = True
        for emit_gi in (True, False):
            got = Call(libs[name], zr, zi, emit_gi)()
            torch.cuda.synchronize()
            exact &= all(torch.equal(g, w) for g, w in zip(got, want[emit_gi]))
        report[name]["bit_exact"] = exact
    torch.cuda.synchronize()
    for name, t in ab.time_in_turns(calls, args.rounds, args.calls).items():
        report[name]["ms"] = t

    card = card_info()
    print(f"int8 Gram variants, _tri form on [{args.f}, {args.t}, {args.sp}] "
          f"int8, {args.rounds} rounds of {args.calls} calls (CUDA events), "
          f"{card}:")
    print("variant | flags | ms min / median / max | bit-exact to plain")
    for name in names:
        r = report[name]
        print(f"{name} | {r['flags'] if r['flags'].startswith('-D') else ''}"
              f" | {ab.ms_cell(r['ms'])} | "
              f"{r.get('bit_exact', 'not checked (probe)')}")
    print(json.dumps({"card": card, "shape": [args.f, args.t, args.sp],
                      "variants": report}))
    bad = [n for n in names if report[n].get("bit_exact") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
