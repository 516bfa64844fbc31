"""Variants of the fused FX kernel's source, timed side by side on the card.

    python -m clenabled_tpu_torch.tools.fx_ab [--n 8388608] [--m 16] \\
        [--dtype float32] [--rounds 7] [--calls 10] \\
        [name=path/to/fx_correlate.cu ...] [name=-DFX_STOP_AFTER=2 ...] \\
        [name=tree] [name=first_body]

Each variant is a ``fx_correlate.cu`` (a path), ``tree`` (the package's
own, on the body ``hopper_kernels.fx_body`` picks), ``first_body`` (the
package's own on ``fx_tile_kernel``, body 0 of the C entry) or the
package's own with extra ``nvcc`` flags (a value starting with ``-D``, on
the rule's body).  By default: ``tree`` and three stage probes of it,
built with ``-DFX_STOP_AFTER=1``, ``2`` and ``3``, whose blocks stop after
the staging, the FIR and the stage-1 DFT (``fx_wide_kernel``, which stages
nothing, after its twiddle table, its FIR from device memory and its DFT,
in every chunk), so that the differences between their times split the
body's time by stage; and at M >= 32 ``first_body``.  Each distinct source
and flag set is compiled by its own ``nvcc`` (all started together,
``-Xptxas -v``) into a library of its own and called as
``hopper_kernels.fx_correlate_streams_v2`` calls it, on the same seeded
frames at 4 antennas, the pipeline's prototype (25 taps a branch at every
M) and the ``fx_tail_len`` tail.  A source from before the body argument
(no ``int body`` in it) is called with the older C signature.  Times are
CUDA events around ``--calls`` back-to-back calls, the variants in turn
(forward, then backward) for ``--rounds`` rounds (``tools/variant_ab.py``);
the table gives the least, the median and the largest per-call time.
Every complete variant (no ``FX_STOP_AFTER``) is held to the plain form at
1e-4 × max|plain|.  Prints the ptxas lines, the table, the card's name and
power limit, and one JSON line.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from clenabled_tpu_torch import _build
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.runtime.device import card_info
from clenabled_tpu_torch.tools import variant_ab as ab

A = 4
TOL = 1e-4
FIRST = "first_body"
STAGE_PROBES = {"stop_after_staging": "-DFX_STOP_AFTER=1",
                "stop_after_fir": "-DFX_STOP_AFTER=2",
                "stop_after_dft": "-DFX_STOP_AFTER=3"}


def build(variants: dict[str, str], out_dir: Path) -> tuple[dict, dict]:
    """Compile each distinct source and flag set into its own library;
    returns, by variant, (library, whether its C entry takes the body
    argument, whether it runs ``fx_tile_kernel`` in place of the rule's
    body) and each variant's ptxas lines."""
    tree = _build.SRC_DIR / "fx_correlate.cu"

    def source(v):
        if v in ("tree", FIRST):
            return tree, ()
        if v.startswith("-D"):
            return tree, tuple(v.split())
        return Path(v).resolve(), ()

    keys = {name: source(v) for name, v in variants.items()}
    distinct = {}
    for name, key in keys.items():
        distinct.setdefault(key, name)
    libs, ptxas = ab.build(
        {lib_name: ([src], [*flags, f"-I{_build.SRC_DIR}"])
         for (src, flags), lib_name in distinct.items()}, out_dir,
        "clen_fx_correlate", ("fx_reg", "fx_tile", "fx_wide", "registers",
                              "spill"))
    args = _build._SIGNATURES["clen_fx_correlate"][0]
    loaded = {}
    for name, key in keys.items():
        lib = libs[distinct[key]]
        with_body = "int tile, int body" in key[0].read_text()
        if not with_body:
            lib.clen_fx_correlate.argtypes = args[:17] + args[18:]
        loaded[name] = (lib, with_body, variants[name] == FIRST)
    return loaded, {name: ptxas[distinct[keys[name]]] for name in variants}


class Call:
    """One variant's clen_fx_correlate on fixed inputs, as ``_launch_fx``
    makes it; outputs allocated once."""

    def __init__(self, lib, with_body, first, ins, taps, m, dev):
        self.lib, self.ins, self.taps, self.m = lib, ins, taps, m
        self.body_name = ("fx_tile_kernel" if first or not with_body
                          else hk.fx_body(m, A, taps.shape[0], dev))
        code = hk.FX_BODIES.index(self.body_name)
        self.body = [code] if with_body else []
        fd, xe = hk._default_pairs(None, None, A)
        self.nfd, self.nb = len(fd), len(xe)
        self.fdp = hk._pairs_on(tuple(fd.reshape(-1).tolist()), dev)
        self.xep = hk._pairs_on(tuple(xe.reshape(-1).tolist()), dev)
        self.tw = hk._twiddles(m, dev)
        self.tile = hk.fx_tile(m, self.body_name)
        n = ins[0].shape[-1]
        nblk = -(-(n // m) // self.tile)
        width = hk._load().clen_fx_partial_width(m, self.nfd, self.nb, code)
        self.partial = torch.empty((nblk, width), device=dev)
        self.out = torch.empty((self.nfd + 2 * self.nb) * m, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __call__(self):
        xr, xi, tr, ti = self.ins
        err = self.lib.clen_fx_correlate(
            xr.data_ptr(), xi.data_ptr(), tr.data_ptr(), ti.data_ptr(),
            hk._DTYPE_CODE[xr.dtype], self.taps.data_ptr(),
            self.tw.data_ptr(), self.fdp.data_ptr(), self.nfd,
            self.xep.data_ptr(), self.nb, A, self.m, self.taps.shape[0],
            xr.shape[-1], tr.shape[-1], self.tile, *self.body,
            self.partial.data_ptr(), self.out.data_ptr(), self.stream)
        if err != 0:
            raise RuntimeError(f"fx launch failed: CUDA error {err}")
        m = self.m
        return (self.out[: self.nfd * m].view(self.nfd, m),
                self.out[self.nfd * m:].view(self.nb, 2 * m))


def parse_args(argv=None) -> argparse.Namespace:
    ap = ab.arg_parser("FX kernel variants A/B", "variants",
                       "name=path|name=tree|name=first_body|name=-Dflags")
    ap.add_argument("--n", type=int, default=1 << 23)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not ab.have_card("fx_ab"):
        return 1
    dev = torch.device("cuda", 0)
    variants = dict(v.split("=", 1) for v in args.variants) or {
        "tree": "tree", **STAGE_PROBES,
        **({FIRST: FIRST} if args.m >= 32 else {})}
    libs, ptxas = build(variants, _build.BUILD_DIR / "fx_ab")

    dt = getattr(torch, args.dtype)
    taps_rm, ntaps = P._prototype(args.m, 100e6)
    taps = torch.as_tensor(taps_rm, device=dev).contiguous()
    h = hk.fx_tail_len(dt, args.m, ntaps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def frame(length):
        if dt == torch.int8:
            return torch.randint(-127, 128, (A, length), generator=gen,
                                 device=dev, dtype=dt)
        return torch.randn((A, length), generator=gen, device=dev).to(dt)

    ins = (frame(args.n), frame(args.n), frame(h), frame(h))
    want = hk.fx_correlate_streams_v2_plain(*ins, taps, A, args.m)
    names = list(libs)
    calls = {name: Call(*libs[name], ins, taps, args.m, dev)
             for name in names}
    report = {name: {"ptxas": ptxas[name], "flags": variants[name],
                     "body": calls[name].body_name} for name in names}
    for name in names:
        got = calls[name]()
        torch.cuda.synchronize()
        if "FX_STOP_AFTER" in variants[name]:
            continue
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        tol = TOL * max(float(w.abs().max()) for w in want)
        report[name]["max_abs_err"] = err
        report[name]["within_tolerance"] = err <= tol
    for name, t in ab.time_in_turns(calls, args.rounds, args.calls).items():
        report[name]["ms"] = t

    card = card_info()
    print(f"FX kernel variants, {A} x {args.n} {args.dtype}, M = {args.m}, "
          f"{taps.shape[0]} taps a branch, {args.rounds} rounds of "
          f"{args.calls} calls (CUDA events), {card}:")
    print("variant | flags | body | ms min / median / max | within 1e-4 x "
          "max|plain|")
    for name in names:
        r = report[name]
        print(f"{name} | {r['flags'] if r['flags'].startswith('-D') else ''}"
              f" | {r['body']} | {ab.ms_cell(r['ms'])} | "
              f"{r.get('within_tolerance', 'not checked (stage probe)')}")
    print(json.dumps({"card": card, "n": args.n, "m": args.m,
                      "dtype": args.dtype, "variants": report}))
    bad = [n for n in names if report[n].get("within_tolerance") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
