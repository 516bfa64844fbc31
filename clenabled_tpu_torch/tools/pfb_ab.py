"""Variants of the packed critically sampled PFB kernel's source, timed side
by side on the card.

    python -m clenabled_tpu_torch.tools.pfb_ab [--samples 131072 8388608] \\
        [--a 4] [--m 16] [--rounds 7] [--calls 10] \\
        [name=path/to/pfb_packed.cu ...] [name=-DFLAG=VALUE ...] \\
        [name=first_body ...]

Each variant is a ``pfb_packed.cu`` (a path, such as an earlier commit's
extracted with ``git show <commit>:clenabled_tpu_torch/csrc/pfb_packed.cu
> _local/pfb_packed_old.cu``), ``tree`` (the package's own, on the body
``hopper_kernels.pfb_packed_body`` picks), ``first_body`` (the package's
own on ``pfb_packed_kernel``, body 0 of the C entry) or the package's own
with extra ``nvcc`` flags (a value starting with ``-D``).  By default:
``tree``, ``first_body`` and two stage probes of the tree, built with
``-DPFB_STOP_AFTER=1`` and ``2``, whose register-tiled blocks
(``pfb_packed_reg_kernel`` at M <= 16, ``pfb_packed_wide_kernel`` at M =
32, 64 and 128) stop after the staging and after the FIR (its sums stored
to shared memory), so that the differences between their times split the
body's time into staging, FIR and the DFT with the copy-out.  Each distinct
source and flag set is compiled by its own ``nvcc`` (all started together,
``-Xptxas -v``) into a library of its own and called as
``hopper_kernels.pfb_channelize_packed`` calls it, on the planar step's
packed stream: ``--a`` antennas of ``--samples`` samples each (one
shape per value; by default the planar step's 2^17 and the fused step's
2^23), ``--m`` channels, the step's prototype (400, 800, 1600 and 3200
taps at M = 16, 32, 64 and 128: W = 25).  A source from before the body
argument (no ``int body`` in its C entry) is called with the older C
signature, and so runs ``pfb_packed_kernel``.  Times are CUDA events
around ``--calls`` back-to-back calls, the variants in turn (forward, then
backward) for
``--rounds`` rounds (``tools/variant_ab.py``); the table gives the least,
the median and the largest per-call time, beside each variant's device
time per call from ``torch.profiler`` over ``--calls`` calls (the events'
time of a small call is the host's).  Every complete variant (no
``PFB_STOP_AFTER``) is held to the plain form at 1e-4 × max|plain|.
Prints the ptxas lines, the tables, the card's name and power limit, and
one JSON line.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from clenabled_tpu_torch import _build
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import channelizer as chan
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.runtime.device import card_info, device_time_ms
from clenabled_tpu_torch.tools import variant_ab as ab

TOL = 1e-4
FIRST = "first_body"
STAGE_PROBES = {"stop_after_staging": "-DPFB_STOP_AFTER=1",
                "stop_after_fir": "-DPFB_STOP_AFTER=2"}


def build(variants: dict[str, str], out_dir: Path) -> tuple[dict, dict]:
    """Compile each distinct source and flag set into its own library;
    returns, by variant, (library, whether its C entry takes the body
    argument, the body code to pass, or None for the wrapper's choice) and
    the ptxas lines of each library."""
    tree = _build.SRC_DIR / "pfb_packed.cu"

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
        "clen_pfb_packed", ("pfb_packed", "registers", "spill"))
    args = _build._SIGNATURES["clen_pfb_packed"][0]
    loaded = {}
    for name, (src, flags) in keys.items():
        lib = libs[distinct[(src, flags)]]
        with_body = "int tile, int body" in src.read_text()
        if not with_body:
            lib.clen_pfb_packed.argtypes = args[:9] + args[10:]
        pick = (hk.PFB_PACKED_BODIES.index("pfb_packed_kernel")
                if variants[name] == FIRST else None)
        loaded[name] = (lib, with_body, pick)
    return loaded, {name: ptxas[distinct[keys[name]]] for name in variants}


class Call:
    """One variant's clen_pfb_packed on fixed inputs, as
    ``hopper_kernels.pfb_channelize_packed`` makes it; output allocated
    once."""

    def __init__(self, lib, with_body, pick, y, hr, a, m):
        self.lib, self.y, self.hr, self.a, self.m = lib, y, hr, a, m
        w = hr.shape[0]
        if not with_body:
            body = hk.PFB_PACKED_BODIES.index("pfb_packed_kernel")
        elif pick is None:
            body = hk.PFB_PACKED_BODIES.index(hk.pfb_packed_body(m, w,
                                                                 y.device))
        else:
            body = pick
        self.body_name = hk.PFB_PACKED_BODIES[body]
        self.tile = hk.pfb_packed_tile(a, m, body)
        self.body = [body] if with_body else []
        self.tw = hk._twiddles(m, y.device)
        self.out = torch.empty((y.shape[0] - (w - 1), y.shape[1]),
                               device=y.device)
        self.stream = torch.cuda.current_stream(y.device).cuda_stream

    def __call__(self):
        err = self.lib.clen_pfb_packed(
            self.y.data_ptr(), self.hr.data_ptr(), self.tw.data_ptr(),
            self.out.data_ptr(), self.out.shape[0], self.hr.shape[0], self.a,
            self.m, self.tile, *self.body, self.stream)
        if err != 0:
            raise RuntimeError(f"pfb_packed launch failed: CUDA error {err}")
        return self.out


def parse_args(argv=None) -> argparse.Namespace:
    ap = ab.arg_parser("packed PFB kernel variants A/B", "variants",
                       "name=path|name=tree|name=first_body|name=-Dflags")
    ap.add_argument("--samples", type=int, nargs="+",
                    default=[1 << 17, 1 << 23])
    ap.add_argument("--a", type=int, default=4)
    ap.add_argument("--m", type=int, default=16)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not ab.have_card("pfb_ab"):
        return 1
    dev = torch.device("cuda", 0)
    variants = dict(v.split("=", 1) for v in args.variants) or {
        "tree": "tree", FIRST: FIRST, **STAGE_PROBES}
    libs, ptxas = build(variants, _build.BUILD_DIR / "pfb_ab")
    names = list(libs)
    card = card_info()
    a, m = args.a, args.m
    taps_rm, ntaps = P._prototype(m, 100e6)
    taps = torch.as_tensor(taps_rm, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    report = {name: {"ptxas": ptxas[name], "flags": variants[name],
                     "by_samples": {}} for name in names}
    bad = []
    for n in args.samples:
        nout = n // m
        comps = torch.randn((2 * a, ntaps - 1 + n), generator=gen, device=dev)
        y, hr = chan._pack_streams(comps, taps, m, ntaps, nout)
        del comps
        want = hk.pfb_channelize_packed_plain(y, hr, a, m)
        tol = TOL * float(want.abs().max())
        calls = {name: Call(*libs[name], y, hr, a, m) for name in names}
        for name in names:
            got = calls[name]()
            torch.cuda.synchronize()
            rep = report[name]["by_samples"].setdefault(n, {
                "body": calls[name].body_name, "rows": calls[name].tile})
            if "PFB_STOP_AFTER" in variants[name]:
                continue
            err = float((got - want).abs().max())
            rep["max_abs_err"] = err
            rep["within_tolerance"] = err <= tol
            if not rep["within_tolerance"]:
                bad.append((name, n))
        del want
        for name, tm in ab.time_in_turns(calls, args.rounds,
                                         args.calls).items():
            report[name]["by_samples"][n]["ms"] = tm
        for name in names:
            report[name]["by_samples"][n]["device_ms"] = device_time_ms(
                calls[name], args.calls)
        print(f"packed PFB variants, y = [{y.shape[0]}, {y.shape[1]}] ({a} "
              f"antennas x {n} samples, M = {m}, W = {hr.shape[0]}), "
              f"{args.rounds} rounds of {args.calls} calls (CUDA events), "
              f"{card}:")
        print("variant | flags | body | rows | ms min / median / max | "
              "device ms | within 1e-4 x max|plain|")
        for name in names:
            rep = report[name]["by_samples"][n]
            flags = variants[name] if variants[name].startswith("-D") else ""
            dms = rep["device_ms"]
            dms = "not measured" if dms is None else f"{dms:.4f}"
            print(f"{name} | {flags} | {rep['body']} | {rep['rows']} | "
                  f"{ab.ms_cell(rep['ms'])} | {dms} | "
                  f"{rep.get('within_tolerance', 'not checked (stage probe)')}")
        del calls, y, hr
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "samples": args.samples, "a": a, "m": m,
                      "variants": report}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
