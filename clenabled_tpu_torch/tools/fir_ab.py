"""Variants of the direct FIR kernel's source, timed side by side on the
card.

    python -m clenabled_tpu_torch.tools.fir_ab [--n 2097152] \\
        [--ntaps 49 241 1601] [--rounds 7] [--calls 10] \\
        [name=path/to/fir_direct.cu ...] [name=-DFLAG=VALUE ...] \\
        [name=first_body ...]

Each variant is a ``fir_direct.cu`` (a path, such as an earlier commit's
extracted with ``git show <commit>:clenabled_tpu_torch/csrc/fir_direct.cu
> _local/fir_direct_old.cu``), ``tree`` (the package's own, on the body
``hopper_kernels.fir_body`` picks), ``first_body`` (the package's own on
``fir_direct_kernel``, body 0 of the C entry) or the package's own with
extra ``nvcc`` flags (a value starting with ``-D``).  By default:
``tree``, ``first_body`` and two stage probes of the tree, built with
``-DFIR_STOP_AFTER=1`` and ``2``, whose ``fir_reg_kernel`` blocks stop
after the staging and after the FIR (its sums stored to shared memory),
so that the differences between their times split the body's time into
staging, FIR and the copy-out.  Each distinct source and flag set is
compiled by its own ``nvcc`` (all started together, ``-Xptxas -v``) into
a library of its own and called as ``hopper_kernels.fir_direct`` calls
it, at decimation 1 on both planar components of a seeded 2 × ``--n``
frame with its K−1 history, at each ``--ntaps`` (a windowed sinc).  A
source from before the body argument (no ``int body`` in its C entry) is
called with the older C signature, and so runs ``fir_direct_kernel``.
Times are CUDA events around ``--calls`` back-to-back calls, the variants
in turn (forward, then backward) for ``--rounds`` rounds
(``tools/variant_ab.py``); the table gives the least, the median and the
largest per-call time, beside each variant's device time per call from
``torch.profiler`` over ``--calls`` calls (the events' time of a small
call is the host's).  Every complete variant (no ``FIR_STOP_AFTER``) is
held to the plain form at 1e-4 × max|plain| and compared bit for bit with
``first_body``'s output.  Prints the ptxas lines, the tables, the card's
name and power limit, and one JSON line.  Without a card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from clenabled_tpu_torch import _build
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.runtime.device import card_info, device_time_ms
from clenabled_tpu_torch.tools import variant_ab as ab

TOL = 1e-4
FIRST = "first_body"
STAGE_PROBES = {"stop_after_staging": "-DFIR_STOP_AFTER=1",
                "stop_after_fir": "-DFIR_STOP_AFTER=2"}


def taps_of(ntaps: int) -> np.ndarray:
    """An ``ntaps``-tap windowed sinc (``chip_smoke.py``'s 1601-tap form)."""
    return (np.sinc(np.linspace(-8, 8, ntaps)) * np.hanning(ntaps)).astype(
        np.float32)


def build(variants: dict[str, str], out_dir: Path) -> tuple[dict, dict]:
    """Compile each distinct source and flag set into its own library;
    returns, by variant, (library, whether its C entry takes the body
    argument, the body code to pass or None for the picked one) and the
    ptxas lines of each library."""
    tree = _build.SRC_DIR / "fir_direct.cu"

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
        "clen_fir_direct", ("fir_", "registers", "spill"))
    args = _build._SIGNATURES["clen_fir_direct"][0]
    loaded = {}
    for name, (src, flags) in keys.items():
        lib = libs[distinct[(src, flags)]]
        with_body = "int decim, int body" in src.read_text()
        if not with_body:
            lib.clen_fir_direct.argtypes = args[:11] + args[12:]
        body = hk.FIR_BODIES.index("fir_direct_kernel") if (
            variants[name] == FIRST) else None
        loaded[name] = (lib, with_body, body)
    return loaded, {name: ptxas[distinct[keys[name]]] for name in variants}


class Call:
    """One variant's clen_fir_direct on fixed inputs at decimation 1, as
    ``hopper_kernels.fir_direct`` makes it; outputs allocated once."""

    def __init__(self, lib, with_body, body, x, h, taps):
        self.lib, self.x, self.h, self.taps = lib, x, h, taps
        k = taps.shape[0]
        if body is None:
            body = hk.FIR_BODIES.index(hk.fir_body(k, 1, x.device))
        self.body = [body] if with_body else []
        self.y = torch.empty_like(x)
        self.stream = torch.cuda.current_stream(x.device).cuda_stream

    def __call__(self):
        x, h, y = self.x, self.h, self.y
        err = self.lib.clen_fir_direct(
            h[0].data_ptr(), x[0].data_ptr(), y[0].data_ptr(),
            h[1].data_ptr(), x[1].data_ptr(), y[1].data_ptr(), 2,
            self.taps.data_ptr(), self.taps.shape[0], x.shape[-1], 1,
            *self.body, self.stream)
        if err != 0:
            raise RuntimeError(f"fir_direct launch failed: CUDA error {err}")
        return y


def parse_args(argv=None) -> argparse.Namespace:
    ap = ab.arg_parser("direct FIR kernel variants A/B", "variants",
                       "name=path|name=tree|name=first_body|name=-Dflags")
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--ntaps", type=int, nargs="+", default=[49, 241, 1601])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not ab.have_card("fir_ab"):
        return 1
    dev = torch.device("cuda", 0)
    variants = dict(v.split("=", 1) for v in args.variants) or {
        "tree": "tree", FIRST: FIRST, **STAGE_PROBES}
    libs, ptxas = build(variants, _build.BUILD_DIR / "fir_ab")
    names = list(libs)
    card = card_info()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((2, args.n), generator=gen, device=dev)
    report = {name: {"ptxas": ptxas[name], "flags": variants[name],
                     "by_ntaps": {}} for name in names}
    bad = []
    for k in args.ntaps:
        taps = torch.as_tensor(taps_of(k), device=dev)
        h = torch.randn((2, k - 1), generator=gen, device=dev)
        want = [hk.fir_direct_plain(x[c], taps, history=h[c])
                for c in range(2)]
        calls = {name: Call(*libs[name], x, h, taps) for name in names}
        firsts = [name for name in names if variants[name] == FIRST]
        first = calls[firsts[0]]().clone() if firsts else None
        for name in names:
            got = calls[name]().clone()
            torch.cuda.synchronize()
            rep = report[name]["by_ntaps"].setdefault(k, {})
            if "FIR_STOP_AFTER" in variants[name]:
                continue
            err = max(float((got[c] - want[c]).abs().max()) for c in range(2))
            tol = TOL * max(float(w.abs().max()) for w in want)
            rep["max_abs_err"] = err
            rep["within_tolerance"] = err <= tol
            if first is not None:
                rep["equal_to_first_body"] = bool(torch.equal(got, first))
            if not rep["within_tolerance"] or first is not None and not \
                    rep["equal_to_first_body"]:
                bad.append((name, k))
        for name, tm in ab.time_in_turns(calls, args.rounds,
                                         args.calls).items():
            report[name]["by_ntaps"][k]["ms"] = tm
        for name in names:
            report[name]["by_ntaps"][k]["device_ms"] = device_time_ms(
                calls[name], args.calls)
        print(f"direct FIR variants, 2 x {args.n} samples, {k} taps, D = 1, "
              f"{args.rounds} rounds of {args.calls} calls (CUDA events), "
              f"{card}:")
        print("variant | flags | ms min / median / max | device ms | "
              "within 1e-4 x max|plain| | bit-equal to first_body")
        for name in names:
            rep = report[name]["by_ntaps"][k]
            flags = variants[name] if variants[name].startswith("-D") else ""
            dms = rep["device_ms"]
            dms = "not measured" if dms is None else f"{dms:.4f}"
            print(f"{name} | {flags} | {ab.ms_cell(rep['ms'])} | {dms} | "
                  f"{rep.get('within_tolerance', 'not checked (stage probe)')}"
                  f" | {rep.get('equal_to_first_body', '')}")
    print(json.dumps({"card": card, "n": args.n, "ntaps": args.ntaps,
                      "variants": report}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
