"""Variants of the oversampled PFB kernel's source, timed side by side on
the card.

    python -m clenabled_tpu_torch.tools.os_ab [--n 8388608] [--m 16] \\
        [--r 8] [--ntaps N] [--rounds 7] [--calls 10] \\
        [name=path/to/pfb_oversampled.cu ...] [name=-DOS_STOP_AFTER=2 ...] \\
        [name=first_body ...]

Each variant is a ``pfb_oversampled.cu`` (a path, such as an earlier
commit's extracted with ``git show <commit>:clenabled_tpu_torch/csrc/
pfb_oversampled.cu > _local/pfb_oversampled_old.cu``), ``tree`` (the
package's own, on the body ``hopper_kernels.os_body`` picks), ``first_body``
(the package's own on ``pfb_os_kernel``, body 0 of the C entry) or the
package's own with extra ``nvcc`` flags (a value starting with ``-D``).  By default: ``tree``, two
stage probes of it, built with ``-DOS_STOP_AFTER=1`` and ``2``, whose
``pfb_os_reg_kernel`` and ``pfb_os_wide_kernel`` blocks stop after the
staging and after the FIR (every chunk's), so that the differences
between their times split the body's time by stage, and at M >= 32
``first_body``.  Each distinct source and flag set is compiled by its own
``nvcc`` (all started together, ``-Xptxas -v``) into a library of its own
and called as ``hopper_kernels.pfb_oversampled_fused`` calls it, on the
same seeded frame and tail: M = ``--m``, R = ``--r``, the path's prototype
(``firdes.low_pass(1, M, 0.5, 0.25)``) or an ``--ntaps``-tap windowed
sinc, the ``os_tail_len`` tail.  A source from before the body argument
(no ``int body`` in its C entry) is called with the older C signature, and
so runs ``pfb_os_kernel``.  Times are CUDA events around ``--calls``
back-to-back calls, the variants in turn (forward, then backward) for
``--rounds`` rounds (``tools/variant_ab.py``); the table gives the least, the median
and the largest per-call time.  Every complete variant (no
``OS_STOP_AFTER``) is held to the plain form at 1e-4 × max|plain|.  Prints
the ptxas lines, the table, the card's name and power limit, and one JSON
line.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from clenabled_tpu_torch import _build
from clenabled_tpu_torch.dsp import channelizer as chan
from clenabled_tpu_torch.dsp import firdes
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.runtime.device import card_info
from clenabled_tpu_torch.tools import variant_ab as ab

TOL = 1e-4
FIRST = "first_body"
STAGE_PROBES = {"stop_after_staging": "-DOS_STOP_AFTER=1",
                "stop_after_fir": "-DOS_STOP_AFTER=2"}


def prototype(m: int, ntaps: int | None) -> np.ndarray:
    """The path's prototype (``firdes.low_pass(1, M, 0.5, 0.25)``) or an
    ``ntaps``-tap windowed sinc, zero-padded to a multiple of M."""
    if ntaps is None:
        p = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    else:
        p = (np.sinc(np.linspace(-ntaps / (2 * m), ntaps / (2 * m), ntaps))
             * np.hanning(ntaps)).astype(np.float32)
    return np.concatenate([p, np.zeros((-len(p)) % m, np.float32)])


def build(variants: dict[str, str], out_dir: Path) -> tuple[dict, dict]:
    """Compile each distinct source and flag set into its own library;
    returns, by variant, (library, whether its C entry takes the body
    argument, whether it runs ``pfb_os_kernel`` in place of the rule's
    body) and each variant's ptxas lines."""
    tree = _build.SRC_DIR / "pfb_oversampled.cu"

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
        "clen_pfb_oversampled", ("pfb_os", "registers", "spill"))
    args = _build._SIGNATURES["clen_pfb_oversampled"][0]
    loaded = {}
    for name, key in keys.items():
        lib = libs[distinct[key]]
        with_body = "int groups, int body" in key[0].read_text()
        if not with_body:
            lib.clen_pfb_oversampled.argtypes = args[:15] + args[16:]
        loaded[name] = (lib, with_body, variants[name] == FIRST)
    return loaded, {name: ptxas[distinct[keys[name]]] for name in variants}


class Call:
    """One variant's clen_pfb_oversampled on fixed inputs, as
    ``pfb_oversampled_fused`` makes it; outputs allocated once."""

    def __init__(self, lib, with_body, first, ins, taps, m, r, dev):
        self.lib, self.ins, self.taps, self.m, self.r = lib, ins, taps, m, r
        self.body_name = ("pfb_os_kernel" if first or not with_body
                          else hk.os_body(m, r, taps.shape[0], dev))
        self.body = [hk.OS_BODIES.index(self.body_name)] if with_body else []
        self.tw = hk._twiddles(m, dev)
        self.zr = torch.empty((ins[0].shape[-1] // r, m), device=dev)
        self.zi = torch.empty_like(self.zr)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __call__(self):
        xr, xi, tr, ti = self.ins
        err = self.lib.clen_pfb_oversampled(
            xr.data_ptr(), xi.data_ptr(), tr.data_ptr(), ti.data_ptr(),
            self.taps.data_ptr(), self.tw.data_ptr(), self.zr.data_ptr(),
            self.zi.data_ptr(), xr.shape[-1], tr.shape[-1], self.m, self.r,
            self.taps.shape[0], 0, max(1, hk._OS_GROUPS // self.m),
            *self.body, self.stream)
        if err != 0:
            raise RuntimeError(f"pfb_oversampled launch failed: CUDA error "
                               f"{err}")
        return self.zr, self.zi


def parse_args(argv=None) -> argparse.Namespace:
    ap = ab.arg_parser("oversampled PFB kernel variants A/B", "variants",
                       "name=path|name=tree|name=first_body|name=-Dflags")
    ap.add_argument("--n", type=int, default=1 << 23)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--ntaps", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not ab.have_card("os_ab"):
        return 1
    dev = torch.device("cuda", 0)
    variants = dict(v.split("=", 1) for v in args.variants) or {
        "tree": "tree", **STAGE_PROBES,
        **({FIRST: FIRST} if args.m >= 32 else {})}
    libs, ptxas = build(variants, _build.BUILD_DIR / "os_ab")

    m, r = args.m, args.r
    taps_rm, ntaps = chan._pfb_constants(prototype(m, args.ntaps), m, r)
    taps = torch.as_tensor(taps_rm, device=dev).contiguous()
    h = hk.os_tail_len(m, r, ntaps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((2, args.n), generator=gen, device=dev)
    t = torch.randn((2, h), generator=gen, device=dev)
    ins = (x[0], x[1], t[0], t[1])
    want = hk.pfb_oversampled_fused_plain(*ins, taps, m, r)
    names = list(libs)
    calls = {name: Call(*libs[name], ins, taps, m, r, dev) for name in names}
    report = {name: {"ptxas": ptxas[name], "flags": variants[name],
                     "body": calls[name].body_name} for name in names}
    for name in names:
        got = calls[name]()
        torch.cuda.synchronize()
        if "OS_STOP_AFTER" in variants[name]:
            continue
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        tol = TOL * max(float(w.abs().max()) for w in want)
        report[name]["max_abs_err"] = err
        report[name]["within_tolerance"] = err <= tol
    for name, tm in ab.time_in_turns(calls, args.rounds, args.calls).items():
        report[name]["ms"] = tm

    card = card_info()
    print(f"oversampled PFB variants, {args.n} samples, M = {m}, R = {r}, "
          f"{taps.shape[0]} taps a branch, {args.rounds} rounds of "
          f"{args.calls} calls (CUDA events), {card}:")
    print("variant | flags | body | ms min / median / max | within 1e-4 x "
          "max|plain|")
    for name in names:
        rep = report[name]
        print(f"{name} | {rep['flags'] if rep['flags'].startswith('-D') else ''}"
              f" | {rep['body']} | {ab.ms_cell(rep['ms'])} | "
              f"{rep.get('within_tolerance', 'not checked (stage probe)')}")
    print(json.dumps({"card": card, "n": args.n, "m": m, "r": r,
                      "w": taps.shape[0], "variants": report}))
    bad = [n for n in names if report[n].get("within_tolerance") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
