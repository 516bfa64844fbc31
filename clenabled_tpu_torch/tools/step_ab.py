"""A path's step, device busy time and wall time, for checkouts of the
package, timed in turns on the card.

    python -m clenabled_tpu_torch.tools.step_ab [name=ROOT ...] \\
        [--path fx|os] [--samples 131072] [--a 4] [--m 16] [--r 8] \\
        [--steps 3] [--reps 30] [--rounds 2]

Each ROOT is a directory holding a ``clenabled_tpu_torch`` package, such as
an earlier commit's tree unpacked with ``git archive <commit> | tar -x -C
_local/parent``; by default ``tree=`` the root of the package that runs
this tool.  Each variant runs in a process of its own with ROOT first on
``sys.path``, so that it builds and calls that tree's kernels; the variants
run in the order given, then backward, for ``--rounds`` rounds.  A process
makes the path's step and ``--steps`` frames of ``--samples`` samples from a
seeded generator, runs the chained steps once to warm them, then times
``--reps`` chains on the host's clock (wall per step: least and median) and
five chains under ``torch.profiler`` (device busy per step: the sum of the
device events' times, and the path's kernel's part).  The paths:

* ``fx`` (the default): the planar step
  (``pipelines.make_fx_pipeline_planar``) for ``--a`` antennas and ``--m``
  channels; its kernel is the packed PFB;
* ``os``: a ``Flowgraph`` of the fused ``PolyphaseChannelizer`` (``--m``
  channels, decimation ``--r``, ``firdes.low_pass(1, M, 0.5, 0.25)``, every
  channel), as ``chip_smoke.py`` drives the oversampled path; its kernel is
  ``pfb_oversampled_fused``, and the process also times the host's part of
  a step and of one ``pfb_oversampled_fused`` call: the host clock around
  ``--reps`` back-to-back calls, read before the card is waited for.

Prints a line per process, the card's name and power limit, and one JSON
line.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
BUSY_CHAINS = 5


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="path step A/B across trees")
    ap.add_argument("variants", nargs="*", metavar="name=ROOT")
    ap.add_argument("--path", choices=("fx", "os"), default="fx")
    ap.add_argument("--samples", type=int, default=1 << 17)
    ap.add_argument("--a", type=int, default=4)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", metavar="ROOT", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def child(args) -> dict:
    """One tree's step of ``--path``, timed in this process."""
    sys.path[0] = str(Path(args.child).resolve())
    import torch

    from clenabled_tpu_torch.runtime.device import _device_events

    dev = torch.device("cuda", 0)
    if args.path == "os":
        chain, steps, kernel, extra = _os_step(args, dev)
    else:
        chain, steps, kernel, extra = _fx_step(args, dev)
    chain()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        chain()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / steps * 1e3)
    _, window = _device_events(
        lambda: [chain() for _ in range(BUSY_CHAINS)], BUSY_CHAINS * steps, 3)
    per = BUSY_CHAINS * steps * 1e3
    mine = [(n, us) for n, us in window if kernel in n]
    return {"root": args.child, "path": args.path,
            "busy_ms": sum(us for _, us in window) / per,
            "kernel_ms": sum(us for _, us in mine) / per,
            "kernels": sorted({re.search(rf"\w*{kernel}\w*", n).group(0)
                               for n, _ in mine}),
            "wall_min_ms": min(walls),
            "wall_median_ms": statistics.median(walls), **extra}


def _enqueue_ms(torch, fn, reps: int) -> float:
    """Host time of one call of ``fn``: the host clock around ``reps``
    back-to-back calls after a synchronise, read before the card is
    waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _os_step(args, dev):
    """The oversampled channelizer path: (chain of ``--steps`` Flowgraph
    steps, steps, the kernel's name, the host times a step and a wrapper
    call)."""
    import numpy as np
    import torch

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import channelizer as chan
    from clenabled_tpu_torch.dsp import firdes, planar
    from clenabled_tpu_torch.dsp import hopper_kernels as hk
    from clenabled_tpu_torch.streaming import Flowgraph

    m, r, n = args.m, args.r, args.samples
    proto = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    proto = np.concatenate([proto, np.zeros((-len(proto)) % m, np.float32)])
    ch = blocks.PolyphaseChannelizer(proto, n, m, r, list(range(m)),
                                     planar=True, fused=True)
    g = Flowgraph()
    g.external_input(ch)
    g.tap(ch, name="channels")
    run = g.compile(n, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    frames = [planar.PC(*torch.randn((2, n), generator=gen, device=dev))
              for _ in range(args.steps)]

    def chain():
        for f in frames:
            run.step(f)

    taps_rm, ntaps = chan._pfb_constants(proto, m, r)
    taps = torch.as_tensor(taps_rm, device=dev)
    tail = torch.zeros(hk.os_tail_len(m, r, ntaps), device=dev)
    call = (lambda: hk.pfb_oversampled_fused(frames[0].re, frames[0].im,
                                             tail, tail, taps, m, r))
    chain()
    call()
    extra = {"host_step_ms": statistics.median(
                 _enqueue_ms(torch, lambda: run.step(frames[0]), 10)
                 for _ in range(args.reps)),
             "host_call_ms": statistics.median(
                 _enqueue_ms(torch, call, 10) for _ in range(args.reps))}
    return chain, args.steps, "pfb_os", extra


def _fx_step(args, dev):
    """The planar FX step: (chain of ``--steps`` steps, steps, the packed
    PFB kernel's name, nothing more)."""
    import torch

    from clenabled_tpu_torch import pipelines as P

    cfg = P.FxPipelineConfig(num_antennas=args.a, num_channels=args.m,
                             samples_per_step=args.samples)
    step, (_, _, hr0, hi0) = P.make_fx_pipeline_planar(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    frames = [tuple(torch.randn((args.a, args.samples), generator=gen,
                                device=dev) for _ in range(2))
              for _ in range(args.steps)]

    def chain():
        hr, hi = hr0, hi0
        for xr, xi in frames:
            o = step(xr, xi, hr, hi)
            hr, hi = o[3], o[4]

    return chain, args.steps, "pfb_packed", {}


def run(root: str, args) -> dict:
    """``child`` in a process of its own on the tree at ``root``."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", root,
           "--path", args.path, "--samples", str(args.samples), "--a",
           str(args.a), "--m", str(args.m), "--r", str(args.r), "--steps",
           str(args.steps), "--reps", str(args.reps)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=root))
    if proc.returncode != 0:
        raise RuntimeError(f"step_ab on {root} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.child:
        print(json.dumps(child(args)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("step_ab: no CUDA device", file=sys.stderr)
        return 1
    from clenabled_tpu_torch.runtime.device import card_info

    variants = dict(v.split("=", 1) for v in args.variants) or {
        "tree": str(PACKAGE_ROOT)}
    names = list(variants)
    report = {name: [] for name in names}
    for _ in range(args.rounds):
        for order in (names, names[::-1]):
            for name in order:
                r = run(variants[name], args)
                report[name].append(r)
                host = ("" if args.path != "os" else
                        f"; host {r['host_step_ms']:.4f} ms a step, "
                        f"{r['host_call_ms']:.4f} a wrapper call")
                print(f"{name}: busy {r['busy_ms']:.4f} ms a step (kernel "
                      f"{r['kernel_ms']:.4f} on {r['kernels']}), wall "
                      f"least {r['wall_min_ms']:.4f} median "
                      f"{r['wall_median_ms']:.4f} ms a step{host}", flush=True)
    card = card_info()
    shape = (f"planar step {args.a} x {args.samples}, M = {args.m}"
             if args.path == "fx" else
             f"oversampled channelizer {args.samples}, M = {args.m}, "
             f"R = {args.r}")
    print(f"{shape}, {args.steps} chained steps, {card}")
    print(json.dumps({"card": card, "path": args.path,
                      "samples": args.samples, "a": args.a, "m": args.m,
                      "r": args.r, "variants": variants, "runs": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
