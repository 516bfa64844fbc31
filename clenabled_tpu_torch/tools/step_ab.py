"""The planar step's device busy time and wall time for checkouts of the
package, timed in turns on the card.

    python -m clenabled_tpu_torch.tools.step_ab [name=ROOT ...] \\
        [--samples 131072] [--a 4] [--m 16] [--steps 3] [--reps 30] \\
        [--rounds 2]

Each ROOT is a directory holding a ``clenabled_tpu_torch`` package, such as
an earlier commit's tree unpacked with ``git archive <commit> | tar -x -C
_local/parent``; by default ``tree=`` the root of the package that runs
this tool.  Each variant runs in a process of its own with ROOT first on
``sys.path``, so that it builds and calls that tree's kernels; the variants
run in the order given, then backward, for ``--rounds`` rounds.  A process
makes the planar step (``pipelines.make_fx_pipeline_planar``) for ``--a``
antennas of ``--samples`` samples and ``--m`` channels and ``--steps``
frames from a seeded generator, runs the chained steps once to warm them,
then times ``--reps`` chains on the host's clock (wall per step: least and
median) and five chains under ``torch.profiler`` (device busy per step: the
sum of the device events' times, and the packed PFB kernel's part).  Prints
a line per process, the card's name and power limit, and one JSON line.
Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
BUSY_CHAINS = 5


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="planar step A/B across trees")
    ap.add_argument("variants", nargs="*", metavar="name=ROOT")
    ap.add_argument("--samples", type=int, default=1 << 17)
    ap.add_argument("--a", type=int, default=4)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", metavar="ROOT", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def child(args) -> dict:
    """One tree's planar step, timed in this process."""
    sys.path[0] = str(Path(args.child).resolve())
    import torch

    from clenabled_tpu_torch import pipelines as P
    from clenabled_tpu_torch.runtime.device import _device_events

    dev = torch.device("cuda", 0)
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

    chain()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        chain()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / args.steps * 1e3)
    _, window = _device_events(
        lambda: [chain() for _ in range(BUSY_CHAINS)],
        BUSY_CHAINS * args.steps, 3)
    per = BUSY_CHAINS * args.steps * 1e3
    pfb = [(n, us) for n, us in window if "pfb_packed" in n]
    return {"root": args.child,
            "busy_ms": sum(us for _, us in window) / per,
            "pfb_ms": sum(us for _, us in pfb) / per,
            "pfb_kernels": sorted({"pfb_packed_reg_kernel"
                                   if "pfb_packed_reg_kernel" in n
                                   else "pfb_packed_kernel" for n, _ in pfb}),
            "wall_min_ms": min(walls),
            "wall_median_ms": statistics.median(walls)}


def run(root: str, args) -> dict:
    """``child`` in a process of its own on the tree at ``root``."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", root,
           "--samples", str(args.samples), "--a", str(args.a), "--m",
           str(args.m), "--steps", str(args.steps), "--reps", str(args.reps)]
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
                print(f"{name}: busy {r['busy_ms']:.4f} ms a step (packed "
                      f"PFB {r['pfb_ms']:.4f} on {r['pfb_kernels']}), wall "
                      f"least {r['wall_min_ms']:.4f} median "
                      f"{r['wall_median_ms']:.4f} ms a step", flush=True)
    card = card_info()
    print(f"planar step {args.a} x {args.samples}, M = {args.m}, "
          f"{args.steps} chained steps, {card}")
    print(json.dumps({"card": card, "samples": args.samples, "a": args.a,
                      "m": args.m, "variants": variants, "runs": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
