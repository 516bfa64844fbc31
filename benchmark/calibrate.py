"""The readings a cell's limits are set from: the program's numbers over a
dozen seeds or more and the control's over three or more, in one process.

    python3 -m benchmark.calibrate --workload fx4x16.f32.resident \\
        --seeds 11,12,...,22 --control-seeds 31,32,33 --seconds 2 \\
        --out chiprun_out/calibrate.fx4x16.f32.resident.json

Each program seed is a run (``harness.run``) with a short window at the
cell's own load; each control seed is a run with ``control``, in which
the reference's answers computed one precision below the configuration's
(``Driver.control``) take the program's place.
Prints, and writes to ``--out``, every reading, the largest reading of
each number over the program's seeds (the lower reading) and the smallest
over the control's (the upper).  Benchmark runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

from benchmark.harness import find_cell, load_spec, run


def readings(cell, seeds, control: bool, seconds: float, card) -> dict:
    """{seed: {number: value, "failed": n}}: the numbers a run's
    comparison gives (``harness.run``), or its control's."""
    out = {}
    for seed in seeds:
        res = run(cell, seed, seconds, False, card, time.perf_counter(),
                  control=control)
        numbers = {n: c["value"] for n, c in res["checks"].items()}
        out[str(seed)] = dict(numbers, failed=res["failed"])
        print(("control" if control else "program"), seed, out[str(seed)],
              flush=True)
        gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.card import Card

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    card = Card("cuda:0")
    cell = find_cell(load_spec(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",")]
    prog = readings(cell, seeds, False, args.seconds, card)
    ctrl = readings(cell, cseeds, True, args.seconds, card)
    names = [n for n in next(iter(prog.values())) if n != "failed"]
    res = {"workload": args.workload, "device": card.describe(),
           "program": prog, "control": ctrl,
           "lower": {n: max(r[n] for r in prog.values()) for n in names},
           "upper": {n: min(r[n] for r in ctrl.values()) for n in names}}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
