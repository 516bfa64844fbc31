"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m benchmark.run --workload fx4x16.f32.resident --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for: set-up (the program's entry built, its kernels and Python's
bytecode cache built on the first run of a checkout and loaded after,
the inputs made on the card from ``--seed``, the cell's shapes warmed
up), then the window of
``--seconds``, then the comparison with the plain reference.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``checks`` last: each number compared beside its limit); the checks
are also the last lines of standard error.  With ``--trace 0`` the
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profiled sub-window.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
2 and prints no result; if JAX or the JAX package is loaded once the
window, the comparison and the per-layer readers are done, it exits 1
and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark.harness import REPO, find_cell, load_spec, run  # noqa: E402

# every cache a library would keep goes under the checkout, at fixed paths
CACHE = REPO / ".bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]

    # Python's bytecode cache, under the checkout at a fixed path: where
    # none may be written beside the sources (PYTHONDONTWRITEBYTECODE, a
    # read-only site-packages), every run would compile torch's sources
    # anew, seconds of CPU that a busy host stretches.  Only a
    # checkout's first run writes it.
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    # no collector passes while the imports make their objects, which
    # none of them frees; the harness collects once and turns it back on
    # before the window
    gc.disable()
    t_torch = time.perf_counter()
    import torch

    t_check = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    print(f"start_parts spec {t_torch - STARTED:.3f} "
          f"import_torch {t_check - t_torch:.3f} "
          f"cuda_check {time.perf_counter() - t_check:.3f}", file=sys.stderr)
    from benchmark.card import Card

    out = run(find_cell(spec, args.workload), args.seed, args.seconds,
              bool(args.trace), Card("cuda:0"), STARTED)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
