"""The shared part of the kernel-variant tools (``fx_ab``, ``costas_ab``,
``gram_ab``): each variant's sources are built into a library of their own,
and the variants' calls are timed in turns on the card.

A tool gives its variants as sources and ``nvcc`` flags, the C entry each
library exports, and what of the ptxas output to keep; it makes its own
calls, checks them against its plain form and prints its own table.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
from pathlib import Path

import torch

from clenabled_tpu_torch import _build


def arg_parser(description: str, dest: str, metavar: str
               ) -> argparse.ArgumentParser:
    """A tool's parser: its variants (positional, into ``dest``), then
    ``--rounds`` and ``--calls`` of the timing."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument(dest, nargs="*", metavar=metavar)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--calls", type=int, default=10)
    return ap


def have_card(tool: str) -> bool:
    """Whether a CUDA device is there; says so on stderr if not."""
    if torch.cuda.is_available():
        return True
    print(f"{tool}: no CUDA device", file=sys.stderr)
    return False


def build(variants: dict[str, tuple[list[Path], list[str]]], out_dir: Path,
          entry: str, keep: tuple[str, ...]) -> tuple[dict, dict]:
    """Compile each variant's (sources, extra nvcc flags) into a library of
    its own, one ``nvcc -Xptxas -v`` each, all started together, and print
    the ptxas lines that hold any of ``keep``.  Returns the loaded
    libraries, ``entry`` typed by its signature in ``_build``, and each
    one's kept ptxas lines."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    libs = {name: out_dir / f"{name}.so" for name in variants}
    done = _build._run_all([
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags, "-shared", "-o",
         str(libs[name]), *map(str, srcs)]
        for name, (srcs, flags) in variants.items()])
    argtypes, restype = _build._SIGNATURES[entry]
    loaded, ptxas = {}, {}
    for name, proc in zip(variants, done):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        lib = ctypes.CDLL(str(libs[name]))
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, restype
        loaded[name] = lib
        ptxas[name] = [ln.strip() for ln in (proc.stdout + proc.stderr)
                       .splitlines() if any(k in ln for k in keep)]
        for ln in ptxas[name]:
            print(f"[ptxas {name}] {ln}")
    return loaded, ptxas


def per_call_ms(fn, calls: int) -> float:
    """Per-call time of ``calls`` back-to-back calls, CUDA events around
    them all."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def time_in_turns(fns: dict, rounds: int, calls: int) -> dict[str, dict]:
    """The least, median and largest per-call ms of each named call, the
    calls taken in turns (forward, then backward) for ``rounds`` rounds."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            times[name].append(per_call_ms(fns[name], calls))
    return {name: {"min": min(ts), "median": statistics.median(ts),
                   "max": max(ts)} for name, ts in times.items()}


def ms_cell(t: dict) -> str:
    """'min / median / max' of one ``time_in_turns`` entry."""
    return f"{t['min']:.4f} / {t['median']:.4f} / {t['max']:.4f}"
