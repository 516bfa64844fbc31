"""Tiny CPU forms of the cells, for the benchmark's own tests.

A run on the CPU skips the look for a card and drives the rest of a run:
set-up, window, comparison, at sizes a test can hold.  Each
configuration's file gives its sizes for this under ``tiny`` (a traffic
file may too); they keep the cell's structure (a ring, chained tails,
every pol product) and cut only its scale.  ``CpuCard`` stands in for the
card: the same calls, run synchronously.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark import harness
from benchmark.card import Card

SEED = (1 << 31) + 977


class _Done:
    """An event on the CPU: done once recorded, at the host clock's time."""

    t = 0.0

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class CpuCard(Card):
    def __init__(self):
        super().__init__("cpu")

    def sync(self) -> None:
        pass

    def event(self, timing: bool = False):
        return _Done()

    def stream(self):
        return None

    def on(self, stream):
        return contextlib.nullcontext()

    def hand_over(self, stream, tensors) -> None:
        pass

    def host_empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype)

    def free_cache(self) -> None:
        pass

    def profiled(self) -> list:
        return [torch.profiler.ProfilerActivity.CPU]

    def peak_bytes(self) -> int:
        return 0

    def describe(self) -> dict:
        return {"platform": "cpu", "kind": "cpu", "count": 1}


def tiny_cell(workload: str, spec=None, root=harness.REPO):
    """The cell ``workload`` at the sizes of its files' ``tiny`` entries;
    a configuration without them is refused, never run at full size."""
    cell = harness.find_cell(spec or harness.load_spec(), workload, root)
    if "tiny" not in cell.config:
        raise KeyError(f"configuration {cell.config['name']!r} gives no "
                       f"'tiny' sizes for a CPU run")
    cell.config.update(cell.config["tiny"])
    cell.traffic.update(cell.traffic.get("tiny", {}))
    return cell


def tiny_run(workload: str, trace: bool = False, seconds: float = 0.3,
             spec=None, root=harness.REPO, seed: int = SEED) -> dict:
    return harness.run(tiny_cell(workload, spec, root), seed, seconds, trace,
                       CpuCard(), time.perf_counter())
