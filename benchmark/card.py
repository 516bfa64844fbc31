"""The card a run measures, and what it says about itself.

The drivers record events, copy on a side stream into pinned host memory
and wait on events through a ``Card``.  The card's name, clocks and power
limit come from ``torch.cuda`` and ``nvidia-smi`` (a copy of the
program's ``runtime.device._smi_clocks``).  The benchmark's CPU tests give
the drivers a stand-in of their own with the same methods.
"""

from __future__ import annotations

import subprocess

import torch


class Card:
    def __init__(self, device="cuda:0"):
        self.device = torch.device(device)

    def sync(self) -> None:
        torch.cuda.synchronize(self.device)

    def event(self, timing: bool = False):
        """An event; ``timing`` ones give ``elapsed_time`` in ms."""
        return torch.cuda.Event(enable_timing=timing)

    def stream(self):
        return torch.cuda.Stream(self.device)

    def on(self, stream):
        """Make ``stream`` current."""
        return torch.cuda.stream(stream)

    def hand_over(self, stream, tensors) -> None:
        """Let ``stream`` start after the current stream's work so far, and
        keep ``tensors`` alive until ``stream`` is done with them."""
        ready = torch.cuda.Event()
        ready.record()
        stream.wait_event(ready)
        for t in tensors:
            t.record_stream(stream)

    def generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed % (1 << 63))
        return g

    def host_empty(self, shape, dtype) -> torch.Tensor:
        """Pinned host memory a card copies into."""
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def free_cache(self) -> None:
        torch.cuda.empty_cache()

    def profiled(self) -> list:
        """What ``torch.profiler`` records: the CUDA activity alone."""
        return [torch.profiler.ProfilerActivity.CUDA]

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device))

    def describe(self) -> dict:
        """The result line's ``device`` entry: platform, name, cards used,
        power limit (W) and clocks where ``nvidia-smi`` reads them."""
        index = self.device.index or 0
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(index),
               "count": 1}
        smi = smi_clocks()
        if index < len(smi):
            out.update(smi[index])
        return out


def smi_clocks() -> list[dict]:
    """Per card: SM and memory clocks (current and maximum, MHz) and the
    power limit (W), from ``nvidia-smi``; empty when it cannot be run."""
    keys = ("clocks.sm", "clocks.max.sm", "clocks.mem", "power.limit")
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    rows = []
    for line in res.stdout.strip().splitlines():
        vals = [v.strip() for v in line.split(",")]
        rows.append({k.replace(".", "_"): _number(v)
                     for k, v in zip(keys, vals)})
    return rows


def _number(text: str):
    try:
        return float(text)
    except ValueError:
        return None
