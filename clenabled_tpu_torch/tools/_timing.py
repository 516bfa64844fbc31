"""Shared timing and platform helpers for the benchmark CLIs.

The port of ``clenabled_tpu.tools._timing``.  The reference times N
iterations with std::chrono around each work() call
(lib/test_clenabled.cc:151-200).  On the card two modes:

* chained (the default): CUDA events around ``iterations`` back-to-back
  calls after two warm-up calls, one synchronise at the end: the rate a
  stream of calls sustains;
* per call (``--percall``): a synchronise after every call, the host clock
  around each: the reference's style, launch latency included.

With ``--cpu`` the host clock times the calls on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def add_device_args(ap) -> None:
    """``--cpu`` and ``--percall``, shared by the tools."""
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA card)")
    ap.add_argument("--percall", action="store_true",
                    help="synchronise after every call (the reference's "
                         "style); default: chained calls timed with CUDA "
                         "events")


def select_device(args) -> torch.device:
    """``cpu`` for ``--cpu``, else ``cuda:0`` (raises without a card)."""
    from clenabled_tpu_torch.runtime.device import get_device

    return get_device("cpu" if getattr(args, "cpu", False) else "cuda")


def platform_banner(device: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or the CPU's
    thread count."""
    if device.type == "cuda":
        from clenabled_tpu_torch.runtime.device import card_info

        return f"cuda: {card_info()} x{torch.cuda.device_count()}"
    return f"cpu: {torch.get_num_threads()} threads"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_calls(call, iterations: int, device: torch.device,
                percall: bool) -> float:
    """Seconds a call of ``call()`` (after two warm-up calls)."""
    for _ in range(2):
        call()
    _sync(device)
    if percall or device.type != "cuda":
        total = 0.0
        for _ in range(iterations):
            t0 = time.perf_counter()
            call()
            _sync(device)
            total += time.perf_counter() - t0
        return max(total / iterations, 1e-9)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        call()
    end.record()
    end.synchronize()
    return max(start.elapsed_time(end) / iterations / 1e3, 1e-9)


def time_fn(fn, *args, iterations: int = 200, device=None,
            percall: bool = False) -> float:
    """Seconds per call of ``fn(*args)``."""
    dev = torch.device(device or "cuda")
    return _time_calls(lambda: fn(*args), iterations, dev, percall)


def time_stateful(fn, state, *args, iterations: int = 200, device=None,
                  percall: bool = False) -> float:
    """Like :func:`time_fn` for ``(state, *args) -> (state, out)``
    streaming functions: the carried state chains the calls."""
    dev = torch.device(device or "cuda")
    box = [state]

    def call():
        box[0] = fn(box[0], *args)[0]

    return _time_calls(call, iterations, dev, percall)


def rand_complex(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


def rand_float(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def report(name: str, block_size: int, secs: float, extra: str = "") -> dict:
    """Print one row; return it as a record."""
    sps = block_size / secs
    print(f"{name:<40s} {sps / 1e6:>12.3f} Msps   ({secs * 1e6:10.2f} us/call"
          f"{', ' + extra if extra else ''})", flush=True)
    return {"name": name, "samples": block_size, "seconds": secs,
            "msps": sps / 1e6}
