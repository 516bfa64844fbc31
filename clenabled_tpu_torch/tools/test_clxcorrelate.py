"""Correlator benchmark on the card — the port of the reference's
test-clxcorrelate (lib/test-clxcorrelate.cc) as
``clenabled_tpu.tools.test_clxcorrelate`` has it: times the time-domain
lag scan (``--batch`` windows a call) and the frequency-domain correlator
(one vector a call and ``--fft-batch`` vectors a call), and reports
samples/s and GB/s in, as the reference does (:74, :216).

    python -m clenabled_tpu_torch.tools.test_clxcorrelate --batch 64

``--planar`` runs the complex-free forms (``td_xcorr_planar_batched`` on
float magnitudes, ``fd_xcorr_planar``); ``--input_complex`` feeds the TD
scan complex64 windows; ``--fftonly`` skips the TD scan; ``--block-api``
drives the FD correlator through ``blocks.XCorrelateFFTVCF`` in a
``Flowgraph`` ``Runner`` with ``--steps-per-dispatch`` frames a call.
Times come from CUDA events around ``--iterations`` back-to-back calls
after two warm-up calls, on the first CUDA card, with the card's name and
power limit printed beside them; ``--cpu`` runs on the CPU (wall clock).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="cross-correlator benchmark")
    ap.add_argument("--num_inputs", type=int, default=2)
    ap.add_argument("--signal_length", type=int, default=8192)
    ap.add_argument("--maxsearch", type=int, default=512)
    ap.add_argument("--input_complex", action="store_true")
    ap.add_argument("--fftonly", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the first CUDA card")
    ap.add_argument("--planar", action="store_true",
                    help="the complex-free float32 forms")
    ap.add_argument("--batch", type=int, default=1,
                    help="analysis windows a call of the TD scan")
    ap.add_argument("--fft-batch", dest="fft_batch", type=int, default=64,
                    help="FFT vectors a call of the FD correlator")
    ap.add_argument("--block-api", dest="block_api", action="store_true",
                    help="drive the FD correlator through the block layer "
                    "(XCorrelateFFTVCF in a Flowgraph Runner)")
    ap.add_argument("--steps-per-dispatch", dest="steps_per_dispatch",
                    default="auto",
                    help="with --block-api: frames a Runner call (an int or "
                    "'auto')")
    ap.add_argument("--iterations", type=int, default=100)
    return ap.parse_args(argv)


def _seconds(fn, iterations: int, dev: torch.device) -> float:
    """Mean seconds a call of ``fn``: CUDA events around back-to-back
    calls on a card, the wall clock on the CPU; two warm-up calls first."""
    for _ in range(2):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iterations):
            fn()
        return (time.perf_counter() - t0) / iterations
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iterations / 1e3


def report(name: str, samples: int, secs: float, nbytes: int) -> dict:
    print(f"{name:<34s} {samples / secs / 1e6:>12.3f} Msps   "
          f"({secs * 1e6:10.1f} us/call, {nbytes / secs / 1e9:.2f} GB/s in)",
          flush=True)
    return {"msps": samples / secs / 1e6, "us_per_call": secs * 1e6,
            "gbps_in": nbytes / secs / 1e9}


def _rand(rng, shape, complex_: bool) -> np.ndarray:
    x = rng.standard_normal(shape).astype(np.float32)
    if complex_:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("test_clxcorrelate times on a CUDA card; none is "
                         "visible (--cpu runs on the CPU)")
    from clenabled_tpu_torch.dsp import planar, xcorr

    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    if dev.type == "cuda":
        from clenabled_tpu_torch.runtime.device import card_info
        where = card_info()
    else:
        where = "cpu"
    n, k, it = args.signal_length, args.num_inputs, args.iterations
    print(f"device: {where}   inputs: {k}   signal_length: {n}   "
          f"max_search: {args.maxsearch}", flush=True)
    rng = np.random.default_rng(0)
    results = {}
    if args.block_api:
        results["block"] = _block_api_bench(args, dev, rng)
        return results

    b = max(1, args.batch)
    if not args.fftonly:
        complex_in = args.input_complex and not args.planar
        sigs = torch.from_numpy(_rand(rng, (k, b, n), complex_in)).to(dev)
        if args.planar:
            fn = lambda: xcorr.td_xcorr_planar_batched(sigs, args.maxsearch)
        else:
            fn = lambda: xcorr.td_xcorr_batched(sigs, args.maxsearch)
        total = n * k * b
        results["td"] = report(
            f"TD xcorr (batch {b}{', planar' if args.planar else ''})",
            total, _seconds(fn, it, dev), total * sigs.element_size())

    for fb in (1, args.fft_batch):
        if args.planar:
            v = planar.PC(*(torch.from_numpy(_rand(rng, (k, fb, n), False))
                            .to(dev) for _ in range(2)))
            fn = lambda v=v: xcorr.fd_xcorr_planar(v)
        else:
            v = torch.from_numpy(_rand(rng, (k, fb, n), True)).to(dev)
            fn = lambda v=v: xcorr.fd_xcorr(v)
        total = n * k * fb
        results[f"fd {fb}"] = report(f"FD xcorr (fft_vcf, batch {fb})",
                                     total, _seconds(fn, it, dev), total * 8)
    return results


def _block_api_bench(args, dev: torch.device, rng) -> dict:
    """The FD correlator through the block layer: XCorrelateFFTVCF in a
    Flowgraph Runner, K frames a Runner call (the reference's GR-scheduler
    shape; its UHD example sustains 30 MSPS at this 8192-point default,
    examples/fft_xcorr_opencl_uhd2_30MSPS.grc)."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.streaming import Flowgraph

    n, k = args.signal_length, args.num_inputs
    spd = args.steps_per_dispatch
    if spd != "auto":
        spd = int(spd)
    g = Flowgraph()
    xc = blocks.XCorrelateFFTVCF(n, k, accumulate_frames=1)
    for p in range(k):
        g.external_input(xc, p)
    g.tap(xc, name="corr")
    r = g.compile(frame_size=n, steps_per_dispatch=spd, device=dev)
    kk = r.steps_per_dispatch
    shape = (kk, n) if kk > 1 else (n,)
    feeds = tuple(planar.PC(*(torch.from_numpy(_rand(rng, shape, False))
                              .to(dev) for _ in range(2)))
                  for _ in range(k))
    secs = _seconds(lambda: r.step(*feeds), max(4, args.iterations // 10),
                    dev)
    return report(f"FD xcorr BLOCK API (K={kk})", kk * n, secs,
                  kk * n * 8 * k)


if __name__ == "__main__":
    main()
