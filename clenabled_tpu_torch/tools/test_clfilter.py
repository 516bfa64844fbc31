"""Filter benchmark on the card — the port of the reference's test-clfilter
(lib/test-clfilter.cc) as ``clenabled_tpu.tools.test_clfilter --planar``
has it: time-domain FIR against frequency-domain filter throughput for a
given --ntaps (an RRC design, 241 taps by default), on planar frames.

    python -m clenabled_tpu_torch.tools.test_clfilter --ntaps 241 \\
        --blocksize 2097152

The time-domain filter is ``fir_filter.make_fir_filter_planar`` (the
``fir_direct`` kernel), the frequency-domain one
``fft_filter.make_fft_filter_planar(fused=True)`` (the overlap-save
kernel); ``chip_smoke.py`` times both against their plain forms.  Each
streams its carried state through ``--iterations`` back-to-back calls
after two warm-up calls, timed with CUDA events on the first CUDA device;
the card's name and power limit are printed beside the times.  Without a
card it exits non-zero.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="FIR vs FFT filter benchmark")
    ap.add_argument("--ntaps", type=int, default=241)
    ap.add_argument("--blocksize", type=int, default=1 << 18)
    ap.add_argument("--decimation", type=int, default=1)
    ap.add_argument("--iterations", type=int, default=100)
    return ap.parse_args(argv)


def time_stateful(apply, state, frame, iterations: int) -> float:
    """Mean seconds per call of ``apply`` with the state carried: CUDA
    events around back-to-back calls after two warm-up calls."""
    for _ in range(2):
        state, _ = apply(state, frame)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        state, _ = apply(state, frame)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iterations / 1e3


def report(name: str, n: int, secs: float) -> None:
    print(f"{name}: {n / secs / 1e6:.1f} Msps   ({secs * 1e3:.4f} ms per "
          f"{n}-sample block)")


def main(argv=None) -> None:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("test_clfilter times on a CUDA card; none is visible")
    from clenabled_tpu_torch.dsp import fft_filter, fir_filter, firdes, planar
    from clenabled_tpu_torch.runtime.device import card_info

    dev = torch.device("cuda", 0)
    d = args.decimation
    taps = firdes.root_raised_cosine(1.0, 10e6, 10e6 / (args.ntaps / 11 + 2),
                                     0.22, args.ntaps)
    print(f"card: {card_info()}   ntaps: {len(taps)}   blocksize: "
          f"{args.blocksize}   decim: {d}")

    def frame(n):
        return planar.PC(*torch.randn((2, n), device=dev))

    def on_card(state):
        return tuple(s.to(dev) for s in state)

    n = max(d, args.blocksize - args.blocksize % d)
    fini, fapp = fir_filter.make_fir_filter_planar(taps, d)
    fr = frame(n)
    report("time-domain FIR (fir_direct kernel)", n,
           time_stateful(fapp, on_card(fini()), fr, args.iterations))

    oini, oapp, plan = fft_filter.make_fft_filter_planar(taps, d, fused=True)
    q = fft_filter.frame_quantum(plan)
    n2 = max(1, args.blocksize // q) * q
    fr2 = frame(n2)
    report(f"freq-domain OFS (ofs_filter kernel, fft {plan.fft_size})", n2,
           time_stateful(oapp, on_card(oini()), fr2, args.iterations))


if __name__ == "__main__":
    main()
