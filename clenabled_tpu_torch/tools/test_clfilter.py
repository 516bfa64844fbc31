"""Filter benchmark — the port of the reference's test-clfilter
(lib/test-clfilter.cc) as ``clenabled_tpu.tools.test_clfilter`` has it:
time-domain FIR against frequency-domain filter throughput for a given
--ntaps (an RRC design, 241 taps by default).

    python -m clenabled_tpu_torch.tools.test_clfilter --ntaps 241 \\
        --blocksize 2097152 [--planar] [--percall] [--cpu]

The time-domain filter is ``fir_filter.make_fir_filter_planar`` (the
``fir_direct`` kernel), the frequency-domain one
``fft_filter.make_fft_filter_planar(fused=True)`` (the overlap-save
kernel); ``chip_smoke.py`` times both against their plain forms.  By
default the frames are complex64, as in the JAX tool, and each call splits
its frame into planar components for the kernel and joins the output
again; ``--planar`` feeds planar frames.  Each filter streams its carried
state through ``--iterations`` calls after two warm-up calls, timed as in
``tools/_timing`` (chained under CUDA events, or a synchronise a call with
``--percall``); the card's name and power limit are printed beside the
times.  Without a card it exits non-zero unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None) -> argparse.Namespace:
    from clenabled_tpu_torch.tools import _timing as T

    ap = argparse.ArgumentParser(description="FIR vs FFT filter benchmark")
    ap.add_argument("--ntaps", type=int, default=241)
    ap.add_argument("--blocksize", type=int, default=1 << 18)
    ap.add_argument("--decimation", type=int, default=1)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--planar", action="store_true",
                    help="planar float32 (re, im) frames")
    T.add_device_args(ap)
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    from clenabled_tpu_torch.dsp import fft_filter, fir_filter, firdes, planar
    from clenabled_tpu_torch.tools import _timing as T

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("test_clfilter times on a CUDA card; none is "
                         "visible (--cpu runs it on the CPU)")
    dev = T.select_device(args)
    d = args.decimation
    taps = firdes.root_raised_cosine(1.0, 10e6, 10e6 / (args.ntaps / 11 + 2),
                                     0.22, args.ntaps)
    print(f"platform: {T.platform_banner(dev)}   ntaps: {len(taps)}   "
          f"blocksize: {args.blocksize}   decim: {d}   "
          f"{'planar' if args.planar else 'complex64'}   timing: "
          f"{'per-call' if args.percall else 'chained'}", flush=True)

    def frame(n, seed):
        if args.planar:
            return planar.PC(torch.from_numpy(T.rand_float(n, seed)).to(dev),
                             torch.from_numpy(T.rand_float(n, seed + 1))
                             .to(dev))
        return torch.from_numpy(T.rand_complex(n, seed)).to(dev)

    def streamed(apply):
        if args.planar:
            return apply

        def on_complex(state, x):
            state, y = apply(state, planar.PC(x.real.contiguous(),
                                              x.imag.contiguous()))
            return state, planar.to_complex(y)

        return on_complex

    def on_card(state):
        return tuple(s.to(dev) for s in state)

    rows = []
    n = max(d, args.blocksize - args.blocksize % d)
    fini, fapp = fir_filter.make_fir_filter_planar(taps, d)
    rows.append(T.report(
        "time-domain FIR (fir_direct kernel)", n,
        T.time_stateful(streamed(fapp), on_card(fini()), frame(n, 1),
                        iterations=args.iterations, device=dev,
                        percall=args.percall)))

    oini, oapp, plan = fft_filter.make_fft_filter_planar(taps, d, fused=True)
    q = fft_filter.frame_quantum(plan)
    n2 = max(1, args.blocksize // q) * q
    rows.append(T.report(
        f"freq-domain OFS (ofs_filter kernel, fft {plan.fft_size})", n2,
        T.time_stateful(streamed(oapp), on_card(oini()), frame(n2, 3),
                        iterations=args.iterations, device=dev,
                        percall=args.percall)))
    return rows


if __name__ == "__main__":
    main()
