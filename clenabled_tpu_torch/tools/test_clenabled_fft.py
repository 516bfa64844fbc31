"""FFT benchmark on the card — the port of the reference's
test-clenabled-fft (lib/test-clenabled-fft.cc) as
``clenabled_tpu.tools.test_clenabled_fft`` has it: FFT timing with the
shift, window, direction and stream options.

    python -m clenabled_tpu_torch.tools.test_clenabled_fft 2097152 \\
        --fft-size 2048 --window --fft-shift

Planar streams go through ``dsp.fft.fft_stream_planar``: the hand-written
FFT kernel (``hopper_kernels.fft_batched_fused``) for sizes its envelope
covers (256 to 16384 points), the two-stage planar DFT otherwise;
``--plain`` pins the plain form, ``--complex`` times the complex64 form
(``torch.fft``).  Each configuration runs ``--iterations`` back-to-back
calls after two warm-up calls, timed with CUDA events on the first CUDA
device; the card's name and power limit are printed beside the times.
Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="FFT benchmark")
    ap.add_argument("blocksize", nargs="?", type=int, default=1 << 18)
    ap.add_argument("--fft-size", type=int, default=2048)
    ap.add_argument("--fft-shift", action="store_true")
    ap.add_argument("--fft-num-streams", type=int, default=1)
    ap.add_argument("--reverse", action="store_true")
    ap.add_argument("--window", action="store_true",
                    help="apply a Blackman-Harris window")
    ap.add_argument("--plain", action="store_true",
                    help="pin the two-stage planar DFT (no kernel)")
    ap.add_argument("--complex", action="store_true",
                    help="time the complex64 form (torch.fft)")
    ap.add_argument("--iterations", type=int, default=100)
    return ap.parse_args(argv)


def time_call(fn, iterations: int) -> float:
    """Mean seconds per call: CUDA events around back-to-back calls after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iterations / 1e3


def main(argv=None) -> None:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("test_clenabled_fft times on a CUDA card; none is "
                         "visible")
    from clenabled_tpu_torch.dsp import fft as dsp_fft
    from clenabled_tpu_torch.dsp import planar, window
    from clenabled_tpu_torch.runtime.device import card_info

    dev = torch.device("cuda", 0)
    size = args.fft_size
    n = max(1, args.blocksize // size) * size
    streams = args.fft_num_streams
    direction = dsp_fft.REVERSE if args.reverse else dsp_fft.FORWARD
    win = (torch.as_tensor(window.blackman_harris(size), device=dev)
           if args.window else None)
    mode = ("complex64 torch.fft" if args.complex else
            "planar, plain" if args.plain else "planar, kernel")
    print(f"card: {card_info()}   fft_size: {size}  block: {n}  streams: "
          f"{streams}  shift: {args.fft_shift}  window: {args.window}  dir: "
          f"{'rev' if args.reverse else 'fwd'}  mode: {mode}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xs = [torch.randn((2, n), generator=gen, device=dev) for _ in range(streams)]
    if args.complex:
        cs = [torch.complex(x[0], x[1]) for x in xs]

        def call():
            for c in cs:
                dsp_fft.fft_stream(c, size, direction=direction, window=win,
                                   shift=args.fft_shift)
    else:
        pcs = [planar.PC(x[0], x[1]) for x in xs]

        def call():
            for pc in pcs:
                dsp_fft.fft_stream_planar(pc, size, direction=direction,
                                          window=win, shift=args.fft_shift,
                                          use_pallas=not args.plain)

    secs = time_call(call, args.iterations)
    total = n * streams
    print(f"fft {size}: {total / secs / 1e6:.1f} Msps   ({secs * 1e3:.4f} ms "
          f"per call, {total // size} transforms/call)")


if __name__ == "__main__":
    main()
