"""X-Engine benchmark on the card — the port of the reference's
test-clxengine (lib/test-clxengine.cc) as ``clenabled_tpu.tools.
test_clxengine`` has it: total and per-station complex samples/s, input
bits/s "comparable to xGPU" (:297-300) and TFLOP/s in xGPU counting (a
cxmac is 8 real operations per baseline, pol product and sample).

    python -m clenabled_tpu_torch.tools.test_clxengine --int8 \\
        --num_inputs 64 --integration-time 8192        # 256 channels

Times are CUDA events around ``--iterations`` back-to-back calls after two
warm-up calls, on the first CUDA device; the card's name and power limit
are printed beside them.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="X-Engine benchmark")
    ap.add_argument("channels", nargs="?", type=int, default=256)
    ap.add_argument("--num_inputs", type=int, default=16)
    ap.add_argument("--integration-time", dest="integration", type=int,
                    default=1024)
    ap.add_argument("--single-polarization", dest="single_pol",
                    action="store_true")
    ap.add_argument("--planar", action="store_true",
                    help="complex-free float32 time-major path")
    ap.add_argument("--channel-major", dest="channel_major",
                    action="store_true",
                    help="[F, T, S·P] marshal, four real batched products")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 Gram operands, f32 sums (exact for <=8-bit "
                    "quantized streams)")
    ap.add_argument("--no-kernel", dest="no_kernel", action="store_true",
                    help="with --stacked/--int8: force the batched-product "
                    "path instead of the Gram kernel")
    ap.add_argument("--stacked", action="store_true",
                    help="single stacked Gram (channel-major)")
    ap.add_argument("--int8", action="store_true",
                    help="raw IChar int8 operands, exact integer sums "
                    "(implies --stacked)")
    ap.add_argument("--iterations", type=int, default=50)
    return ap.parse_args(argv)


def build_case(args: argparse.Namespace, device):
    """(fn, label): a no-argument call of the chosen engine on inputs made
    on ``device`` from seed 0."""
    from clenabled_tpu_torch.dsp import planar, xengine

    s, f, t = args.num_inputs, args.channels, args.integration
    p = 1 if args.single_pol else 2
    rng = np.random.default_rng(0)

    def on(arr, dtype):
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    if args.stacked or args.int8:
        q = rng.integers(-127, 128, (2, f, t, s * p))
        if args.int8:
            dt, scale = torch.int8, 1.0 / (127.0 * 127.0)
        else:
            dt, scale = (torch.bfloat16 if args.bf16 else torch.float32), 1.0
        zr, zi = on(q[0], dt), on(q[1], dt)
        use = False if args.no_kernel else None
        return (lambda: xengine.xengine_correlate_stacked(
            zr, zi, npol=p, scale=scale, use_kernel=use)), f"stacked {dt}"
    if args.channel_major:
        dt = torch.bfloat16 if args.bf16 else torch.float32
        zr = on(rng.integers(-127, 128, (f, t, s * p)), dt)
        zi = on(rng.integers(-127, 128, (f, t, s * p)), dt)
        cd = torch.bfloat16 if args.bf16 else None
        return (lambda: xengine.xengine_correlate_channel_major(
            zr, zi, npol=p, compute_dtype=cd)), f"channel-major {dt}"
    if args.planar:
        zr = on(rng.standard_normal((t, s, f, p)), torch.float32)
        zi = on(rng.standard_normal((t, s, f, p)), torch.float32)
        return (lambda: xengine.xengine_correlate_planar(
            planar.PC(zr, zi), npol=p)), "planar float32"
    z = on(rng.standard_normal((t, s, f, p))
           + 1j * rng.standard_normal((t, s, f, p)), torch.complex64)
    return (lambda: xengine.xengine_correlate(z, npol=p)), "complex64"


def time_cuda(fn, iterations: int) -> float:
    """Mean seconds per call: CUDA events around back-to-back calls."""
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
        raise SystemExit("test_clxengine times on a CUDA card; none is "
                         "visible")
    from clenabled_tpu_torch.dsp import xengine
    from clenabled_tpu_torch.runtime.device import card_info

    torch.backends.cuda.matmul.allow_tf32 = False
    s, f, t = args.num_inputs, args.channels, args.integration
    p = 1 if args.single_pol else 2
    nb = xengine.num_baselines(s)
    fn, label = build_case(args, torch.device("cuda", 0))
    print(f"card: {card_info()}   engine: {label}   stations: {s}  pols: {p}"
          f"  channels: {f}  integration: {t}  baselines: {nb}")
    secs = time_cuda(fn, args.iterations)
    samples = t * f  # per-station complex samples per integration
    total = samples * s
    in_bps = total * 8 * 8 / secs  # complex64 input bits/s
    print(f"total: {total / secs / 1e6:.1f} Msps   per-station: "
          f"{samples / secs / 1e6:.2f} Msps   input: {in_bps / 1e9:.1f} Gbps"
          f"   ({secs * 1e3:.4f} ms per integration)")
    flops = 8.0 * t * f * nb * p * p  # cxmac = 8 real ops
    print(f"correlator compute: {flops / secs / 1e12:.2f} TFLOP/s")


if __name__ == "__main__":
    main()
