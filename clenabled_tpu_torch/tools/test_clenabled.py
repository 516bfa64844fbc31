"""Block-by-block throughput benchmark — the reference's test-clenabled
(lib/test_clenabled.cc): samples/s for every block class at a positional
blocksize, on the first CUDA card (``--cpu``: the CPU).

    python -m clenabled_tpu_torch.tools.test_clenabled 2097152 \\
        [--iterations 200] [--percall] [--testcostas] [--planar] [--cpu]

The rows and options are ``clenabled_tpu.tools.test_clenabled``'s.  The
FFT, FIR, FFT filter, quadrature demod and Costas rows run the port's
kernel forms (``fft_batched``, ``fir_direct``, ``ofs_filter``, ``qdemod``,
``costas``): in the default complex64 mode each call splits its complex64
frame into planar components first, as ``demod.make_costas_loop`` does;
``--planar`` feeds planar frames.  The other rows are plain torch.  Each
row prints its kernel launches in the run (the wrappers' counters): a row
whose block has a kernel shows them, and 0 there means the plain form
ran.  Timing (``tools/_timing``): chained calls under CUDA events, or a
synchronise a call with ``--percall``.  Without a card it exits non-zero
unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    from clenabled_tpu_torch.tools import _timing as T

    ap = argparse.ArgumentParser(description="block throughput benchmark")
    ap.add_argument("blocksize", nargs="?", type=int, default=8192)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--testcostas", action="store_true",
                    help="include the (sequential) Costas loop")
    ap.add_argument("--planar", action="store_true",
                    help="planar float32 (re, im) frames")
    ap.add_argument("--baseline-only", action="store_true",
                    help="only the no-op copy baseline")
    T.add_device_args(ap)
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)

    import torch

    from clenabled_tpu_torch.dsp import (demod, elementwise as ew,
                                         fft as dsp_fft, fft_filter,
                                         fir_filter, firdes, hopper_kernels,
                                         planar as pl, siggen,
                                         window as win)
    from clenabled_tpu_torch.tools import _timing as T

    dev = T.select_device(args)
    n, it = args.blocksize, args.iterations
    mode = "per-call" if args.percall else "chained (CUDA events)" \
        if dev.type == "cuda" else "host clock"
    print(f"platform: {T.platform_banner(dev)}   blocksize: {n}   "
          f"iterations: {it}   timing: {mode}   "
          f"{'planar' if args.planar else 'complex64'}", flush=True)
    rows = []

    def on(a):
        return torch.from_numpy(a).to(dev)

    def row(name, samples, measure, has_kernel=False):
        hopper_kernels.reset_launch_counts()
        secs = measure()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = {k: v for k, v in hopper_kernels.launch_counts().items()
                    if v}
        shown = (", ".join(f"{k} x{v}" for k, v in launches.items())
                 or "0 (plain form)") if has_kernel else "no kernel"
        rec = T.report(name, samples, secs, f"launches: {shown}")
        rec.update(launches=launches, has_kernel=has_kernel)
        rows.append(rec)

    def tfn(fn, *a):
        return lambda: T.time_fn(fn, *a, iterations=it, device=dev,
                                 percall=args.percall)

    def tst(fn, st, *a):
        return lambda: T.time_stateful(fn, st, *a, iterations=it, device=dev,
                                       percall=args.percall)

    def on_dev(state):
        return tuple(s.to(dev) for s in state)

    taps = firdes.low_pass(1.0, 10e6, 1e6, 500e3)
    w2 = win.blackman_harris(2048)
    fir_init, fir_apply = fir_filter.make_fir_filter_planar(taps)
    ofs_init, ofs_apply, plan = fft_filter.make_fft_filter_planar(
        taps, fused=True)
    q = fft_filter.frame_quantum(plan)
    nq = max(1, n // q) * q
    nc = min(n, 1 << 16)

    if args.planar:
        ar, ai, br, bi = (on(T.rand_float(n, s)) for s in (1, 11, 2, 12))
        f = on(T.rand_float(n, 3) ** 2 + 0.1)
        g = on(T.rand_float(n, 4) ** 2 + 0.1)
        PC = pl.PC
        row("empty w/copy (baseline)", n, tfn(lambda x: x + 0, ar))
        if args.baseline_only:
            return rows
        row("multiply (cc planar)", n, tfn(
            lambda r, i, r2, i2: pl.mul(PC(r, i), PC(r2, i2)), ar, ai, br, bi))
        row("multiply conjugate", n, tfn(
            lambda r, i, r2, i2: pl.mul_conj(PC(r, i), PC(r2, i2)),
            ar, ai, br, bi))
        row("complex->mag", n, tfn(lambda r, i: pl.pabs(PC(r, i)), ar, ai))
        row("complex->arg", n, tfn(lambda r, i: torch.atan2(i, r), ar, ai))
        row("log10 (n,k)", n, tfn(lambda x: ew.log10(x, 10.0, 1.0), f))
        row("snr helper", n, tfn(lambda x, y: ew.snr_helper(x, y, 10.0), f, g))
        row("fft 2048 fwd+win+shift", n, tfn(
            lambda r, i: dsp_fft.fft_stream_planar(PC(r, i), 2048, window=w2,
                                                   shift=True), ar, ai), True)
        row("quadrature demod", n, tfn(
            lambda r, i: demod.quadrature_demod_planar(PC(r, i), 1.0),
            ar, ai), True)
        row(f"FIR filter ({len(taps)} taps)", n, tst(
            lambda st, r, i: fir_apply(st, PC(r, i)), on_dev(fir_init()),
            ar, ai), True)
        qr, qi = on(T.rand_float(nq, 5)), on(T.rand_float(nq, 15))
        row(f"FFT filter ({len(taps)} taps, fft {plan.fft_size})", nq, tst(
            lambda st, r, i: ofs_apply(st, PC(r, i)), on_dev(ofs_init()),
            qr, qi), True)
        if args.testcostas:
            costas = demod.make_costas_loop_planar(0.02, 2)
            row(f"costas loop (order 2, n={nc})", nc, tst(
                lambda st, r, i: costas(st, PC(r, i)),
                demod.costas_init(dev), ar[:nc], ai[:nc]), True)
        return rows

    a = on(T.rand_complex(n, 1))
    b = on(T.rand_complex(n, 2))
    f = on(T.rand_float(n, 3) ** 2 + 0.1)
    g = on(T.rand_float(n, 4) ** 2 + 0.1)

    def split(x):
        return pl.PC(x.real.contiguous(), x.imag.contiguous())

    row("empty w/copy (baseline)", n, tfn(lambda x: x + 0, a))
    if args.baseline_only:
        return rows
    row("multiply (cc)", n, tfn(
        lambda x, y: ew.math_op(ew.MATHOP_MULTIPLY, x, y), a, b))
    row("add (cc)", n, tfn(lambda x, y: x + y, a, b))
    row("multiply conjugate", n, tfn(ew.multiply_conjugate, a, b))
    row("complex conjugate", n, tfn(ew.complex_conjugate, a))
    row("multiply const", n, tfn(lambda x: ew.multiply_const(x, 2.0), a))
    row("complex->mag", n, tfn(ew.complex_to_mag, a))
    row("complex->arg", n, tfn(ew.complex_to_arg, a))
    row("complex->magphase", n, tfn(ew.complex_to_mag_phase, a))
    row("magphase->complex", n, tfn(ew.mag_phase_to_complex, f, g))
    row("log10 (n,k)", n, tfn(lambda x: ew.log10(x, 10.0, 1.0), f))
    row("snr helper", n, tfn(lambda x, y: ew.snr_helper(x, y, 10.0), f, g))

    init, gen = siggen.make_signal_source(10e6, 1, 1e6, 1.0, n, device=dev)
    row("signal source", n, tst(lambda s, _: gen(s), init(), 0))
    row("quadrature demod", n, tfn(
        lambda x: demod.quadrature_demod_planar(split(x), 1.0), a), True)
    row("fft 2048 fwd+win+shift", n, tfn(
        lambda x: pl.to_complex(dsp_fft.fft_stream_planar(
            split(x), 2048, window=w2, shift=True)), a), True)

    def fir_c(st, x):
        st, y = fir_apply(st, split(x))
        return st, pl.to_complex(y)

    def ofs_c(st, x):
        st, y = ofs_apply(st, split(x))
        return st, pl.to_complex(y)

    row(f"FIR filter ({len(taps)} taps)", n,
        tst(fir_c, on_dev(fir_init()), a), True)
    a2 = on(T.rand_complex(nq, 5))
    row(f"FFT filter ({len(taps)} taps, fft {plan.fft_size})", nq,
        tst(ofs_c, on_dev(ofs_init()), a2), True)

    # short-dtype FIR variants (the reference's fir_filter_scc/fsf,
    # lib/fir_filter.h:160,192): plain conv forms
    import numpy as np

    ctaps = (taps + 1j * taps[::-1]).astype(np.complex64)
    sini, sapp = fir_filter.make_fir_filter_typed(
        ctaps, in_dtype=torch.int16, device=dev)
    xs = on(np.random.default_rng(6).integers(-2000, 2000, n, dtype=np.int16))
    row(f"FIR scc ({len(taps)} taps, short in)", n, tst(sapp, sini(), xs))
    fsini, fsapp = fir_filter.make_fir_filter_typed(
        taps, in_dtype=torch.float32, out_dtype=torch.int16, device=dev)
    row(f"FIR fsf ({len(taps)} taps, short out)", n, tst(fsapp, fsini(), f))

    if args.testcostas:
        run = demod.make_costas_loop(0.02, 2)
        row(f"costas loop (order 2, n={nc})", nc,
            tst(run, demod.costas_init(dev), a[:nc]), True)
    return rows


if __name__ == "__main__":
    main()
