"""Drive the PyTorch / CUDA port's FX receive step and X-Engine path once
on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card   — require a Hopper card; print its name and power limit.
2. build  — compile ``clenabled_tpu_torch/csrc/*.cu`` from this checkout,
   one ``nvcc`` per source, all started together.
3. kernels — each kernel against its plain torch form on the card, TF32
   off, at the main paths' shapes, with kernel and plain times from CUDA
   events.  Tolerance 1e-4 × max|plain| for float32 sums in another order
   (the FX kernels, B.1 and its flat entry B.1b, and B.2; the Gram kernel
   B.4 in bfloat16); the int8 Gram must be bit-exact, at the X-Engine's
   full width (F=256, T=8192, S·P=128) in both of its output modes and at
   k = 4 lane blocks (S·P=512, F=16).
4. main path — launch counts reset, then the fused step at full width
   (4 antennas × 2^23 samples, 16 channels, 400 taps) for 3 chained steps
   in f32 and int8 ingest, and the planar step at the entry shape (2^17);
   counts read; every step's outputs held to the plain forms, the fused
   sums checked for additivity over two chained frames, and the fused
   step held to the complex64 torch.fft pipeline on a small input.
5. ingest — ``HostIngest`` feeds 8 host frames through the fused step;
   device step time, kernel and plain times and end-to-end MSPS.
6. flat FX path — counts reset, 3 chained frames of 4 × 2^23 through
   ``fx_correlate_streams`` with the history carried; counts read; every
   step held to the plain form.
7. X-Engine path — counts reset, a ``Flowgraph`` holding ``XEngine`` at
   the reference configuration (64 stations × 2 pols, 256 channels, 8192
   frames, raw IChar bytes, channel-major, triangular output,
   pipeline_integration=2) driven for 3 integrations; counts read; the
   emitted matrix must equal the plain ``xengine_correlate_stacked`` of
   the same two integrations bit for bit, and the third integration must
   sit in the accumulator.  Device step time and host-to-product time
   per integration.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import os
import sys
import time

TOL = 1e-4          # × max|plain|
A, M, N_FULL = 4, 16, 1 << 23
N_ENTRY = 1 << 17
STEPS = 3
INGEST_FRAMES = 8
# the X-Engine's reference configuration: stations, pols, channels, frames
XE_S, XE_P, XE_F, XE_T = 64, 2, 256, 8192
XE_STEPS = 3
DEVICE = ("cuda", 0)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, got, want) -> tuple[float, float]:
    """(max |got − want|, tolerance) for one pair of outputs."""
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail("non-finite output")
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    err = float((got.double() - want.double()).abs().max())
    return err, TOL * float(want.double().abs().max())


def check(torch, label: str, gots, wants) -> float:
    """Hold each output to its reference; returns the largest error."""
    worst, shown = 0.0, (0.0, 0.0)
    for g, w in zip(gots, wants):
        err, tol = max_err(torch, g, w)
        if not err <= tol:
            fail(f"{label}: max abs err {err:.3e} > tolerance {tol:.3e}")
        worst = max(worst, err)
        if err * shown[1] >= shown[0] * tol:    # the output nearest its limit
            shown = (err, tol)
    phase("check", f"{label}: max abs err {shown[0]:.3e} <= {shown[1]:.3e} "
                   f"({TOL} x max|ref|)")
    return worst


def frames(torch, gen, dtype, shape, device):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def gram_phase(torch, hk, gen, dev) -> dict:
    """B.4 against its plain form in all three output forms; returns the
    bfloat16 error and the kernel and plain times."""
    res = {"bf16_err": 0.0}
    cases = [("int8", torch.int8, XE_F, XE_S * XE_P),
             ("int8 k=4", torch.int8, 16, 512),
             ("bf16", torch.bfloat16, XE_F, XE_S * XE_P)]
    for label, dt, f, sp in cases:
        zr, zi = (frames(torch, gen, dt, (f, XE_T, sp), dev) for _ in range(2))
        shape = f"[{f}x{XE_T}x{sp}]"
        for form in ("xengine_gram_stacked_tri", "xengine_gram_stacked_blocks",
                     "xengine_gram_stacked"):
            got = getattr(hk, form)(zr, zi)[:2]
            torch.cuda.synchronize()
            want = getattr(hk, form + "_plain")(zr, zi)[:2]
            if dt == torch.int8:
                for g, w in zip(got, want):
                    if not torch.equal(g, w):
                        err = float((g.double() - w.double()).abs().max())
                        fail(f"{form} {label} {shape}: not bit-exact "
                             f"(max abs err {err})")
                phase("check", f"{form} {label} {shape}: bit-exact")
            else:
                res["bf16_err"] = max(res["bf16_err"], check(
                    torch, f"{form} {label} {shape}", got, want))
        if label != "int8 k=4":
            key = label
            res[key] = (
                time_ms(torch, lambda: hk.xengine_gram_stacked_tri(zr, zi)),
                time_ms(torch, lambda: hk.xengine_gram_stacked_tri_plain(
                    zr, zi), reps=3, warmup=1))
            phase("time", f"xengine_gram_stacked_tri {label} {shape}: kernel "
                          f"{res[key][0]:.4f} ms, plain {res[key][1]:.4f} ms")
        del zr, zi, got, want
        torch.cuda.empty_cache()
    return res


def flat_fx_phase(torch, hk, gen, dev, taps) -> tuple[int, float]:
    """The flat-layout entry of the fused kernel over 3 chained frames,
    the history carried as the last W·m − 1 samples; (launches, max err)."""
    hl = taps.shape[0] * M - 1
    comps = [torch.randn((2 * A, N_FULL), generator=gen, device=dev)
             for _ in range(STEPS)]
    hist0 = torch.randn((2 * A, hl), generator=gen, device=dev)
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    hist, outs = hist0, []
    for c in comps:
        outs.append(hk.fx_correlate_streams(c, hist, taps, A, M))
        hist = c[:, -hl:].contiguous()
    torch.cuda.synchronize()
    launches = hk.fx_correlate_streams.launches
    phase("flat", f"fx_correlate_streams {2 * A}x{N_FULL}, hist {hl}, "
                  f"{STEPS} chained frames; launches {launches}")
    if launches < 1:
        fail("fx_correlate_streams was not launched on its path")
    worst, hist = 0.0, hist0
    for k, c in enumerate(comps):
        want = hk.fx_correlate_streams_plain(c, hist, taps, A, M)
        worst = max(worst, check(torch, f"flat step {k}", outs[k], want))
        hist = c[:, -hl:]
    return launches, worst


def xengine_phase(torch, hk, gen, dev) -> dict:
    """The X-Engine flowgraph at full width, counted and checked, then
    timed per integration."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import xengine as X
    from clenabled_tpu_torch.streaming import Flowgraph

    xe = blocks.XEngine(data_type=5, polarization=XE_P, num_inputs=XE_S,
                        num_channels=XE_F, integration=XE_T,
                        pipeline_integration=2, planar=True)
    g = Flowgraph()
    for s in range(XE_S):
        g.external_input(xe, s)
    r = g.compile(xe.quantum, device=dev)
    msgs = []
    r.on_message("xengine.xcorr", msgs.append)
    feeds = [[torch.randint(-128, 128, (xe.quantum,), generator=gen,
                            device=dev, dtype=torch.int8)
              for _ in range(XE_S)] for _ in range(XE_STEPS)]
    torch.cuda.synchronize()

    hk.reset_launch_counts()
    for fr in feeds:
        r.step(*fr)
    torch.cuda.synchronize()
    launches = hk.gram_launches()
    phase("xengine", f"Flowgraph/XEngine S={XE_S} P={XE_P} F={XE_F} "
                     f"T={XE_T} IChar, {XE_STEPS} integrations, "
                     f"pipeline_integration=2; launches {launches}")
    if launches < 1:
        fail("the Gram kernel was not launched on the X-Engine path")

    def marshal(fr):
        """IChar bytes [S][T·F·P·2] → channel-major int8 (zr, zi)."""
        raw = torch.stack(fr).view(XE_S, XE_T, XE_F, XE_P, 2)
        return tuple(raw[..., c].permute(2, 1, 0, 3).reshape(XE_F, XE_T, -1)
                     for c in (0, 1))

    plain = [X.xengine_correlate_stacked(*marshal(fr), npol=XE_P,
                                         scale=1.0 / 127.0 ** 2,
                                         use_kernel=False) for fr in feeds]
    if [bool(m["valid"]) for m in msgs] != [False, True, False]:
        fail(f"emission flags {[m['valid'] for m in msgs]}")
    out = msgs[1]["matrix"]
    nb = XE_S * (XE_S + 1) // 2
    if tuple(out.re.shape) != (XE_F, nb, XE_P * XE_P):
        fail(f"matrix shape {tuple(out.re.shape)}")
    want = (plain[0].re + plain[1].re, plain[0].im + plain[1].im)
    if not (torch.equal(out.re, want[0]) and torch.equal(out.im, want[1])):
        err = float(max((out.re - want[0]).abs().max(),
                        (out.im - want[1]).abs().max()))
        fail(f"X-Engine emission differs from the plain engine ({err})")
    if not bool(torch.isfinite(out.re).all() and torch.isfinite(out.im).all()):
        fail("X-Engine emission is not finite")
    for k in (0, 2):
        if msgs[k]["matrix"].re.any() or msgs[k]["matrix"].im.any():
            fail(f"integration {k}: held-back output is not zero")
    st = r.states[0]
    if not (st.count == 1 and torch.equal(st.accum.re, plain[2].re)
            and torch.equal(st.accum.im, plain[2].im)):
        fail("the third integration is not the carried accumulator")
    phase("check", f"X-Engine [{XE_F}, {nb}, {XE_P * XE_P}] emission = plain "
                   f"engine over the same two integrations, bit-exact; "
                   f"third integration carried")

    # device step: feeds already on the card, one integration per call
    step_ms = time_ms(torch, lambda: r.step(*feeds[0]), reps=6, warmup=2)
    # host to product: numpy bytes in, the emitted matrix back on the host
    host = [[f.cpu().numpy() for f in fr] for fr in feeds[:2]]
    products = []

    def fetch(m):
        if m["valid"]:
            products.append((m["matrix"].re.cpu(), m["matrix"].im.cpu()))

    r.reset()
    r.on_message("xengine.xcorr", fetch)
    n = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n):
        r.step(*host[k % 2])
    torch.cuda.synchronize()
    h2p_ms = (time.perf_counter() - t0) / n * 1e3
    if len(products) != n // 2:
        fail(f"{len(products)} products from {n} host integrations")
    if not (torch.equal(products[0][0], out.re.cpu())
            and torch.equal(products[0][1], out.im.cpu())):
        fail("the host-fed run differs from the device-fed one")
    in_mb = XE_S * xe.quantum / 2 ** 20
    phase("xengine", f"device step {step_ms:.4f} ms per integration "
                     f"({XE_S * XE_T * XE_F / step_ms / 1e3:.1f} MSPS in all);"
                     f" host-to-product {h2p_ms:.2f} ms per integration "
                     f"({in_mb:.0f} MiB of bytes in)")
    return {"launches": launches, "step_ms": step_ms, "h2p_ms": h2p_ms}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "clenabled_tpu_torch")):
        fail("the clenabled_tpu_torch package is not beside this script")
    sys.path.insert(0, here)
    from clenabled_tpu_torch import _build
    from clenabled_tpu_torch import pipelines as P
    from clenabled_tpu_torch.dsp import channelizer as chan
    from clenabled_tpu_torch.dsp import hopper_kernels as hk
    from clenabled_tpu_torch.runtime.device import card_info, require_hopper
    from clenabled_tpu_torch.streaming import HostIngest

    # 1. card
    dev = torch.device(*DEVICE)
    require_hopper(dev)
    card = card_info()
    print(card, flush=True)
    phase("card", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__}"
                  f" | CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.load(verbose=True)
    phase("build", f"{len(_build.sources())} sources -> "
                   f"{os.path.basename(_build.last_build['path'])} in "
                   f"{time.perf_counter() - t0:.1f} s")
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            phase("ptxas", line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    cfg = P.FxPipelineConfig(num_antennas=A, num_channels=M,
                             samples_per_step=N_FULL)
    taps_rm, ntaps = P._prototype(M, 100e6)
    taps = torch.as_tensor(taps_rm, device=dev)

    # 3. kernels against their plain forms
    errs = {"fx": 0.0, "pfb": 0.0}
    times = {}
    fx_cases = [("f32", torch.float32, N_FULL, None, None, None),
                ("bf16", torch.bfloat16, N_FULL, None, None, None),
                ("int8", torch.int8, N_FULL, None, None, None),
                ("f32 pairs", torch.float32, N_FULL, None, [(0, 3), (2, 2)],
                 [(0, 1), (3, 3), (2, 0)]),
                ("f32 1600 taps", torch.float32, N_FULL, 1600, None, None)]
    import numpy as np
    for label, dt, n, deep, fdp, xep in fx_cases:
        if deep:
            proto = (np.sinc(np.linspace(-4, 4, deep))
                     * np.hanning(deep)).astype(np.float32)
            t_rm, nt = P._prototype(M, 100e6, proto)
            tk = torch.as_tensor(t_rm, device=dev)
        else:
            tk, nt = taps, ntaps
        h = hk.fx_tail_len(dt, M, nt)
        xr, xi = (frames(torch, gen, dt, (A, n), dev) for _ in range(2))
        tr, ti = (frames(torch, gen, dt, (A, h), dev) for _ in range(2))
        args = (xr, xi, tr, ti, tk, A, M)
        kw = dict(fd_pairs=fdp, xe_pairs=xep)
        got = hk.fx_correlate_streams_v2(*args, **kw)
        torch.cuda.synchronize()
        want = hk.fx_correlate_streams_v2_plain(*args, **kw)
        errs["fx"] = max(errs["fx"], check(
            torch, f"fx_correlate {label} [{A}x{n}, H={h}, W={tk.shape[0]}]",
            got, want))
        if label in ("f32", "int8"):
            times[f"fx {label}"] = (
                time_ms(torch, lambda: hk.fx_correlate_streams_v2(*args)),
                time_ms(torch, lambda: hk.fx_correlate_streams_v2_plain(*args),
                        reps=3, warmup=1))
            phase("time", f"fx_correlate {label}: kernel "
                          f"{times[f'fx {label}'][0]:.3f} ms, plain "
                          f"{times[f'fx {label}'][1]:.3f} ms")
        del xr, xi, tr, ti, got, want
    nout = N_ENTRY // M
    comps = torch.randn((2 * A, ntaps - 1 + N_ENTRY), generator=gen, device=dev)
    y, hrt = chan._pack_streams(comps, taps, M, ntaps, nout)
    got = hk.pfb_channelize_packed(y, hrt, A, M)
    torch.cuda.synchronize()
    errs["pfb"] = check(torch, f"pfb_packed [{tuple(y.shape)}]", [got],
                        [hk.pfb_channelize_packed_plain(y, hrt, A, M)])
    times["pfb"] = (time_ms(torch, lambda: hk.pfb_channelize_packed(y, hrt, A, M)),
                    time_ms(torch, lambda: hk.pfb_channelize_packed_plain(
                        y, hrt, A, M)))
    phase("time", f"pfb_packed: kernel {times['pfb'][0]:.3f} ms, plain "
                  f"{times['pfb'][1]:.3f} ms")
    del y, hrt, got, comps
    hl = taps.shape[0] * M - 1
    comps = torch.randn((2 * A, N_FULL), generator=gen, device=dev)
    hist = torch.randn((2 * A, hl), generator=gen, device=dev)
    got = hk.fx_correlate_streams(comps, hist, taps, A, M)
    torch.cuda.synchronize()
    errs["fx1"] = check(torch, f"fx_correlate_streams [{2 * A}x{N_FULL}, "
                               f"hist {hl}]", got,
                        hk.fx_correlate_streams_plain(comps, hist, taps, A, M))
    times["fx1"] = (
        time_ms(torch, lambda: hk.fx_correlate_streams(comps, hist, taps, A, M)),
        time_ms(torch, lambda: hk.fx_correlate_streams_plain(
            comps, hist, taps, A, M), reps=3, warmup=1))
    phase("time", f"fx_correlate_streams: kernel {times['fx1'][0]:.3f} ms, "
                  f"plain {times['fx1'][1]:.3f} ms")
    del comps, hist, got
    gram_res = gram_phase(torch, hk, gen, dev)

    # 4. the main path, counted
    runs = {}
    fused = {}
    for label, dt in (("f32", torch.float32), ("int8", torch.int8)):
        fused[label] = P.make_fx_pipeline_fused(cfg, in_dtype=dt, device=dev)
        fn, (_, _, tr0, ti0) = fused[label]
        runs[label] = ([(frames(torch, gen, dt, (A, N_FULL), dev),
                         frames(torch, gen, dt, (A, N_FULL), dev))
                        for _ in range(STEPS)], tr0, ti0)
    ecfg = P.FxPipelineConfig(num_antennas=A, num_channels=M,
                              samples_per_step=N_ENTRY)
    planar_fn, (_, _, ph0, pi0) = P.make_fx_pipeline_planar(ecfg, device=dev)
    planar_frames = [(torch.randn((A, N_ENTRY), generator=gen, device=dev),
                      torch.randn((A, N_ENTRY), generator=gen, device=dev))
                     for _ in range(STEPS)]
    torch.cuda.synchronize()

    hk.reset_launch_counts()
    outs = {}
    for label, (fr, tr, ti) in runs.items():
        fn = fused[label][0]
        outs[label] = []
        for xr, xi in fr:
            o = fn(xr, xi, tr, ti)
            outs[label].append(o)
            tr, ti = o[3], o[4]
    hr, hi = ph0, pi0
    outs["planar"] = []
    for xr, xi in planar_frames:
        o = planar_fn(xr, xi, hr, hi)
        outs["planar"].append(o)
        hr, hi = o[3], o[4]
    torch.cuda.synchronize()
    launches = {"fx": hk.fx_correlate_streams_v2.launches,
                "pfb": hk.pfb_channelize_packed.launches}
    phase("main", f"fused step {A}x{N_FULL} f32 and int8, {STEPS} steps "
                  f"each; planar step {A}x{N_ENTRY}, {STEPS} steps; launches "
                  f"{launches}")
    if launches["fx"] < 1 or launches["pfb"] < 1:
        fail(f"a kernel of the main path was not launched: {launches}")

    for label, (fr, tr, ti) in runs.items():
        fn = fused[label][0]
        for k, (xr, xi) in enumerate(fr):
            fd_sum, gram = hk.fx_correlate_streams_v2_plain(
                xr, xi, tr, ti, fn.taps_rm, A, M)
            want = (torch.roll(fd_sum / (N_FULL // M), M // 2, dims=-1),
                    gram[:, :M].T[:, :, None], gram[:, M:].T[:, :, None])
            got = outs[label][k]
            check(torch, f"fused {label} step {k}", got[:3], want)
            h = fn.tail_len
            if not (torch.equal(got[3], xr[:, -h:])
                    and torch.equal(got[4], xi[:, -h:])):
                fail(f"fused {label} step {k}: carried tail is wrong")
            tr, ti = got[3], got[4]
    planar_fn.use_kernel = False
    hr, hi = ph0, pi0
    for k, (xr, xi) in enumerate(planar_frames):
        want = planar_fn(xr, xi, hr, hi)
        check(torch, f"planar step {k}", outs["planar"][k][:3], want[:3])
        hr, hi = want[3], want[4]

    # additivity: two chained frames == one doubled frame from the same tail
    fr, tr, ti = runs["f32"]
    (x1r, x1i), (x2r, x2i) = fr[0], fr[1]
    h = fused["f32"][0].tail_len
    s1 = hk.fx_correlate_streams_v2(x1r, x1i, tr, ti, taps, A, M)
    s2 = hk.fx_correlate_streams_v2(x2r, x2i, x1r[:, -h:].contiguous(),
                                    x1i[:, -h:].contiguous(), taps, A, M)
    both = hk.fx_correlate_streams_v2(torch.cat([x1r, x2r], -1),
                                      torch.cat([x1i, x2i], -1), tr, ti,
                                      taps, A, M)
    check(torch, "additivity (2 chained steps vs 1 doubled frame)",
          [s1[0] + s2[0], s1[1] + s2[1]], list(both))

    # the fused step against the complex64 torch.fft pipeline, small input
    n_small = 1 << 14
    scfg = P.FxPipelineConfig(num_antennas=A, num_channels=M,
                              samples_per_step=n_small)
    sfn, (_, _, st0, _) = P.make_fx_pipeline_fused(scfg, device=dev)
    cfn, (_, hist0) = P.make_fx_pipeline(scfg, device=dev)
    h = st0.shape[-1]
    vr = torch.randn((A, h + n_small), generator=gen, device=dev)
    vi = torch.randn((A, h + n_small), generator=gen, device=dev)
    got = sfn(vr[:, h:], vi[:, h:], vr[:, :h], vi[:, :h])
    v = torch.complex(vr, vi)
    hl = hist0.shape[-1]
    fd_c, xm_c, _ = cfn(v[:, hl:hl + n_small], v[:, :hl])
    check(torch, "fused vs complex64 pipeline (2^14)",
          [got[0], torch.complex(got[1], got[2])], [fd_c, xm_c])
    del runs, outs, fr

    # 5. HostIngest at full width
    fn = fused["f32"][0]
    rng = np.random.default_rng(0)
    host = [(rng.standard_normal((A, N_FULL), dtype=np.float32),
             rng.standard_normal((A, N_FULL), dtype=np.float32))
            for _ in range(4)]
    tail0 = fused["f32"][1][2]

    def step(carry, xr, xi):
        fd, xre, xim, ntr, nti = fn(xr, xi, carry[0], carry[1])
        return (ntr, nti), (fd, xre, xim)

    ing = HostIngest(step, (tail0, tail0), N_FULL, prefetch=2, fetch_every=1,
                     device=dev)
    ing.run(iter(host))                  # warm-up: pins the staging ring
    fetched = []
    stats = ing.run((host[i % len(host)] for i in range(INGEST_FRAMES)),
                    on_outputs=lambda k, o: fetched.append(o))
    if stats["steps"] != INGEST_FRAMES or len(fetched) != INGEST_FRAMES:
        fail(f"HostIngest ran {stats['steps']} steps")
    last = host[(INGEST_FRAMES - 1) % len(host)][0][:, -fn.tail_len:]
    if not np.array_equal(ing.carry[0].cpu().numpy(), last):
        fail("HostIngest carry is not the last frame's tail")
    if not all(bool(torch.isfinite(t).all()) for o in fetched for t in o):
        fail("HostIngest produced non-finite outputs")
    dr = torch.as_tensor(host[0][0], device=dev)
    di = torch.as_tensor(host[0][1], device=dev)
    step_ms = time_ms(torch, lambda: fn(dr, di, tail0, tail0), reps=20)
    # the feed's two legs for one frame (re and im planes): host staging
    # copy into pinned memory, and the pinned -> device copy
    src = torch.from_numpy(host[0][0])
    pin = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    t0 = time.perf_counter()
    for _ in range(4):
        pin.copy_(src)
    stage_ms = 2 * (time.perf_counter() - t0) / 4 * 1e3
    h2d_ms = 2 * time_ms(torch, lambda: dr.copy_(pin, non_blocking=True))
    frame_gb = 2 * src.numel() * src.element_size() / 1e9
    phase("ingest", f"{INGEST_FRAMES} frames of {A}x{N_FULL} f32 through "
                    f"HostIngest: {stats['wall_s'] * 1e3:.1f} ms, "
                    f"{stats.msps:.1f} MSPS per antenna end to end")
    phase("ingest", f"per frame ({frame_gb:.3f} GB): host staging copy "
                    f"{stage_ms:.2f} ms ({frame_gb / stage_ms * 1e3:.1f} GB/s),"
                    f" pinned->device {h2d_ms:.2f} ms "
                    f"({frame_gb / h2d_ms * 1e3:.1f} GB/s)")
    phase("ingest", f"device step {step_ms:.3f} ms = "
                    f"{N_FULL / step_ms / 1e3:.1f} MSPS per antenna; fused "
                    f"kernel {times['fx f32'][0]:.3f} ms, plain "
                    f"{times['fx f32'][1]:.3f} ms")
    del ing, fetched, host, dr, di, pin, src
    torch.cuda.empty_cache()

    # 6. the flat-layout FX path, counted
    flat_launches, errs["fx1 path"] = flat_fx_phase(torch, hk, gen, dev, taps)
    torch.cuda.empty_cache()

    # 7. the X-Engine path, counted
    xe = xengine_phase(torch, hk, gen, dev)
    phase("xengine", f"on {card}")
    print(card, flush=True)

    record = {"kernels": [
        {"name": "fx_correlate_streams_v2", "route": "cuda",
         "source": "clenabled_tpu_torch/csrc/fx_correlate.cu",
         "replaces": "clenabled_tpu/dsp/pallas_kernels.py:1042",
         "launches": launches["fx"], "max_abs_err": errs["fx"],
         "ms": times["fx f32"][0], "plain_ms": times["fx f32"][1]},
        {"name": "pfb_channelize_packed", "route": "cuda",
         "source": "clenabled_tpu_torch/csrc/pfb_packed.cu",
         "replaces": "clenabled_tpu/dsp/pallas_kernels.py:1654",
         "launches": launches["pfb"], "max_abs_err": errs["pfb"],
         "ms": times["pfb"][0], "plain_ms": times["pfb"][1]},
        {"name": "fx_correlate_streams", "route": "cuda",
         "source": "clenabled_tpu_torch/csrc/fx_correlate.cu",
         "replaces": "clenabled_tpu/dsp/pallas_kernels.py:817",
         "launches": flat_launches,
         "max_abs_err": max(errs["fx1"], errs["fx1 path"]),
         "ms": times["fx1"][0], "plain_ms": times["fx1"][1]},
        {"name": "xengine_gram_stacked", "route": "cuda",
         "source": "clenabled_tpu_torch/csrc/xengine_gram.cu",
         "replaces": "clenabled_tpu/dsp/pallas_kernels.py:2068",
         "launches": xe["launches"], "max_abs_err": 0.0,
         "ms": gram_res["int8"][0], "plain_ms": gram_res["int8"][1]},
    ], "step_ms": step_ms, "ingest_msps": stats.msps,
        "stage_ms": stage_ms, "h2d_ms": h2d_ms,
        "int8_fx_ms": times["fx int8"][0], "int8_fx_plain_ms": times["fx int8"][1],
        "gram_bf16_ms": gram_res["bf16"][0],
        "gram_bf16_plain_ms": gram_res["bf16"][1],
        "gram_bf16_max_abs_err": gram_res["bf16_err"],
        "xengine_step_ms": xe["step_ms"],
        "xengine_host_to_product_ms": xe["h2p_ms"]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
