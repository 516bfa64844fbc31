"""Drive the PyTorch / CUDA port's FX receive step once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card   — require a Hopper card; print its name and power limit.
2. build  — compile ``clenabled_tpu_torch/csrc/*.cu`` from this checkout.
3. kernels — each kernel against its plain torch form on the card, TF32
   off, at the main path's shapes (tolerance 1e-4 × max|plain|: float32
   sums in another order), with kernel and plain times from CUDA events.
4. main path — launch counts reset, then the fused step at full width
   (4 antennas × 2^23 samples, 16 channels, 400 taps) for 3 chained steps
   in f32 and int8 ingest, and the planar step at the entry shape (2^17);
   counts read; every step's outputs held to the plain forms, the fused
   sums checked for additivity over two chained frames, and the fused
   step held to the complex64 torch.fft pipeline on a small input.
5. ingest — ``HostIngest`` feeds 8 host frames through the fused step;
   device step time, kernel and plain times and end-to-end MSPS.

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
    ], "step_ms": step_ms, "ingest_msps": stats.msps,
        "stage_ms": stage_ms, "h2d_ms": h2d_ms,
        "int8_fx_ms": times["fx int8"][0], "int8_fx_plain_ms": times["fx int8"][1]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
