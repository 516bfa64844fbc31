"""Weak scaling of the sharded paths over 1..N ranks.

The port of ``clenabled_tpu.tools.test_scaling``: for each mesh size in
``--devices`` it starts that many ranks (``sharding.spawn``: NCCL with one
card a rank, gloo with ``--cpu``), keeps the work a rank fixed, and prints
the total and per-rank throughput with the efficiency against one rank.

    python -m clenabled_tpu_torch.tools.test_scaling --devices 1 2 4 \\
        [--samples-per-chip 65536] [--iterations 10] [--cpu]
        [--xengine [--stations-per-chip 8] [--channels 32] [--integration 512]]
        [--ospfb] [--xcorr [--windows-per-chip 8] [--signal-length 8192]
                           [--max-shift 512]]

The legs:

* default: the fused sharded step
  (``pipelines.make_sharded_fx_pipeline_fused``, 4 antennas, 16 channels,
  ``--samples-per-chip`` a rank, the ``fx_correlate_streams_v2`` kernel
  on every rank), through ``tools.sharded_scaling``'s rank function: rank 0
  holds two chained steps to the unsharded step over the joined stream,
  float32 and int8 ingest; the float32 step is timed;
* ``--xengine``: the stacked station-sharded X-Engine
  (``make_sharded_xengine_stacked``) with ``--stations-per-chip`` · D
  stations × 2 pols of int8 lanes, each rank its lane block, its channel
  slice bit for bit the unsharded engine's (the Gram kernel wherever a
  rank's engine sees a multiple of 128 lanes);
* ``--ospfb``: the time-sharded fused oversampled channelizer (16
  channels, R = 8, the ``pfb_oversampled_fused`` kernel), rank 0's rows
  held to the unsharded channelizer over the joined stream;
* ``--xcorr``: the window-parallel TD correlator (no collective), rank 0's
  windows held to the unsharded lag scan.

Checks: within 1e-4 × max|ref| (the X-Engine bit for bit); a mismatch
raises.  Times: CUDA events over ``--iterations`` back-to-back calls (the
host clock on the CPU); the slowest rank sets the step.  The script's top
level is guarded: the ranks import it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

TOL = 1e-4          # × max|ref|
SEED = 11


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="sharded weak scaling")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--samples-per-chip", type=int, default=1 << 16)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU")
    ap.add_argument("--xengine", action="store_true",
                    help="weak-scale the stacked sharded X-Engine")
    ap.add_argument("--stations-per-chip", type=int, default=8)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--integration", type=int, default=512)
    ap.add_argument("--ospfb", action="store_true",
                    help="weak-scale the time-sharded fused oversampled PFB")
    ap.add_argument("--xcorr", action="store_true",
                    help="weak-scale the window-parallel TD correlator")
    ap.add_argument("--windows-per-chip", type=int, default=8)
    ap.add_argument("--signal-length", type=int, default=8192)
    ap.add_argument("--max-shift", type=int, default=512)
    return ap.parse_args(argv)


def _rank_context():
    from clenabled_tpu_torch.runtime.device import get_context
    from clenabled_tpu_torch.sharding import axis_index

    ctx = get_context()
    d = ctx.num_devices
    if ctx.device.type == "cpu":            # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // d))
    return ctx.mesh, ctx.device, axis_index(ctx.mesh), d


def _worst(got, want) -> float:
    """max |got − want| / (TOL × max|want|): at most 1 passes."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return err / (TOL * scale) if scale else err


def _timed(fn, reps: int, dev) -> float:
    from clenabled_tpu_torch.tools.sharded_scaling import _per_call_ms

    return _per_call_ms(fn, reps, dev)


def _fx_rank(opts: dict) -> dict:
    from clenabled_tpu_torch.tools.sharded_scaling import _rank

    res = _rank({"samples": opts["samples"], "steps": 2,
                 "reps": opts["iterations"]})
    f32 = res["float32"]
    return {"ms": min(f32["ms"]["sharded"]),
            "launches": {k: r["launches"] for k, r in res.items()},
            "worst_over_tol": max(r.get("worst_over_tol", 0.0)
                                  for r in res.values())}


def _xengine_rank(opts: dict) -> dict:
    from clenabled_tpu_torch.dsp import hopper_kernels as hk
    from clenabled_tpu_torch.dsp import xengine as X
    from clenabled_tpu_torch.sharding import make_sharded_xengine_stacked
    from clenabled_tpu_torch.tools.sharded_scaling import _frame

    mesh, dev, rank, d = _rank_context()
    p, f, t = 2, opts["channels"], opts["integration"]
    s = opts["stations_per_chip"] * d
    lanes, rows = s * p // d, f // d
    kw = dict(pipeline_integration=1, scale=1.0 / 127.0 ** 2)
    init, apply = make_sharded_xengine_stacked(s, f, p, t, mesh, **kw)
    frame = tuple(_frame(torch.int8, (f, t, s * p), SEED + c, dev)
                  for c in range(2))
    mine = tuple(z[..., rank * lanes:(rank + 1) * lanes].contiguous()
                 for z in frame)
    hk.reset_launch_counts()
    _, (got, ready) = apply(init(), mine)
    launches = {k: v for k, v in hk.launch_counts().items() if v}
    uinit, uapply = X.make_xengine_channel_major(s, f, p, t, device=dev, **kw)
    want, _ = uapply(uinit(), frame)[1]
    sl = slice(rank * rows, (rank + 1) * rows)
    if not (ready and torch.equal(got.re, want.re[sl])
            and torch.equal(got.im, want.im[sl])):
        raise AssertionError(f"rank {rank}: the channel slice differs from "
                             f"the unsharded engine's")
    st = init()
    ms = _timed(lambda: apply(st, mine), opts["iterations"], dev)
    return {"ms": ms, "launches": launches, "stations": s,
            "worst_over_tol": 0.0}


def _ospfb_prototype():
    from clenabled_tpu_torch.dsp import firdes

    proto = firdes.low_pass(1.0, 16.0, 0.5, 0.25)
    return np.concatenate([proto, np.zeros((-len(proto)) % 16, np.float32)])


def _ospfb_rank(opts: dict) -> dict:
    from clenabled_tpu_torch.dsp import channelizer, hopper_kernels as hk
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.sharding import (
        make_sharded_channelizer_fused_oversampled)

    mesh, dev, rank, d = _rank_context()
    m, r = 16, 8
    proto = _ospfb_prototype()
    local = max(1024, opts["samples"] // 1024 * 1024)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    xr, xi = (torch.randn(local * d, generator=gen, device=dev)
              for _ in range(2))
    x = planar.PC(xr[rank * local:(rank + 1) * local].contiguous(),
                  xi[rank * local:(rank + 1) * local].contiguous())
    init_s, apply_s = make_sharded_channelizer_fused_oversampled(proto, m, r,
                                                                 mesh)
    hk.reset_launch_counts()
    st, out = apply_s(init_s(), x)
    launches = {k: v for k, v in hk.launch_counts().items() if v}
    worst = 0.0
    if rank == 0:
        uinit, uapply = channelizer.make_channelizer_fused_oversampled(
            proto, m, r, list(range(m)), device=dev)
        _, want = uapply(tuple(s.to(dev) for s in uinit()),
                         planar.PC(xr, xi))
        rows = local // r
        worst = max(_worst(out.re, want.re[:rows]),
                    _worst(out.im, want.im[:rows]))
        if worst > 1.0:
            raise AssertionError(f"rank 0 differs from the unsharded "
                                 f"channelizer by {worst:.3f} x tolerance")
    box = [st]

    def call():
        box[0] = apply_s(box[0], x)[0]

    ms = _timed(call, opts["iterations"], dev)
    return {"ms": ms, "launches": launches, "samples": local,
            "worst_over_tol": worst}


def _xcorr_rank(opts: dict) -> dict:
    from clenabled_tpu_torch.dsp import xcorr
    from clenabled_tpu_torch.sharding import make_sharded_td_xcorr

    mesh, dev, rank, d = _rank_context()
    ns, n, ms_ = 2, opts["signal_length"], opts["max_shift"]
    b = opts["windows_per_chip"] * d
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    mags = torch.randn((ns, b, n), generator=gen, device=dev).abs()
    apply = make_sharded_td_xcorr(mesh, ms_)
    res = apply(mags)
    worst = 0.0
    if rank == 0:
        per = b // d
        want = xcorr.td_xcorr_planar_batched(mags[:, :per], ms_)
        worst = _worst(res.corr, want.corr)
        if worst > 1.0 or not torch.equal(res.lag, want.lag):
            raise AssertionError("rank 0 differs from the unsharded lag scan")
    ms = _timed(lambda: apply(mags), opts["iterations"], dev)
    return {"ms": ms, "launches": {}, "windows": b, "worst_over_tol": worst}


LEGS = {"fx": _fx_rank, "xengine": _xengine_rank, "ospfb": _ospfb_rank,
        "xcorr": _xcorr_rank}


def main(argv=None) -> dict:
    args = parse_args(argv)
    from clenabled_tpu_torch.sharding import launch

    device = "cpu" if args.cpu else "cuda"
    card = None
    if device == "cuda":
        from clenabled_tpu_torch import _build
        from clenabled_tpu_torch.runtime.device import card_info, get_device

        get_device("cuda")
        _build.load()                 # once, before the ranks load it
        card = card_info()
        avail = torch.cuda.device_count()
        sizes = [d for d in args.devices if d <= avail]
        if not sizes:
            raise SystemExit(f"no requested size fits {avail} card(s)")
    else:
        sizes = list(args.devices)
    leg = ("xengine" if args.xengine else "ospfb" if args.ospfb
           else "xcorr" if args.xcorr else "fx")
    opts = {"samples": args.samples_per_chip, "iterations": args.iterations,
            "stations_per_chip": args.stations_per_chip,
            "channels": args.channels, "integration": args.integration,
            "windows_per_chip": args.windows_per_chip,
            "signal_length": args.signal_length,
            "max_shift": args.max_shift}
    print(f"platform: {card or 'cpu (gloo)'}   leg: {leg}   sizes: {sizes}",
          flush=True)
    rows, base = [], None
    for d in sizes:
        results = launch.spawn(LEGS[leg], d, device, opts)
        step_ms = max(r["ms"] for r in results)
        if leg == "fx":
            work, unit = args.samples_per_chip * d, "MSPS an antenna"
            rate = work / step_ms / 1e3
        elif leg == "xengine":
            s = args.stations_per_chip * d
            nb = s * (s + 1) // 2
            work, unit = 8.0 * args.channels * args.integration * nb * 4, \
                "TFLOP/s useful"
            rate = work / step_ms / 1e9
        elif leg == "ospfb":
            work, unit = results[0]["samples"] * d, "MSPS"
            rate = work / step_ms / 1e3
        else:
            work, unit = args.windows_per_chip * d * args.signal_length, \
                "MSPS of windowed stream"
            rate = work / step_ms / 1e3
        per_rank = rate / d
        base = per_rank if base is None else base
        eff = per_rank / base * 100.0
        worst = max(r["worst_over_tol"] for r in results)
        print(f"  {d} rank(s): {step_ms:9.4f} ms a step  {rate:10.4g} {unit} "
              f"total  {per_rank:10.4g} a rank  efficiency {eff:5.1f}%  "
              f"(rank 0 within {worst:.3f} x tolerance; launches "
              f"{results[0]['launches']})", flush=True)
        rows.append({"ranks": d, "step_ms": step_ms, "rate": rate,
                     "unit": unit, "per_rank": per_rank,
                     "efficiency_pct": eff, "worst_over_tol": worst,
                     "launches": [r["launches"] for r in results],
                     "ms_by_rank": [r["ms"] for r in results]})
    return {"leg": leg, "device": device, "card": card, "rows": rows}


if __name__ == "__main__":
    main()
