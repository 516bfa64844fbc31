"""The sharded fused step (or the stacked X-Engine) across ranks, held to
the unsharded form and timed.

    python -m clenabled_tpu_torch.tools.sharded_scaling [--ranks 4] \\
        [--device cuda] [--samples 8388608] [--steps 3] [--reps 20]
    python -m clenabled_tpu_torch.tools.sharded_scaling --xengine \\
        [--ranks 4] [--xe-channels 256] [--xe-frames 8192]

Starts ``--ranks`` ranks (``sharding.spawn``: NCCL with one card a rank, or
gloo with ``--device cpu``).  Every rank makes the same global frames from
a seed (4 antennas × ranks · ``--samples`` a step, ``--steps`` chained
steps), takes its time block and runs
``pipelines.make_sharded_fx_pipeline_fused`` at 16 channels on it, with
float32 and with int8 ingest, its kernel launches counted (one ``fx_correlate_streams_v2`` a step).  Rank 0 holds every
step's outputs to ``make_fx_pipeline_fused`` over the joined stream on its
own device: the sums within 1e-4 × max|ref| (they add in another order),
the carried tails bit for bit.  Then every rank times, in turns, the
sharded step, the unsharded step on its block alone (the same kernel work
without the collectives) and the step's collectives alone (the ring hop,
the all-reduce of the sums and the broadcast of the tails): CUDA events
over ``--reps`` back-to-back calls on the card, the host clock on the CPU;
and the host time to enqueue a sharded and an unsharded step.  On the card
every rank also traces 5 sharded steps with ``torch.profiler``: its device
time a step, and the NCCL kernels' by kernel (a kernel's time includes its
wait for the slowest peer).

With ``--xengine`` it runs the X-Engine leg instead:
``sharding.make_sharded_xengine_stacked`` at the X-Engine reference
configuration (64 stations × 2 pols: 128 lanes, ``--xe-channels`` 256
channels, ``--xe-frames`` 8192 frames of int8, scale 1/127²), each rank
ingesting its 128/ranks-lane block of the same seeded global frames and
emitting its channel slice every call; every rank holds its slice to
``make_xengine_channel_major`` over the whole frames bit for bit, counts
its Gram launches (one a call on a card), and times in turns the sharded
call, its ``all_to_all`` of both components alone, and one unsharded
engine on the whole frames on its own card.  It also sends complex64
through the exchange: ``sharding.sharded_xengine`` on each rank's
stations of a seeded [64, 64, 256, 2] frame, its channel slice held to
``xengine_correlate`` on the whole frame within 1e-4 × max|ref|.

Prints a line per ingest dtype (or the X-Engine's), the card's name and
power limit, and one JSON line; a mismatch exits non-zero.  ``--device
cuda`` without as many cards as ranks exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.dsp import xengine as X
from clenabled_tpu_torch.runtime.device import (_device_events, get_context,
                                                host_ms, is_nccl_kernel)
from clenabled_tpu_torch.sharding import (all_to_all, axis_index, broadcast,
                                          launch, make_sharded_xengine_stacked,
                                          psum, ring_forward, sharded_xengine)
from clenabled_tpu_torch.tools.variant_ab import per_call_ms

TOL = 1e-4          # × max|ref|
SEED = 7
A, M = 4, 16        # antennas and channels: the fused cell's
DTYPES = ("float32", "int8")
PROFILED = 5        # sharded steps a rank traces with torch.profiler


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="sharded fused step across ranks")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--samples", type=int, default=1 << 23,
                    help="samples a rank a step")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--xengine", action="store_true",
                    help="run the stacked X-Engine leg instead")
    ap.add_argument("--xe-channels", type=int, default=256)
    ap.add_argument("--xe-frames", type=int, default=8192)
    return ap.parse_args(argv)


def _frame(dtype, shape, seed: int, dev):
    """The global frame of one step: the same on every rank."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _per_call_ms(fn, reps: int, dev) -> float:
    """ms a call of fn over reps back-to-back calls after a warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        return per_call_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _worst(got, want) -> float:
    """max |got − want| / (TOL × max|want|): at most 1 passes."""
    err = float((got.double() - want.double()).abs().max())
    return err / (TOL * float(want.double().abs().max()))


def _check(outs, frames, dtype, cfg, d, dev) -> float:
    """Rank 0: the sharded outputs against the unsharded step over the
    joined stream; returns the worst error over TOL × max|ref|."""
    whole = cfg._replace(samples_per_step=cfg.samples_per_step * d)
    ufn, (_, _, tr, ti) = P.make_fx_pipeline_fused(whole, in_dtype=dtype,
                                                   device=dev)
    worst = 0.0
    for k, (xr, xi) in enumerate(frames):
        want = ufn(xr, xi, tr, ti)
        worst = max(worst, *(_worst(g, w) for g, w in zip(outs[k][:3],
                                                          want[:3])))
        if not (torch.equal(outs[k][3], want[3])
                and torch.equal(outs[k][4], want[4])):
            raise AssertionError(f"step {k}: the carried tails differ from "
                                 f"the unsharded step's")
        tr, ti = want[3], want[4]
    if worst > 1.0:
        raise AssertionError(f"outputs differ from the unsharded step's by "
                             f"{worst:.3f} × the tolerance")
    return worst


def _rank(opts: dict) -> dict:
    """One rank's run: checks, launches and times per dtype."""
    ctx = get_context()
    mesh, dev = ctx.mesh, ctx.device
    rank, d = axis_index(mesh), ctx.num_devices
    if dev.type == "cpu":             # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // d))
    n, a, m = opts["samples"], A, M
    cfg = P.FxPipelineConfig(num_antennas=a, num_channels=m,
                             samples_per_step=n)
    out = {}
    for name in DTYPES:
        dtype = getattr(torch, name)
        frames = [tuple(_frame(dtype, (a, n * d), SEED + 2 * k + c, dev)
                        for c in range(2)) for k in range(opts["steps"])]
        sfn, (_, _, tr0, ti0) = P.make_sharded_fx_pipeline_fused(
            mesh, cfg=cfg, in_dtype=dtype)
        blocks = [(xr[:, rank * n:(rank + 1) * n].contiguous(),
                   xi[:, rank * n:(rank + 1) * n].contiguous())
                  for xr, xi in frames]
        hk.reset_launch_counts()
        outs, tr, ti = [], tr0, ti0
        for xr, xi in blocks:
            outs.append(sfn(xr, xi, tr, ti))
            tr, ti = outs[-1][3], outs[-1][4]
        launches = {k: v for k, v in hk.launch_counts().items() if v}
        res = {"launches": launches}
        if rank == 0:
            res["worst_over_tol"] = _check(outs, frames, dtype, cfg, d, dev)
        del outs, frames
        ufn, _ = P.make_fx_pipeline_fused(cfg, in_dtype=dtype, device=dev)
        xr, xi = blocks[0]
        mine = torch.stack([tr0, ti0])
        sums = torch.zeros((a - 1) * m + a * (a + 1) * m, device=dev)

        def coll():
            return (ring_forward(mine, mesh), psum(sums, mesh),
                    broadcast(mine, mesh, d - 1))

        calls = {"sharded": lambda: sfn(xr, xi, tr0, ti0),
                 "block": lambda: ufn(xr, xi, tr0, ti0),
                 "collectives": coll}
        times = {k: [] for k in calls}
        for k in ("block", "sharded", "collectives", "collectives",
                  "sharded", "block"):
            times[k].append(_per_call_ms(calls[k], opts["reps"], dev))
        res["ms"] = times
        res["host_ms"] = {k: host_ms(calls[k], opts["reps"], dev)
                          for k in ("sharded", "block")}
        if dev.type == "cuda":
            # every rank traces the same PROFILED steps, collectives in step
            _, events = _device_events(
                lambda: [calls["sharded"]() for _ in range(PROFILED)],
                PROFILED, 1)
            res["device_ms"] = sum(us for _, us in events) / PROFILED / 1e3
            nccl: dict = {}
            for nm, us in events:
                if is_nccl_kernel(nm):
                    key = nm.split("(")[0]
                    nccl[key] = nccl.get(key, 0.0) + us / PROFILED / 1e3
            res["nccl_ms"] = sum(nccl.values())
            res["nccl_by_kernel"] = nccl
        out[name] = res
    return out


XE_S, XE_P = 64, 2   # the X-Engine reference configuration's 128 lanes


def _xengine_rank(opts: dict) -> dict:
    """One rank's X-Engine leg: its lane block through the sharded stacked
    engine, held to the unsharded engine's rows of its channels, counted
    and timed."""
    ctx = get_context()
    mesh, dev = ctx.mesh, ctx.device
    rank, d = axis_index(mesh), ctx.num_devices
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // d))
    f, t, sp = opts["xe_channels"], opts["xe_frames"], XE_S * XE_P
    lanes, rows = sp // d, f // d
    kw = dict(pipeline_integration=1, scale=1.0 / 127.0 ** 2)
    init, apply = make_sharded_xengine_stacked(XE_S, f, XE_P, t, mesh, **kw)
    uinit, uapply = X.make_xengine_channel_major(XE_S, f, XE_P, t,
                                                 device=dev, **kw)
    frames = [tuple(_frame(torch.int8, (f, t, sp), SEED + 2 * k + c, dev)
                    for c in range(2)) for k in range(opts["steps"])]
    mine = [tuple(z[..., rank * lanes:(rank + 1) * lanes].contiguous()
                  for z in fr) for fr in frames]
    hk.reset_launch_counts()
    outs = [apply(init(), fr)[1] for fr in mine]
    launches = {k: v for k, v in hk.launch_counts().items() if v}
    for k, fr in enumerate(frames):
        (want, _), (got, ready) = uapply(uinit(), fr)[1], outs[k]
        sl = slice(rank * rows, (rank + 1) * rows)
        if not (ready and torch.equal(got.re, want.re[sl])
                and torch.equal(got.im, want.im[sl])):
            raise AssertionError(f"rank {rank} call {k}: the channel slice "
                                 f"differs from the unsharded engine's")
    del outs
    # complex64 through the exchange: the time-major one-shot engine
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    z = torch.randn((64, XE_S, f, XE_P), generator=gen, device=dev,
                    dtype=torch.complex64)
    per = XE_S // d
    got = sharded_xengine(z[:, rank * per:(rank + 1) * per].contiguous(),
                          mesh)
    complex_worst = _worst(torch.view_as_real(got), torch.view_as_real(
        X.xengine_correlate(z)[rank * rows:(rank + 1) * rows]))
    if complex_worst > 1.0:
        raise AssertionError(f"rank {rank}: sharded_xengine differs from "
                             f"xengine_correlate by {complex_worst:.3f} × "
                             f"the tolerance")
    st, ust = init(), uinit()
    zr, zi = mine[0]
    calls = {"sharded": lambda: apply(st, mine[0]),
             "all_to_all": lambda: (all_to_all(zr, mesh, 0, 2),
                                    all_to_all(zi, mesh, 0, 2)),
             "unsharded": lambda: uapply(ust, frames[0])}
    times = {k: [] for k in calls}
    for k in ("unsharded", "sharded", "all_to_all", "all_to_all", "sharded",
              "unsharded"):
        times[k].append(_per_call_ms(calls[k], opts["reps"], dev))
    return {"launches": launches, "ms": times,
            "complex_worst_over_tol": complex_worst,
            "host_ms": {k: host_ms(calls[k], opts["reps"], dev)
                        for k in ("sharded", "all_to_all")},
            "exchanged_bytes": 2 * zr.numel(),
            "transpose_bytes": 2 * rows * t * sp}


def main(argv=None) -> None:
    args = parse_args(argv)
    card = None
    if args.device == "cuda":
        from clenabled_tpu_torch import _build
        from clenabled_tpu_torch.runtime.device import card_info

        _build.load()                 # once, before the ranks load it
        card = card_info()
    opts = {k: getattr(args, k) for k in ("samples", "steps", "reps",
                                          "xe_channels", "xe_frames")}
    if args.xengine:
        _xengine_main(args, opts, card)
        return
    results = launch.spawn(_rank, args.ranks, args.device, opts)
    # on the CPU the wrapper runs its plain form and counts no launch
    want = {"fx_correlate_streams_v2": args.steps} if card else {}
    for name in DTYPES:
        per = [r[name] for r in results]
        for rank, r in enumerate(per):
            if r["launches"] != want:
                raise SystemExit(f"rank {rank} {name}: launches "
                                 f"{r['launches']}, expected one a step")
        r0 = per[0]
        print(f"[sharded] {name} {args.ranks} ranks x {A}x{args.samples}: "
              f"rank 0 within {r0['worst_over_tol']:.3f} x tolerance of the "
              f"unsharded step over the joined stream, tails bit-equal; ms a "
              f"call by rank {[r['ms'] for r in per]}"
              + f"; host ms to enqueue a call by rank "
                f"{[r['host_ms'] for r in per]}"
              + (f"; device ms a sharded step by rank "
                 f"{[round(r['device_ms'], 4) for r in per]}, of it NCCL "
                 f"kernels {[r['nccl_by_kernel'] for r in per]}"
                 if "device_ms" in r0 else ""), flush=True)
    if card:
        print(card, flush=True)
    print(json.dumps({"ranks": args.ranks, "device": args.device,
                      "card": card, "samples": args.samples, "a": A,
                      "m": M, "steps": args.steps, "reps": args.reps,
                      "results": results}), flush=True)


def _xengine_main(args, opts: dict, card) -> None:
    results = launch.spawn(_xengine_rank, args.ranks, args.device, opts)
    # on the CPU the wrapper runs its plain form and counts no launch
    want = {"xengine_gram_stacked_tri": args.steps} if card else {}
    for rank, r in enumerate(results):
        if r["launches"] != want:
            raise SystemExit(f"rank {rank}: launches {r['launches']}, "
                             f"expected one Gram launch a call")
    print(f"[sharded] stacked X-Engine {args.ranks} ranks, S={XE_S} P={XE_P} "
          f"F={args.xe_channels} T={args.xe_frames} int8, "
          f"{XE_S * XE_P // args.ranks} lanes a rank: every channel slice "
          f"bit-equal to the unsharded engine; complex64 sharded_xengine "
          f"within {max(r['complex_worst_over_tol'] for r in results):.3f} "
          f"× tolerance; ms a call by rank "
          f"{[r['ms'] for r in results]}; host ms to enqueue by rank "
          f"{[r['host_ms'] for r in results]}; bytes a rank exchanged "
          f"{results[0]['exchanged_bytes']}, copied by the transpose "
          f"{results[0]['transpose_bytes']}", flush=True)
    if card:
        print(card, flush=True)
    print(json.dumps({"ranks": args.ranks, "device": args.device,
                      "card": card, "leg": "xengine",
                      "s": XE_S, "p": XE_P, "f": args.xe_channels,
                      "t": args.xe_frames, "steps": args.steps,
                      "reps": args.reps, "results": results}), flush=True)


if __name__ == "__main__":
    main()
