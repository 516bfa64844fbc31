"""End-to-end host-ingest benchmark of the fused flagship step.

The port of ``clenabled_tpu.tools.test_ingest``.  The reference's sustained
numbers go through its pinned double-buffered host feed
(lib/clXEngine_impl.cc:325-366); this tool measures the same for the fused
step (``pipelines.make_fx_pipeline_fused``: 4 antennas, 16 channels, the
``fx_correlate_streams_v2`` kernel) and separates the three rates that
bound it:

  link   — the frame's pinned host → card copies alone (CUDA events)
  device — the fused step on frames already on the card, tails chained
  e2e    — ``HostIngest``: pinned staging on a side stream feeding the
           step, wall-clocked around everything

Sustained end-to-end throughput is min(link, device) when feed and compute
overlap; a shortfall below it is pipeline loss.  int8 ingest (the
reference's IChar format) quarters the link bytes a sample.

``--packed4`` runs the link-bound production path instead: packed 4-bit
tagged frames (1 byte a complex sample) from four staggered antenna
streams, one of which drops a frame, through ``SynchronizedIngest`` (one
sync and one resync event) and ``HostIngest``, unpacked on the card
(``xengine.unpack_packed_4bit_int8``), the int8 fused step, and the
products written by the native ``RollingFileWriter`` with JSON sidecars
into ``--outdir`` (``--no-disk`` skips the writer).

    python -m clenabled_tpu_torch.tools.test_ingest [--steps N] \\
        [--samples-per-step LOG2] [--dtype f32|int8|both] [--packed4] \\
        [--no-disk] [--outdir DIR] [--cpu]

On the CPU (``--cpu``) the step runs its plain form and the copies are
host copies.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _frames(kind: str, a: int, n: int, count: int = 4):
    rng = np.random.default_rng(0)
    if kind == "int8":
        return [(rng.integers(-100, 100, (a, n), dtype=np.int8),
                 rng.integers(-100, 100, (a, n), dtype=np.int8))
                for _ in range(count)]
    return [(rng.standard_normal((a, n)).astype(np.float32),
             rng.standard_normal((a, n)).astype(np.float32))
            for _ in range(count)]


def _seconds(call, reps: int, dev: torch.device) -> float:
    """Seconds a call of ``call()`` over ``reps`` back-to-back calls after
    a warm-up: CUDA events on the card, the host clock on the CPU."""
    call()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / 1e3


def bench_dtype(kind: str, n_log2: int, steps: int, dev) -> dict:
    from clenabled_tpu_torch.pipelines import (FxPipelineConfig,
                                               make_fx_pipeline_fused)
    from clenabled_tpu_torch.streaming.ingest import HostIngest

    dtype = {"f32": torch.float32, "int8": torch.int8}[kind]
    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << n_log2)
    fn, (xr, _, tr, ti) = make_fx_pipeline_fused(cfg, in_dtype=dtype,
                                                 device=dev)
    a, n = xr.shape
    frames = _frames(kind, a, n)
    frame_bytes = frames[0][0].nbytes * 2
    reps = max(2, steps)

    # 1) link: the frame's two planes, pinned host -> device
    pinned = [torch.from_numpy(f).pin_memory() if dev.type == "cuda"
              else torch.from_numpy(f) for f in frames[0]]
    dst = [torch.empty(p.shape, dtype=p.dtype, device=dev) for p in pinned]

    def put():
        for d, p in zip(dst, pinned):
            d.copy_(p, non_blocking=True)

    link_s = _seconds(put, reps, dev)

    # 2) device: the step on device-resident frames, tails chained
    dr, di = dst
    carry = [tr, ti]

    def dev_step():
        out = fn(dr, di, carry[0], carry[1])
        carry[0], carry[1] = out[3], out[4]

    dev_s = _seconds(dev_step, reps, dev)

    # 3) end to end through HostIngest
    def step(c, fr, fi):
        fd, xre, xim, ntr, nti = fn(fr, fi, c[0], c[1])
        return (ntr, nti), (fd, xre, xim)

    ing = HostIngest(step, (tr, ti), samples_per_frame=n, prefetch=2,
                     device=dev)
    ing.run(iter(frames[:1]))            # warm-up: pins the staging ring
    stats = ing.run(frames[i % len(frames)] for i in range(steps))
    link_msps = n / link_s / 1e6
    dev_msps = n / dev_s / 1e6
    e2e_ms = stats["wall_s"] / stats["steps"] * 1e3
    eff = stats.msps / min(link_msps, dev_msps) * 100
    print(f"[{kind}] frame {n} samples/ant x{a} ({frame_bytes / 1e6:.1f} MB)")
    print(f"  link  h2d      {frame_bytes / link_s / 1e9:7.3f} GB/s = "
          f"{link_msps:10.1f} MSPS")
    print(f"  device step    {dev_s * 1e3:7.3f} ms   = {dev_msps:10.1f} MSPS")
    print(f"  end-to-end     {e2e_ms:7.3f} ms   = {stats.msps:10.1f} MSPS  "
          f"({eff:.0f}% of min(link, device))", flush=True)
    return {"dtype": kind, "samples": n, "antennas": a,
            "frame_bytes": frame_bytes, "link_ms": link_s * 1e3,
            "link_gbs": frame_bytes / link_s / 1e9, "link_msps": link_msps,
            "device_ms": dev_s * 1e3, "device_msps": dev_msps,
            "e2e_ms": e2e_ms, "e2e_msps": stats.msps, "steps": stats["steps"],
            "efficiency_pct": eff}


DROP_ANTENNA, DROP_FRAME = 2, 3    # antenna 2 loses its frame 3 (after skew)


def bench_packed4(n_log2: int, steps: int, write_disk: bool, outdir: str,
                  dev) -> dict:
    """Packed 4-bit tagged frames → SynchronizedIngest (staggered starts,
    one dropped frame and a resync) → HostIngest → unpack on the card →
    the int8 fused step → RollingFileWriter."""
    import json
    import os

    from clenabled_tpu_torch.dsp import xengine
    from clenabled_tpu_torch.pipelines import (FxPipelineConfig,
                                               make_fx_pipeline_fused)
    from clenabled_tpu_torch.streaming.ingest import HostIngest
    from clenabled_tpu_torch.streaming.sync import (SynchronizedIngest,
                                                    TaggedFrame)

    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << n_log2)
    fn, (xr, _, tr, ti) = make_fx_pipeline_fused(cfg, in_dtype=torch.int8,
                                                 device=dev)
    a, n = xr.shape
    rng = np.random.default_rng(0)
    pool = [rng.integers(0, 256, (a, n), dtype=np.uint8) for _ in range(4)]
    frame_bytes = pool[0].nbytes

    def source(ant):
        skew = ant           # staggered start timestamps force an alignment
        for ts in range(skew, steps + 8):
            if ant == DROP_ANTENNA and ts == DROP_FRAME + skew:
                continue
            yield TaggedFrame(ts, pool[ts % len(pool)][ant])

    events = []
    sync = SynchronizedIngest([source(i) for i in range(a)],
                              block_multiple=2,
                              on_sync=lambda ts: events.append(("sync", ts)),
                              on_resync=lambda o, t: events.append(
                                  ("resync", o, t)))
    stacked = (np.stack(f) for f in sync)   # [A, n] packed bytes a step

    writer, base = None, None
    if write_disk:
        from clenabled_tpu_torch.native import RollingFileWriter

        os.makedirs(outdir, exist_ok=True)
        base = os.path.join(outdir, "xcorr")
        sidecar = json.dumps({"antennas": a, "channels": cfg.num_channels,
                              "format": "triangular order", "dtype": "f32"})
        writer = RollingFileWriter(base, 1 << 22, sidecar)

    def step(c, raw):
        re8, im8 = xengine.unpack_packed_4bit_int8(raw)    # on the card
        fd, xre, xim, ntr, nti = fn(re8.contiguous(), im8.contiguous(),
                                    c[0], c[1])
        return (ntr, nti), (fd, xre, xim)

    HostIngest(step, (tr, ti), samples_per_frame=n, prefetch=2,
               device=dev).run(iter([pool[0]]))        # warm-up
    marks, wstall, wbytes = [], [0.0], [0]

    def on_outputs(step_no, fetched):
        if writer is not None:
            fd, xre, xim = fetched
            buf = np.ascontiguousarray(np.stack([xre.numpy(), xim.numpy()]))
            t0 = time.perf_counter()
            writer.write(buf)
            wstall[0] += time.perf_counter() - t0
            wbytes[0] += buf.nbytes
        marks.append(time.perf_counter())

    ing = HostIngest(step, (tr, ti), samples_per_frame=n, prefetch=2,
                     fetch_every=1, device=dev)
    stats = ing.run(stacked, n_steps=steps, on_outputs=on_outputs)
    files = 0
    if writer is not None:
        writer.close()
        files = len([f for f in os.listdir(outdir)
                     if f.startswith("xcorr_") and f.endswith(".bin")])
    gbs = stats["steps"] * frame_bytes / stats["wall_s"] / 1e9
    e2e_ms = stats["wall_s"] / stats["steps"] * 1e3
    print(f"[packed4] frame {n} samples/ant x{a} ({frame_bytes / 1e6:.1f} MB "
          f"wire = 1/8 of f32)")
    print(f"  sync events    {events}")
    print(f"  end-to-end     {e2e_ms:7.3f} ms   = {stats.msps:10.1f} "
          f"MSPS/ant  ({gbs:.3f} GB/s wire{', disk on' if write_disk else ''})")
    if writer is not None:
        print(f"  writer         {wbytes[0] / 1e6:.3f} MB in {files} file(s) "
              f"under {outdir}, {wstall[0]:.3f} s in write() "
              f"({100 * wstall[0] / stats['wall_s']:.1f}% of wall)")
    print(f"  steps          {stats['steps']} over {stats['wall_s']:.3f} s "
          f"wall", flush=True)
    return {"samples": n, "antennas": a, "steps": stats["steps"],
            "events": events, "e2e_ms": e2e_ms, "e2e_msps": stats.msps,
            "wire_gbs": gbs, "writer_bytes": wbytes[0], "files": files,
            "write_s": wstall[0], "base": base}


def main(argv=None) -> dict:
    from clenabled_tpu_torch.tools import _timing as T

    ap = argparse.ArgumentParser(description="host-ingest flagship benchmark")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--samples-per-step", type=int, default=22,
                    help="log2 samples per antenna per step")
    ap.add_argument("--dtype", choices=["f32", "int8", "both"],
                    default="both")
    ap.add_argument("--packed4", action="store_true",
                    help="packed-4-bit frames -> SynchronizedIngest -> "
                         "HostIngest -> int8 fused step -> rolling disk")
    ap.add_argument("--no-disk", action="store_true",
                    help="with --packed4: skip the RollingFileWriter")
    ap.add_argument("--outdir", default="clenabled_ingest_out",
                    help="with --packed4: the writer's directory")
    args = ap.parse_args(argv)
    dev = T.select_device(args)
    print(f"platform: {T.platform_banner(dev)}", flush=True)
    if args.packed4:
        return {"packed4": bench_packed4(args.samples_per_step, args.steps,
                                         not args.no_disk, args.outdir, dev)}
    names = ["f32", "int8"] if args.dtype == "both" else [args.dtype]
    return {nm: bench_dtype(nm, args.samples_per_step, args.steps, dev)
            for nm in names}


if __name__ == "__main__":
    main()
