"""Profiling harness: a ``torch.profiler`` trace of the flagship step.

The reference has only std::chrono benchmark loops and debug prints; here
a device trace.  Runs ``--steps`` fused steps
(``pipelines.make_fx_pipeline_fused``, 4 antennas, 16 channels, the
``fx_correlate_streams_v2`` kernel), or the planar step with
``--pipeline planar`` (the ``pfb_channelize_packed`` kernel and torch
ops), after one warm-up step, with the tails carried; writes the trace as
``trace.json`` (Chrome format: chrome://tracing or perfetto) into
``--outdir`` and prints the five kernels with the most device time in
the steps' marked window (the CPU ops with the most self time on
``--cpu``).  The profiler can miss the first milliseconds of device
work in a trace, so each opens with 30 ms of uncounted steps, and a window that
holds fewer of the port's kernels than its wrappers counted launches is
taken again, up to three times (as ``chip_smoke.py`` does).

    python -m clenabled_tpu_torch.tools.profile --outdir /tmp/trace \\
        [--steps 5] [--samples-per-step 2097152] [--pipeline planar] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import time

WINDOW = "clenabled_steps"     # the marked window of the traced steps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="trace the flagship step")
    ap.add_argument("--outdir", default="clenabled_trace")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--samples-per-step", type=int, default=1 << 21)
    ap.add_argument("--pipeline", choices=["fused", "planar"],
                    default="fused")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from clenabled_tpu_torch.dsp import hopper_kernels as hk
    from clenabled_tpu_torch.pipelines import (FxPipelineConfig,
                                               make_fx_pipeline_fused,
                                               make_fx_pipeline_planar)
    from clenabled_tpu_torch.tools import _timing as T

    dev = T.select_device(args)
    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=args.samples_per_step)
    make = make_fx_pipeline_fused if args.pipeline == "fused" \
        else make_fx_pipeline_planar
    fn, (xr, _, tr, ti) = make(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xr = torch.randn(xr.shape, generator=gen, device=dev)
    xi = torch.randn(xr.shape, generator=gen, device=dev)
    out = fn(xr, xi, tr, ti)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    bodies = hk.FX_BODIES + hk.PFB_PACKED_BODIES
    carry = [out]

    def step():
        carry[0] = fn(xr, xi, carry[0][3], carry[0][4])

    for _ in range(3):
        with profile(activities=acts) as prof:
            if on_card:
                # the profiler can miss the first milliseconds of device
                # work in a trace: open it with 30 ms of uncounted steps
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < 0.03:
                    step()
                    torch.cuda.synchronize(dev)
            before = sum(hk.launch_counts().values())
            with record_function(WINDOW):
                for _ in range(args.steps):
                    step()
                if on_card:
                    torch.cuda.synchronize(dev)
            launched = sum(hk.launch_counts().values()) - before
        if not on_card:
            break
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.events()
        start = min(e.time_range.start for e in events if e.name == WINDOW)
        window = [e for e in events if e.device_type == cuda
                  and e.name != WINDOW and e.time_range.start >= start]
        recorded = sum(any(b in e.name for b in bodies) for e in window)
        if recorded >= launched:
            break
        print(f"the trace holds {recorded} of the {launched} kernel "
              f"launches counted in it; taken again", flush=True)
    per: dict = {}
    if on_card:
        for e in window:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, "trace.json")
    prof.export_chrome_trace(path)
    if on_card:
        what = "kernels by device time"
    else:
        per = {e.key: e.self_cpu_time_total
               for e in prof.key_averages() if e.key != WINDOW}
        what = "CPU ops by self time"
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    print(f"platform: {T.platform_banner(dev)}   {args.pipeline} step "
          f"4 x {args.samples_per_step}, {args.steps} steps traced")
    print(f"trace written to {path} (chrome://tracing or perfetto)")
    print(f"top {len(top)} {what}:")
    for name, us in top:
        print(f"  {us / args.steps / 1e3:10.4f} ms/step  {name}")
    return {"trace": path,
            "top": [(name, us / args.steps / 1e3) for name, us in top]}


if __name__ == "__main__":
    main()
