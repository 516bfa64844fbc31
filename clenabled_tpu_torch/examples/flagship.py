"""The flagship pipeline — the port of ``examples/tpu_flagship.py``: a
4-antenna, 16-channel PFB channelizer + FD cross-correlator + X-Engine,
which on the card is ONE fused kernel
(``hopper_kernels.fx_correlate_streams_v2``) a step.  Shows delay
recovery and baseline detection at full rate.

    python -m clenabled_tpu_torch.examples.flagship [--cpu] [--percall]

On the first CUDA card: ``pipelines.make_fx_pipeline_fused`` at 2^21
samples an antenna a step, 20 chained steps timed with CUDA events after
two warm-up steps (``--percall``: a synchronise after each, on the host
clock), the rate line naming the card and its power limit.  With
``--cpu``: the planar step's plain torch form
(``make_fx_pipeline_planar(use_kernel=False)``) at 2^17 samples and 3
steps, as the JAX script's CPU branch.  The flag alone makes that
choice.
"""

from __future__ import annotations

import numpy as np
import torch

from clenabled_tpu_torch.dsp import xengine
from clenabled_tpu_torch.examples import _common
from clenabled_tpu_torch.pipelines import (FxPipelineConfig,
                                           make_fx_pipeline_fused,
                                           make_fx_pipeline_planar)
from clenabled_tpu_torch.tools import _timing


def sky_inputs(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(xr, xi) [4, n] float32: a common sky signal on antennas 0 and 2,
    noise on every antenna, drawn as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    sky_r = rng.standard_normal(n).astype(np.float32)
    sky_i = rng.standard_normal(n).astype(np.float32)
    xr = 0.3 * rng.standard_normal((4, n)).astype(np.float32)
    xi = 0.3 * rng.standard_normal((4, n)).astype(np.float32)
    for ant in (0, 2):
        xr[ant] += sky_r
        xi[ant] += sky_i
    return xr, xi


def main(argv=None) -> dict:
    args = _common.parser(__doc__).parse_args(argv)
    dev = _common.device(args, "flagship")
    on_cpu = dev.type == "cpu"
    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << (17 if on_cpu else 21))
    if on_cpu:
        fn, (_, _, h0r, h0i) = make_fx_pipeline_planar(cfg, use_kernel=False,
                                                       device=dev)
    else:
        fn, (_, _, h0r, h0i) = make_fx_pipeline_fused(cfg, device=dev)
    n = cfg.samples_per_step
    xr_np, xi_np = sky_inputs(n)
    xr = torch.as_tensor(xr_np, device=dev)
    xi = torch.as_tensor(xi_np, device=dev)

    last = {}

    def step(tails, xr, xi):
        # one step from the carried tails; keep the last one's inputs and
        # outputs
        last["tails"] = tails
        last["out"] = fn(xr, xi, *tails)
        return last["out"][3:], None

    # chained steps from the zero tail after two warm-up steps, on CUDA
    # events (the host clock with --percall or on the CPU)
    iters = 3 if on_cpu else 20
    secs = _timing.time_stateful(step, (h0r, h0i), xr, xi, iterations=iters,
                                 device=dev, percall=args.percall)
    fd, xre, xim, hr, hi = last["out"]

    power = np.abs(_common.host(xre) + 1j * _common.host(xim)).mean(
        axis=(0, 2))
    st = xengine.baseline_stations(4)
    cross = [k for k in range(len(st)) if st[k][0] != st[k][1]]
    best = cross[int(np.argmax(power[cross]))]
    print(f"X-Engine strongest cross baseline: "
          f"ant{st[best][0]}–ant{st[best][1]} (expected ant2–ant0)")
    msps = n / secs / 1e6
    print(f"pipeline: {msps:.1f} MSPS/antenna on "
          f"{_timing.platform_banner(dev)}")
    return {"device": str(dev), "samples_per_step": n, "steps": iters + 2,
            "timed_steps": iters, "step_s": secs, "msps": msps,
            "baseline": (int(st[best][0]), int(st[best][1])),
            "inputs": (xr_np, xi_np), "fd": _common.host(fd),
            "xre": _common.host(xre), "xim": _common.host(xim),
            "tails": (_common.host(hr), _common.host(hi)),
            "step": fn, "last_step": (xr, xi, *last["tails"])}


if __name__ == "__main__":
    main()
