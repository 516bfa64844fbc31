"""Max-rate correlator throughput demo — the port of
``examples/xcorr_max_rate.py`` (the reference's
examples/xcorr_test_max_rate_no_ui.grc): no UI, just the time-domain
correlator (``dsp.xcorr.td_xcorr``) pushed as fast as the device goes.

    python -m clenabled_tpu_torch.examples.xcorr_max_rate [--frames 50] \\
        [--signal_length 262144] [--max_search 512] [--cpu] [--percall]

Runs on the first CUDA card; ``--cpu`` runs it on the CPU.  On the card
the frames are chained calls timed with CUDA events after two warm-up
calls (``--percall``: a synchronise after each); the rate line names the
card and its power limit.  The correlator is plain torch on both devices.
"""

from __future__ import annotations

import numpy as np
import torch

from clenabled_tpu_torch.dsp import xcorr
from clenabled_tpu_torch.examples import _common
from clenabled_tpu_torch.tools import _timing


def main(argv=None) -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--signal_length", type=int, default=1 << 18)
    ap.add_argument("--max_search", type=int, default=512)
    args = ap.parse_args(argv)
    dev = _common.device(args, "xcorr_max_rate")

    n = args.signal_length
    rng = np.random.default_rng(0)
    sigs = torch.as_tensor(rng.standard_normal((2, n)).astype(np.float32),
                           device=dev)
    out = []

    def frame():
        out[:] = [xcorr.td_xcorr(sigs, args.max_search)]

    secs = _timing.time_fn(frame, iterations=args.frames, device=dev,
                           percall=args.percall)
    msps = n / secs / 1e6
    print(f"TD correlator: {msps:.1f} MSPS sustained "
          f"({args.frames} frames of {n} samples, ±{args.max_search} lags; "
          f"{_timing.platform_banner(dev)})")
    res = out[0]
    return {"device": str(dev), "msps": msps, "seconds_per_frame": secs,
            "signals": _common.host(sigs), "corr": _common.host(res.corr),
            "lag": _common.host(res.lag),
            "corr_vectors": _common.host(res.corr_vectors)}


if __name__ == "__main__":
    main()
