"""Time-domain cross-correlation demo — the port of
``examples/xcorr_test.py`` (the reference's examples/xcorr_test_opencl.grc):
a common wideband signal received on two paths with a controlled delay;
the correlator recovers the delay through its "corr" message port.

    python -m clenabled_tpu_torch.examples.xcorr_test [--delay 37] [--cpu]

Runs on the first CUDA card; ``--cpu`` runs it on the CPU.  The complex
low-pass filters and the correlator are plain torch, as the JAX script's
complex path is XLA.
"""

from __future__ import annotations

import numpy as np

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch.examples import _common
from clenabled_tpu_torch.streaming import Flowgraph


def main(argv=None) -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--delay", type=int, default=37)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)
    dev = _common.device(args, "xcorr_test")

    fs, frame = 2.4e6, 8192
    rng = np.random.default_rng(0)
    # wideband "sky" signal + independent receiver noise
    n_total = frame * (args.frames + 1)
    sky = (rng.standard_normal(n_total) + 1j * rng.standard_normal(n_total)
           ).astype(np.complex64)

    lpf0 = blocks.LowPassFilter(1, 1.0, fs, 300e3, 100e3, use_time=True)
    lpf1 = blocks.LowPassFilter(1, 1.0, fs, 300e3, 100e3, use_time=True)
    xc = blocks.XCorrelate(2, signal_length=frame, max_search_index=512)
    g = Flowgraph()
    g.external_input(lpf0)
    g.external_input(lpf1)
    g.connect(lpf0, xc, dst_port=0)
    g.connect(lpf1, xc, dst_port=1)
    r = g.compile(frame_size=frame, device=dev)
    got = {"corr": [], "lags": [], "corrvect": []}

    def on_corr(m):
        # the message holds device tensors; read them on the host
        corr = float(_common.host(m["corr"])[0])
        lag = int(_common.host(m["corrective_lags"])[0])
        got["corr"].append(corr)
        got["lags"].append(lag)
        got["corrvect"].append(_common.host(m["corrvect"])[0])
        print(f"  corr={corr:.3f}  lag={lag} (true delay {args.delay})")

    r.on_message("xcorr.corr", on_corr)

    feeds = []
    for i in range(args.frames):
        base = 512 + i * frame
        a = sky[base:base + frame]
        b = sky[base - args.delay:base - args.delay + frame]
        noise = 0.3 * (rng.standard_normal((2, frame))
                       + 1j * rng.standard_normal((2, frame))).astype(
                           np.complex64)
        print(f"frame {i}:")
        feeds.append((a + noise[0], b + noise[1]))
        r.step(*feeds[-1])
    return {"device": str(dev), "feeds": feeds, "corr": got["corr"],
            "lags": got["lags"], "corrvect": np.stack(got["corrvect"])}


if __name__ == "__main__":
    main()
