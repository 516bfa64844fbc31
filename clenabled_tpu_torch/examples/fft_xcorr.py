"""Frequency-domain cross-correlation chain — the port of
``examples/fft_xcorr.py`` (the reference's
examples/fft_xcorr_opencl_uhd2_30MSPS.grc): two antenna streams → forward
FFT → XCorrelateFFTVCF → a correlation-magnitude vector whose peak
position encodes the inter-antenna delay.

    python -m clenabled_tpu_torch.examples.fft_xcorr [--cpu]

Runs on the first CUDA card; ``--cpu`` runs it on the CPU.  The streams
are complex64, which the FFT block transforms with ``torch.fft`` (the JAX
script's run on its library FFT too), so no hand-written kernel runs.
"""

from __future__ import annotations

import numpy as np

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch.examples import _common
from clenabled_tpu_torch.streaming import Flowgraph


def main(argv=None) -> dict:
    args = _common.parser(__doc__).parse_args(argv)
    dev = _common.device(args, "fft_xcorr")
    fft_size, delay = 2048, 25
    rng = np.random.default_rng(1)
    base = rng.standard_normal(3 * fft_size).astype(np.float32)
    a = (base[512:512 + fft_size] + 0j).astype(np.complex64)
    b = (base[512 - delay:512 - delay + fft_size] + 0j).astype(np.complex64)

    fft = blocks.Fft(fft_size, num_streams=2)
    xc = blocks.XCorrelateFFTVCF(fft_size, num_inputs=2)
    g = Flowgraph()
    g.external_input(fft, 0)
    g.external_input(fft, 1)
    g.connect(fft, xc, src_port=0, dst_port=0)
    g.connect(fft, xc, src_port=1, dst_port=1)
    tap = g.tap(xc, name="corr_mag")
    r = g.compile(frame_size=fft_size, device=dev)
    out = _common.host(r.step(a, b)[tap])
    peak = int(out.argmax())
    # b lags a by `delay` samples → peak appears at center − delay
    print(f"correlation peak at bin {peak} → recovered delay "
          f"{fft_size // 2 - peak} (true delay {delay})")
    return {"device": str(dev), "inputs": (a, b), "corr": out, "peak": peak,
            "delay": fft_size // 2 - peak}


if __name__ == "__main__":
    main()
