"""FM receive chain — the port of ``examples/fm_receiver.py`` (the role of
the reference's per-block test flowgraphs,
examples/test_flowgraphs/OpenCL_Test-*.grc): an FM-modulated tone →
complex LowPass (time domain) → QuadratureDemod, streaming over three
frames with carried filter and demodulator state.

    python -m clenabled_tpu_torch.examples.fm_receiver [--cpu]

Runs on the first CUDA card; ``--cpu`` runs it on the CPU.  On complex64
streams no hand-written kernel runs: the filter and the demodulator take
their plain torch forms, as the JAX script's complex path runs XLA.
"""

from __future__ import annotations

import numpy as np

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch.examples import _common
from clenabled_tpu_torch.streaming import Flowgraph


def main(argv=None) -> dict:
    args = _common.parser(__doc__).parse_args(argv)
    dev = _common.device(args, "fm_receiver")
    fs, frame = 1e6, 8192
    dev_hz, f_audio = 75e3, 5e3

    lpf = blocks.LowPassFilter(1, 1.0, fs, 150e3, 50e3, use_time=True)
    qd = blocks.QuadratureDemod(fs / (2 * np.pi * dev_hz))
    g = Flowgraph()
    g.external_input(lpf)
    g.connect(lpf, qd)
    tap = g.tap(qd, name="audio")
    r = g.compile(frame_size=frame, device=dev)

    t_all = np.arange(3 * frame) / fs
    msg = np.sin(2 * np.pi * f_audio * t_all)
    iq = np.exp(1j * 2 * np.pi * dev_hz * np.cumsum(msg) / fs).astype(
        np.complex64)

    gd = (len(lpf.taps()) - 1) // 2  # FIR group delay in samples
    audio, errs = [], []
    for i in range(3):
        a = _common.host(r.step(iq[i * frame:(i + 1) * frame])[tap])
        lo, hi = i * frame + 100, (i + 1) * frame
        err = float(np.abs(a[100:] - msg[lo - gd:hi - gd]).max())
        print(f"frame {i}: recovered audio, max err vs message = {err:.3e} "
              f"(group-delay compensated by {gd} samples)")
        audio.append(a)
        errs.append(err)
    return {"device": str(dev), "iq": iq, "audio": np.stack(audio),
            "errors": errs, "group_delay": gd, "frame": frame}


if __name__ == "__main__":
    main()
