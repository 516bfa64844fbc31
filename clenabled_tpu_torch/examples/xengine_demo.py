"""X-Engine interferometry demo — the port of ``examples/xengine_demo.py``
(the reference's examples/xcorr_clxengine.grc): 4 antennas with a
correlated source between two of them, integrated by the FX correlator;
the triangular correlation matrix leaves through the "xcorr" message port
and is written to rolling files with a JSON sidecar (the clXEngine
direct-to-disk path, through the native writer).

    python -m clenabled_tpu_torch.examples.xengine_demo [--cpu]

Runs on the first CUDA card; ``--cpu`` runs it on the CPU.  The
complex-float engine is the plain torch form on both devices, as the JAX
script's is XLA.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from clenabled_tpu_torch import blocks, native
from clenabled_tpu_torch.dsp import xengine as dsp_xengine
from clenabled_tpu_torch.examples import _common
from clenabled_tpu_torch.streaming import Flowgraph


def main(argv=None) -> dict:
    args = _common.parser(__doc__).parse_args(argv)
    dev = _common.device(args, "xengine_demo")
    stations, channels, integration, npol = 4, 64, 128, 1
    rng = np.random.default_rng(2)

    xe = blocks.XEngine(
        data_type=1, polarization=npol, num_inputs=stations,
        num_channels=channels, integration=integration,
        antenna_list=[f"ant{i}" for i in range(stations)],
    )
    g = Flowgraph()
    for s in range(stations):
        g.external_input(xe, s)
    frame = integration * channels * npol
    r = g.compile(frame_size=frame, device=dev)

    outdir = tempfile.mkdtemp(prefix="xengine_")
    sidecar = json.dumps({
        "antennas": xe.antenna_list, "channels": channels,
        "polarizations": npol,
        "baselines": dsp_xengine.num_baselines(stations),
        "data_format": "triangular order",
    })
    writer = native.RollingFileWriter(os.path.join(outdir, "xcorr"),
                                      rollover_bytes=1 << 20,
                                      sidecar_json=sidecar)
    st = dsp_xengine.baseline_stations(stations)
    matrices, best_pairs = [], []

    def on_xcorr(m):
        mat = _common.host(m["matrix"])
        writer.write(mat.astype(np.complex64).view(np.float32))
        cross = np.abs(mat).mean(axis=(0, 2))
        best = max((k for k in range(len(st)) if st[k][0] != st[k][1]),
                   key=lambda k: cross[k])
        matrices.append(mat)
        best_pairs.append((int(st[best][0]), int(st[best][1])))
        print(f"  strongest cross baseline: "
              f"ant{st[best][0]}–ant{st[best][1]}")

    r.on_message("xengine.xcorr", on_xcorr)

    feeds = []
    for it in range(3):
        # common source between antennas 0 and 2
        common = (rng.standard_normal((integration, channels))
                  + 1j * rng.standard_normal((integration, channels))
                  ).astype(np.complex64)
        feeds.append([])
        for s in range(stations):
            z = 0.2 * (rng.standard_normal((integration, channels))
                       + 1j * rng.standard_normal((integration, channels))
                       ).astype(np.complex64)
            if s in (0, 2):
                z += common
            feeds[-1].append(z.reshape(-1))
        print(f"integration {it}:")
        r.step(*feeds[-1])

    writer.close()                       # drains the writer's queue
    files = sorted(os.listdir(outdir))
    print("output files:", files)
    return {"device": str(dev), "outdir": outdir, "files": files,
            "feeds": feeds, "matrices": np.stack(matrices),
            "baselines": best_pairs}


if __name__ == "__main__":
    main()
