"""Synchronized multi-antenna X-Engine chain — the port of
``examples/xengine_synchronized.py`` (the reference's clXEngine with
``internal_synchronizer=True`` + IChar ingest + direct-to-disk,
lib/clXEngine_impl.cc:1158-1226, :831-845, :438-465), end to end:

  tagged capture streams (misaligned starts, one mid-stream drop)
      → SynchronizedIngest  (consume tags until aligned; "sync" PDU;
                             drop detection + re-sync on the block grid)
      → XEngine block       (channel-major stacked Gram, IChar samples
                             int8 all the way to the Gram)
      → RollingFileWriter   (binary matrices + JSON sidecar)

    python -m clenabled_tpu_torch.examples.xengine_synchronized [--cpu]

Runs on the first CUDA card, where every aligned window launches the int8
Gram kernel (``hopper_kernels.xengine_gram_stacked_tri``) once; ``--cpu``
runs its plain form on the CPU.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from clenabled_tpu_torch import blocks, native
from clenabled_tpu_torch.dsp import xengine as dsp_xengine
from clenabled_tpu_torch.examples import _common
from clenabled_tpu_torch.streaming import (Flowgraph, SynchronizedIngest,
                                           TaggedFrame)


def main(argv=None) -> dict:
    args = _common.parser(__doc__).parse_args(argv)
    dev = _common.device(args, "xengine_synchronized")
    stations, channels, integration, npol = 4, 32, 64, 2
    frame_items = integration * channels * npol * 2   # IChar bytes per window
    rng = np.random.default_rng(5)

    # --- capture simulation: per-antenna tagged IChar windows ------------
    n_windows, offsets = 24, [0, 3, 1, 2]
    common = rng.integers(-60, 61, (n_windows + 8, integration,
                                    channels, npol, 2))

    def capture(s):
        """Antenna s's stream: starts ``offsets[s]`` windows late; antenna
        1 drops two windows mid-stream (re-sync will be exercised)."""
        for w in range(offsets[s], n_windows):
            if s == 1 and w in (13, 14):
                continue
            noise = rng.integers(-15, 16, common.shape[1:])
            sig = common[w] if s in (0, 2) else 0
            raw = np.clip(sig + noise, -127, 127).astype(np.int8)
            yield TaggedFrame(w, raw.reshape(-1))

    # --- flowgraph: IChar → channel-major stacked X-Engine sink ----------
    xe = blocks.XEngine(
        data_type=5, polarization=npol, num_inputs=stations,
        num_channels=channels, integration=integration, planar=True,
        pipeline_integration=4,
        antenna_list=[f"ant{i}" for i in range(stations)],
    )
    assert xe.channel_major   # the int8-to-Gram fast path
    g = Flowgraph()
    for s in range(stations):
        g.external_input(xe, s)
    r = g.compile(frame_size=frame_items, device=dev)

    outdir = tempfile.mkdtemp(prefix="xengine_sync_")
    sidecar = {
        "antennas": xe.antenna_list, "channels": channels,
        "polarizations": npol,
        "baselines": dsp_xengine.num_baselines(stations),
        "data_format": "triangular order", "sync_timestamp": None,
        "resyncs": [],
    }
    writer = native.RollingFileWriter(os.path.join(outdir, "xcorr"),
                                      rollover_bytes=1 << 20,
                                      sidecar_json=json.dumps(sidecar))
    st = dsp_xengine.baseline_stations(stations)
    emitted, matrices, events = [], [], []

    def on_xcorr(m):
        if not bool(m["valid"]):          # a host flag
            return
        re, im = _common.host(m["matrix"].re), _common.host(m["matrix"].im)
        mat = np.empty(re.shape, np.complex64)
        mat.real, mat.imag = re, im
        writer.write(mat.view(np.float32))
        cross = np.abs(mat).mean(axis=(0, 2))
        best = max((k for k in range(len(st)) if st[k][0] != st[k][1]),
                   key=lambda k: cross[k])
        emitted.append((int(st[best][0]), int(st[best][1])))
        matrices.append(mat)
        print(f"  integration emitted: strongest cross baseline "
              f"ant{st[best][0]}-ant{st[best][1]}")

    r.on_message("xengine.xcorr", on_xcorr)

    def on_sync(ts):
        events.append(("sync", ts))
        print(f"sync PDU: aligned at window {ts}")

    def on_resync(old, new):
        events.append(("resync", old, new))
        print(f"  drop detected at window {old} -> re-synced at {new} "
              f"(integration grid preserved)")

    # --- the synchronizer drives the runner ------------------------------
    ingest = SynchronizedIngest(
        [capture(s) for s in range(stations)], block_multiple=4,
        on_sync=on_sync, on_resync=on_resync)
    windows = []

    def aligned():
        # the windows the runner takes, one tuple of station bytes each
        for feeds in ingest:
            windows.append(feeds)
            yield feeds

    r.run(aligned())

    writer.close()                       # drains the writer's queue
    assert emitted and all(b == (2, 0) for b in emitted), emitted
    files = sorted(os.listdir(outdir))
    print("output files:", files)
    print(f"{len(emitted)} integrations written; correlated pair "
          "recovered through misaligned + dropped-frame capture")
    return {"device": str(dev), "outdir": outdir, "files": files,
            "events": events, "baselines": emitted,
            "matrices": np.stack(matrices), "windows": windows,
            "pipeline_integration": 4, "shape": (channels, integration,
                                                 stations * npol)}


if __name__ == "__main__":
    main()
