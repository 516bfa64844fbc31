"""Production-style streaming ingest — the port of
``examples/streaming_ingest.py``: native ring buffer + flowgraph.

A capture thread produces packed 4-bit I/Q bytes into the lock-free native
ring (the role of the reference's pinned double buffers and worker thread,
lib/clXEngine_impl.cc:304-382); the main loop pops fixed frames, unpacks
them to planar float pairs in C++ (``native.unpack_4bit_planar``) and
drives a planar LowPass (49 taps, time domain) → QuadratureDemod
flowgraph, reporting the sustained rate from the Runner's counters.

    python -m clenabled_tpu_torch.examples.streaming_ingest [--seconds 3] \\
        [--frame 65536] [--cpu]

Runs on the first CUDA card, where each frame launches the direct-FIR
kernel (``hopper_kernels.fir_direct``) and the demodulator kernel
(``hopper_kernels.qdemod_fused``) once; ``--cpu`` runs their plain forms
on the CPU.  The rate counts the Runner's dispatch time
(``Runner.stats["wall_s"]``) plus the wait for the device's queued work
after the last frame.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from clenabled_tpu_torch import blocks, native
from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.examples import _common
from clenabled_tpu_torch.streaming import Flowgraph


def build_chain(frame: int, dev):
    """(runner, tap name, filter block) of the planar LowPass →
    QuadratureDemod chain on ``dev``; the runner also taps the filtered
    stream as "filtered"."""
    lpf = blocks.LowPassFilter(1, 1.0, 10e6, 1.5e6, 500e3, use_time=True,
                               planar=True)
    qd = blocks.QuadratureDemod(1.0, planar=True)
    g = Flowgraph()
    g.external_input(lpf)
    g.connect(lpf, qd)
    tap = g.tap(qd, name="audio")
    g.tap(lpf, name="filtered")
    return g.compile(frame_size=frame, device=dev), tap, lpf


def step(runner, raw: np.ndarray) -> dict:
    """One frame of packed 4-bit bytes through the chain: its tapped
    outputs, on the runner's device."""
    re, im = native.unpack_4bit_planar(raw)
    return runner.step(planar.PC(re, im))


def main(argv=None) -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--frame", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    dev = _common.device(args, "streaming_ingest")

    frame = args.frame
    rb = native.RingBuffer(1 << 24)
    stop = threading.Event()

    def capture():
        """Simulated SDR front end: packed 4-bit bytes at the ring's rate."""
        rng = np.random.default_rng(0)
        chunk = rng.integers(0, 256, 1 << 18, dtype=np.uint8)
        while not stop.is_set():
            if rb.space() >= chunk.nbytes:
                rb.write(chunk)
            else:
                time.sleep(0.0005)

    producer = threading.Thread(target=capture, daemon=True)
    producer.start()
    r, tap, lpf = build_chain(frame, dev)

    deadline = time.time() + args.seconds
    frames = 0
    raws = [None, None]                 # the last two frames' bytes
    outs = [None, None]                 # and their tapped outputs
    try:
        while time.time() < deadline:
            if rb.available() < frame:   # a short read would drop bytes
                time.sleep(0.0005)
                continue
            raw = rb.read(frame)  # 1 byte = 1 packed complex sample
            raws = [raws[1], raw]
            outs = [outs[1], step(r, raw)]
            frames += 1
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # block on the last frame
        drain_s = time.perf_counter() - t0
    finally:
        stop.set()
        producer.join()
        rb.close()
    wall = r.stats["wall_s"] + drain_s
    msps = frames * frame / max(wall, 1e-9) / 1e6
    print(f"ingest chain sustained {msps:.1f} MSPS over {frames} frames "
          f"(ring → C++ unpack → LPF → demod)")
    last = outs[1] or {}
    return {"device": str(dev), "frames": frames, "frame": frame,
            "msps": msps, "wall_s": wall, "drain_s": drain_s,
            "taps": np.asarray(lpf.taps(), np.float32), "raws": raws,
            "audio": _common.host(last[tap]) if last else None,
            "filtered": [None if o is None else
                         tuple(_common.host(c) for c in o["filtered"])
                         for o in outs]}


if __name__ == "__main__":
    main()
