"""Host→device ingest pipeline for sustained streaming.

The port of ``clenabled_tpu.streaming.ingest``.  The reference's answer to
host-feed overlap is pinned double buffers plus a worker thread
(clXEngine_impl.cc:325-366, 1234-1299): work() copies into buffer B while
the GPU correlates buffer A.  Here:

  * a prefetch thread stages each frame in a ring of pinned host buffers
    and copies it to the device with ``non_blocking=True`` on a side
    stream, recording a CUDA event after the copy;
  * the main thread makes the compute stream wait on that event before the
    step consumes the frame, so copy and compute overlap and stay ordered;
  * a pinned buffer is refilled only after its previous copy's event has
    completed;
  * carried state never leaves the device, and only the (small) per-step
    outputs are fetched, every ``fetch_every`` steps.

On the CPU the frames are passed through as tensors and no stream is used.
"""

from __future__ import annotations

import threading
import time
from queue import Queue
from typing import Any, Callable, Iterable

import numpy as np
import torch


class HostIngestStats(dict):
    @property
    def msps(self) -> float:
        return self["samples"] / self["wall_s"] / 1e6 if self["wall_s"] else 0.0


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


class HostIngest:
    """Double-buffered host-feed driver.

    Args:
      step_fn: ``(carry, *frame_tensors) -> (carry, outputs)``.
      init_carry: initial device-resident carry.
      samples_per_frame: per-step input samples (for throughput accounting).
      prefetch: frames staged ahead of compute (2 = classic double buffer).
      fetch_every: copy ``outputs`` to the host every N steps (0 = never);
        outputs are assumed SMALL (correlation products, not streams).
      device: where the step runs (``cuda:N`` or ``cpu``).
    """

    def __init__(self, step_fn: Callable, init_carry: Any,
                 samples_per_frame: int, prefetch: int = 2,
                 fetch_every: int = 0, device="cuda:0"):
        self._step = step_fn
        self._carry = init_carry
        self._n = samples_per_frame
        self._prefetch = max(1, prefetch)
        self._fetch_every = fetch_every
        self._dev = torch.device(device)
        self._ring: list[tuple | None] = []
        self._done: list[torch.cuda.Event | None] = []

    @property
    def carry(self):
        return self._carry

    def _cpu_uploader(self, frames, q: Queue) -> None:
        for f in frames:
            q.put((tuple(_as_tensor(x) for x in f), None))

    def _cuda_uploader(self, frames, q: Queue) -> None:
        side = torch.cuda.Stream(self._dev)
        # ring of pinned staging buffers (prefetch frames queued, one being
        # consumed, one being filled), kept across runs so that a warm-up
        # run pays for pinning them
        if len(self._ring) != self._prefetch + 2:
            self._ring = [None] * (self._prefetch + 2)
            self._done = [None] * len(self._ring)
        ring, done = self._ring, self._done
        with torch.cuda.stream(side):
            for i, f in enumerate(frames):
                slot = i % len(ring)
                if done[slot] is not None:
                    done[slot].synchronize()     # its last copy has finished
                host = tuple(_as_tensor(x) for x in f)
                if ring[slot] is None or any(
                        p.shape != h.shape or p.dtype != h.dtype
                        for p, h in zip(ring[slot], host)):
                    ring[slot] = tuple(torch.empty(h.shape, dtype=h.dtype,
                                                   pin_memory=True)
                                       for h in host)
                dev = []
                for p, h in zip(ring[slot], host):
                    p.copy_(h)
                    dev.append(p.to(self._dev, non_blocking=True))
                ev = torch.cuda.Event()
                ev.record(side)
                done[slot] = ev
                q.put((tuple(dev), ev))

    def run(self, frames: Iterable, n_steps: int | None = None,
            on_outputs: Callable | None = None) -> HostIngestStats:
        """Drive the pipeline over an iterable of host frame tuples (numpy
        arrays or CPU tensors), passed to step_fn after the carry.  Returns
        sustained-throughput stats (wall time around the WHOLE pipeline,
        host feed included)."""
        q: Queue = Queue(maxsize=self._prefetch)
        stop = object()
        errors: list[BaseException] = []
        on_cuda = self._dev.type == "cuda"

        def items():
            for i, f in enumerate(frames):
                if n_steps is not None and i >= n_steps:
                    break
                yield f if isinstance(f, tuple) else (f,)

        def uploader():
            try:
                if on_cuda:
                    self._cuda_uploader(items(), q)
                else:
                    self._cpu_uploader(items(), q)
            except BaseException as e:  # re-raised on the main thread
                errors.append(e)
            q.put(stop)

        th = threading.Thread(target=uploader, daemon=True)
        t0 = time.perf_counter()
        th.start()
        steps = 0
        while True:
            item = q.get()
            if item is stop:
                break
            frame, ready = item
            if on_cuda:
                compute = torch.cuda.current_stream(self._dev)
                compute.wait_event(ready)
                for x in frame:
                    x.record_stream(compute)
            self._carry, outputs = self._step(self._carry, *frame)
            steps += 1
            if self._fetch_every and steps % self._fetch_every == 0:
                fetched = _to_host(outputs)
                if on_outputs is not None:
                    on_outputs(steps, fetched)
        if on_cuda:
            torch.cuda.synchronize(self._dev)
        wall = time.perf_counter() - t0
        th.join()
        if errors:
            raise errors[0]
        return HostIngestStats(steps=steps, wall_s=wall,
                               samples=steps * self._n)
