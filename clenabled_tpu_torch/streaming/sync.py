"""Multi-stream synchronizer — the clXEngine internal ATA-SNAP synchronizer
(lib/clXEngine_impl.cc:1158-1226) as a host-side utility.

The port's copy of ``clenabled_tpu.streaming.sync``, which imports no JAX:
the same plans, rounding, discards, resync and callbacks.  Frame data
passes through untouched (numpy arrays or torch tensors); the port's
``Runner`` moves it to its device.

The reference reads per-stream timestamp tags and, until synchronized,
consumes samples from each stream so all N inputs align on the HIGHEST
starting timestamp, stepping in multiples of 16 frames (:111-116).  Here the
capture layer tracks a starting timestamp per stream (one tick per frame of
``frame_len`` samples); :meth:`plan` returns how many frames each stream
must discard, and the sync timestamp to publish (the "sync" PDU analogue).

:class:`SynchronizedIngest` is the tag-CONSUMING integration: it wraps N
per-stream tagged-frame iterators, applies the discards automatically, and
yields aligned feed tuples directly drivable by ``Runner.run`` — the role
of the reference's in-``general_work`` consume-until-aligned loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, NamedTuple


@dataclass
class SyncPlan:
    sync_timestamp: int
    discard_frames: list[int]  # per stream

    @property
    def synchronized(self) -> bool:
        return all(d == 0 for d in self.discard_frames)


class StreamSynchronizer:
    """Aligns N streams on their highest starting timestamp."""

    def __init__(self, num_inputs: int, block_multiple: int = 16):
        if num_inputs < 1:
            raise ValueError("need at least one stream")
        # the reference requires integrations in multiples of 16 (:111-116)
        self.num_inputs = num_inputs
        self.block_multiple = block_multiple

    def plan(self, start_timestamps: list[int]) -> SyncPlan:
        """Given each stream's next-frame timestamp, compute per-stream
        frames to discard so all start at the same (highest, rounded up to
        the block multiple) timestamp."""
        if len(start_timestamps) != self.num_inputs:
            raise ValueError(
                f"expected {self.num_inputs} timestamps, got "
                f"{len(start_timestamps)}"
            )
        target = max(start_timestamps)
        bm = self.block_multiple
        if target % bm:
            target += bm - (target % bm)
        return SyncPlan(
            sync_timestamp=target,
            discard_frames=[target - t for t in start_timestamps],
        )


class TaggedFrame(NamedTuple):
    """One capture frame with its starting timestamp tag (in frame ticks —
    the reference tags carry sample timestamps; divide by the frame length
    at the capture layer)."""
    timestamp: int
    data: Any


class SynchronizedIngest:
    """Tag-consuming alignment stage for N capture streams.

    The reference's clXEngine consumes stream tags inside general_work
    until every input starts at the same (highest, block-multiple-rounded)
    timestamp, then publishes the "sync" PDU and streams aligned windows
    (lib/clXEngine_impl.cc:1158-1226).  Here the same contract runs
    host-side, upstream of the flowgraph's Runner:

        ingest = SynchronizedIngest([capA, capB, capC, capD],
                                    on_sync=lambda ts: ...)
        runner.run(ingest)          # yields aligned feed tuples

    * sources: per-stream iterables of :class:`TaggedFrame` (capture
      queues, SDR drivers, file readers).  Timestamps are in frame ticks
      and must be non-decreasing per stream; gaps are legal (dropped
      frames).
    * Initial alignment: leading frames below the sync timestamp are
      DISCARDED per stream (`SyncPlan.discard_frames`), and ``on_sync``
      receives the sync timestamp — the "sync" PDU analogue.
    * Continuous failure detection (the reference silently drifts here —
      SURVEY §5): after sync, every yielded tuple is verified to carry
      identical timestamps.  A detected drop RE-SYNCS (discarding on the
      surviving streams until they align again) and calls ``on_resync``
      with (old_ts, new_ts) so the host can flag the integration window.
    """

    def __init__(self, sources: Iterable[Iterable[TaggedFrame]],
                 block_multiple: int = 16,
                 on_sync: Callable[[int], None] | None = None,
                 on_resync: Callable[[int, int], None] | None = None):
        self._its: list[Iterator[TaggedFrame]] = [iter(s) for s in sources]
        if not self._its:
            raise ValueError("need at least one stream")
        self._sync = StreamSynchronizer(len(self._its), block_multiple)
        self._on_sync = on_sync
        self._on_resync = on_resync
        self.sync_timestamp: int | None = None
        self.discarded = [0] * len(self._its)

    def _advance_to(self, i: int, head: TaggedFrame,
                    target: int) -> TaggedFrame | None:
        """Discard frames of stream i until timestamp >= target."""
        while head.timestamp < target:
            self.discarded[i] += 1
            nxt = next(self._its[i], None)
            if nxt is None:
                return None
            if nxt.timestamp < head.timestamp:
                raise ValueError(
                    f"stream {i}: timestamps regressed "
                    f"({head.timestamp} -> {nxt.timestamp})")
            head = nxt
        return head

    def __iter__(self):
        heads = [next(it, None) for it in self._its]
        if any(h is None for h in heads):
            return
        plan = self._sync.plan([h.timestamp for h in heads])
        target = plan.sync_timestamp
        heads = [self._advance_to(i, h, target) for i, h in enumerate(heads)]
        if any(h is None for h in heads):
            return
        self.sync_timestamp = target
        if self._on_sync is not None:
            self._on_sync(target)
        while True:
            ts = {h.timestamp for h in heads}
            if len(ts) > 1:
                # a stream dropped frames — re-align on the max, rounded up
                # to the block multiple so resumed output stays on the same
                # integration grid as the initial sync (:111-116)
                bm = self._sync.block_multiple
                new_target = max(ts)
                if new_target % bm:
                    new_target += bm - (new_target % bm)
                old = min(ts)
                heads = [self._advance_to(i, h, new_target)
                         for i, h in enumerate(heads)]
                if any(h is None for h in heads):
                    return
                if self._on_resync is not None:
                    self._on_resync(old, new_target)
                continue
            yield tuple(h.data for h in heads)
            heads = [next(it, None) for it in self._its]
            if any(h is None for h in heads):
                return
