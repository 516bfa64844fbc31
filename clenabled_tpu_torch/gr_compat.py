"""GNU Radio adapter: any block of the port as a ``gr.basic_block``.

The port of ``clenabled_tpu.gr_compat``.  The reference makes every block
instantiable from GRC through pybind11 bindings
(python/bindings/python_bindings.cc:29-49) and .block.yml descriptors;
here :func:`wrap` adapts a :class:`~clenabled_tpu_torch.streaming.block.
Block` into a ``gr.basic_block``, so that the descriptors in
``clenabled_tpu_torch/grc/`` (``tools/gen_grc_yaml.py``) put the port's
blocks into a stock GNU Radio flowgraph: the card does the math, GR the
stream plumbing.  GNU Radio is an optional dependency, imported only
inside :func:`wrap`.

Contract mapping (GR ↔ Block), as in the JAX package:

====================  =====================================================
GR concept            Block concept
====================  =====================================================
io_signature          n_inputs / n_outputs (dtype from in/out_kinds)
forecast()            quantum (input frames must be multiples of it)
relative rate         rate (Fraction: 1/decim or interp)
work state            init_state() tree carried across general_work calls
message ports         the ``messages`` dict returned by apply()
callbacks             ``set_*`` methods of the block, through the wrapper
====================  =====================================================

Where the torch idiom differs from the JAX adapter:

* Blocks run eagerly: ``block.apply(state, frames)`` is called on the
  block's device at every work call, with no per-length compile cache, so
  a reconfiguration between work calls (``Filter.set_taps``,
  ``MultiplyConst.set_k``) takes effect on the next call.  The carried
  state is passed through ``block.migrate_state`` before each call, as
  ``Runner.refresh`` does; a ``set_*`` callback called on the wrapper first
  runs the frames already consumed on the old configuration.
* A batch of K frames goes to the device in one copy a port and runs
  through ``apply`` frame by frame, in order; the K outputs of a port are
  joined on the device and fetched in one copy.
* Pipelining (depth D > 1, sinks only) queues, at dispatch, non-blocking
  copies of the messages into pinned host buffers followed by a CUDA event,
  and waits on that event when the publish comes due D−1 calls later, so
  the fetch of frame N−1 does not wait behind frame N's kernels.
* An explicit ``pipeline_depth > 1`` on a block with stream outputs raises
  ``ValueError``: the trailing frames could not be emitted after the
  scheduler's last work call (the JAX adapter loses them at ``stop()``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from clenabled_tpu_torch import _tree
from clenabled_tpu_torch.dsp import planar


def _to_numpy(y):
    """A block output or message leaf (tensor, planar.PC, Python value) →
    numpy; planar pairs assemble straight into complex64."""
    if isinstance(y, planar.PC):
        out = np.empty(tuple(y.re.shape), np.complex64)
        out.real = y.re.detach().cpu().numpy()
        out.imag = y.im.detach().cpu().numpy()
        return out
    if torch.is_tensor(y):
        t = y.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(y)


def _payload_numpy(payload):
    if isinstance(payload, dict):
        return {k: _to_numpy(v) for k, v in payload.items()}
    return _to_numpy(payload)


_KIND_DTYPE = {  # the reference's DTYPE_* codes, GRCLBase.h:57-62
    "c": np.complex64, "f": np.float32, "i": np.int32,
    "s": np.int16, "b": np.int8,
}


def _sig_from_kinds(kinds, n_ports):
    if kinds is None:
        return [np.complex64] * n_ports
    if len(kinds) != n_ports:
        raise ValueError(f"kinds {kinds} do not cover {n_ports} ports")
    return [_KIND_DTYPE[k] for k in kinds]


def _row(x, j: int):
    """Frame ``j`` of a stacked [K, n] tensor or planar pair."""
    if isinstance(x, planar.PC):
        return planar.PC(x.re[j], x.im[j])
    return x[j]


def default_device() -> torch.device:
    """The device a wrapped block runs on when ``wrap`` is given none: the
    first card (raises when no card is visible)."""
    from clenabled_tpu_torch.runtime.device import get_device

    return get_device("cuda")


def _pinned_copy(tree, device: torch.device):
    """(a host copy of ``tree``, the event after its copies): every card
    tensor copied without blocking into a new pinned buffer on the current
    stream.  On the CPU the tree itself and no event."""
    if device.type != "cuda":
        return tree, None

    def copy(t):
        if torch.is_tensor(t) and t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host
        return t

    host = _tree.tree_map(copy, tree)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return host, event


def wrap(block, in_sig=None, out_sig=None, msg_ports=None, name=None,
         max_frames_pow2: int = 17, batch_frames: int | str = "auto",
         pipeline_depth: int | str = "auto", device=None):
    """Adapt a port Block into a ``gr.basic_block``.

    Args:
      block: any Block instance (``blocks.Fft(...)``, ``blocks.XEngine(...)``).
      in_sig / out_sig: numpy dtypes per port; default from the block's
        ``in_kinds``/``out_kinds`` (undeclared ports: complex64).
      msg_ports: names to register as GR message outputs (default: the
        block's ``msg_ports``); messages on other keys are dropped.
      name: GR block name (default: the block's class name).
      max_frames_pow2: cap on the per-call frame bucket (2**k samples).
      batch_frames: ``1`` runs one ``apply`` per general_work call.
        ``"auto"`` (default) or an int K batches adaptively: when the
        scheduler offers at least one batch frame (quantum·2^j, ≤ 2^13
        samples), consumed frames accumulate and K of them run back to
        back with one fetch; smaller offers (throttled or draining
        streams) flush what is pending and take the per-call path, so
        trickling streams keep per-call latency.  Messages publish per
        frame, in order.  Up to K−1 consumed frames can stay pending at
        the end: ``flush()`` (or the scheduler's ``stop()``) runs them.
      pipeline_depth: with depth D > 1 the adapter keeps up to D−1 frames
        in flight and publishes the oldest one each call (the reference's
        async double-buffered worker, lib/clXCorrelate_impl.cc:1641-1698);
        ``flush()``/``stop()`` drain the tail.  ``"auto"`` is 2 for sinks
        (message-only blocks) and 1 otherwise; an explicit D > 1 on a
        block with stream outputs raises ``ValueError``.
      device: where the block runs (default: the first card, raising
        without one; ``"cpu"`` when the caller asks for it).

    Frames are bucketed to quantum·2^k samples (the largest that fits the
    offered input and output space), as in the JAX adapter, so a
    scheduler's arbitrary buffer sizes become a bounded set of shapes.
    """
    from gnuradio import gr  # optional dependency, imported lazily
    import pmt

    dev = default_device() if device is None else torch.device(device)
    n_in = block.n_inputs
    n_out = block.n_outputs
    if in_sig is None:
        in_sig = _sig_from_kinds(getattr(block, "in_kinds", None), n_in)
    if out_sig is None:
        out_sig = _sig_from_kinds(getattr(block, "out_kinds", None), n_out)
    if msg_ports is None:
        msg_ports = tuple(getattr(block, "msg_ports", ()))
    planar_mode = bool(getattr(block, "planar", False))
    rate = block.rate
    quantum = max(1, int(block.quantum))

    # batch frame bf = quantum·2^j capped at 2^13 samples (the reference's
    # GR-buffer scale), K sized so one batch carries ~2^21 samples
    if n_in:
        bf = quantum
        while bf * 2 <= max(quantum, 1 << 13):
            bf *= 2
    else:
        bf = int(getattr(block, "source_frame", None) or 1)
    if batch_frames == "auto":
        bk = max(1, min(64, (1 << 21) // max(1, bf)))
    else:
        bk = max(1, int(batch_frames))
    if pipeline_depth == "auto":
        depth = 2 if (n_in and not n_out) else 1
    else:
        depth = max(1, int(pipeline_depth))
        if depth > 1 and n_out:
            raise ValueError(
                f"pipeline_depth={depth} on a block with stream outputs: the "
                f"trailing frames could not be emitted after the last work "
                f"call; pipelining is for message-only sinks")

    def to_device(x, sig_dtype):
        x = np.ascontiguousarray(x)
        if planar_mode and np.issubdtype(sig_dtype, np.complexfloating):
            return planar.PC(
                torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
                .to(dev),
                torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
                .to(dev))
        return torch.from_numpy(x).to(dev)

    def state_to_device(tree):
        return _tree.tree_map(
            lambda t: t.to(dev) if torch.is_tensor(t) else t, tree)

    class _TorchBlock(gr.basic_block):
        def __init__(self):
            gr.basic_block.__init__(
                self, name=name or type(block).__name__,
                in_sig=list(in_sig), out_sig=list(out_sig))
            self._blk = block
            self._state = state_to_device(block.init_state())
            if n_in and rate != 1:
                self.set_relative_rate(float(rate))
            out_items = quantum * rate
            if n_out and out_items.denominator == 1 and out_items > 1:
                self.set_output_multiple(int(out_items))
            self._msg_port_syms = {}
            for port in msg_ports:
                sym = pmt.intern(port)
                self.message_port_register_out(sym)
                self._msg_port_syms[port] = sym
            # batching: pending input frames per port, output queue
            # segments per port
            self._pend = [[] for _ in range(n_in)]
            self._outq = [[] for _ in range(max(1, n_out))]
            # pipelining (depth > 1): dispatched-but-unpublished
            # (host messages, event), oldest first
            self._inflight = []
            self.apply_calls = 0

        def __getattr__(self, attr):
            """The block's own attributes through the wrapper; a ``set_*``
            callback first runs the frames already consumed on the old
            configuration, then moves the carried state into the new
            one."""
            if attr.startswith("_"):
                raise AttributeError(attr)
            value = getattr(self._blk, attr)
            if not (attr.startswith("set_") and callable(value)):
                return value

            def callback(*args, **kwargs):
                self.flush()
                out = value(*args, **kwargs)
                self._migrate()
                return out

            return callback

        def forecast(self, noutput_items, ninputs):
            need = int(math.ceil(noutput_items / float(rate))) if n_out else quantum
            need = max(quantum, ((need + quantum - 1) // quantum) * quantum)
            return [need] * ninputs

        def _migrate(self):
            st = self._blk.migrate_state(self._state)
            if st is not self._state:
                self._state = state_to_device(st)

        def _apply(self, ins):
            self._migrate()
            self._state, outs, msgs = self._blk.apply(self._state, ins)
            self.apply_calls += 1
            return outs, msgs

        def _publish(self, msgs):
            """Publish host-side messages in port order."""
            for port, payload in msgs.items():
                sym = self._msg_port_syms.get(port)
                if sym is None:
                    continue
                self.message_port_pub(sym, pmt.to_pmt(_payload_numpy(payload)))

        def _registered(self, msgs):
            return {k: v for k, v in msgs.items() if k in self._msg_port_syms}

        def general_work(self, input_items, output_items):
            if bk == 1:
                return self._work_percall(input_items, output_items)
            return self._work_batched(input_items, output_items)

        def _work_percall(self, input_items, output_items):
            if n_in:
                avail = min(len(x) for x in input_items)
                frames = (avail // quantum) * quantum
                if n_out:
                    out_cap = min(len(o) for o in output_items)
                    # largest quantum multiple whose output fits
                    while frames > 0 and int(frames * rate) > out_cap:
                        frames -= quantum
                # bucket to quantum·2^k (bounded shapes, see wrap())
                if frames >= quantum:
                    k = (frames // quantum).bit_length() - 1
                    cap = max(0, max_frames_pow2 - (quantum.bit_length() - 1))
                    frames = quantum * (1 << min(k, cap))
                if frames <= 0:
                    # nothing to consume, but batched output may still be
                    # queued: emit it as the scheduler offers space
                    if n_out and self._q_len():
                        return self._emit(output_items)
                    return 0
                ins = [to_device(x[:frames], s)
                       for x, s in zip(input_items, in_sig)]
            else:
                frames = 0
                ins = []
                if block.source_frame is None:
                    raise RuntimeError("source block needs source_frame")
                if output_items and len(output_items[0]) < block.source_frame:
                    return 0
            outs, msgs = self._apply(ins)
            if n_in:
                self.consume_each(frames)
            if depth > 1:
                # sinks only: queue the copies now, publish D-1 calls later
                self._inflight.append(_pinned_copy(self._registered(msgs),
                                                   dev))
                if len(self._inflight) >= depth:
                    self._publish_oldest()
                return 0
            self._publish(msgs)
            if not n_out:
                return 0
            arrs = [_to_numpy(y).ravel() for y in outs]
            for o, arr in zip(output_items, arrs):
                o[:len(arr)] = arr.astype(o.dtype, copy=False)
            return len(arrs[0]) if arrs else 0

        def _publish_oldest(self):
            host, event = self._inflight.pop(0)
            if event is not None:
                event.synchronize()
            self._publish(host)

        def _drain_inflight(self):
            while self._inflight:
                self._publish_oldest()

        def _q_len(self):
            return sum(len(a) for a in self._outq[0]) if self._outq else 0

        def _emit(self, output_items):
            if not n_out or not output_items or not self._outq:
                return 0
            space = min(len(o) for o in output_items)
            emitted = 0
            while emitted < space and self._outq[0]:
                take = min(space - emitted, len(self._outq[0][0]))
                for p, o in enumerate(output_items):
                    seg = self._outq[p][0]
                    o[emitted:emitted + take] = seg[:take].astype(
                        o.dtype, copy=False)
                    if take == len(seg):
                        self._outq[p].pop(0)
                    else:
                        self._outq[p][0] = seg[take:]
                emitted += take
            return emitted

        def _run_frames(self, frame_ins):
            """Run the frames in order; queue each port's outputs (joined
            on the device, fetched in one copy) and publish each frame's
            messages, frame by frame."""
            outs_all, msgs_all = [], []
            for ins in frame_ins:
                outs, msgs = self._apply(ins)
                outs_all.append(outs)
                msgs_all.append(msgs)
            for p in range(n_out):
                parts = [outs[p] for outs in outs_all]
                if isinstance(parts[0], planar.PC):
                    joined = planar.PC(
                        torch.cat([q.re.reshape(-1) for q in parts]),
                        torch.cat([q.im.reshape(-1) for q in parts]))
                else:
                    joined = torch.cat([q.reshape(-1) for q in parts])
                self._outq[p].append(_to_numpy(joined))
            for msgs in msgs_all:
                self._publish(msgs)

        def _dispatch_group(self):
            self._drain_inflight()   # keep message order across path mixes
            k = bk
            # one host-to-device copy a port for the K frames, then rows
            stacked = [to_device(np.stack(self._pend[p][:k]), s)
                       for p, s in zip(range(n_in), in_sig)]
            for p in range(n_in):
                del self._pend[p][:k]
            self._run_frames([[_row(x, j) for x in stacked]
                              for j in range(k)])

        def flush(self):
            """Run the consumed-but-unprocessed frames one at a time and
            publish the in-flight messages (call after tb.wait() to drain
            the tail)."""
            self._drain_inflight()
            if not n_in or not self._pend or not self._pend[0]:
                return
            while self._pend[0]:
                ins = [to_device(self._pend[p].pop(0), s)
                       for p, s in zip(range(n_in), in_sig)]
                self._run_frames([ins])

        def stop(self):
            """GR scheduler stop callback: run the pending frames so their
            messages publish and the output queue is complete."""
            self.flush()
            base_stop = getattr(gr.basic_block, "stop", None)
            return base_stop(self) if callable(base_stop) else True

        def _work_batched(self, input_items, output_items):
            if not n_in:
                if block.source_frame is None:
                    raise RuntimeError("source block needs source_frame")
                if self._q_len() == 0:
                    self._run_frames([[] for _ in range(bk)])
                return self._emit(output_items)
            avail = min(len(x) for x in input_items)
            nf = avail // bf
            if nf > 0:
                room = max(0, 2 * bk - len(self._pend[0]))
                take = min(nf, room)
                if take:
                    for p, x in enumerate(input_items):
                        for j in range(take):
                            self._pend[p].append(
                                np.ascontiguousarray(x[j * bf:(j + 1) * bf]))
                    self.consume_each(take * bf)
                cap = 2 * bk * max(1, int(bf * rate))
                while len(self._pend[0]) >= bk and self._q_len() <= cap:
                    self._dispatch_group()
            else:
                # trickle/drain: flush pending first; the sub-frame offer
                # takes the per-call path once nothing is queued ahead of
                # it (order preservation: GR re-offers next call)
                if self._pend and self._pend[0]:
                    self.flush()
                elif self._q_len() == 0 and avail >= quantum:
                    return self._work_percall(input_items, output_items)
            return self._emit(output_items)

    return _TorchBlock()
