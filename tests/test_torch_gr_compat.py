"""The port's GNU Radio adapter (``clenabled_tpu_torch.gr_compat.wrap``)
held to the JAX package's on every case of ``tests/test_gr_compat.py``:
the same block, from each package's ``blocks``, wrapped under the same
fake ``gnuradio`` and driven with the same numpy offers.  The scheduler
facing numbers (consumed counts, relative rate, output multiple,
forecast, produced counts, published ports) are equal; the streams and
message payloads agree within 1e-4 × max|JAX| (ints exactly).

Then the port's own contract: a ``set_taps`` or ``set_k`` between work
calls takes effect on the next call, as a ``Flowgraph`` retuned at the
same sample; the ``ValueError`` for an explicit depth > 1 on a stream
block; the sink's tail after ``stop()``; a stateless block's batch as one
vmapped ``apply`` (the FFT operator entered once a batch, the stream
equal to the per-call path's and within 1e-4 × max of the JAX adapter's);
and, on a card, the pinned-copy pipelining and one FFT launch a batch."""

from __future__ import annotations

import functools
import sys
import types
from fractions import Fraction

import numpy as np
import pytest
import torch

from test_gr_compat import _FakeBasicBlock

TOL = 1e-4      # × max|reference|


@pytest.fixture()
def fake_gr(monkeypatch):
    gr_mod = types.ModuleType("gnuradio.gr")
    gr_mod.basic_block = _FakeBasicBlock
    gnuradio = types.ModuleType("gnuradio")
    gnuradio.gr = gr_mod
    pmt_mod = types.ModuleType("pmt")
    pmt_mod.intern = lambda s: ("sym", s)
    pmt_mod.to_pmt = lambda x: ("pmt", x)
    monkeypatch.setitem(sys.modules, "gnuradio", gnuradio)
    monkeypatch.setitem(sys.modules, "gnuradio.gr", gr_mod)
    monkeypatch.setitem(sys.modules, "pmt", pmt_mod)
    return gr_mod


class Side:
    """One package's blocks, adapter and a few array helpers."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            import jax.numpy as jnp

            from clenabled_tpu import blocks
            from clenabled_tpu.gr_compat import wrap
            from clenabled_tpu.streaming.block import Block, FunctionBlock

            self.wrap = wrap
            self.mean_abs = lambda x: jnp.mean(jnp.abs(x))

            def upsample(x, interp):
                out = jnp.zeros((x.shape[-1], interp), x.dtype)
                return out.at[:, 0].set(x).reshape(-1)
        else:
            from clenabled_tpu_torch import blocks
            from clenabled_tpu_torch.gr_compat import wrap
            from clenabled_tpu_torch.streaming.block import (Block,
                                                             FunctionBlock)

            self.wrap = functools.partial(wrap, device="cpu")
            self.mean_abs = lambda x: torch.mean(torch.abs(x))

            def upsample(x, interp):
                out = torch.zeros((x.shape[-1], interp), dtype=x.dtype)
                out[:, 0] = x
                return out.reshape(-1)
        self.blocks, self.Block, self.FunctionBlock = blocks, Block, FunctionBlock
        self.upsample = upsample

    def mean_sink(self):
        side = self

        class MeanSink(self.Block):
            n_inputs, n_outputs = 1, 0
            msg_ports = ("mean",)

            def __init__(self):
                super().__init__()
                self.quantum = 1024
                self.rate = Fraction(1)

            def init_state(self):
                return ()

            def apply(self, state, ins):
                return state, [], {"mean": side.mean_abs(ins[0])}

        return MeanSink()


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x)


class Rec:
    """What a wrapped block showed the scheduler, call by call."""

    def __init__(self, g):
        self.g = g
        self.produced, self.outs = [], []

    def work(self, ins, out_space, n_out=1, dtype=np.complex64):
        outs = [np.zeros(out_space, dtype) for _ in range(n_out)]
        n = self.g.general_work(list(ins), outs)
        self.produced.append(n)
        self.outs.append([o[:n].copy() for o in outs])
        return n

    def summary(self) -> dict:
        g = self.g
        pub = [(sym, _np(msg[1])) for sym, msg in g.published]
        return {"produced": self.produced, "consumed": list(g.consumed),
                "relative_rate": g.relative_rate,
                "output_multiple": g.output_multiple,
                "registered": list(g.registered_ports),
                "in_sig": [np.dtype(d) for d in g._in_sig],
                "out_sig": [np.dtype(d) for d in g._out_sig],
                "published_ports": [p for p, _ in pub],
                "payloads": [m for _, m in pub],
                "outs": [np.concatenate(parts) if parts else np.zeros(0)
                         for parts in zip(*self.outs)] if self.outs else []}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer) or want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _same(got: dict, want: dict):
    for key in ("produced", "consumed", "relative_rate", "output_multiple",
                "registered", "in_sig", "out_sig", "published_ports",
                "forecast", "extra"):
        assert got.get(key) == want.get(key), (key, got.get(key),
                                               want.get(key))
    assert len(got["outs"]) == len(want["outs"])
    for p, (a, b) in enumerate(zip(got["outs"], want["outs"])):
        _close(a, b, f"stream port {p}")
    assert len(got["payloads"]) == len(want["payloads"])
    for i, (a, b) in enumerate(zip(got["payloads"], want["payloads"])):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                _close(a[k], b[k], f"message {i} {k}")
        else:
            _close(a, b, f"message {i}")


def _crand(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


def _drive(rec, x, offer, out_space):
    """Scheduler loop: offer up to ``offer`` samples and ``out_space``
    output items a call until the stream drains, then flush and emit."""
    g = rec.g
    remaining = x
    idle = 0
    while idle < 3:
        before = len(g.consumed)
        n = rec.work([remaining[:offer]], out_space)
        consumed = sum(g.consumed[before:])
        remaining = remaining[consumed:]
        idle = idle + 1 if (n == 0 and consumed == 0) else 0
    g.flush()
    out = np.zeros(out_space, np.complex64)
    n = g._emit([out])
    rec.produced.append(n)
    rec.outs.append([out[:n].copy()])


# --- the cases of tests/test_gr_compat.py, each a function of a Side ----

def case_elementwise_roundtrip(s):
    rec = Rec(s.wrap(s.blocks.MultiplyConst(2.0 + 0j)))
    rec.work([(np.arange(8) + 1j).astype(np.complex64)], 8)
    return rec.summary()


def case_quantum_and_decimation(s):
    taps = np.array([0.25, 0.5, 0.25], np.float32)
    blk = s.blocks.FIRTapFilter(2, taps, use_time=True)
    rec = Rec(s.wrap(blk))
    n = 4 * blk.quantum
    x = _crand(np.random.default_rng(0), n)
    rec.work([x[: n // 2]], n // 4)
    rec.work([x[n // 2:]], n // 4)
    one = Rec(s.wrap(s.blocks.FIRTapFilter(2, taps, use_time=True)))
    one.work([x], n // 2)
    out = rec.summary()
    out["extra"] = one.produced
    out["outs"].append(one.summary()["outs"][0])
    return out


def case_forecast_rounds_to_quantum(s):
    g = s.wrap(s.blocks.FIRTapFilter(4, np.ones(5, np.float32),
                                     use_time=True))
    out = Rec(g).summary()
    out["forecast"] = [g.forecast(k, 1) for k in (1, 10, 100, 1000)]
    return out


def case_partial_input_waits_for_quantum(s):
    blk = s.blocks.FIRTapFilter(2, np.ones(3, np.float32), use_time=True)
    rec = Rec(s.wrap(blk))
    rec.work([np.zeros(blk.quantum - 1, np.complex64)], blk.quantum)
    return rec.summary()


def case_sink_publishes_messages(s):
    rec = Rec(s.wrap(s.blocks.XCorrelate(2, signal_length=256,
                                         max_search_index=16)))
    sig = _crand(np.random.default_rng(1), 256)
    rec.work([sig, np.roll(sig, 3)], 0, n_out=0)
    before = len(rec.g.published)
    rec.g.flush()
    out = rec.summary()
    out["extra"] = before
    return out


def case_planar_block_converts_streams(s):
    rec = Rec(s.wrap(s.blocks.CostasLoop(0.1, 2, planar=True)))
    t = np.arange(1024)
    x = np.exp(1j * (2 * np.pi * 0.01 * t + 0.5)).astype(np.complex64)
    rec.work([x[:512]], 512)
    rec.work([x[512:]], 512)
    return rec.summary()


def case_source_produces_frames(s):
    rec = Rec(s.wrap(s.blocks.SignalSource(48000.0, 1, 1000.0, 1.0,
                                           frame_size=512)))
    rec.work([], 512)
    rec.work([], 512)
    rec.work([], 100)          # too little room: nothing produced
    return rec.summary()


def case_interpolating_block(s):
    interp = 4
    blk = s.FunctionBlock(lambda x: s.upsample(x, interp),
                          rate=Fraction(interp), quantum=8)
    g = s.wrap(blk)
    rec = Rec(g)
    rec.work([(np.arange(16) + 0j).astype(np.complex64)], 16 * interp)
    out = rec.summary()
    out["forecast"] = [g.forecast(k, 1) for k in (1, 64, 100)]
    return out


def case_float_output_signature_defaults(s):
    b = s.blocks
    sigs = []
    for blk, kw in ((b.ComplexToMag(), {}), (b.QuadratureDemod(2.0), {}),
                    (b.MagPhaseToComplex(), {}), (b.SNRHelper(), {}),
                    (b.ComplexToMag(), {"out_sig": [np.float64]})):
        g = s.wrap(blk, **kw)
        sigs.append(([np.dtype(d) for d in g._in_sig],
                     [np.dtype(d) for d in g._out_sig]))
    out = Rec(s.wrap(b.ComplexToArg())).summary()
    out["extra"] = sigs
    return out


def case_buckets_frames_to_pow2_quanta(s):
    rec = Rec(s.wrap(s.blocks.MultiplyConst(2.0)))
    remaining = np.random.default_rng(0).standard_normal(12000).astype(
        np.complex64)
    for offer in (3000, 1700, 999, 2048, 1213, 1024):
        before = len(rec.g.consumed)
        rec.work([remaining[:offer]], offer)
        remaining = remaining[sum(rec.g.consumed[before:]):]
    return rec.summary()


def case_batched_matches_percall_stateful(s):
    taps = np.array([0.25, 0.5, 0.25, 0.125], np.float32)
    x = _crand(np.random.default_rng(4), 8192 * 12 + 3000)
    out = {}
    for bf in (1, 4):
        rec = Rec(s.wrap(s.blocks.FIRTapFilter(1, taps, use_time=True),
                         batch_frames=bf))
        _drive(rec, x, 1 << 14, 1 << 15)
        r = rec.summary()
        out.setdefault("produced", []).append(r["produced"])
        out.setdefault("consumed", []).append(r["consumed"])
        out.setdefault("outs", []).extend(r["outs"])
    out["payloads"] = []
    return out


def case_batched_trickle_keeps_percall_path(s):
    rec = Rec(s.wrap(s.blocks.MultiplyConst(3.0), batch_frames="auto"))
    rec.work([(np.arange(256) + 1j).astype(np.complex64)], 256)
    return rec.summary()


def case_batched_source_stays_phase_continuous(s):
    rec = Rec(s.wrap(s.blocks.SignalSource(48000.0, 1, 1000.0, 1.0,
                                           frame_size=512), batch_frames=4))
    for _ in range(6):
        rec.work([], 512)
    return rec.summary()


def case_batched_sink_publishes_per_frame(s):
    rec = Rec(s.wrap(s.mean_sink(), batch_frames=2))
    bf = 8192
    x = np.concatenate([np.full(bf, v, np.complex64) for v in (1, 2, 3, 4)])
    for i in range(4):
        rec.work([x[i * bf:(i + 1) * bf]], 0, n_out=0)
    return rec.summary()


def case_bucketing_respects_decimator_output_capacity(s):
    lpf = s.blocks.LowPassFilter(2, 1.0, 1e6, 100e3, 50e3)
    rec = Rec(s.wrap(lpf))
    q = lpf.quantum
    x = _crand(np.random.default_rng(3), q * 7)
    rec.work([x], q // 2)
    rec.work([x], q * 4)
    return rec.summary()


def case_batched_decimator_matches_percall(s):
    def mk():
        return s.blocks.LowPassFilter(4, 1.0, 1e6, 100e3, 50e3)

    q = mk().quantum
    x = _crand(np.random.default_rng(6), max(1 << 16, q * 64))
    out = {"payloads": []}
    for bf in (1, 3):
        rec = Rec(s.wrap(mk(), batch_frames=bf))
        _drive(rec, x, 1 << 14, 1 << 14)
        r = rec.summary()
        out.setdefault("produced", []).append(r["produced"])
        out.setdefault("outs", []).extend(r["outs"])
    return out


def case_stop_drains_pending_batch_frames(s):
    rec = Rec(s.wrap(s.mean_sink(), batch_frames=4))
    bf = 8192
    x = np.concatenate([np.full(bf, v, np.complex64) for v in (1, 2, 3)])
    for i in range(3):
        rec.work([x[i * bf:(i + 1) * bf]], 0, n_out=0)
    before = len(rec.g.published)
    stopped = rec.g.stop()
    out = rec.summary()
    out["extra"] = (before, stopped)
    return out


def case_sink_pipelines_percall_dispatch(s):
    rec = Rec(s.wrap(s.mean_sink(), batch_frames=1))
    bf = 1024
    x = np.concatenate([np.full(bf, v, np.complex64) for v in (1, 2, 3)])
    seen = []
    for i in range(3):
        rec.work([x[i * bf:(i + 1) * bf]], 0, n_out=0)
        seen.append(len(rec.g.published))
    rec.g.flush()
    out = rec.summary()
    out["extra"] = seen
    return out


def case_stream_pipeline_depth_opt_in(s):
    """JAX trails one call at depth 2 on a stream block; the port refuses
    the depth.  The streams agree: JAX's drained stream equals the port's
    at depth 1."""
    x = (np.arange(16) + 1j).astype(np.complex64)
    if s.name == "torch":
        with pytest.raises(ValueError, match="pipeline_depth"):
            s.wrap(s.blocks.MultiplyConst(2.0 + 0j), batch_frames=1,
                   pipeline_depth=2)
        rec = Rec(s.wrap(s.blocks.MultiplyConst(2.0 + 0j), batch_frames=1))
        rec.work([x[:8]], 8)
        rec.work([x[8:]], 8)
        return {"outs": [np.concatenate([o[0] for o in rec.outs])],
                "payloads": []}
    rec = Rec(s.wrap(s.blocks.MultiplyConst(2.0 + 0j), batch_frames=1,
                     pipeline_depth=2))
    rec.work([x[:8]], 8)
    rec.work([x[8:]], 8)
    rec.work([x[:0]], 8)
    return {"outs": [np.concatenate([o[0] for o in rec.outs])],
            "payloads": []}


def case_batched_stateless_vmaps_and_matches(s):
    x = (np.arange(4 << 13) + 1j).astype(np.complex64)
    out = {"payloads": []}
    for bf in (1, 4):
        rec = Rec(s.wrap(s.blocks.MultiplyConst(2.0 + 0j), batch_frames=bf))
        _drive(rec, x, 1 << 13, 1 << 13)
        r = rec.summary()
        out.setdefault("produced", []).append(r["produced"])
        out.setdefault("outs", []).extend(r["outs"])
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrap_matches_jax(case, fake_gr):
    """Each case of tests/test_gr_compat.py through both adapters."""
    want = CASES[case](Side("jax"))
    got = CASES[case](Side("torch"))
    _same(got, want)


def test_cases_cover_the_jax_tests():
    import test_gr_compat as jt

    names = {n[len("test_wrap_"):] for n in dir(jt)
             if n.startswith("test_wrap_")}
    assert names == set(CASES) and len(names) == 20


# --- the port's own contract -------------------------------------------

def _flowgraph_retune(blk_fn, x, frame, retune_at, retune):
    """A Flowgraph over ``x`` in frames of ``frame`` samples, ``retune``
    applied to its block (then ``Runner.refresh``) before the frame that
    starts at sample ``retune_at``; returns the joined output."""
    from clenabled_tpu_torch.streaming import Flowgraph

    blk = blk_fn()
    g = Flowgraph()
    g.add(blk)
    g.external_input(blk)
    g.tap(blk, name="y")
    r = g.compile(frame, device="cpu")
    outs = []
    for k in range(len(x) // frame):
        if k * frame == retune_at:
            retune(blk)
            r.refresh()
        outs.append(r.step(torch.from_numpy(x[k * frame:(k + 1) * frame]))
                    ["y"].numpy())
    return np.concatenate(outs)


@pytest.mark.parametrize("what,batch", [
    ("set_taps", 1), ("set_taps", 4), ("set_k", 1), ("set_k", 4),
    ("set_taps_direct", 1)])
def test_retune_between_work_calls(fake_gr, what, batch):
    """A retune between work calls takes effect from the next consumed
    sample, per call and batched: the stream equals a Flowgraph retuned
    at the same sample.  ``set_taps_direct`` calls the block's own
    ``set_taps`` (not the wrapper's): per call it takes effect on the next
    call too (batched, it would also reach the frames already pending)."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.gr_compat import wrap

    rng = np.random.default_rng(11)
    n, frame = 8192 * 8, 8192
    x = _crand(rng, n)
    taps0 = rng.standard_normal(17).astype(np.float32)
    taps1 = rng.standard_normal(33).astype(np.float32)
    if what == "set_k":
        def mk():
            return blocks.MultiplyConst(2.0 + 0j)

        def retune(target):
            target.set_k(-0.5 + 0j)
    else:
        def mk():
            return blocks.FIRTapFilter(1, taps0, use_time=True)

        def retune(target):
            target.set_taps(taps1)
    at = 3 * frame
    want = _flowgraph_retune(mk, x, frame, at, retune)

    blk = mk()
    g = wrap(blk, batch_frames=batch, device="cpu")
    rec = Rec(g)
    pos = 0
    while pos < n:
        if pos == at:
            retune(blk if what == "set_taps_direct" else g)
        before = len(g.consumed)
        rec.work([x[pos:pos + frame]], 2 * frame)
        pos += sum(g.consumed[before:])
    g.flush()
    out = np.zeros(n, np.complex64)
    m = g._emit([out])
    got = np.concatenate([o[0] for o in rec.outs] + [out[:m]])
    assert len(got) == n
    _close(got, want, what)


def _run_out(g, pending, dtype, space=1 << 20):
    """Offer ``pending`` until the wrapped block has taken all of it, then
    flush and emit its queue; the produced items.  Fails when the block
    does not run out within 256 work calls."""
    outs = []
    for _ in range(256):
        if len(pending):
            before = len(g.consumed)
            out = np.zeros(space, dtype)
            n = g.general_work([pending], [out])
            pending = pending[sum(g.consumed[before:]):]
            outs.append(out[:n].copy())
            continue
        g.flush()
        out = np.zeros(space, dtype)
        n = g.general_work([np.zeros(0, np.complex64)], [out])
        outs.append(out[:n].copy())
        if n == 0:
            return outs
    raise AssertionError("the wrapped block did not run out")


@pytest.mark.parametrize("batch", [1, 4, "auto"])
def test_batched_chain_lpf_to_qd(fake_gr, batch):
    """LowPassFilter (49 taps, time domain, planar) feeding a
    QuadratureDemod through a FIFO, both wrapped, on seeded offers: the
    demod puts out one sample for every sample the filter took, and both
    streams equal a Flowgraph over the joined input."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import planar
    from clenabled_tpu_torch.gr_compat import wrap
    from clenabled_tpu_torch.streaming import Flowgraph

    def mk():
        return (blocks.LowPassFilter(1, 1.0, 10e6, 1.5e6, 500e3,
                                     use_time=True, planar=True),
                blocks.QuadratureDemod(1.0, planar=True))

    rng = np.random.default_rng(19)
    offers = rng.integers(1000, 1 << 16, 24)
    x = _crand(rng, int(offers.sum()))
    g_lpf, g_qd = (wrap(b, batch_frames=batch, device="cpu") for b in mk())
    ly, qy, fifo, pos = [], [], np.zeros(0, np.complex64), 0
    for o in (int(v) for v in offers):
        before = len(g_lpf.consumed)
        out = np.zeros(o, np.complex64)
        n = g_lpf.general_work([x[pos:pos + o]], [out])
        pos += sum(g_lpf.consumed[before:])
        ly.append(out[:n].copy())
        fifo = np.concatenate([fifo, out[:n]])
        before = len(g_qd.consumed)
        out = np.zeros(max(1, len(fifo)), np.float32)
        n = g_qd.general_work([fifo], [out])
        fifo = fifo[sum(g_qd.consumed[before:]):]
        qy.append(out[:n].copy())
    tail = _run_out(g_lpf, x[pos:], np.complex64)
    pos = len(x)
    ly += tail
    qy += _run_out(g_qd, np.concatenate([fifo, *tail]), np.float32)
    ly, qy = np.concatenate(ly), np.concatenate(qy)
    assert len(ly) == len(qy) == pos

    lpf, qd = mk()
    fg = Flowgraph()
    fg.external_input(lpf)
    fg.connect(lpf, qd)
    fg.tap(lpf, name="filtered")
    fg.tap(qd, name="audio")
    want = fg.compile(1, device="cpu").step(planar.PC(
        torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())))
    _close(ly, planar.to_complex(want["filtered"]).numpy(), "LowPassFilter")
    _close(qy, want["audio"].numpy(), "QuadratureDemod")


def test_sink_tail_after_stop(fake_gr):
    """An XCorrelate sink at the automatic depth 2, batched: every frame's
    message is published, in order, once stop() has run; the payloads
    equal a Flowgraph's over the same stream."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.gr_compat import wrap
    from clenabled_tpu_torch.streaming import Flowgraph

    rng = np.random.default_rng(2)
    L, frames = 256, 5
    sig = _crand(rng, L * frames)
    streams = [sig, np.roll(sig, 5)]

    def mk():
        return blocks.XCorrelate(2, signal_length=L, max_search_index=16)

    fg = Flowgraph()
    blk = fg.add(mk())
    fg.external_input(blk, 0)
    fg.external_input(blk, 1)
    r = fg.compile(L, device="cpu")
    want = []
    r.on_message(f"{blk.name}.corr", lambda m: want.append(
        {k: np.asarray(v) for k, v in m.items()}))
    for k in range(frames):
        r.step(*(torch.from_numpy(s[k * L:(k + 1) * L]) for s in streams))

    for batch in (1, 2):
        g = wrap(mk(), batch_frames=batch, device="cpu")
        rec = Rec(g)
        for k in range(frames):
            rec.work([s[k * L:(k + 1) * L] for s in streams], 0, n_out=0)
        assert len(g.published) < frames
        assert g.stop() is True
        got = [msg[1] for _, msg in g.published]
        assert len(got) == frames
        for a, b in zip(got, want):
            for key in b:
                _close(a[key], b[key], key)


def test_wrap_defaults_to_the_card(fake_gr, monkeypatch):
    """Without ``device`` the adapter runs on the first card and raises
    when none is visible."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.gr_compat import wrap

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wrap(blocks.MultiplyConst(2.0))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_pinned_copy_pipelining_on_card(card, fake_gr):
    """On the card a depth-2 sink queues its message copies into pinned
    host memory behind a CUDA event at dispatch: the publish of frame N−1
    waits on that event, not on frame N's work, and the messages equal
    the depth-1 adapter's."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.gr_compat import wrap

    rng = np.random.default_rng(5)
    L = 4096
    sig = _crand(rng, L * 4)
    streams = [sig, np.roll(sig, 7)]
    out = {}
    for depth in (1, 2):
        g = wrap(blocks.XCorrelate(2, signal_length=L, max_search_index=64),
                 batch_frames=1, pipeline_depth=depth, device="cuda")
        for k in range(4):
            g.general_work([s[k * L:(k + 1) * L] for s in streams], [])
            if depth == 2 and k:
                host, event = g._inflight[-1]
                assert event is not None
                pinned = {key for key, v in host["corr"].items()
                          if torch.is_tensor(v) and v.is_pinned()}
                assert {"corr", "corrective_lags", "corrvect"} <= pinned
        g.stop()
        out[depth] = [msg[1] for _, msg in g.published]
    assert len(out[1]) == len(out[2]) == 4
    for a, b in zip(out[2], out[1]):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


# --- the vectorised batch of a stateless block --------------------------

FFT_WIN = np.hanning(1024).astype(np.float32)


def _wrapped_fft(wrap, batch, x, offer, **kw):
    """A wrapped Fft(1024, Hann, shift) driven over ``x`` in offers of
    ``offer`` samples; returns the recorder."""
    from clenabled_tpu_torch import blocks

    blk = kw.pop("blocks", blocks).Fft(1024, window=FFT_WIN, shift=True,
                                       **kw)
    rec = Rec(wrap(blk, batch_frames=batch))
    _drive(rec, x, offer, 1 << 16)
    return rec


def test_batched_stateless_fft_enters_the_op_once_a_batch(fake_gr,
                                                          monkeypatch):
    """A stateless wrapped Fft (planar, on the kernel's route) in batched
    mode runs each batch of 4 frames of 8192 through one vmapped ``apply``
    that enters the FFT operator once; its stream equals the per-call
    path's bit for bit and the JAX adapter's batched stream within 1e-4 ×
    max."""
    from clenabled_tpu_torch.dsp import hopper_kernels as hk

    entries = []
    plain = hk.fft_batched_fused_plain

    def counted(xr, *a, **kw):
        entries.append(xr.numel())
        return plain(xr, *a, **kw)

    monkeypatch.setattr(hk, "fft_batched_fused_plain", counted)
    x = _crand(np.random.default_rng(9), 3 * 4 * 8192)
    torch_side, jax_side = Side("torch"), Side("jax")
    rec = _wrapped_fft(torch_side.wrap, 4, x, 4 * 8192, planar=True,
                       use_pallas=True)
    assert entries == [4 * 8192] * 3 and rec.g.apply_calls == 3
    entries.clear()
    one = _wrapped_fft(torch_side.wrap, 1, x, 4 * 8192, planar=True,
                       use_pallas=True)
    assert len(entries) == one.g.apply_calls == 3
    got = rec.summary()["outs"][0]
    assert len(got) == len(x)
    np.testing.assert_array_equal(got, one.summary()["outs"][0])
    want = _wrapped_fft(jax_side.wrap, 4, x, 4 * 8192,
                        blocks=jax_side.blocks).summary()["outs"][0]
    _close(got, want, "the JAX adapter's batched stream")


@pytest.mark.cuda
def test_batched_stateless_fft_one_launch_a_batch_on_card(card, fake_gr):
    """On the card: a wrapped Fft(2048, Blackman-Harris, shift) at
    8192-sample offers, batched at the automatic K (64 frames), launches
    ``fft_batched_fused`` once a batch and equals the per-call path bit
    for bit."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.dsp import hopper_kernels as hk
    from clenabled_tpu_torch.dsp import window
    from clenabled_tpu_torch.gr_compat import wrap

    x = _crand(np.random.default_rng(10), 2 * 64 * 8192)
    outs, launches = {}, {}
    for batch in ("auto", 1):
        g = wrap(blocks.Fft(2048, window=window.blackman_harris(2048),
                            shift=True, planar=True),
                 batch_frames=batch, device="cuda")
        hk.reset_launch_counts()
        rec = Rec(g)
        _drive(rec, x, 8192, 1 << 16)
        torch.cuda.synchronize()
        launches[batch] = (hk.fft_batched_fused.launches, g.apply_calls)
        outs[batch] = rec.summary()["outs"][0]
    assert launches == {"auto": (2, 2), 1: (128, 128)}
    np.testing.assert_array_equal(outs["auto"], outs[1])
