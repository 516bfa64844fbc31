"""Port parity: the multi-stream synchronizer (``streaming/sync.py``).

Every case of ``tests/test_sync_and_blocks.py`` that covers the
synchronizer runs on the same inputs through the JAX package's module and
the port's: the plans, the discard counts, the callbacks and the yielded
data must be equal (and equal the values that test pins).  Then
``SynchronizedIngest`` drives the port's ``Runner`` and JAX's on the same
tagged numpy frames: the 2-input ``MultiplyConjugate`` within 1e-5 ×
max|ref|, and an IChar ``XEngine`` flowgraph with staggered starts and a
dropped window, its matrices bit for bit.
"""

import numpy as np
import pytest
import torch

try:
    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu.streaming import Flowgraph as JFlowgraph
    from clenabled_tpu.streaming import sync as j_sync
except ImportError:  # a card machine without JAX runs the card tests only
    j_sync = None

from clenabled_tpu_torch import blocks, streaming
from clenabled_tpu_torch.streaming import Flowgraph
from clenabled_tpu_torch.streaming import sync as t_sync

REL = 1e-5


@pytest.fixture
def mods():
    if j_sync is None:
        pytest.skip("needs JAX, the reference")
    return {"jax": j_sync, "torch": t_sync}


def _tagged(mod, start, n, base):
    return [mod.TaggedFrame(start + k, base + start + k) for k in range(n)]


def _ingest(mod, sources, **kw):
    """(yielded tuples, discards, sync timestamp, sync calls, resync
    calls) of one SynchronizedIngest run."""
    synced, resyncs = [], []
    ing = mod.SynchronizedIngest(sources, on_sync=synced.append,
                                 on_resync=lambda o, n: resyncs.append((o, n)),
                                 **kw)
    out = list(ing)
    return out, ing.discarded, ing.sync_timestamp, synced, resyncs


def test_exports():
    for name in ("SyncPlan", "StreamSynchronizer", "TaggedFrame",
                 "SynchronizedIngest"):
        assert getattr(streaming, name) is getattr(t_sync, name)


def test_synchronizer_aligns_to_highest_rounded(mods):
    plans = {}
    for k, mod in mods.items():
        sync = mod.StreamSynchronizer(4, block_multiple=16)
        plan = sync.plan([100, 117, 96, 110])
        plan2 = sync.plan([128, 128, 128, 128])
        plans[k] = (plan.sync_timestamp, plan.discard_frames,
                    plan.synchronized, plan2.sync_timestamp,
                    plan2.synchronized)
    assert plans["torch"] == plans["jax"] == (128, [28, 11, 32, 18], False,
                                              128, True)


def test_synchronizer_validates(mods):
    for mod in mods.values():
        with pytest.raises(ValueError, match="expected 2 timestamps"):
            mod.StreamSynchronizer(2).plan([1, 2, 3])
        with pytest.raises(ValueError, match="at least one stream"):
            mod.StreamSynchronizer(0)
        with pytest.raises(ValueError, match="at least one stream"):
            mod.SynchronizedIngest([])


def test_synchronized_ingest_discards_and_publishes_sync(mods):
    runs = {k: _ingest(mod, [_tagged(mod, 100, 60, 0),
                             _tagged(mod, 117, 60, 1000),
                             _tagged(mod, 96, 60, 2000)], block_multiple=16)
            for k, mod in mods.items()}
    assert runs["torch"] == runs["jax"]
    out, discarded, ts, synced, resyncs = runs["torch"]
    assert (synced, discarded, ts, resyncs) == ([128], [28, 11, 32], 128, [])
    assert out[0] == (128, 1128, 2128) and out[-1] == (155, 1155, 2155)
    assert len(out) == 60 - 32


@pytest.mark.parametrize("bm,drop,want", [(1, (20, 23), (20, 23)),
                                          (8, (18, 21), (18, 24))],
                         ids=["resync", "resync_block_multiple"])
def test_synchronized_ingest_resyncs_after_drop(mods, bm, drop, want):
    """A dropped run of frames on one stream re-aligns the streams, rounded
    up to the block multiple, and calls on_resync once."""
    runs = {}
    for k, mod in mods.items():
        a, b = _tagged(mod, 0, 40, 0), _tagged(mod, 0, 40, 1000)
        del b[drop[0]:drop[1]]
        runs[k] = _ingest(mod, [a, b], block_multiple=bm)
    assert runs["torch"] == runs["jax"]
    out, discarded, _, synced, resyncs = runs["torch"]
    assert resyncs == [want] and synced == [0]
    assert out == ([(k, 1000 + k) for k in range(want[0])]
                   + [(k, 1000 + k) for k in range(want[1], 40)])
    assert discarded == [want[1] - want[0], want[1] - drop[1]]


def test_synchronized_ingest_regression_raises(mods):
    for mod in mods.values():
        frames = [mod.TaggedFrame(t, t) for t in (0, 5, 3)]
        ing = mod.SynchronizedIngest([frames, _tagged(mod, 6, 4, 0)],
                                     block_multiple=1)
        with pytest.raises(ValueError, match="timestamps regressed"):
            list(ing)


def _mult_graph(blk_mod, graph_cls, **compile_kw):
    g = graph_cls()
    mult = blk_mod.MultiplyConjugate()
    g.external_input(mult, 0)
    g.external_input(mult, 1)
    g.tap(mult, name="prod")
    return g.compile(frame_size=64, **compile_kw)


def test_synchronized_ingest_drives_runner(mods):
    """Aligned two-antenna feeds into a 2-input flowgraph: the port's
    Runner and JAX's on the same tagged numpy frames, within 1e-5."""
    rng = np.random.default_rng(0)
    n_frames, offset = 8, 3
    base = (rng.standard_normal((n_frames + offset, 64))
            + 1j * rng.standard_normal((n_frames + offset, 64))
            ).astype(np.complex64)
    outs = {}
    for k, mod in mods.items():
        s1 = [mod.TaggedFrame(i, base[i]) for i in range(n_frames + offset)]
        s2 = [mod.TaggedFrame(i + offset, base[i + offset])
              for i in range(n_frames)]
        ing = mod.SynchronizedIngest([s1, s2], block_multiple=1)
        runner = (_mult_graph(blocks, Flowgraph, device="cpu")
                  if k == "torch" else _mult_graph(j_blocks, JFlowgraph))
        outs[k] = [np.asarray(o["prod"]) for o in runner.run(ing)]
    assert len(outs["torch"]) == len(outs["jax"]) == n_frames
    for i, (got, want) in enumerate(zip(outs["torch"], outs["jax"])):
        np.testing.assert_allclose(got, want, rtol=REL,
                                   atol=REL * np.abs(want).max())
        ref = base[i + offset] * np.conj(base[i + offset])
        np.testing.assert_allclose(got, ref, rtol=REL, atol=REL)


# the XEngine flowgraph at test size: 4 stations × 2 pols, 8 channels,
# 64 frames of IChar bytes a window
XS, XP, XF, XT = 4, 2, 8, 64
STARTS = (0, 2, 1, 2)              # staggered by 0-2 windows
DROP = (1, 5)                      # station 1 loses window 5


def _station_frames(mod, rng_bytes):
    """Per station its tagged windows from STARTS to 10, station DROP[0]
    missing window DROP[1]."""
    return [[mod.TaggedFrame(t, rng_bytes[s][t]) for t in range(STARTS[s], 10)
             if (s, t) != DROP] for s in range(XS)]


def test_synchronized_ingest_drives_xengine(mods):
    """Staggered starts and a dropped window through SynchronizedIngest into
    the IChar XEngine flowgraph: the same discards, sync and resync in
    both packages, and the emitted matrices bit for bit."""
    rng = np.random.default_rng(11)
    q = XT * XF * XP * 2
    bytes_ = [[rng.integers(-128, 128, q).astype(np.int8) for _ in range(10)]
              for _ in range(XS)]
    res = {}
    for k, mod in mods.items():
        blk = blocks if k == "torch" else j_blocks
        xe = blk.XEngine(data_type=5, polarization=XP, num_inputs=XS,
                         num_channels=XF, integration=XT,
                         pipeline_integration=2, planar=True)
        g = Flowgraph() if k == "torch" else JFlowgraph()
        for s in range(XS):
            g.external_input(xe, s)
        r = (g.compile(xe.quantum, device="cpu") if k == "torch"
             else g.compile(xe.quantum))
        msgs = []
        r.on_message("xengine.xcorr", lambda m: msgs.append(
            (np.asarray(m["matrix"].re), np.asarray(m["matrix"].im),
             bool(m["valid"]))))
        synced, resyncs = [], []
        ing = mod.SynchronizedIngest(
            _station_frames(mod, bytes_), block_multiple=1,
            on_sync=synced.append,
            on_resync=lambda o, n: resyncs.append((o, n)))
        r.run(ing)
        res[k] = (msgs, ing.discarded, synced, resyncs)
    (got, t_disc, t_sync_, t_resync), (want, *j_rest) = res["torch"], res["jax"]
    assert (t_disc, t_sync_, t_resync) == tuple(j_rest)
    # sync on window 2; station 1 lacks window 5: resync 5 -> 6, the other
    # stations discard their window 5
    assert t_sync_ == [2] and t_resync == [(5, 6)]
    assert t_disc == [3, 0, 2, 1]
    # aligned windows 2, 3, 4, 6, 7, 8, 9: emissions after 3, 6 and 8
    assert [v for *_, v in got] == [v for *_, v in want] == [
        False, True, False, True, False, True, False]
    for (gr, gi, _), (wr, wi, _) in zip(got, want):
        assert gr.shape == (XF, XS * (XS + 1) // 2, XP * XP)
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gi, wi)


def test_frames_pass_untouched():
    """Frame data passes through as given, numpy or torch."""
    x, y = np.arange(3), torch.arange(3)
    ing = t_sync.SynchronizedIngest([[t_sync.TaggedFrame(0, x)],
                                     [t_sync.TaggedFrame(0, y)]],
                                    block_multiple=1)
    (got,) = list(ing)
    assert got[0] is x and got[1] is y
