"""Port parity: the streaming runtime (Block, Flowgraph, Runner) and the
X-Engine path through it.

Graph structure — toposort, frame-size resolution, per-port frames — is
held to the JAX package's Flowgraph on the same blocks.  The Runner's
K-frame dispatch is held to K single steps (equal: the same calls in the
same order), and the X-Engine flowgraph to the JAX flowgraph on the same
numpy feeds: IChar (int8) matrices equal bit for bit, float32 feeds within
1e-5 × max|ref| (float32 sums in another order than XLA's).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu.dsp import planar as j_planar
    from clenabled_tpu.streaming import block as j_block
    from clenabled_tpu.streaming import graph as j_graph
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch.blocks._legacy import strip_legacy_kwargs
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.streaming import Block, Flowgraph, FunctionBlock
from clenabled_tpu_torch.streaming import block as t_block
from clenabled_tpu_torch.streaming import graph as t_graph

REL = 1e-5
# the slice at test size: 8 stations × 2 pols, 4 channels, 32 frames
S, P, F, T = 8, 2, 4, 32
ICHAR_FRAME = T * F * P * 2


def np_of(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, rel=REL):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def equal(got, want):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference")


# --------------------------------------------------------------------------
# blocks and graph structure
# --------------------------------------------------------------------------

def test_block_protocol():
    b = FunctionBlock(lambda x: x * 2, rate=Fraction(1, 4), quantum=8,
                      name="dec")
    assert b.stateless and b.init_state() == ()
    st, out, msgs = b.apply((), (torch.ones(3),))
    assert st == () and msgs == {} and out[0].tolist() == [2.0] * 3
    assert b.out_frame(64) == 16
    with pytest.raises(ValueError, match="quantum"):
        b.out_frame(60)
    with pytest.raises(ValueError, match="not integral"):
        FunctionBlock(lambda x: x, rate=Fraction(1, 3)).out_frame(8)
    src = FunctionBlock(lambda: torch.zeros(4), n_inputs=0)
    with pytest.raises(ValueError, match="source_frame"):
        src.out_frame(0)
    src.source_frame = 4
    assert src.out_frame(0) == 4
    assert not Block.stateless
    with pytest.raises(NotImplementedError):
        Block().apply((), ())
    assert b.set_debug() is b and b.debug


def test_legacy_kwargs():
    xe = blocks.clXEngine(5, 2, S, num_channels=F, integration=T,
                          devSelector=1, setDebug=True, output_file="x")
    assert isinstance(xe, blocks.XEngine) and xe.debug
    with pytest.raises(TypeError, match="unexpected"):
        strip_legacy_kwargs({"bogus": 1})


def _multirate_graph(mod_block, mod_graph):
    """ext0 → dec(rate 1/4, quantum 4) → up(rate 3, quantum 3) → join;
    ext1 → ident(rate 3/4, keeps the head) → join → tap: the base frame
    must be a multiple of 12."""
    fb = mod_block.FunctionBlock
    dec = fb(lambda x: x[..., ::4], rate=Fraction(1, 4), quantum=4,
             name="dec")
    up = fb(lambda x: x.repeat_interleave(3, -1) if torch.is_tensor(x)
            else x.repeat(3, -1), rate=Fraction(3), quantum=3, name="up")
    ident = fb(lambda x: x[..., : x.shape[-1] * 3 // 4] * 0.75,
               rate=Fraction(3, 4), name="ident")
    join = fb(lambda x, y: x + y, n_inputs=2, name="join")
    g = mod_graph.Flowgraph()
    g.external_input(dec)
    g.external_input(ident)
    g.connect(dec, up)
    g.connect(up, join, dst_port=0)
    g.connect(ident, join, dst_port=1)
    g.tap(join, name="out")
    return g, [dec, up, ident, join]


def test_frame_resolution_matches_jax(ref):
    tg, tb = _multirate_graph(t_block, t_graph)
    jg, jb = _multirate_graph(j_block, j_graph)
    for size in (None, 48, 96):
        t_order, _, t_frames, t_size = tg._build(size)
        j_order, _, j_frames, j_size = jg._build(size)
        assert t_size == j_size == (size or 12)
        assert [b.name for b in t_order] == [b.name for b in j_order]
        for t, j in zip(tb, jb):
            assert t_frames[(id(t), 0)] == j_frames[(id(j), 0)]
    for bad in (18, 50):
        with pytest.raises(ValueError, match="multiple of 12"):
            tg._build(bad)
        with pytest.raises(ValueError, match="multiple of 12"):
            jg._build(bad)
    r = tg.compile(None, device="cpu")
    x = torch.arange(12, dtype=torch.float32)
    out = r.step(x, x)["out"]
    assert out.shape == (9,)
    equal(out, x[::4].repeat_interleave(3) + x[:9] * 0.75)


def test_graph_errors():
    a, b = FunctionBlock(lambda x: x, name="a"), FunctionBlock(lambda x: x)
    g = Flowgraph()
    g.connect(a, b)
    with pytest.raises(ValueError, match="already connected"):
        g.connect(a, b)
    with pytest.raises(ValueError, match="no output port"):
        g.connect(a, b, src_port=1)
    g.connect(b, a)
    with pytest.raises(ValueError, match="cycle"):
        g.compile(device="cpu")
    g2 = Flowgraph()
    g2.add(FunctionBlock(lambda x: x))
    with pytest.raises(ValueError, match="unconnected"):
        g2.compile(device="cpu")
    with pytest.raises(TypeError):
        Flowgraph().compile(8)             # the device is required


# --------------------------------------------------------------------------
# Runner: K-frame dispatch, run, messages, checkpoints
# --------------------------------------------------------------------------

def test_auto_dispatch_tells_stacked_from_single_feeds():
    """All-stateless graph at 2^20-sample frames: auto K = 2^22 / 2^20 = 4;
    a rank-1 feed is one frame, a [4, n] feed four."""
    blk = FunctionBlock(lambda x: x * 2, name="dbl")
    g = Flowgraph()
    g.external_input(blk)
    g.tap(blk, name="y")
    n = 1 << 20
    r = g.compile(n, device="cpu")
    assert r.steps_per_dispatch == 4 and r.auto_dispatch
    x = torch.arange(4 * n, dtype=torch.float32).reshape(4, n)
    assert r.step(x[0])["y"].shape == (n,)
    y = r.step(x)["y"]
    assert y.shape == (4, n)
    equal(y, x * 2)
    assert r.stats["steps"] == 5 and r.throughput_msps() > 0
    with pytest.raises(ValueError, match="expected 1 feeds"):
        r.step()
    pinned = g.compile(n, steps_per_dispatch=2, device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        pinned.step(x[:3])


def _fd_graph(mod_blocks, mod_graph, k, **compile_kw):
    blk = mod_blocks.XCorrelateFFTVCF(fft_size=16, num_inputs=3,
                                      accumulate_frames=2)
    g = mod_graph.Flowgraph()
    for i in range(3):
        g.external_input(blk, i)
    for i in range(2):
        g.tap(blk, i, name=f"c{i}")
    return g.compile(32, steps_per_dispatch=k, **compile_kw)


def _complex_feeds(seed, k):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((k, 32)) + 1j * rng.standard_normal((k, 32))
             ).astype(np.complex64) for _ in range(3)]


def test_k_frame_stateless_matches_single_steps_and_jax(ref):
    feeds = _complex_feeds(1, 4)
    multi = _fd_graph(blocks, t_graph, 4, device="cpu")
    single = _fd_graph(blocks, t_graph, 1, device="cpu")
    got = multi.step(*feeds)
    jgot = _fd_graph(j_blocks, j_graph, 4).step(*feeds)
    for j in range(4):
        one = single.step(*(f[j] for f in feeds))
        for name in ("c0", "c1"):
            equal(got[name][j], one[name])
    for name in ("c0", "c1"):
        assert got[name].shape == (4, 32)
        close(got[name], jgot[name])


def _xengine(**kw):
    kw = {"data_type": 5, "planar": True, "pipeline_integration": 2, **kw}
    return blocks.XEngine(polarization=P, num_inputs=S, num_channels=F,
                          integration=T, **kw)


def _jxengine(**kw):
    kw = {"data_type": 5, "planar": True, "pipeline_integration": 2, **kw}
    return j_blocks.XEngine(polarization=P, num_inputs=S, num_channels=F,
                            integration=T, **kw)


def _graph(xe, graph_mod=t_graph, **compile_kw):
    g = graph_mod.Flowgraph()
    for s in range(S):
        g.external_input(xe, s)
    return g.compile(xe.quantum, **compile_kw)


def _ichar_frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.integers(-128, 128, ICHAR_FRAME).astype(np.int8)
             for _ in range(S)] for _ in range(n)]


def _listen(runner, key="xengine.xcorr"):
    got = []
    runner.on_message(key, lambda m: got.append(
        (m["matrix"].re.clone(), m["matrix"].im.clone(), bool(m["valid"]))))
    return got


def test_k_frame_stateful_matches_single_steps():
    frames = _ichar_frames(4, seed=1)
    multi = _graph(_xengine(), steps_per_dispatch=2, device="cpu")
    single = _graph(_xengine(), steps_per_dispatch=1, device="cpu")
    got_m, got_s = _listen(multi), _listen(single)
    for k in (0, 2):
        stacked = [np.stack([frames[k][s], frames[k + 1][s]])
                   for s in range(S)]
        assert multi.step(*stacked) == {}
    for fr in frames:
        single.step(*fr)
    assert [v for *_, v in got_m] == [False, True, False, True]
    for (mr, mi, mv), (sr, si, sv) in zip(got_m, got_s):
        assert mv == sv and torch.equal(mr, sr) and torch.equal(mi, si)


def test_run_with_remainder_and_per_frame_messages(ref):
    """5 frames at K=2: two 2-frame dispatches and one single frame; one
    message per frame, equal to the JAX Runner's at the same K."""
    frames = _ichar_frames(5, seed=2)
    r = _graph(_xengine(), steps_per_dispatch=2, device="cpu")
    got = _listen(r)
    res = r.run(iter(frames))
    assert len(res) == 3 and r.stats["steps"] == 5
    jr = _graph(_jxengine(), j_graph, steps_per_dispatch=2)
    want = []
    jr.on_message("xengine.xcorr", lambda m: want.append(
        (np.asarray(m["matrix"].re), np.asarray(m["matrix"].im),
         bool(m["valid"]))))
    jr.run(iter(frames))
    assert [v for *_, v in got] == [v for *_, v in want] == [
        False, True, False, True, False]
    for (gr, gi, _), (wr, wi, _) in zip(got, want):
        equal(gr, wr)
        equal(gi, wi)


def test_save_load_state_round_trip(tmp_path):
    frames = _ichar_frames(2, seed=3)
    r = _graph(_xengine(), device="cpu")
    r.step(*frames[0])                    # half an integration carried
    assert r.states[0].count == 1 and r.states[0].accum.re.any()
    path = str(tmp_path / "state.pkl")
    r.save_state(path)
    want = _listen(r)
    r.step(*frames[1])
    r2 = _graph(_xengine(), device="cpu")
    got = _listen(r2)
    r2.load_state(path)
    assert r2.states[0].count == 1
    r2.step(*frames[1])
    assert got[0][2] and want[0][2]
    assert torch.equal(got[0][0], want[0][0])
    assert torch.equal(got[0][1], want[0][1])
    r2.reset()
    assert r2.states[0].count == 0 and not r2.states[0].accum.re.any()
    other = _graph(_xengine(planar=False), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        other.load_state(path)


def test_debug_block_prints_item_counts(capsys):
    r = _graph(_xengine().set_debug(), device="cpu")
    r.step(*_ichar_frames(1)[0])
    assert f"xengine: {ICHAR_FRAME} items/step × 1 steps" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the slice as a whole: the X-Engine flowgraph against JAX's
# --------------------------------------------------------------------------

def _run_both(tblock, jblock, feeds_per_step):
    tr = _graph(tblock, device="cpu")
    jr = _graph(jblock, j_graph)
    got, want = _listen(tr), []
    jr.on_message("xengine.xcorr", lambda m: want.append(
        (np.asarray(getattr(m["matrix"], "re", m["matrix"])),
         np.asarray(getattr(m["matrix"], "im", m["matrix"])),
         bool(m["valid"]))))
    for tf, jf in feeds_per_step:
        tr.step(*tf)
        jr.step(*jf)
    assert [v for *_, v in got] == [v for *_, v in want] == [False, True] * 2
    return got, want


def test_xengine_flowgraph_ichar_matches_jax(ref):
    """IChar bytes, channel-major stacked engine, pipeline_integration=2,
    4 steps: the emitted matrices equal JAX's bit for bit."""
    hk.reset_launch_counts()
    frames = _ichar_frames(4, seed=4)
    got, want = _run_both(_xengine(), _jxengine(),
                          [(fr, fr) for fr in frames])
    assert hk.gram_launches() == 0                # S·P = 16: batched products
    for (gr, gi, _), (wr, wi, _) in zip(got, want):
        assert gr.shape == (F, S * (S + 1) // 2, P * P)
        equal(gr, wr)
        equal(gi, wi)


@pytest.mark.parametrize("fmt", [1, 2], ids=["tri", "full"])
def test_xengine_flowgraph_packed_4bit_matches_jax(ref, fmt):
    """Packed 4-bit bytes: the triangular matrices equal JAX's; the full
    matrix within 1e-5 × max|ref|, because XLA fuses the 1/49 scale and
    the accumulator add of that format into one rounding (1 ulp)."""
    rng = np.random.default_rng(5)
    frames = [[rng.integers(0, 256, T * F * P).astype(np.uint8)
               for _ in range(S)] for _ in range(4)]
    got, want = _run_both(_xengine(data_type=6, output_format=fmt),
                          _jxengine(data_type=6, output_format=fmt),
                          [(fr, fr) for fr in frames])
    same = equal if fmt == 1 else close
    for (gr, gi, _), (wr, wi, _) in zip(got, want):
        same(gr, wr)
        same(gi, wi)


def test_xengine_flowgraph_float_feeds_match_jax(ref):
    """float32 feeds: planar pairs (channel-major) and complex64
    (time-major), within 1e-5 × max|ref|."""
    rng = np.random.default_rng(6)
    n = T * F * P
    re = [[rng.standard_normal(n).astype(np.float32) for _ in range(S)]
          for _ in range(4)]
    im = [[rng.standard_normal(n).astype(np.float32) for _ in range(S)]
          for _ in range(4)]
    steps = [([planar.PC(torch.from_numpy(a), torch.from_numpy(b))
               for a, b in zip(ra, ia)],
              [j_planar.PC(a, b) for a, b in zip(ra, ia)])
             for ra, ia in zip(re, im)]
    got, want = _run_both(_xengine(data_type=1), _jxengine(data_type=1),
                          steps)
    for (gr, gi, _), (wr, wi, _) in zip(got, want):
        close(gr, wr)
        close(gi, wi)
    steps = [([torch.complex(torch.from_numpy(a), torch.from_numpy(b))
               for a, b in zip(ra, ia)],
              [(a + 1j * b).astype(np.complex64) for a, b in zip(ra, ia)])
             for ra, ia in zip(re, im)]
    tr = _graph(_xengine(data_type=1, planar=False), device="cpu")
    jr = _graph(_jxengine(data_type=1, planar=False), j_graph)
    got, want = [], []
    tr.on_message("xengine.xcorr", lambda m: got.append(m))
    jr.on_message("xengine.xcorr", lambda m: want.append(m))
    for tf, jf in steps:
        tr.step(*tf)
        jr.step(*jf)
    for g, w in zip(got, want):
        assert bool(g["valid"]) == bool(w["valid"])
        wm = np.asarray(w["matrix"])
        close(torch.view_as_real(g["matrix"]),
              np.stack([wm.real, wm.imag], -1))
