"""Port parity: the typed FIRs (``fir_filter_scc``/``fsf``,
``make_fir_filter_typed``), the polyphase interpolating FIR and their
blocks (``FirFilterSCC``, ``FirFilterFSF``, ``InterpFirFilter``), and the
runtime's dtype codes and frame-size policy.

The same numpy inputs, made from a seed, go through the JAX function and
the port's on the CPU.  Complex and float outputs are held to JAX's within
1e-4 relative and 1e-4 × max|JAX| absolute; int16 outputs (truncated
toward zero after a float32 dot product in another order) to within one
count of JAX's, equal on all but a few samples; carried histories bit for
bit.  The float → int16 cast equals JAX's saturating cast exactly.  The
cases mirror the JAX package's ``test_short_dtypes.py`` and
``test_streaming.py``'s multirate graph.  The ``cuda`` case runs the
blocks on the card against the CPU path (skipped without a card).
"""

import os
import tempfile
from fractions import Fraction

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu import runtime as j_runtime
    from clenabled_tpu.dsp import fir_filter as j_fir
    from clenabled_tpu.dsp import planar as j_planar
    from clenabled_tpu.runtime import config as j_config
    from clenabled_tpu.streaming import Flowgraph as JFlowgraph
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import blocks, runtime
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import fir_filter, firdes, planar
from clenabled_tpu_torch.runtime import config
from clenabled_tpu_torch.streaming import Flowgraph

REL = 1e-4
TORCH_OF = {np.int16: torch.int16, np.float32: torch.float32,
            np.complex64: torch.complex64}
# float32 values around and beyond the int16 range, and the non-finite ones
EXTREMES = np.array([32768.5, 40000, -40000, -32769.5, np.nan, np.inf,
                     -np.inf], np.float32)


def np_of(x):
    if isinstance(x, planar.PC):
        return np_of(x.re) + 1j * np_of(x.im)
    if isinstance(x, tuple) and len(x) == 2:          # JAX's planar.PC
        return np.asarray(x[0]) + 1j * np.asarray(x[1])
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, rel=REL):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def counts_close(got, want):
    """int16 outputs within one count, equal on all but a few samples."""
    got, want = np_of(got), np_of(want)
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d != 0).mean() < 0.01


def equal(got, want):
    got, want = np_of(got), np_of(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference")


def _ctaps(rng, n):
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _conv_ref(x, taps):
    """y[m] = sum_j taps[j] * x[m + ntaps-1 - j] over history-prefixed x."""
    full = np.convolve(x, taps)
    return full[len(taps) - 1:len(x)]


# ------------------------------------------------------------ the runtime

def test_dtype_codes_and_frame_policy(ref):
    for code in range(1, 7):
        want = np.dtype(j_runtime.dtype_of(code))
        got = runtime.dtype_of(code)
        assert torch.empty(0, dtype=got).numpy().dtype == want
        assert runtime.itemsize_of(code) == j_runtime.itemsize_of(code)
    assert runtime.DTYPE_SHORT == 4 and runtime.dtype_of(4) == torch.int16
    for fn in (runtime.dtype_of, runtime.itemsize_of):
        with pytest.raises(ValueError, match="unknown dtype code"):
            fn(7)
    assert config.ALIGN == j_config.ALIGN == 1024
    assert config.DEFAULT_FRAME_SIZE == j_config.DEFAULT_FRAME_SIZE
    for n, m in ((1, 1024), (1024, 1024), (1025, 1024), (100, 7)):
        assert config.round_up(n, m) == j_config.round_up(n, m)
    assert config.validate_frame_size(8) == 8
    with pytest.raises(ValueError, match="positive"):
        config.validate_frame_size(0)


# ----------------------------------------------------- typed FIR functions

def test_int16_cast_saturates_as_jax_does(ref):
    """JAX's float32 → int16 cast truncates toward zero and saturates
    (NaN → 0); torch's own cast wraps.  Exactly equal to JAX's."""
    want = np.asarray(jnp.asarray(EXTREMES).astype(jnp.int16))
    np.testing.assert_array_equal(
        want, [32767, 32767, -32768, -32768, 0, 32767, -32768])
    equal(fir_filter.to_int16(torch.from_numpy(EXTREMES)), want)
    # fsf with a one-tap filter of 1.0 passes each value to the cast
    got = fir_filter.fir_filter_fsf(EXTREMES, np.ones(1, np.float32))
    equal(got, j_fir.fir_filter_fsf(EXTREMES, np.ones(1, np.float32)))
    # and in range: toward zero on both sides
    v = np.array([1.7, -1.7, -0.3, 0.3, 32767.9, -32768.9], np.float32)
    equal(fir_filter.to_int16(torch.from_numpy(v)),
          jnp.asarray(v).astype(jnp.int16))


@pytest.mark.parametrize("ntaps,n,dec,seed,span", [
    (31, 1024, 1, 0, 2000), (21, 640, 4, 2, 500)])
def test_fir_scc_matches_jax(ref, ntaps, n, dec, seed, span):
    """test_short_dtypes.py:20,58: int16 in, complex taps, complex64 out,
    at decimation 1 and 4."""
    rng = np.random.default_rng(seed)
    taps = _ctaps(rng, ntaps)
    x = rng.integers(-span, span, n + ntaps - 1, dtype=np.int16)
    got = fir_filter.fir_filter_scc(x, taps, decimation=dec)
    assert got.dtype == torch.complex64 and got.shape == (n // dec,)
    close(got, j_fir.fir_filter_scc(x, taps, decimation=dec))
    close(got, _conv_ref(x.astype(np.float64),
                         taps.astype(np.complex128))[::dec])


@pytest.mark.parametrize("dec", [1, 2])
def test_fir_fsf_matches_jax(ref, dec):
    """test_short_dtypes.py:35: float in, float taps, int16 out truncated
    toward zero, within one count of JAX and of the float64 dot product."""
    rng = np.random.default_rng(1)
    ntaps, n = 17, 512
    taps = rng.standard_normal(ntaps).astype(np.float32)
    x = (rng.standard_normal(n + ntaps - 1) * 100).astype(np.float32)
    got = fir_filter.fir_filter_fsf(x, taps, decimation=dec)
    counts_close(got, j_fir.fir_filter_fsf(x, taps, decimation=dec))
    yf = _conv_ref(x.astype(np.float64), taps.astype(np.float64))[::dec]
    np.testing.assert_allclose(np_of(got), yf, atol=1.0)


@pytest.mark.parametrize("variant", ["scc", "fsf", "ccc", "fff"])
def test_make_fir_filter_typed_streams(ref, variant):
    """Three chained frames through make_fir_filter_typed: outputs held to
    JAX's, the history in the INPUT dtype and equal to JAX's."""
    rng = np.random.default_rng(9)
    ntaps, n, dec = 13, 256, 2
    if variant == "scc":
        taps, in_np, out = _ctaps(rng, ntaps), np.int16, None
        frames = [rng.integers(-800, 800, n, dtype=np.int16)
                  for _ in range(3)]
    elif variant == "fsf":
        taps = rng.standard_normal(ntaps).astype(np.float32)
        in_np, out = np.float32, np.int16
        frames = [(rng.standard_normal(n) * 3000).astype(np.float32)
                  for _ in range(3)]      # outputs past ±32767: saturated
    elif variant == "ccc":
        taps, in_np, out = _ctaps(rng, ntaps), np.complex64, None
        frames = [_ctaps(rng, n) for _ in range(3)]
    else:
        taps = rng.standard_normal(ntaps).astype(np.float32)
        in_np, out = np.float32, None
        frames = [rng.standard_normal(n).astype(np.float32)
                  for _ in range(3)]
    ti, ta = fir_filter.make_fir_filter_typed(
        taps, dec, in_dtype=TORCH_OF[in_np],
        out_dtype=None if out is None else TORCH_OF[out], device="cpu")
    ji, ja = j_fir.make_fir_filter_typed(taps, dec, in_dtype=in_np,
                                         out_dtype=out)
    ts, js = ti(), ji()
    assert ts.dtype == TORCH_OF[in_np]
    for f in frames:
        ts, y = ta(ts, torch.from_numpy(f))
        js, w = ja(js, f)
        equal(ts, js)
        if out is None:
            close(y, w)
        else:
            counts_close(y, w)
    if variant == "fsf":
        assert np.abs(np_of(y).astype(np.int32)).max() == 32767 or \
            np_of(y).min() == -32768


# ------------------------------------------------- interpolating FIR functions

@pytest.mark.parametrize("ntaps,interp", [(10, 4), (25, 3), (3, 4), (7, 1)])
def test_interp_fir_filter_matches_jax(ref, ntaps, interp):
    rng = np.random.default_rng(ntaps + interp)
    taps = rng.standard_normal(ntaps).astype(np.float32)
    kb = -(-ntaps // interp)
    np.testing.assert_array_equal(fir_filter._branch_taps(taps, interp),
                                  j_fir._branch_taps(taps, interp))
    x = rng.standard_normal(kb - 1 + 200).astype(np.float32)
    got = fir_filter.interp_fir_filter(torch.from_numpy(x), taps, interp)
    assert got.shape == (200 * interp,)
    close(got, j_fir.interp_fir_filter(x, taps, interp))
    # zero-stuff by L, then the FIR: the polyphase identity
    up = np.zeros(len(x) * interp)
    up[::interp] = x
    want = np.convolve(up, taps.astype(np.float64))
    close(got, want[(kb - 1) * interp:(kb - 1) * interp + 200 * interp])


@pytest.mark.parametrize("form", ["complex", "planar"])
def test_make_interp_fir_filter_streams(ref, form):
    rng = np.random.default_rng(12)
    interp = 4
    taps = firdes.low_pass(float(interp), 4.0, 0.4, 0.2)
    if form == "planar":
        ti, ta = fir_filter.make_interp_fir_filter_planar(taps, interp,
                                                          device="cpu")
        ji, ja = j_fir.make_interp_fir_filter_planar(taps, interp)
    else:
        ti, ta = fir_filter.make_interp_fir_filter(taps, interp,
                                                   device="cpu")
        ji, ja = j_fir.make_interp_fir_filter(taps, interp)
    ts, js = ti(), ji()
    for _ in range(3):
        x = _ctaps(rng, 256)
        if form == "planar":
            ts, y = ta(ts, planar.from_complex(x))
            js, w = ja(js, j_planar.from_complex(x))
            equal(ts[0], js[0])
            equal(ts[1], js[1])
        else:
            ts, y = ta(ts, torch.from_numpy(x))
            js, w = ja(js, x)
            equal(ts, js)
        assert np_of(y).shape == (256 * interp,)
        close(y, w)


# ----------------------------------------------------------------- blocks

def _int16_graph(mod, fg, taps, frame, **kw):
    """test_short_dtypes.py:71: int16 feeds → Add (int16 math) →
    FirFilterSCC → ComplexToMag."""
    add, scc, mag = mod.Add(), mod.FirFilterSCC(1, taps), mod.ComplexToMag()
    g = fg()
    g.external_input(add, 0)
    g.external_input(add, 1)
    g.connect(add, scc)
    g.connect(scc, mag)
    tap = g.tap(mag, name="m")
    return g.compile(frame_size=frame, **kw), tap


def test_int16_stream_through_block_layer(ref):
    """The DTYPE_SHORT flowgraph against JAX's, three frames with the
    int16 history carried, and against the float64 convolution."""
    assert runtime.dtype_of(runtime.DTYPE_SHORT) == torch.int16
    rng = np.random.default_rng(3)
    taps = _ctaps(rng, 25)
    frame = 512
    tr, tt = _int16_graph(blocks, Flowgraph, taps, frame, device="cpu")
    jr, jt = _int16_graph(j_blocks, JFlowgraph, taps, frame)
    a = rng.integers(-800, 800, 3 * frame, dtype=np.int16)
    b = rng.integers(-800, 800, 3 * frame, dtype=np.int16)
    outs = []
    for i in range(3):
        sl = slice(i * frame, (i + 1) * frame)
        got = tr.step(a[sl], b[sl])[tt]
        close(got, jr.step(a[sl], b[sl])[jt])
        outs.append(np_of(got))
    assert tr.states[1].dtype == torch.int16
    equal(tr.states[1], jr.states[1])
    s = (a + b).astype(np.float64)
    want = np.abs(np.convolve(s, taps.astype(np.complex128))[:len(s)])
    close(np.concatenate(outs), want)


def test_fsf_block_stream(ref):
    """test_short_dtypes.py:97: FirFilterFSF at decimation 2, float stream
    in → int16 out across frames."""
    rng = np.random.default_rng(4)
    taps = rng.standard_normal(15).astype(np.float32)
    outs = []
    for mod, fg, kw in ((blocks, Flowgraph, {"device": "cpu"}),
                        (j_blocks, JFlowgraph, {})):
        fsf = mod.FirFilterFSF(2, taps)
        assert fsf.rate == Fraction(1, 2) and fsf.quantum == 2
        g = fg()
        g.external_input(fsf)
        tap = g.tap(fsf, name="y")
        r = g.compile(frame_size=256, **kw)
        x = (np.random.default_rng(5).standard_normal(512) * 50
             ).astype(np.float32)
        outs.append(np.concatenate([np_of(r.step(x[i * 256:(i + 1) * 256])
                                          [tap]) for i in range(2)]))
    counts_close(outs[0], outs[1])
    want = np.convolve(x.astype(np.float64), taps)[:len(x)][::2]
    np.testing.assert_allclose(outs[0], want, atol=1.0)


def test_typed_blocks_keep_their_taps():
    rng = np.random.default_rng(6)
    t = _ctaps(rng, 5)
    scc = blocks.FirFilterSCC(3, t, devId=0)
    assert scc.taps().dtype == np.complex64 and scc.rate == Fraction(1, 3)
    assert scc.init_state().dtype == torch.int16
    assert scc.init_state().shape == (4,)
    fsf = blocks.FirFilterFSF(1, t.real)
    assert fsf.taps().dtype == np.float32
    assert fsf.init_state().dtype == torch.float32
    up = blocks.InterpFirFilter(3, t.real, planar=True)
    assert up.rate == Fraction(3) and isinstance(up.init_state(), tuple)
    with pytest.raises(ValueError):
        blocks.InterpFirFilter(0, t.real)
    if not torch.cuda.is_available():      # the factories' default: the card
        for make in (lambda: fir_filter.make_fir_filter_typed(t),
                     lambda: fir_filter.make_interp_fir_filter(t.real, 2),
                     lambda: fir_filter.make_interp_fir_filter_planar(
                         t.real, 2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


@pytest.mark.parametrize("planar_feed", [False, True])
def test_multirate_interp_and_decimator_graph(ref, planar_feed):
    """test_streaming.py:237: a 1:4 interpolator feeding a 1/2 decimating
    filter runs through the scheduler (super-framing), checkpoints and
    resumes, and matches JAX's graph and the dsp-layer composition."""
    interp, decim = 4, 2
    itaps = firdes.low_pass(float(interp), 4.0, 0.4, 0.2)
    dtaps = firdes.low_pass(1.0, 1.0, 0.2, 0.1)

    def build(mod, fg, **kw):
        up = mod.InterpFirFilter(interp, itaps, planar=planar_feed)
        lpf = mod.Filter(decim, dtaps, use_time=True, planar=planar_feed)
        g = fg()
        g.external_input(up)
        g.connect(up, lpf)
        g.tap(lpf, name="out")
        r = g.compile(frame_size=512, **kw)
        assert r.frames[(id(up), 0)] == 512 * interp
        assert r.frames[(id(lpf), 0)] == 512 * interp // decim
        return r

    tr, jr = build(blocks, Flowgraph, device="cpu"), build(j_blocks,
                                                           JFlowgraph)
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(3 * 512)
         + 1j * rng.standard_normal(3 * 512)).astype(np.complex64)

    def feed(k, pc):
        f = x[k * 512:(k + 1) * 512]
        return pc.from_complex(f) if planar_feed else f

    outs = []
    for k in range(2):
        got = tr.step(feed(k, planar))["out"]
        close(got, jr.step(feed(k, j_planar))["out"])
        outs.append(np_of(got))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.pkl")
        tr.save_state(path)
        r2 = build(blocks, Flowgraph, device="cpu")
        r2.load_state(path)
        out3a = np_of(tr.step(feed(2, planar))["out"])
        out3b = np_of(r2.step(feed(2, planar))["out"])
    np.testing.assert_array_equal(out3a, out3b)
    close(out3a, jr.step(feed(2, j_planar))["out"])
    # the dsp-layer composition over the whole stream
    iinit, iapply = fir_filter.make_interp_fir_filter(itaps, interp,
                                                      device="cpu")
    _, y = iapply(iinit(), torch.from_numpy(x))
    finit, fapply = fir_filter.make_fir_filter(dtaps, decim)
    fst, want = finit(), []
    for k in range(3):
        fst, w = fapply(fst, y[k * 2048:(k + 1) * 2048])
        want.append(np_of(w))
    close(np.concatenate(outs + [out3a]), np.concatenate(want))


# --------------------------------------------------- hand-over from JAX

@pytest.mark.parametrize("kind", ["scc", "interp", "interp_planar"])
def test_runner_state_from_reference(ref, kind):
    """An int16 FirFilterSCC history and an InterpFirFilter state carried
    from a JAX Runner into the port mid-stream: the port's next frames
    equal JAX's."""
    rng = np.random.default_rng(13)
    frame = 256

    def build(mod, fg, **kw):
        if kind == "scc":
            blk = mod.FirFilterSCC(2, _ctaps(np.random.default_rng(1), 21))
        else:
            blk = mod.InterpFirFilter(3, firdes.low_pass(3.0, 3.0, 0.4, 0.2),
                                      planar=kind == "interp_planar")
        g = fg()
        g.external_input(blk)
        g.tap(blk, name="y")
        return g.compile(frame_size=frame, **kw)

    tr, jr = build(blocks, Flowgraph, device="cpu"), build(j_blocks,
                                                           JFlowgraph)
    if kind == "scc":
        frames = [rng.integers(-800, 800, frame, dtype=np.int16)
                  for _ in range(4)]
        t_feed = j_feed = lambda f: f
    else:
        frames = [_ctaps(rng, frame) for _ in range(4)]
        if kind == "interp_planar":
            t_feed, j_feed = planar.from_complex, j_planar.from_complex
        else:
            t_feed = j_feed = lambda f: f
    for f in frames[:2]:
        jr.step(j_feed(f))
    states = jax.tree.map(np.asarray, jr.states)
    tr.states = P.runner_state_from_reference(tr, states, [None])
    if kind == "scc":
        assert tr.states[0].dtype == torch.int16
    for f in frames[2:]:
        close(tr.step(t_feed(f))["y"], jr.step(j_feed(f))["y"])
    np.testing.assert_array_equal(
        np_of(tr.states[0] if kind != "interp_planar"
              else planar.PC(*tr.states[0])),
        np_of(jax.tree.map(np.asarray, jr.states)[0]))


# ------------------------------------------------------------ the card

@pytest.fixture
def tf32_on():
    """Both TF32 switches on for the test, restored after it: the port's
    own full-float32 sections, not the process's settings, must hold the
    tolerance."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.cuda
def test_typed_firs_on_card_match_cpu(tf32_on):
    """FirFilterSCC, FirFilterFSF (outputs crossing ±32767) and
    InterpFirFilter (complex and planar) on the card, three chained
    frames, against the CPU path: float outputs within 1e-4 × max|cpu|,
    int16 outputs within one count, histories equal, with TF32 on in the
    process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(14)
    taps = _ctaps(rng, 25)
    lp = firdes.low_pass(4.0, 4.0, 0.4, 0.2)
    cases = {
        "scc": (lambda: blocks.FirFilterSCC(4, taps),
                [rng.integers(-800, 800, 4096, dtype=np.int16)
                 for _ in range(3)]),
        "fsf": (lambda: blocks.FirFilterFSF(2, taps.real),
                [(rng.standard_normal(4096) * 8000).astype(np.float32)
                 for _ in range(3)]),
        "interp": (lambda: blocks.InterpFirFilter(4, lp),
                   [_ctaps(rng, 4096) for _ in range(3)]),
        "interp planar": (lambda: blocks.InterpFirFilter(4, lp, planar=True),
                          [planar.from_complex(_ctaps(rng, 4096))
                           for _ in range(3)]),
    }
    for name, (make, frames) in cases.items():
        outs = []
        for dev in ("cpu", "cuda"):
            g = Flowgraph()
            blk = make()
            g.external_input(blk)
            g.tap(blk, name="y")
            r = g.compile(frame_size=4096, device=dev)
            outs.append(([np_of(r.step(f)["y"]) for f in frames],
                         r.states[0]))
        for got, want in zip(outs[1][0], outs[0][0]):
            if name == "fsf":
                counts_close(got, want)
            else:
                close(got, want)
        st_c, st_g = outs[0][1], outs[1][1]
        if isinstance(st_c, tuple):
            st_c, st_g = planar.PC(*st_c), planar.PC(*st_g)
        np.testing.assert_array_equal(np_of(st_g), np_of(st_c))
