"""Port parity: the FIR and FFT filters (B.6, B.7), the filter
blocks, the FM receive flowgraph and the live retune.

On the CPU each kernel wrapper runs its plain torch form, which is held to
the JAX package: the direct FIR (``conv1d``) to ``fir_direct`` and
``fir_direct_mxu`` in interpret mode at 1e-5 × max|ref| (float32 sums in
another order), histories bit-equal; the overlap-save form (``torch.fft``
at the port's own transform size) to ``ofs_filter_planar`` in interpret
mode at 1e-4 × max|ref| (FFTs of other sizes and orders: the TPU kernel's
four DFT stages against one radix-2 FFT pair), tails bit-equal; the
overlap-add forms to JAX's at 1e-5 × max|ref|.  Flowgraphs compare the
filtered stream at 1e-5 × max|ref| and the demodulated audio as wrapped
angles at 1e-4·|gain| rad (an angle's error is the filter error over the
sample's magnitude, so rare small samples set it).  On a card (``cuda``
marker; skipped without one) each kernel is held to its plain form on the
same device at 1e-4 × max|plain|, TF32 off.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu.dsp import fft_filter as j_ofa
    from clenabled_tpu.dsp import fir_filter as j_fir
    from clenabled_tpu.dsp import pallas_kernels as j_pk
    from clenabled_tpu.dsp import planar as j_planar
    from clenabled_tpu.streaming import Flowgraph as JFlowgraph
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import fft_filter, fir_filter, firdes
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.streaming import Flowgraph

REL_FIR = 1e-5
REL_OFS = 1e-4
REL_CARD = 1e-4
ANGLE = 1e-4


def np_of(x):
    if isinstance(x, (planar.PC, tuple)) and len(x) == 2 and not isinstance(
            x[0], (int, float)):
        return np_of(x[0]) + 1j * np_of(x[1])
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, rel):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def equal(got, want):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def angles_close(got, want, gain=1.0, tol=ANGLE):
    """Demodulated samples as angles: the wrapped difference."""
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    d = np.angle(np.exp(1j * (got - want) / gain)) * abs(gain)
    assert np.abs(d).max() <= tol * abs(gain), np.abs(d).max()


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def lpf49():
    """The FM path's low-pass (examples/streaming_ingest.py): 49 taps."""
    return firdes.low_pass(1.0, 10e6, 1.5e6, 500e3)


def rrc241():
    """test_clfilter's RRC at its default 241 taps."""
    return firdes.root_raised_cosine(1.0, 10e6, 10e6 / (241 / 11 + 2), 0.22,
                                     241)


def deep(ntaps):
    return (np.sinc(np.linspace(-8, 8, ntaps)) * np.hanning(ntaps)).astype(
        np.float32)


TAPS = {"lpf49": lpf49, "rrc241": rrc241}


def planar_frames(n, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, n)).astype(np.float32)
            for _ in range(count)]


def tpc(a):
    return planar.PC(torch.from_numpy(a[0]), torch.from_numpy(a[1]))


def jpc(a):
    return j_planar.PC(jnp.asarray(a[0]), jnp.asarray(a[1]))


def test_taps_match_jax(ref):
    from clenabled_tpu.dsp import firdes as j_firdes

    equal(lpf49(), j_firdes.low_pass(1.0, 10e6, 1.5e6, 500e3))
    assert len(lpf49()) == 49 and len(rrc241()) == 241


# --------------------------------------------------------------------------
# the direct FIR (B.7 / B.8)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["vpu", "mxu"])
@pytest.mark.parametrize("taps", ["lpf49", "rrc241"])
@pytest.mark.parametrize("decim", [1, 4])
def test_fir_planar_stream_matches_pallas(ref, engine, taps, decim):
    """make_fir_filter_planar over 2 chained frames against JAX's on
    fir_direct / fir_direct_mxu in interpret mode."""
    t = TAPS[taps]()
    ji, ja = j_fir.make_fir_filter_planar(t, decim, tile_rows=8,
                                          interpret=True,
                                          use_mxu=engine == "mxu",
                                          precision="float32")
    ti, ta = fir_filter.make_fir_filter_planar(t, decim)
    js, ts = ji(), ti()
    hk.reset_launch_counts()
    for fr in planar_frames(8192, 2, seed=decim):
        js, jy = ja(js, jpc(fr))
        ts, ty = ta(ts, tpc(fr))
        close(ty, jy, REL_FIR)
        equal(ts[0], js[0])
        equal(ts[1], js[1])
    assert hk.fir_direct.launches == 0


def test_fir_wrapper_contract(ref):
    """fir_direct keeps the JAX function's contract ([K−1+n] with the
    history in front → [n]); fir_direct_mxu is the same entry."""
    t = rrc241()
    x = np.random.default_rng(3).standard_normal(240 + 4096).astype(np.float32)
    want = j_pk.fir_direct(jnp.asarray(x), t, tile_rows=8, interpret=True)
    assert hk.fir_direct_mxu is hk.fir_direct
    got = hk.fir_direct(torch.from_numpy(x), t)
    close(got, want, REL_FIR)
    split = hk.fir_direct(torch.from_numpy(x[240:]), t,
                          history=torch.from_numpy(x[:240]))
    assert torch.equal(split, got)
    dec = hk.fir_direct(torch.from_numpy(x), t, decimation=4)
    assert torch.equal(dec, hk.fir_direct_plain(torch.from_numpy(x), t,
                                                decimation=4))
    close(dec, np.asarray(want)[::4], REL_FIR)


def test_fir_wrapper_checks():
    x = torch.zeros(100)
    with pytest.raises(ValueError, match="real taps"):
        hk.fir_direct(x, np.ones(5, np.complex64))
    with pytest.raises(ValueError, match="multiple of the decimation"):
        hk.fir_direct(x, np.ones(5), decimation=5)     # n = 96
    with pytest.raises(ValueError, match="history"):
        hk.fir_direct(x, np.ones(5), history=torch.zeros(3))
    with pytest.raises(ValueError, match="positive"):
        hk.fir_direct(torch.zeros(4), np.ones(5))


@pytest.mark.parametrize("combo", ["ff", "cf", "fc", "cc"])
def test_fir_filter_combos_match_jax(ref, combo):
    rng = np.random.default_rng(4)
    k, n = 33, 512
    x = rng.standard_normal(k - 1 + n).astype(np.float32)
    t = rng.standard_normal(k).astype(np.float32)
    if combo[0] == "c":
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    if combo[1] == "c":
        t = (t + 1j * rng.standard_normal(k)).astype(np.complex64)
    for d in (1, 4):
        close(fir_filter.fir_filter(torch.from_numpy(x), t, d),
              j_fir.fir_filter(x, t, d), REL_FIR)


@pytest.mark.parametrize("cplx_taps", [False, True])
def test_fir_streaming_forms_match_jax(ref, cplx_taps):
    """The complex-stream FIR and the planar plain form (real and complex
    taps) over 3 chained frames, histories bit-equal."""
    rng = np.random.default_rng(5)
    t = rng.standard_normal(33).astype(np.float32)
    if cplx_taps:
        t = (t + 1j * rng.standard_normal(33)).astype(np.complex64)
    ci, ca = fir_filter.make_fir_filter(t, 2)
    cji, cja = j_fir.make_fir_filter(t, 2)
    pi_, pa = fir_filter.make_fir_filter_planar_xla(t, 2)
    pji, pja = j_fir.make_fir_filter_planar_xla(t, 2)
    cs, cjs, ps, pjs = ci(), cji(), pi_(), pji()
    for fr in planar_frames(1000, 3, seed=6):
        z = (fr[0] + 1j * fr[1]).astype(np.complex64)
        cs, cy = ca(cs, torch.from_numpy(z))
        cjs, cjy = cja(cjs, z)
        ps, py = pa(ps, tpc(fr))
        pjs, pjy = pja(pjs, jpc(fr))
        close(cy, cjy, REL_FIR)
        close(py, (pjy.re, pjy.im), REL_FIR)
        equal(cs, cjs)
        equal(ps[0], pjs[0])


# --------------------------------------------------------------------------
# the overlap-save filter (B.6) and the overlap-add forms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ntaps", [49, 241, 861, 1601])
def test_ofs_plan_sizing_matches_jax(ref, ntaps):
    t = deep(ntaps)
    mine, theirs = hk.OfsPlan(t), j_pk.OfsPlan(t)
    for attr in ("ntaps", "ov_rows", "stride", "t", "quantum", "tail_len"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    assert mine.quantum == 32768
    assert mine.fft_size >= 4 * (ntaps - 1) and mine.valid == (
        mine.fft_size - ntaps + 1)
    with pytest.raises(ValueError):
        hk.OfsPlan([1.0])


# (id, taps, decimation, frame length in quanta)
OFS_CASES = [("lpf49_one_quantum", "lpf49", 1, 1),
             ("rrc241_d4", "rrc241", 4, 2),
             ("complex33", "complex33", 1, 1)]


def _ofs_taps(name):
    if name == "complex33":
        rng = np.random.default_rng(7)
        return (rng.standard_normal(33) + 1j * rng.standard_normal(33)
                ).astype(np.complex64)
    return TAPS[name]()


@pytest.mark.parametrize("case", OFS_CASES, ids=[c[0] for c in OFS_CASES])
def test_ofs_stream_matches_pallas(ref, case):
    """make_fft_filter_planar(fused=True) over 2 chained frames against
    JAX's ofs_filter_planar in interpret mode, fed the same tails."""
    _, name, decim, quanta = case
    t = _ofs_taps(name)
    init, apply, plan = fft_filter.make_fft_filter_planar(t, decim, fused=True)
    jplan = j_pk.OfsPlan(t)
    assert isinstance(plan, hk.OfsPlan)
    assert fft_filter.frame_quantum(plan) == plan.quantum == jplan.quantum
    n = plan.quantum * quanta
    st = init()
    jt = (jnp.zeros(plan.tail_len), jnp.zeros(plan.tail_len))
    hk.reset_launch_counts()
    for fr in planar_frames(n, 2, seed=8):
        st, y = apply(st, tpc(fr))
        jr, ji = j_pk.ofs_filter_planar(jnp.asarray(fr[0]), jnp.asarray(fr[1]),
                                        *jt, jplan, interpret=True)
        jr, ji = np.asarray(jr)[::decim], np.asarray(ji)[::decim]
        close(y, (jr, ji), REL_OFS)
        equal(st[0], fr[0][-plan.tail_len:])
        equal(st[1], fr[1][-plan.tail_len:])
        jt = (jnp.asarray(fr[0][-plan.tail_len:]),
              jnp.asarray(fr[1][-plan.tail_len:]))
    assert hk.ofs_filter_planar.launches == 0
    with pytest.raises(ValueError, match="multiple of"):
        apply(st, tpc(planar_frames(n + 128, 1, seed=9)[0]))


@pytest.mark.parametrize("ntaps", [49, 241, 1601])
def test_ofs_kernel_spectrum_in_core_order(ntaps):
    """The kernel's constants: the tap spectrum / P in the order the core's
    forward passes leave (natural: Stockham), and a chunk through the numpy
    model of the kernel's forward passes, the product and the reversed
    inverse passes equals the circular convolution."""
    from test_torch_fft import stockham

    plan = hk.OfsPlan(deep(ntaps))
    p = plan.fft_size
    spec, kspec, tw = (c.numpy() for c in plan.consts(torch.device("cpu")))
    fwd, inv = hk.fft_passes(p), hk.fft_passes(p, reverse=True)
    assert inv[0] == fwd[0][::-1]
    assert np.array_equal(tw, np.concatenate([fwd[1], inv[1]]))
    padded = np.zeros(p, np.complex128)
    padded[:ntaps] = deep(ntaps)
    close(kspec, stockham(padded, *fwd) / p, 1e-5)
    close(spec, stockham(padded, *fwd), 1e-5)
    x = np.random.default_rng(ntaps).standard_normal((2, p))
    chunk = x[0] + 1j * x[1]
    got = stockham(stockham(chunk, *fwd) * kspec, *inv, inverse=True)
    want = np.fft.ifft(np.fft.fft(chunk) * np.fft.fft(padded))
    close(got, want, 1e-5)


def test_ofs_equals_ofa_samples():
    """The overlap-save form's samples are the overlap-add form's."""
    t = rrc241()
    oi, oa, plan = fft_filter.make_fft_filter_planar(t, fused=True)
    ai, aa, aplan = fft_filter.make_fft_filter_planar(t, fused=False)
    assert not hasattr(aplan, "tail_len")
    n = plan.quantum * aplan.nsamples     # a multiple of both quanta
    os_, as_ = oi(), ai()
    for fr in planar_frames(n, 2, seed=10):
        os_, yo = oa(os_, tpc(fr))
        as_, ya = aa(as_, tpc(fr))
        close(yo, ya, REL_OFS)


@pytest.mark.parametrize("decim", [1, 4])
def test_ofa_forms_match_jax(ref, decim):
    """The complex and planar overlap-add forms over 3 chained frames."""
    t = firdes.low_pass(1.0, 1e6, 80e3, 20e3)
    ci, ca, plan = fft_filter.make_fft_filter(t, decim)
    cji, cja, jplan = j_ofa.make_fft_filter(t, decim)
    pi_, pa, pplan = fft_filter.make_fft_filter_planar(t, decim, fused=False)
    pji, pja, _ = j_ofa.make_fft_filter_planar(t, decim, use_pallas=False)
    assert (plan.fftsize, plan.nsamples) == (jplan.fftsize, jplan.nsamples)
    assert fft_filter.frame_quantum(plan) == j_ofa.frame_quantum(jplan)
    equal(plan.xformed_taps, jplan.xformed_taps)
    n = fft_filter.frame_quantum(plan) * 4
    cs, cjs, ps, pjs = ci(), cji(), pi_(), pji()
    for fr in planar_frames(n, 3, seed=11):
        z = (fr[0] + 1j * fr[1]).astype(np.complex64)
        cs, cy = ca(cs, torch.from_numpy(z))
        cjs, cjy = cja(cjs, z)
        ps, py = pa(ps, tpc(fr))
        pjs, pjy = pja(pjs, jpc(fr))
        close(cy, cjy, REL_FIR)
        close(cs, cjs, REL_FIR)
        close(py, (pjy.re, pjy.im), REL_FIR)
        close(ps, (pjs[0], pjs[1]), REL_FIR)
    x = planar_frames(n, 1, seed=12)[0]
    z = (x[0] + 1j * x[1]).astype(np.complex64)
    close(fft_filter.fft_filter(z, t, decim), j_ofa.fft_filter(z, t, decim),
          REL_FIR)
    assert fft_filter.compute_sizes(241) == j_ofa.compute_sizes(241)


# --------------------------------------------------------------------------
# blocks and the FM receive flowgraph
# --------------------------------------------------------------------------

def _fm_graph(mod_blocks, graph_cls, use_time, planar_, frame, decim=1,
              **compile_kw):
    lpf = mod_blocks.LowPassFilter(decim, 1.0, 10e6, 1.5e6, 500e3,
                                   use_time=use_time, planar=planar_)
    qd = mod_blocks.QuadratureDemod(1.0, planar=planar_)
    g = graph_cls()
    g.external_input(lpf)
    g.connect(lpf, qd)
    y = g.tap(lpf, name="filtered")
    a = g.tap(qd, name="audio")
    return g.compile(frame_size=frame, **compile_kw), (lpf, qd), (y, a)


@pytest.mark.parametrize("use_time", [True, False], ids=["td", "fd"])
@pytest.mark.parametrize("planar_", [True, False], ids=["planar", "complex"])
def test_fm_flowgraph_matches_jax(ref, use_time, planar_):
    """LowPass → QuadratureDemod (the streaming_ingest configuration) over
    3 frames against the JAX flowgraph: filtered stream, audio and the
    carried states."""
    probe = blocks.LowPassFilter(1, 1.0, 10e6, 1.5e6, 500e3,
                                 use_time=use_time, planar=planar_)
    frame = 4096 if use_time else probe.quantum * 64
    tr, (tl, tq), (ty, ta) = _fm_graph(blocks, Flowgraph, use_time, planar_,
                                       frame, device="cpu")
    jr, (jl, jq), (jy, ja) = _fm_graph(j_blocks, JFlowgraph, use_time,
                                       planar_, frame)
    assert tl.quantum == jl.quantum and tr.frame_size == jr.frame_size
    assert tl._state_kind == jl._state_kind
    for fr in planar_frames(frame, 3, seed=13):
        if planar_:
            got, want = tr.step(tpc(fr)), jr.step(jpc(fr))
            gy, wy = got[ty], (want[jy].re, want[jy].im)
        else:
            z = (fr[0] + 1j * fr[1]).astype(np.complex64)
            got, want = tr.step(z), jr.step(z)
            gy, wy = got[ty], want[jy]
        close(gy, wy, REL_FIR)
        angles_close(got[ta], want[ja])
    for mine, theirs in zip(tr.states, jr.states):
        close(mine, theirs, REL_FIR)


def test_filter_block_paths():
    """The block's routes: TD real taps on the kernel wrapper (quantum D),
    complex planar taps on the plain form, FD on the overlap-add form
    without a card; ComplexFilter keeps complex taps; cl* aliases."""
    t = lpf49()
    td = blocks.Filter(4, t, use_time=True, planar=True)
    assert (td.quantum, td._state_kind, td._state_len) == (4, "td", 48)
    fd = blocks.clLowPassFilter(2, 1.0, 10e6, 1.5e6, 500e3, planar=True,
                                devSelector=1)
    assert fd._state_kind == ("ofs" if torch.cuda.is_available() else "ofa")
    cf = blocks.ComplexFilter(1, t.astype(np.complex64) * 1j, planar=True)
    assert cf.taps().dtype == np.complex64 and cf._state_kind == "td"
    for cls in ("HighPassFilter", "BandPassFilter", "BandRejectFilter",
                "RootRaisedCosineFilter", "FIRTapFilter"):
        assert getattr(blocks, cls) is not None
    hp = blocks.HighPassFilter(1, 1.0, 10e6, 1.5e6, 500e3)
    bp = blocks.BandPassFilter(1, 1.0, 10e6, 1e6, 2e6, 500e3)
    br = blocks.BandRejectFilter(1, 1.0, 10e6, 1e6, 2e6, 500e3)
    rrc = blocks.RootRaisedCosineFilter(1, 1.0, 10e6, 1e6, 0.22, 65)
    fir = blocks.FIRTapFilter(1, t, use_time=True)
    for b in (hp, bp, br, rrc, fir):
        assert isinstance(b, blocks.Filter) and b.taps().dtype == np.float32
    assert blocks.clQuadratureDemod is blocks.QuadratureDemod
    assert blocks.clFilter is blocks.Filter
    with pytest.raises(TypeError):
        blocks.Filter(1, t, bogus=1)


def test_filter_blocks_match_jax_designs(ref):
    pairs = [("HighPassFilter", (1, 1.0, 10e6, 1.5e6, 500e3)),
             ("BandPassFilter", (1, 1.0, 10e6, 1e6, 2e6, 500e3)),
             ("BandRejectFilter", (1, 1.0, 10e6, 1e6, 2e6, 500e3)),
             ("RootRaisedCosineFilter", (1, 1.0, 10e6, 1e6, 0.22, 65))]
    for name, args in pairs:
        equal(getattr(blocks, name)(*args).taps(),
              getattr(j_blocks, name)(*args).taps())


# --------------------------------------------------------------------------
# live retune: the six cases of tests/test_retune.py on the port's Runner
# --------------------------------------------------------------------------

def _run_chain(taps_a, taps_b, frames, use_time, retune_after, frame,
               decimation=1):
    flt = blocks.Filter(decimation, taps_a, use_time=use_time)
    g = Flowgraph()
    g.external_input(flt)
    tap = g.tap(flt, name="y")
    r = g.compile(frame_size=frame, device="cpu")
    outs = []
    for i, x in enumerate(frames):
        if i == retune_after:
            r.set_taps(flt, taps_b)
        outs.append(np.asarray(r.step(x)[tap]))
    return np.concatenate(outs)


def _frames(n_frames, frame, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n_frames * frame)
         + 1j * rng.standard_normal(n_frames * frame)).astype(np.complex64)
    return x, [x[i * frame:(i + 1) * frame] for i in range(n_frames)]


@pytest.mark.parametrize("use_time", [True, False])
def test_retune_same_taps_stream_unchanged(use_time):
    """Retune to IDENTICAL taps mid-stream == no retune at all."""
    taps = np.hanning(33).astype(np.float32)
    frame = 1024 if use_time else blocks.Filter(
        1, taps, use_time=False).quantum * 4
    x, frames = _frames(6, frame)
    base = _run_chain(taps, taps, frames, use_time, retune_after=None,
                      frame=frame)
    retuned = _run_chain(taps, taps.copy(), frames, use_time, retune_after=3,
                         frame=frame)
    np.testing.assert_array_equal(base, retuned)


def test_retune_td_new_taps_exact_from_retune_point():
    """TD state is input-domain history, so with unchanged ntaps the
    post-retune output equals a convolution of the CONTINUOUS input with
    the new taps from the very first post-retune sample."""
    taps_a = np.hanning(33).astype(np.float32)
    taps_b = (np.hanning(33) * np.cos(np.arange(33))).astype(np.float32)
    frame = 512
    x, frames = _frames(6, frame, seed=1)
    got = _run_chain(taps_a, taps_b, frames, True, retune_after=3,
                     frame=frame)
    want_post = np.convolve(x, taps_b)[:len(x)][3 * frame:]
    np.testing.assert_allclose(got[3 * frame:], want_post, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("ntaps_b", [17, 65])
def test_retune_td_ntaps_change(ntaps_b):
    """Tap-count change: history is truncated (keep most recent) or
    left-padded with zeros; outputs are exact once the new filter window
    fits inside the kept history."""
    ntaps_a = 33
    taps_a = np.hanning(ntaps_a).astype(np.float32)
    taps_b = np.hanning(ntaps_b).astype(np.float32)
    frame = 512
    x, frames = _frames(6, frame, seed=2)
    got = _run_chain(taps_a, taps_b, frames, True, retune_after=3,
                     frame=frame)
    want_post = np.convolve(x, taps_b)[:len(x)][3 * frame:]
    settle = max(0, ntaps_b - ntaps_a)
    np.testing.assert_allclose(got[3 * frame + settle:], want_post[settle:],
                               rtol=1e-4, atol=1e-4)


def test_retune_ofa_new_taps_post_transient():
    """FD (overlap-add) state is the output-domain tail: after a retune the
    cross-boundary contributions still use the old taps (the reference's
    behaviour — the carried tail was computed before set_taps), so outputs
    match the new-tap convolution after ntaps−1 samples."""
    ntaps = 33
    taps_a = np.hanning(ntaps).astype(np.float32)
    taps_b = (np.hanning(ntaps) * np.cos(np.arange(ntaps))).astype(np.float32)
    flt = blocks.Filter(1, taps_a, use_time=False)
    frame = flt.quantum * 4
    x, frames = _frames(6, frame, seed=3)
    got = _run_chain(taps_a, taps_b, frames, False, retune_after=3,
                     frame=frame)
    want_post = np.convolve(x, taps_b)[:len(x)][3 * frame:]
    np.testing.assert_allclose(got[3 * frame + ntaps - 1:],
                               want_post[ntaps - 1:], rtol=1e-4, atol=1e-4)


def test_retune_quantum_violation_raises():
    """A retune that changes the OFA chunk quantum past the compiled frame
    size must fail loudly, not corrupt the stream."""
    taps_a = np.hanning(33).astype(np.float32)
    flt = blocks.Filter(1, taps_a, use_time=False)
    g = Flowgraph()
    g.external_input(flt)
    g.tap(flt, name="y")
    frame = flt.quantum
    r = g.compile(frame_size=frame, device="cpu")
    r.step(np.zeros(frame, np.complex64))
    big = np.hanning(4097).astype(np.float32)  # quantum grows past frame
    old_taps = np.asarray(flt.taps())
    old_quantum = flt.quantum
    with pytest.raises(ValueError):
        r.set_taps(flt, big)
    # atomic: the failed retune rolled the block back — it still reports
    # the OLD taps/quantum and the stream keeps running on them
    np.testing.assert_array_equal(np.asarray(flt.taps()), old_taps)
    assert flt.quantum == old_quantum
    r.step(np.zeros(frame, np.complex64))


def test_retune_downstream_state_untouched():
    """refresh() migrates only the reconfigured block; other blocks'
    carried state flows on."""
    taps = np.hanning(33).astype(np.float32)
    taps2 = (np.hanning(33) * 0.5).astype(np.float32)
    f1 = blocks.Filter(1, taps, use_time=True, name="f1")
    f2 = blocks.Filter(1, taps, use_time=True, name="f2")
    g = Flowgraph()
    g.external_input(f1)
    g.connect(f1, f2)
    tap = g.tap(f2, name="y")
    frame = 512
    x, frames = _frames(6, frame, seed=4)
    r = g.compile(frame_size=frame, device="cpu")
    outs = []
    for i, fr in enumerate(frames):
        if i == 3:
            r.set_taps(f1, taps2)
        outs.append(np.asarray(r.step(fr)[tap]))
    got = np.concatenate(outs)
    # reference: conv chain where f1's taps switch at sample 3·frame
    y1_a = np.convolve(x, taps)[:len(x)]
    y1_b = np.convolve(x, taps2)[:len(x)]
    y1 = np.concatenate([y1_a[:3 * frame], y1_b[3 * frame:]])
    want = np.convolve(y1, taps)[:len(x)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_retune_matches_jax_runner(ref):
    """The planar TD path (the FIR kernel's wrapper) retuned mid-stream
    against the JAX Runner's set_taps, and refresh() refusing a changed
    block set."""
    t_a, t_b = lpf49(), rrc241()[96:145] * 4.0
    frame = 4096
    outs = []
    for mod, graph_cls, kw, conv in ((blocks, Flowgraph, {"device": "cpu"},
                                      tpc),
                                     (j_blocks, JFlowgraph, {}, jpc)):
        flt = mod.Filter(1, t_a, use_time=True, planar=True)
        g = graph_cls()
        g.external_input(flt)
        tap = g.tap(flt, name="y")
        r = g.compile(frame_size=frame, **kw)
        got = []
        for i, fr in enumerate(planar_frames(frame, 4, seed=14)):
            if i == 2:
                r.set_taps(flt, t_b)
            y = r.step(conv(fr))[tap]
            got.append(np_of((y.re, y.im)))
        outs.append(np.concatenate(got))
    close(outs[0], outs[1], REL_FIR)


def test_retune_ofs_keeps_the_input_tail(monkeypatch):
    """With a card visible the FD block takes the overlap-save form; its
    input-domain tail makes a same-length retune exact from the retune
    point, a longer one exact after the tap-count delta, and a switch to
    the overlap-add form starts from zeros (no mapping)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    t_a = np.hanning(33).astype(np.float32)
    flt = blocks.Filter(1, t_a, planar=True)
    assert flt._state_kind == "ofs" and flt._state_len == 128
    g = Flowgraph()
    g.external_input(flt)
    tap = g.tap(flt, name="y")
    frame = flt.quantum
    r = g.compile(frame_size=frame, device="cpu")
    fr = planar_frames(frame, 4, seed=15)
    x = np.concatenate([f[0] + 1j * f[1] for f in fr])
    t_b = (np.hanning(33) * np.cos(np.arange(33))).astype(np.float32)
    t_c = np.hanning(129).astype(np.float32)
    got = []
    for i, f in enumerate(fr):
        if i == 1:
            r.set_taps(flt, t_b)
        if i == 2:
            r.set_taps(flt, t_c)
            assert r.states[0][0].shape == (128,)
        got.append(np_of(r.step(tpc(f))[tap]))
    np.testing.assert_allclose(got[1], np.convolve(x, t_b)[frame:2 * frame],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2], np.convolve(x, t_c)[2 * frame:3 * frame],
                               rtol=1e-4, atol=1e-4)
    flt._old_kind = "ofa"
    assert not flt.migrate_state(r.states[0])[0].any()
    g.connect(flt, blocks.Filter(1, t_a, use_time=True))
    with pytest.raises(ValueError, match="block set"):
        r.refresh()


# --------------------------------------------------------------------------
# state hand-over from a JAX Runner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_time", [True, False], ids=["td", "fd"])
def test_runner_state_from_reference(ref, use_time):
    """A stream begun in the JAX package continues in the port: 2 frames
    in JAX, the states handed over, a third frame in both."""
    probe = blocks.LowPassFilter(1, 1.0, 10e6, 1.5e6, 500e3,
                                 use_time=use_time, planar=True)
    frame = probe.quantum * (1024 if use_time else 16)
    tr, _, (ty, ta) = _fm_graph(blocks, Flowgraph, use_time, True, frame,
                                device="cpu")
    jr, (jl, jq), (jy, ja) = _fm_graph(j_blocks, JFlowgraph, use_time, True,
                                       frame)
    fr = planar_frames(frame, 3, seed=16)
    for f in fr[:2]:
        jr.step(jpc(f))
    kinds = [getattr(b, "_state_kind", None) for b in jr._order]
    states = jax.tree.map(np.asarray, jr.states)
    tr.states = P.runner_state_from_reference(tr, states, kinds)
    assert isinstance(tr.states[1], planar.PC)
    got, want = tr.step(tpc(fr[2])), jr.step(jpc(fr[2]))
    close(got[ty], (want[jy].re, want[jy].im), REL_FIR)
    angles_close(got[ta], want[ja])
    with pytest.raises(ValueError, match="state kind"):
        P.runner_state_from_reference(tr, states, [None] * len(kinds))
    with pytest.raises(ValueError, match="trees differ"):
        P.runner_state_from_reference(tr, (states[0], ()), kinds)


def test_runner_state_hand_over_refuses_ofa_for_ofs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    r, (lpf, _), _ = _fm_graph(blocks, Flowgraph, False, True, 32768,
                               device="cpu")
    assert lpf._state_kind == "ofs"
    z = np.zeros(48, np.float32)
    with pytest.raises(ValueError, match="overlap-add tail does not map"):
        P.runner_state_from_reference(r, ((z, z), (z[:1], z[:1])),
                                      ["ofa", None])


def test_clfilter_cli_arguments():
    from clenabled_tpu_torch.tools import test_clfilter as cli

    args = cli.parse_args([])
    assert (args.ntaps, args.blocksize, args.decimation) == (241, 1 << 18, 1)
    args = cli.parse_args(["--ntaps", "49", "--decimation", "4"])
    assert (args.ntaps, args.decimation) == (49, 4)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):     # it times on a card only
            cli.main(["--ntaps", "49"])


# --------------------------------------------------------------------------
# fir_reg_kernel's schedule, replayed in numpy (csrc/fir_direct.cu)
# --------------------------------------------------------------------------

FIR_THREADS = 256
FIR_R = 16               # outputs a lane
FIR_STAGE_UNROLL = 4


def _fma32(a, b, c):
    """fmaf as float64 product and sum rounded to float32 (the same
    rounding on both sides of every comparison here)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _fir_swz(g):
    """The stored 16-byte group of window group g (the kernel's fir_swz)."""
    return g ^ ((g >> 3) & (FIR_R // 4 - 1))


def _fir_kpad(ntaps):
    return -(-ntaps // 4) * 4


def _fir_stage(frame, hist, blk, ntaps, vec=True):
    """The kernel's staging for block ``blk``: window group i (i <
    (KP + 256·R)/4) holds frame samples f = o0 − KP + 4i .. + 3 (hist[K−1+f]
    for f < 0, 0 past either end); with ``vec`` (a 16-byte aligned frame)
    a group inside the frame loads as one vector, any other sample by
    sample.  Thread t stores groups t + 256·(4·a + u) at _fir_swz.  Returns
    the flat window (words never stored are 0) and a record of reads (by
    source), vector reads and thread-ordered group stores."""
    n, hl = frame.shape[-1], ntaps - 1
    kp, outs = _fir_kpad(ntaps), FIR_THREADS * FIR_R
    groups = (kp + outs) // 4
    fbase = blk * outs - kp
    win = np.zeros(-(-(kp + outs) // 32) * 32, np.float32)
    rec = {"reads_h": [], "reads_f": [], "vector": [], "store": []}
    for i0 in range(0, groups, FIR_STAGE_UNROLL * FIR_THREADS):
        for u in range(FIR_STAGE_UNROLL):
            for t in range(FIR_THREADS):
                i = i0 + u * FIR_THREADS + t
                rec["store"].append(None if i >= groups else _fir_swz(i))
                if i >= groups:
                    continue
                f = fbase + 4 * i
                val = np.zeros(4, np.float32)
                if vec and f >= 0 and f + 4 <= n:
                    rec["vector"].append(f)
                    rec["reads_f"] += range(f, f + 4)
                    val[:] = frame[f:f + 4]
                else:
                    for q in range(4):
                        fq = f + q
                        if -hl <= fq < 0:
                            rec["reads_h"].append(hl + fq)
                            val[q] = hist[hl + fq]
                        elif 0 <= fq < n:
                            rec["reads_f"].append(fq)
                            val[q] = frame[fq]
                g = _fir_swz(i)
                win[4 * g:4 * g + 4] = val
    return win, rec


def _fir_compute(win, taps, ntaps, blk):
    """The FIR on one block's window, lane by lane (vectorized over the 256
    lanes): the ring of R/4 + 1 groups, slot (i − c) mod G for group gw −
    c + i, each chunk loading group gw − c into slot −c mod G first; taps
    4c .. 4c + 3 (the last chunk K mod 4 of them) in ascending order, each
    output's sum one fma chain from 0.  Alongside the values, the ring
    carries each word's frame index, so every multiply-add's operand is
    checked to be frame sample o − k.  Returns the [256·R] sums in output
    order, the window group loads (warp-wide, thread-ordered) and the
    sums' group stores."""
    r = FIR_R
    s = r // 4
    g_ = s + 1
    kp, outs = _fir_kpad(ntaps), FIR_THREADS * r
    lane = np.arange(FIR_THREADS)
    gw = kp // 4 + lane * s - 1
    fbase = blk * outs - kp
    vals = np.zeros((g_, 4, FIR_THREADS), np.float32)
    fidx = np.zeros((g_, 4, FIR_THREADS), np.int64)
    loads = []

    def load(slot, g):
        assert (g >= 0).all() and (4 * g + 3 < kp + outs).all()
        a = _fir_swz(g)
        loads.append(a)
        for q in range(4):
            vals[slot, q] = win[4 * a + q]
            fidx[slot, q] = fbase + 4 * g + q

    for i in range(1, s + 1):
        load(i, gw + i)
    acc = np.zeros((r, FIR_THREADS), np.float32)
    o = blk * outs + lane * r
    for c in range(-(-ntaps // 4)):
        load((-c) % g_, gw - c)
        for j in range(min(4, ntaps - 4 * c)):
            k = 4 * c + j
            for rr in range(r):
                w = rr - j + 4
                slot = (w // 4 - c) % g_
                assert (fidx[slot, w % 4] == o + rr - k).all()
                acc[rr] = _fma32(taps[k], vals[slot, w % 4], acc[rr])
    stores = [_fir_swz(lane * s + i) for i in range(s)]
    out = np.zeros(outs, np.float32)
    for i in range(s):
        for q in range(4):
            out[4 * stores[i] + q] = acc[4 * i + q]
    t = np.arange(FIR_THREADS)
    copy = [t + m * FIR_THREADS for m in range(r)]
    words = [4 * _fir_swz(w // 4) + w % 4 for w in copy]
    y = np.zeros(outs, np.float32)
    for w, a in zip(copy, words):
        y[w] = out[a]
    return y, {"window": loads, "sums": stores, "copy_out": words}


def _fir_reg(frame, hist, taps, vec=True):
    """The whole kernel on one component: every block's staging, FIR and
    copy-out (the ragged end masked)."""
    n, k = frame.shape[-1], taps.shape[0]
    outs = FIR_THREADS * FIR_R
    y = np.zeros(n, np.float32)
    for blk in range(-(-n // outs)):
        win, _ = _fir_stage(frame, hist, blk, k, vec)
        got, _ = _fir_compute(win, taps, k, blk)
        valid = min(outs, n - blk * outs)
        y[blk * outs: blk * outs + valid] = got[:valid]
    return y


def _fir_chain(frame, hist, taps):
    """Every output's fma chain in ascending tap order, vectorized over the
    outputs (fir_direct_kernel's order of sums)."""
    k, n = taps.shape[0], frame.shape[-1]
    v = np.concatenate([hist, frame])
    acc = np.zeros(n, np.float32)
    for j in range(k):
        acc = _fma32(taps[j], v[k - 1 - j: k - 1 - j + n], acc)
    return acc


def _fir_case(ntaps, n, seed):
    rng = np.random.default_rng(seed)
    taps = rng.standard_normal(ntaps).astype(np.float32)
    return (taps, rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(ntaps - 1).astype(np.float32))


# (ntaps, n): K − 1 at 0, 1, 2 and 3 mod 4 (the history's start against the
# frame's 16-byte groups); ragged n (n mod 4 = 1, 2, 3 and n mod 4096 ≠ 0),
# n < K − 1 (a frame shorter than the history), n < 4096 (one block)
FIR_REPLAY = [(1, 4101), (2, 8195), (3, 2050), (4, 1000), (49, 4107),
              (50, 4097), (51, 7), (52, 4300), (241, 100), (241, 4099),
              (1601, 1000), (1601, 4103)]


@pytest.mark.parametrize("ntaps,n", FIR_REPLAY,
                         ids=[f"k{k}_n{n}" for k, n in FIR_REPLAY])
def test_fir_reg_schedule_matches_plain(ntaps, n):
    """A replay of fir_reg_kernel's staging, register-ring FIR and copy-out
    reads frame sample o − k for tap k of output o, in ascending k, so
    its sums equal fir_direct_kernel's fma chains bit for bit and the
    plain form within float32 rounding; with a 16-byte aligned frame and
    without."""
    taps, frame, hist = _fir_case(ntaps, n, seed=ntaps + n)
    chain = _fir_chain(frame, hist, taps)
    want = np_of(hk.fir_direct_plain(torch.from_numpy(frame),
                                     torch.from_numpy(taps),
                                     history=torch.from_numpy(hist)))
    for vec in (True, False):
        got = _fir_reg(frame, hist, taps, vec)
        equal(got, chain)
    close(chain, want, REL_FIR)


@pytest.mark.parametrize("ntaps,n,vec", [
    (1, 4101, True), (2, 8195, True), (50, 4097, False), (51, 7, True),
    (241, 100, True), (1601, 4103, True), (1601, 1000, False)],
    ids=["k1", "k2_n4099", "k50_scalar", "k51_n7", "k241_n100",
         "k1601_ragged", "k1601_scalar"])
def test_fir_reg_staging_reads_stay_inside(ntaps, n, vec):
    """fir_reg_kernel's staging, replayed for every block: every read lies
    inside the history or the frame, every vector read is a whole aligned
    group of the frame, each stored group is stored once, and every sample
    that a valid output needs (frame samples o − K + 1 .. o) is staged."""
    taps, frame, hist = _fir_case(ntaps, n, seed=7)
    outs = FIR_THREADS * FIR_R
    for blk in range(-(-n // outs)):
        win, rec = _fir_stage(frame, hist, blk, ntaps, vec)
        assert all(0 <= i < ntaps - 1 for i in rec["reads_h"])
        assert all(0 <= i < n for i in rec["reads_f"])
        assert all(f % 4 == 0 and f + 4 <= n for f in rec["vector"])
        if not vec:
            assert not rec["vector"]
        st = [g for g in rec["store"] if g is not None]
        assert len(set(st)) == len(st)
        valid = min(outs, n - blk * outs)
        lo = max(blk * outs - (ntaps - 1), -(ntaps - 1))
        need = set(range(lo, blk * outs + valid))
        got = set(rec["reads_f"]) | {i - (ntaps - 1) for i in rec["reads_h"]}
        assert need <= got


def _fir_banks_ok(words, width):
    """Each warp-wide access (32 lanes, ``width`` consecutive words a lane)
    is served without a bank conflict: in each phase of 32/width lanes, no
    two distinct words share a bank (equal words are a broadcast)."""
    words = np.asarray(words).reshape(-1, 32)
    lanes = 32 // width
    for acc in words:
        for ph in range(width):
            seg = acc[ph * lanes:(ph + 1) * lanes]
            wds = np.unique((seg[:, None] + np.arange(width)).reshape(-1))
            if len(np.unique(wds % 32)) != len(wds):
                return False
    return True


def test_fir_reg_shared_memory_banks():
    """Every warp-wide shared-memory access of fir_reg_kernel hits 32
    distinct banks: the staging's 16-byte group stores, the ring's 16-byte
    window loads (at every chunk's offset), the sums' 16-byte stores and
    the copy-out's 4-byte loads; the taps' 16-byte load is one broadcast.
    The swizzle is a permutation of every 8-group block, so the window and
    the sums stay inside their buffer."""
    outs = FIR_THREADS * FIR_R
    for ntaps in (13, 50):
        kp = _fir_kpad(ntaps)
        taps, frame, hist = _fir_case(ntaps, 3 * outs, seed=11)
        win, rec = _fir_stage(frame, hist, 1, ntaps, True)
        st = [kp + 4 * g for g in rec["store"] if g is not None]
        assert _fir_banks_ok(st[:len(st) // 32 * 32], 4)
        _, seen = _fir_compute(win, taps, ntaps, 1)
        for kind in ("window", "sums"):
            for a in seen[kind]:
                assert _fir_banks_ok(kp + 4 * a, 4), kind
        for a in seen["copy_out"]:
            assert _fir_banks_ok(kp + a, 1)
    g = np.arange(4096)
    sw = _fir_swz(g)
    assert (np.sort(sw.reshape(-1, 8), axis=1) == g.reshape(-1, 8)).all()


def _fir_reg_smem_bytes(ntaps):
    """fir_reg_kernel's block: the taps padded to a multiple of 4 (KP) and
    the window of KP + 4096 floats rounded up to whole 32-word swizzle
    blocks (the card test holds it to clen_fir_smem_bytes)."""
    kp = _fir_kpad(ntaps)
    return 4 * (kp + -(-(kp + FIR_THREADS * FIR_R) // 32) * 32)


H100_SMEM_OPTIN = 232448    # an H100's opt-in shared memory per block, B


def test_fir_body_by_shape():
    """fir_reg_kernel at decimation 1 wherever its block fits the opt-in
    shared memory (here an H100's 232,448 B), fir_direct_kernel at D > 1
    and past that size; fir_body names a CUDA body only, and refuses
    ntaps or decimation below 1 before it asks a card."""
    assert hk.FIR_BODIES == ("fir_direct_kernel", "fir_reg_kernel")
    optin = H100_SMEM_OPTIN
    assert _fir_reg_smem_bytes(1601) == 4 * (1604 + 5728)
    assert _fir_reg_smem_bytes(27008) == optin
    for k in (1, 2, 3, 49, 50, 241, 1601, 27008, 27009):
        smem = _fir_reg_smem_bytes(k)
        assert hk._pick_fir_body(1, smem, optin) == (
            "fir_reg_kernel" if k <= 27008 else "fir_direct_kernel")
        for d in (2, 4):
            assert hk._pick_fir_body(d, smem, optin) == "fir_direct_kernel"
    for k, d in ((0, 1), (49, 0)):
        with pytest.raises(ValueError):
            hk.fir_body(k, d, "cuda")
    with pytest.raises(ValueError):
        hk.fir_body(49, 1, "cpu")


def test_fir_ab_cli_arguments():
    """The direct-FIR variants tool's arguments; without a card it exits
    non-zero."""
    from clenabled_tpu_torch.tools import fir_ab as cli

    args = cli.parse_args([])
    assert (args.variants, args.n, args.ntaps, args.rounds, args.calls) == (
        [], 1 << 21, [49, 241, 1601], 7, 10)
    args = cli.parse_args(["old=_local/fir_direct_old.cu",
                           "s1=-DFIR_STOP_AFTER=1", "pr3=first_body", "--ntaps", "1601", "--n",
                           "65536", "--rounds", "3"])
    assert (args.variants, args.ntaps, args.n, args.rounds) == (
        ["old=_local/fir_direct_old.cu", "s1=-DFIR_STOP_AFTER=1",
         "pr3=first_body"],
        [1601], 1 << 16, 3)
    assert set(cli.STAGE_PROBES.values()) == {"-DFIR_STOP_AFTER=1",
                                              "-DFIR_STOP_AFTER=2"}
    if not torch.cuda.is_available():
        assert cli.main(["--n", "4096"]) == 1


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _fir_on_body(x, h, taps, decim, body):
    """Both planar rows of ``x`` (history rows ``h``) through the C entry on
    the given body, uncounted."""
    lib = hk._load()
    y = torch.empty((2, x.shape[-1] // decim), device=x.device)
    err = lib.clen_fir_direct(
        h[0].data_ptr(), x[0].data_ptr(), y[0].data_ptr(), h[1].data_ptr(),
        x[1].data_ptr(), y[1].data_ptr(), 2, taps.data_ptr(), taps.shape[0],
        x.shape[-1], decim, hk.FIR_BODIES.index(body),
        torch.cuda.current_stream(x.device).cuda_stream)
    assert err == 0, err
    return y


def _fir_card_taps(card, ntaps):
    """``deep(ntaps)`` from 49 taps on; seeded normal taps below, where the
    windowed sinc is nearly all zeros."""
    taps = deep(ntaps) if ntaps >= 49 else np.random.default_rng(
        ntaps).standard_normal(ntaps).astype(np.float32)
    return torch.from_numpy(taps).to(card)


def _fir_card_case(card, ntaps, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32)).to(card)
    h = torch.from_numpy(rng.standard_normal((2, ntaps - 1)).astype(
        np.float32)).to(card)
    return x, h


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps", [49, 241, 1601, 1, 2, 3, 50])
@pytest.mark.parametrize("decim", [1, 4])
def test_fir_kernel_matches_plain_on_card(card, ntaps, decim):
    """A ragged last block (2^16 + 4000 outputs' worth), a frame shorter
    than one block and, from 3 taps, shorter than the history; each also
    through the history-in-front form, whose frame pointer is not 16-byte
    aligned where (K − 1) mod 4 ≠ 0."""
    t = _fir_card_taps(card, ntaps)
    for n in sorted({(1 << 16) + 4 * 1000, 1000,
                     max(decim, (ntaps - 1) // 2 // decim * decim)}):
        # the first case keeps its seed from before the others joined
        seed = ntaps + decim + (0 if n == (1 << 16) + 4 * 1000 else n)
        x, h = _fir_card_case(card, ntaps, n, seed)
        before = hk.fir_direct.launches
        got = hk.fir_direct(planar.PC(x[0], x[1]), t, decimation=decim,
                            history=planar.PC(h[0], h[1]))
        one = hk.fir_direct(torch.cat([h[0], x[0]]), t, decimation=decim)
        torch.cuda.synchronize()
        assert hk.fir_direct.launches == before + 2
        want = hk.fir_direct_plain(planar.PC(x[0], x[1]), t,
                                   decimation=decim,
                                   history=planar.PC(h[0], h[1]))
        close(got.re, want.re, REL_CARD)
        close(got.im, want.im, REL_CARD)
        close(one, want.re, REL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps", [1, 2, 3, 4, 49, 50, 51, 52, 241, 1601])
def test_fir_reg_equals_first_body_on_card(card, ntaps):
    """At decimation 1 fir_reg_kernel's output equals fir_direct_kernel's
    bit for bit (one fmaf chain an output in ascending tap order), on
    ragged blocks, a frame shorter than one block and one shorter than the
    history, and through the history-in-front form (an unaligned frame
    pointer where (K − 1) mod 4 ≠ 0)."""
    t = _fir_card_taps(card, ntaps)
    assert hk.fir_body(ntaps, 1, card) == "fir_reg_kernel"
    for n in (1, 7, 1000, 2049, (1 << 16) + 13, (1 << 18) + 4 * 1000):
        x, h = _fir_card_case(card, ntaps, n, ntaps + n)
        got = hk.fir_direct(planar.PC(x[0], x[1]), t,
                            history=planar.PC(h[0], h[1]))
        first = _fir_on_body(x, h, t, 1, "fir_direct_kernel")
        assert torch.equal(torch.stack(list(got)), first)
        one = hk.fir_direct(torch.cat([h[0], x[0]]), t)
        assert torch.equal(one, first[0])


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps,decim", [(49, 1), (1601, 1), (49, 4),
                                         (1601, 4), (28100, 1)])
def test_fir_direct_launches_its_body_on_card(card, ntaps, decim):
    """A call launches the body fir_body names (torch.profiler's kernel
    names), once, and nothing of the other: fir_reg_kernel at D = 1,
    fir_direct_kernel at D = 4 and at 28,100 taps, whose fir_reg_kernel
    block would not fit the card's opt-in shared memory (its own block,
    halved to fit, does)."""
    from clenabled_tpu_torch.runtime.device import launched_kernels

    t = torch.from_numpy(deep(ntaps)).to(card)
    x, h = _fir_card_case(card, ntaps, 1 << 14, 5)
    body = hk.fir_body(ntaps, decim, card)
    assert body == ("fir_reg_kernel" if decim == 1 and ntaps < 27009
                    else "fir_direct_kernel")
    if body == "fir_reg_kernel":
        assert _fir_reg_smem_bytes(ntaps) == hk._load().clen_fir_smem_bytes(
            ntaps, 1, 1)
    other, = set(hk.FIR_BODIES) - {body}
    args = (planar.PC(x[0], x[1]), t)
    got, events = launched_kernels(lambda: hk.fir_direct(
        *args, decimation=decim, history=planar.PC(h[0], h[1])))
    assert sum(body in e for e in events) == 1
    assert not any(other in e for e in events)
    want = hk.fir_direct_plain(*args, decimation=decim,
                               history=planar.PC(h[0], h[1]))
    close(got.re, want.re, REL_CARD)
    close(got.im, want.im, REL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps", [49, 241, 1601])
@pytest.mark.parametrize("quanta", [2, 67])
def test_ofs_kernel_matches_plain_on_card(card, ntaps, quanta):
    """67 quanta: a chunk count that is not a multiple of the chunks a block
    carries (16 at 49 taps, 4 at 241) and, at 1601 taps, 334 chunks, a last
    wave the card's 132 SMs do not fill."""
    plan = hk.OfsPlan(deep(ntaps))
    rng = np.random.default_rng(ntaps)
    n = plan.quantum * quanta
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32)).to(card)
    t = torch.from_numpy(rng.standard_normal((2, plan.tail_len)).astype(
        np.float32)).to(card)
    for decim in (1, 4):
        before = hk.ofs_filter_planar.launches
        got = hk.ofs_filter_planar(x[0], x[1], t[0], t[1], plan,
                                   decimation=decim)
        torch.cuda.synchronize()
        assert hk.ofs_filter_planar.launches == before + 1
        want = hk.ofs_filter_planar_plain(x[0], x[1], t[0], t[1], plan,
                                          decimation=decim)
        close(got[0], want[0], REL_CARD)
        close(got[1], want[1], REL_CARD)


@pytest.mark.cuda
def test_ofs_kernel_complex_taps_one_quantum_on_card(card):
    rng = np.random.default_rng(17)
    taps = (rng.standard_normal(33) + 1j * rng.standard_normal(33)).astype(
        np.complex64)
    plan = hk.OfsPlan(taps)
    x = torch.from_numpy(rng.standard_normal((2, plan.quantum)).astype(
        np.float32)).to(card)
    z = torch.zeros(plan.tail_len, device=card)
    got = hk.ofs_filter_planar(x[0], x[1], z, z, plan)
    want = hk.ofs_filter_planar_plain(x[0], x[1], z, z, plan)
    close(got[0], want[0], REL_CARD)
    close(got[1], want[1], REL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("use_time", [True, False], ids=["td", "fd"])
def test_fm_flowgraph_on_card_launches_kernels(card, use_time):
    """The planar LPF → QD flowgraph on a CUDA Runner launches its two
    kernels once per frame; its filtered stream equals the same flowgraph
    on the CPU, and its audio is the plain demodulator of that stream (an
    angle's error is the filter's over the sample's magnitude, so the two
    stages are held apart)."""
    probe = blocks.LowPassFilter(1, 1.0, 10e6, 1.5e6, 500e3,
                                 use_time=use_time, planar=True)
    frame = max(probe.quantum, 1 << 15)
    fr = planar_frames(frame, 3, seed=18)
    rc, _, (ty, ta) = _fm_graph(blocks, Flowgraph, use_time, True, frame,
                                device=card)
    rh, _, _ = _fm_graph(blocks, Flowgraph, use_time, True, frame,
                         device="cpu")
    hk.reset_launch_counts()
    last = torch.zeros((2, 1), device=card)
    for f in fr:
        got = rc.step(tpc(f))
        close(got[ty], rh.step(tpc(f))[ty], REL_CARD)
        y = got[ty]
        angles_close(got[ta], hk.qdemod_fused_plain(y.re, y.im, last[0],
                                                     last[1], 1.0), tol=1e-6)
        last = torch.stack([y.re[-1:], y.im[-1:]])
    torch.cuda.synchronize()
    filt = hk.fir_direct if use_time else hk.ofs_filter_planar
    assert filt.launches == 3 and hk.qdemod_fused.launches == 3
