"""Port parity: the time-domain correlator (``td_xcorr`` family), the
``XCorrelate`` block, ``planar.zeros``/``ifft`` and the correlator tool.

Each case feeds the same numpy inputs, made from a seed, to the JAX
function and to the port's on the CPU, and holds the port's correlation
vectors and maxima to JAX's within 1e-4 relative and 1e-4 × max|JAX|
absolute; lags are held equal.  The cases mirror the JAX package's
``test_xcorr.py``, ``test_planar_filters.py``, ``test_ingest.py``,
``test_streaming.py``, ``test_sync_and_blocks.py`` and
``test_planar_blocks.py`` at n <= 4096 and B <= 8.  The ``cuda`` case runs
the block on the card against the CPU path (skipped without a card).
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu.dsp import planar as j_planar
    from clenabled_tpu.dsp import xcorr as j_xcorr
    from clenabled_tpu.streaming import Flowgraph as JFlowgraph
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import planar, xcorr
from clenabled_tpu_torch.streaming import Flowgraph

REL = 1e-4


def np_of(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, rel=REL):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def same_result(got: xcorr.XCorrResult, want, rel=REL):
    close(got.corr_vectors, want.corr_vectors, rel)
    close(got.corr, want.corr, rel)
    assert got.lag.dtype == torch.int32
    np.testing.assert_array_equal(np_of(got.lag), np_of(want.lag))


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference")


def _real(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- planar ops

def test_planar_zeros_and_ifft(ref):
    z = planar.zeros((3, 4), "ignored")
    jz = j_planar.zeros((3, 4), "ignored")
    assert z.re.dtype == torch.float32 and z.re.shape == jz.re.shape
    assert not z.re.any() and not z.im.any()
    rng = np.random.default_rng(1)
    for n in (64, 1024):                       # one stage and two
        x = _cplx(rng, 2, n)
        got = planar.ifft(planar.from_complex(x))
        want = j_planar.ifft(j_planar.from_complex(x))
        close(got.re + 1j * got.im,
              np.asarray(want.re) + 1j * np.asarray(want.im))
        close(got.re + 1j * got.im, np.fft.ifft(x.astype(np.complex128)))


# ---------------------------------------------------------- td_xcorr family

@pytest.mark.parametrize("kind,n,max_shift", [
    ("float", 1024, 64), ("complex", 512, 32), ("multi", 2048, 128)])
def test_td_xcorr_matches_jax(ref, kind, n, max_shift):
    """test_xcorr.py: float and complex pairs, four signals."""
    rng = np.random.default_rng(17)
    nsig = 4 if kind == "multi" else 2
    sigs = _cplx(rng, nsig, n) if kind == "complex" else _real(rng, nsig, n)
    got = xcorr.td_xcorr(_t(sigs), max_shift)
    assert got.corr_vectors.shape == (nsig - 1, 2 * max_shift)
    assert got.corr.shape == got.lag.shape == (nsig - 1,)
    same_result(got, j_xcorr.td_xcorr(sigs, max_shift))


@pytest.mark.parametrize("form", ["complex", "planar"])
def test_td_xcorr_recovers_known_delay(ref, form):
    """The examples/xcorr_test_opencl.grc use case: delayed copies, both
    directions."""
    rng = np.random.default_rng(18)
    n, max_shift, delay = 4096, 512, 37
    base = _real(rng, n + max_shift + delay)
    a = base[max_shift:max_shift + n]
    b = base[max_shift - delay:max_shift - delay + n]
    fn, jfn = ((xcorr.td_xcorr, j_xcorr.td_xcorr) if form == "complex" else
               (xcorr.td_xcorr_planar, j_xcorr.td_xcorr_planar))
    for sigs, lag in ((np.stack([a, b]), -delay), (np.stack([b, a]), delay)):
        got = fn(_t(sigs), max_shift)
        assert int(got.lag[0]) == lag and float(got.corr[0]) > 0.95
        same_result(got, jfn(sigs, max_shift))


def test_td_xcorr_zero_signal_sentinel(ref):
    rng = np.random.default_rng(19)
    sigs = np.stack([_real(rng, 256), np.zeros(256, np.float32)])
    for fn, jfn in ((xcorr.td_xcorr, j_xcorr.td_xcorr),
                    (xcorr.td_xcorr_planar, j_xcorr.td_xcorr_planar)):
        got = fn(_t(sigs), 16)
        assert torch.equal(got.corr_vectors, torch.full((1, 32), -2.0))
        assert int(got.lag[0]) == -16          # all -2: the first lag
        same_result(got, jfn(sigs, 16))


def test_td_xcorr_batched_windows(ref):
    """test_xcorr.py:131: each window equals the unbatched scan."""
    rng = np.random.default_rng(20)
    n, shift, b = 1024, 64, 5
    sigs = _real(rng, 3, b, n)
    got = xcorr.td_xcorr_batched(_t(sigs), shift)
    assert got.corr_vectors.shape == (2, b, 2 * shift)
    same_result(got, j_xcorr.td_xcorr_batched(sigs, shift))
    for w in range(b):
        single = xcorr.td_xcorr(_t(sigs[:, w]), shift)
        close(got.corr_vectors[:, w], single.corr_vectors)


def test_planar_td_xcorr_matches(ref):
    """test_planar_filters.py:42: the planar scan against the complex one
    and against JAX's planar scan."""
    rng = np.random.default_rng(21)
    sigs = _real(rng, 3, 4096)
    got = xcorr.td_xcorr_planar(_t(sigs), 256)
    same_result(got, j_xcorr.td_xcorr_planar(sigs, 256))
    close(got.corr_vectors, xcorr.td_xcorr(_t(sigs), 256).corr_vectors)


def test_planar_batched_matches_complex(ref):
    """test_ingest.py:131: td_xcorr_planar_batched on |complex| windows ==
    td_xcorr_batched on the complex windows."""
    rng = np.random.default_rng(11)
    sig = _cplx(rng, 3, 2, 512)
    got = xcorr.td_xcorr_planar_batched(_t(np.abs(sig)), 32)
    same_result(got, j_xcorr.td_xcorr_planar_batched(np.abs(sig), 32))
    same_result(got, xcorr.td_xcorr_batched(_t(sig), 32))
    same_result(xcorr.td_xcorr_batched(_t(sig), 32),
                j_xcorr.td_xcorr_batched(sig, 32))


@pytest.mark.parametrize("n,max_shift", [(48, 64), (16, 40)])
def test_td_xcorr_lags_beyond_the_window(ref, n, max_shift):
    """max_shift > n: the port gathers as JAX does (negative indices count
    from the end, the rest clamp), so the scans agree.  The edge lags of a
    one-sample overlap are ±1 up to rounding, so the port's lag need only
    pick a maximum of JAX's scan."""
    rng = np.random.default_rng(22)
    sigs = _real(rng, 3, n)
    for fn, jfn in ((xcorr.td_xcorr, j_xcorr.td_xcorr),
                    (xcorr.td_xcorr_planar, j_xcorr.td_xcorr_planar)):
        got, want = fn(_t(sigs), max_shift), jfn(sigs, max_shift)
        close(got.corr_vectors, want.corr_vectors)
        jv = np.asarray(want.corr_vectors)
        picked = jv[np.arange(2), np_of(got.lag) + max_shift]
        np.testing.assert_allclose(picked, jv.max(-1), atol=REL)


# ------------------------------------------------------------ XCorrelate

def _xcorr_graph(mod, fg, accumulate=1, decim=1, n=1024, shift=64,
                 inputs=2, **kw):
    xc = mod.XCorrelate(inputs, signal_length=n, max_search_index=shift,
                        decim_frames=decim, accumulate_frames=accumulate)
    g = fg()
    for p in range(inputs):
        g.external_input(xc, p)
    r = g.compile(frame_size=n * accumulate, **kw)
    msgs = []
    r.on_message("xcorr.corr", lambda m: msgs.append(
        {k: np.asarray(np_of(v)) for k, v in m.items()}))
    return xc, r, msgs


def _same_messages(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == {"corr", "corrective_lags", "corrvect", "valid"}
        for k in ("corr", "corrvect"):
            close(g[k], w[k])
        assert g["corrective_lags"].dtype == np.int32
        np.testing.assert_array_equal(g["corrective_lags"],
                                      w["corrective_lags"])
        np.testing.assert_array_equal(g["valid"], w["valid"])


@pytest.mark.parametrize("accumulate,decim", [(1, 1), (3, 1), (3, 2),
                                              (1, 3)])
def test_xcorrelate_block_matches_jax(ref, accumulate, decim):
    """test_ingest.py:88-125 (N windows a call as 1; decimation stays
    window-indexed across batched calls) and test_streaming.py:119 (1 in
    3 frames): the port's messages equal JAX's.  With one window a frame
    a skipped window is zeros; with several every window is computed and
    only flagged."""
    n, n_frames, delay = 1024, 6, 17
    rng = np.random.default_rng(3)
    base = _real(rng, n_frames * n + 256)
    a = base[128:128 + n_frames * n]
    b = base[128 - delay:128 - delay + n_frames * n]
    _, tr, tm = _xcorr_graph(blocks, Flowgraph, accumulate, decim,
                             device="cpu")
    _, jr, jm = _xcorr_graph(j_blocks, JFlowgraph, accumulate, decim)
    for s in range(0, n_frames, accumulate):
        sl = slice(s * n, (s + accumulate) * n)
        tr.step(a[sl], b[sl])
        jr.step(a[sl], b[sl])
    _same_messages(tm, jm)
    valid = np.concatenate([np.atleast_1d(m["valid"]) for m in tm])
    assert list(valid) == [k % decim == 0 for k in range(n_frames)]
    lags = np.concatenate([m["corrective_lags"].reshape(-1) for m in tm])
    vecs = np.concatenate([m["corrvect"].reshape(-1, 128) for m in tm])
    assert (lags[valid] == -delay).all()
    if accumulate == 1:
        assert not lags[~valid].any() and not vecs[~valid].any()
        assert tm[0]["valid"].shape == () and tm[0]["corr"].shape == (1,)
        assert tm[0]["corrvect"].shape == (1, 128)
    else:
        assert tm[0]["valid"].shape == (accumulate,)
        assert tm[0]["corrvect"].shape == (accumulate, 1, 128)


def test_xcorrelate_message_port(ref):
    """test_streaming.py:97: one frame publishes one message with the
    planted lag."""
    rng = np.random.default_rng(2)
    n, shift, delay = 4096, 256, 33
    base = _real(rng, 3 * n)
    a = base[1000:1000 + n]
    b = base[1000 - delay:1000 - delay + n]
    xc, tr, tm = _xcorr_graph(blocks, Flowgraph, n=n, shift=shift,
                              device="cpu")
    _, jr, jm = _xcorr_graph(j_blocks, JFlowgraph, n=n, shift=shift)
    assert xc.msg_ports == ("corr",) and xc.n_outputs == 0
    tr.step(a, b)
    jr.step(a, b)
    assert len(tm) == 1 and bool(tm[0]["valid"])
    assert int(tm[0]["corrective_lags"][0]) == -delay
    _same_messages(tm, jm)


def test_xcorrelate_skipped_frame_costs_no_correlation(monkeypatch):
    """A skipped window (one a frame) calls no correlator; the skip is
    decided from the host-side counter."""
    xc = blocks.XCorrelate(2, signal_length=256, max_search_index=16,
                           decim_frames=2)
    calls = []
    real = xcorr.td_xcorr_batched
    monkeypatch.setattr(xcorr, "td_xcorr_batched",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(256)
    st, _, m0 = xc.apply(xc.init_state(), [x, x])
    st, _, m1 = xc.apply(st, [x, x])
    assert st == 2 and isinstance(st, int) and calls == [1]
    assert bool(m0["corr"]["valid"]) and not bool(m1["corr"]["valid"])
    assert not m1["corr"]["corrvect"].any()
    assert m1["corr"]["corrective_lags"].dtype == torch.int32


def test_xcorrelate_processes_every_window_in_superframe(ref):
    """test_sync_and_blocks.py:157: a frame of twice the quantum
    correlates all four windows; the counter tracks the stream."""
    sl = 256
    rng = np.random.default_rng(4)
    x = _cplx(rng, 4 * sl)
    y = np.roll(x, 5)
    outs = []
    for mod, arr in ((blocks, _t), (j_blocks, jnp.asarray)):
        blk = mod.XCorrelate(2, signal_length=sl, max_search_index=16,
                             accumulate_frames=2)
        state, _, msg = blk.apply(blk.init_state(), [arr(x), arr(y)])
        assert int(state) == 4
        outs.append({k: np.asarray(np_of(v)) for k, v in msg["corr"].items()})
    lags = outs[0]["corrective_lags"]
    assert lags.shape[0] == 4
    np.testing.assert_array_equal(lags[:, 0], [-5, -5, -5, -5])
    _same_messages(outs[:1], outs[1:])


def test_planar_xcorrelate_block(ref):
    """test_planar_blocks.py:104: planar feeds through pabs and the planar
    batched scan, three inputs."""
    rng = np.random.default_rng(5)
    n, shift, delay = 4096, 256, 21
    base = _real(rng, 2 * n)
    sigs = [(base[512 - d:512 - d + n] + 0j).astype(np.complex64)
            for d in (0, delay, -delay)]
    _, tr, tm = _xcorr_graph(blocks, Flowgraph, n=n, shift=shift, inputs=3,
                             device="cpu")
    _, jr, jm = _xcorr_graph(j_blocks, JFlowgraph, n=n, shift=shift,
                             inputs=3)
    tr.step(*(planar.from_complex(s) for s in sigs))
    jr.step(*(j_planar.from_complex(s) for s in sigs))
    assert list(tm[0]["corrective_lags"]) == [-delay, delay]
    _same_messages(tm, jm)


def test_xcorrelate_keeps_the_reference_kwargs():
    xc = blocks.clXCorrelate(3, 512, data_type=1, data_size=8,
                             max_search_index=32, decim_frames=0,
                             accumulate_frames=4, devId=0, **{"async": True})
    assert xc.quantum == 512 * 4 and xc.decim_frames == 1
    assert xc.max_shift == 32 and xc.n_inputs == 3 and xc.init_state() == 0
    with pytest.raises(ValueError):
        blocks.XCorrelate(1)


def test_xcorrelate_counter_from_jax_runner(ref):
    """A JAX Runner's window counter (an int32) carried into the port
    mid-stream: the decimation phase continues."""
    n = 256
    rng = np.random.default_rng(6)
    frames = [(_real(rng, n), _real(rng, n)) for _ in range(4)]
    _, tr, tm = _xcorr_graph(blocks, Flowgraph, decim=3, n=n, shift=16,
                             device="cpu")
    _, jr, jm = _xcorr_graph(j_blocks, JFlowgraph, decim=3, n=n, shift=16)
    for f in frames[:2]:
        jr.step(*f)
    states = jax.tree.map(np.asarray, jr.states)
    tr.states = P.runner_state_from_reference(tr, states, [None])
    assert tr.states == (2,)
    jm.clear()
    for f in frames[2:]:
        tr.step(*f)
        jr.step(*f)
    assert [bool(m["valid"]) for m in tm] == [False, True]
    _same_messages(tm, jm)


# -------------------------------------------------------------- the tool

def test_clxcorrelate_tool_on_cpu(capsys):
    from clenabled_tpu_torch.tools import test_clxcorrelate as cli

    args = cli.parse_args([])
    assert (args.signal_length, args.maxsearch, args.batch,
            args.fft_batch) == (8192, 512, 1, 64)
    res = cli.main(["--cpu", "--signal_length", "512", "--maxsearch", "32",
                    "--batch", "2", "--fft-batch", "2", "--iterations", "1",
                    "--input_complex"])
    assert set(res) == {"td", "fd 1", "fd 2"}
    res = cli.main(["--cpu", "--signal_length", "512", "--maxsearch", "32",
                    "--planar", "--fftonly", "--iterations", "1"])
    assert set(res) == {"fd 1", "fd 64"}
    res = cli.main(["--cpu", "--signal_length", "256", "--block-api",
                    "--steps-per-dispatch", "2", "--iterations", "4"])
    assert res["block"]["msps"] > 0
    out = capsys.readouterr().out
    assert "GB/s in" in out and "BLOCK API (K=2)" in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):          # the card, unless --cpu
            cli.main(["--iterations", "1"])


# -------------------------------------------------------------- the card

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
def test_xcorrelate_on_card_matches_cpu(tf32_on):
    """The block on the card, complex and planar, one window and a
    super-frame, against the CPU path, with TF32 on in the process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(7)
    n = 2048
    x = _cplx(rng, 2, 4 * n)
    for acc, decim in ((1, 2), (4, 1)):
        for form in ("complex", "planar"):
            res = []
            for dev in ("cpu", "cuda"):
                _, r, msgs = _xcorr_graph(blocks, Flowgraph, acc, decim,
                                          n=n, shift=128, device=dev)
                for s in range(0, 4, acc):
                    f = [s_[s * n:(s + acc) * n] for s_ in x]
                    if form == "planar":
                        f = [planar.from_complex(v) for v in f]
                    r.step(*f)
                res.append(msgs)
            _same_messages(res[1], res[0])
