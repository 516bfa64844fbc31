"""Port parity: the exact sequential Costas loop (B.9) and its block.

The port runs one recurrence (``demod._costas_step_planar``) for all three
exact-sequential forms: on the card through ``csrc/costas.cu``, on the CPU
through the kernel's plain form, a per-sample torch loop.  It is held to
the JAX package's forms within JAX's own tolerances
(tests/test_siggen_demod.py:279-286): 5e-6 on the outputs, 1e-5 on the
carried phase and 1e-6 on the carried frequency — the scan form (exact
``cos``/``sin``), the complex form and the Pallas scalar kernel in
interpret mode (1-ulp polynomial sin/cos).  Flowgraphs over 3 frames are
held to JAX's within 1e-4 × max|ref|.  On a card (``cuda`` marker; skipped
without one) the kernel is held to its plain form bit for bit, and its
chain's sin/cos to the CUDA math library's on every float32 of its
domain.  Frames stay at or below 4096 samples: the plain loop costs one
Python step per sample.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu.dsp import demod as j_demod
    from clenabled_tpu.dsp import pallas_kernels as j_pk
    from clenabled_tpu.dsp import planar as j_planar
    from clenabled_tpu.streaming import Flowgraph as JFlowgraph
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import demod
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.streaming import Flowgraph

OUT_TOL, PHASE_TOL, FREQ_TOL = 5e-6, 1e-5, 1e-6
FLOW_TOL = 1e-4


def np_of(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def stream(n, order, seed, omega=0.02, noise=0.01):
    """The JAX test's signal: BPSK (order 2) or QPSK (order 4) symbols at
    ``omega`` rad/sample of carrier offset, with noise, as float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    k = rng.integers(0, order, n)
    sym = np.exp(1j * (np.pi * k if order == 2 else np.pi / 4 * (2 * k + 1)))
    sig = sym * np.exp(1j * (omega * t + 0.3))
    sig = sig + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return sig.real.astype(np.float32), sig.imag.astype(np.float32)


def close(got, want, tol):
    err = float(np.abs(np_of(got).astype(np.float64) - np_of(want)).max())
    assert err <= tol, err
    return err


def test_gains_and_init_match_jax(ref):
    for bw in (0.00628, 0.02, 0.1):
        assert demod.costas_gains(bw) == j_demod.costas_gains(bw)
    st = demod.costas_init(device="cpu")
    assert [float(v) for v in st] == [0.0, 0.0, 0.0]
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in st)


@pytest.mark.parametrize("order", [2, 4])
def test_planar_forms_match_jax_scan(ref, order):
    """make_costas_loop_planar and _scalar (plain on the CPU) against JAX's
    scan form over two frames, the state carried across the seam."""
    xr, xi = stream(4096, order, seed=9)
    j_run = j_demod.make_costas_loop_planar(0.02, order)
    j_st = j_demod.costas_init()
    runs = {"planar": demod.make_costas_loop_planar(0.02, order),
            "scalar": demod.make_costas_loop_scalar(0.02, order)}
    sts = {k: demod.costas_init(device="cpu") for k in runs}
    for lo, hi in ((0, 2048), (2048, 4096)):
        j_st, j_out = j_run(j_st, j_planar.PC(jnp.asarray(xr[lo:hi]),
                                               jnp.asarray(xi[lo:hi])))
        for k, run in runs.items():
            sts[k], out = run(sts[k], planar.PC(torch.from_numpy(xr[lo:hi]),
                                                torch.from_numpy(xi[lo:hi])))
            close(out.re, j_out.re, OUT_TOL)
            close(out.im, j_out.im, OUT_TOL)
    for st in sts.values():
        close(st.phase, j_st.phase, PHASE_TOL)
        close(st.freq, j_st.freq, FREQ_TOL)
        close(st.error, j_st.error, OUT_TOL)


@pytest.mark.parametrize("order", [2, 4])
def test_plain_form_matches_pallas_scalar_kernel(ref, order):
    """costas_scalar (plain) against the Pallas scalar-core kernel in
    interpret mode, from a nonzero carried state."""
    xr, xi = stream(2048, order, seed=11)
    alpha, beta = demod.costas_gains(0.02)
    want = j_pk.costas_scalar(jnp.asarray(xr), jnp.asarray(xi), 0.4, 0.01,
                              0.2, order, alpha, beta, chunk=512,
                              interpret=True)
    hk.reset_launch_counts()
    got = hk.costas_scalar(torch.from_numpy(xr), torch.from_numpy(xi),
                           torch.tensor(0.4), torch.tensor(0.01), 0.2, order,
                           alpha, beta)
    assert hk.costas_scalar.launches == 0
    close(got[0], want[0], OUT_TOL)
    close(got[1], want[1], OUT_TOL)
    close(got[2], want[2], PHASE_TOL)
    close(got[3], want[3], FREQ_TOL)


def test_complex_form_matches_jax(ref):
    xr, xi = stream(3000, 2, seed=12)
    z = (xr + 1j * xi).astype(np.complex64)
    j_st, j_out = j_demod.make_costas_loop(0.05, 2)(j_demod.costas_init(), z)
    st, out = demod.make_costas_loop(0.05, 2)(demod.costas_init(device="cpu"),
                                              torch.from_numpy(z))
    assert out.dtype == torch.complex64
    close(out.real, np.asarray(j_out).real, OUT_TOL)
    close(out.imag, np.asarray(j_out).imag, OUT_TOL)
    close(st.phase, j_st.phase, PHASE_TOL)
    close(st.freq, j_st.freq, FREQ_TOL)


def test_wrapper_contract():
    """Any length (0 included), state as floats or 0-d tensors, frequency
    clamp, order and shape checks."""
    alpha, beta = demod.costas_gains(0.1)
    x = torch.from_numpy(np.stack(stream(300, 2, seed=13)))
    o_r, o_i, ph, fr, er = hk.costas_scalar(x[0], x[1], 0.0, 0.0, 0.5, 2,
                                            alpha, beta)
    assert o_r.shape == (300,) and ph.dim() == fr.dim() == er.dim() == 0
    e = hk.costas_scalar(x[0, :0], x[1, :0], ph, fr, er, 2, alpha, beta)
    assert e[0].shape == (0,) and float(e[2]) == float(ph)
    assert float(e[4]) == float(er)
    clamped = hk.costas_scalar(x[0], x[1], 0.0, 0.0, 0.0, 2, alpha, beta,
                               f_min=-1e-4, f_max=1e-4)
    assert abs(float(clamped[3])) <= 1e-4
    with pytest.raises(ValueError, match="order"):
        hk.costas_scalar(x[0], x[1], 0.0, 0.0, 0.0, 3, alpha, beta)
    with pytest.raises(ValueError, match="one length"):
        hk.costas_scalar(x[0], x[1, :5], 0.0, 0.0, 0.0, 2, alpha, beta)
    with pytest.raises(ValueError, match="order"):
        demod.make_costas_loop(0.02, 3)


@pytest.mark.parametrize("limits", [(float("nan"), 1.0), (-1.0, float("nan"))],
                         ids=["f_min", "f_max"])
def test_wrapper_refuses_nan_frequency_limits(limits):
    """The kernel's clamp and wrap bound need real frequency limits, so a
    NaN limit is refused off the CPU, before any launch (a meta tensor
    stands for the card's); the CPU's plain form takes it, as JAX's step
    does: the NaN reaches the carried frequency, and the phase after the
    first sample."""
    x = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="NaN"):
        hk.costas_scalar(x, x, 0.0, 0.0, 0.0, 2, 0.1, 0.01, *limits)
    xr, xi = (torch.from_numpy(v) for v in stream(8, 2, seed=26))
    got = hk.costas_scalar(xr, xi, 0.0, 0.0, 0.0, 2, 0.1, 0.01, *limits)
    assert torch.isnan(got[3]) and torch.isfinite(got[0][0])


def test_block_flags_match_jax():
    """The JAX block's exclusivity errors, in its order; the chunked and
    multi-stream shapes build (their quantum, ports and kept chunk and
    warm-up)."""
    with pytest.raises(ValueError, match="exclusive"):
        blocks.CostasLoop(0.02, 2, planar=True, chunked=True, scalar=True)
    with pytest.raises(ValueError, match="exclusive"):
        blocks.CostasLoop(0.02, 2, planar=True, scalar=True, num_streams=4)
    with pytest.raises(ValueError, match="exclusive"):
        blocks.CostasLoop(0.02, 2, planar=True, chunked=True, num_streams=4)
    with pytest.raises(ValueError, match="planar"):
        blocks.CostasLoop(0.02, 2, scalar=True)
    with pytest.raises(ValueError, match="planar"):
        blocks.CostasLoop(0.02, 2, chunked=True)
    with pytest.raises(ValueError, match="exclusive"):
        blocks.CostasLoop(0.02, 2, chunked=True, num_streams=4)
    chunked = blocks.CostasLoop(0.02, 2, planar=True, chunked=True,
                                chunk=2048, warmup=300)
    assert (chunked.quantum, chunked.chunk, chunked.warmup) == (2048, 2048,
                                                                300)
    lag, tail = chunked.init_state()
    assert lag.phase.dim() == 0 and tail.re.shape == (300,)
    streams = blocks.CostasLoop(0.02, 2, num_streams=2)
    assert streams.n_inputs == streams.n_outputs == 2
    assert all(v.shape == (2,) for v in streams.init_state())
    assert blocks.clCostasLoop is blocks.CostasLoop


@pytest.mark.parametrize("kw", [dict(planar=True, scalar=True),
                                dict(planar=True), dict()],
                         ids=["scalar", "planar", "complex"])
def test_flowgraph_matches_jax(ref, kw):
    """A CostasLoop flowgraph over 3 frames against the JAX one."""
    n = 1024
    xr, xi = stream(3 * n, 2, seed=14)

    def build(mod, fg, **compile_kw):
        blk = mod.CostasLoop(0.02, 2, **kw)
        g = fg()
        g.external_input(blk)
        t = g.tap(blk)
        return g.compile(frame_size=n, **compile_kw), t

    jr, jt = build(j_blocks, JFlowgraph)
    tr, tt = build(blocks, Flowgraph, device="cpu")
    for k in range(3):
        sl = slice(k * n, (k + 1) * n)
        if kw.get("planar"):
            want = jr.step(j_planar.PC(jnp.asarray(xr[sl]),
                                       jnp.asarray(xi[sl])))[jt]
            got = tr.step(planar.PC(torch.from_numpy(xr[sl]),
                                    torch.from_numpy(xi[sl])))[tt]
            pairs = [(got.re, want.re), (got.im, want.im)]
        else:
            z = (xr[sl] + 1j * xi[sl]).astype(np.complex64)
            want = np.asarray(jr.step(z)[jt])
            got = tr.step(torch.from_numpy(z))[tt]
            pairs = [(got.real, want.real), (got.imag, want.imag)]
        for g_, w_ in pairs:
            close(g_, w_, FLOW_TOL * float(np.abs(np_of(w_)).max()))


def streams_of(k, n, offsets, seed):
    """k streams of ``stream``'s signal at the given offsets."""
    rows = [stream(n, 2, seed=seed + i, omega=w) for i, w in
            enumerate(offsets[:k])]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))


@pytest.mark.parametrize("planar_io", [True, False], ids=["planar", "complex"])
def test_streams_flowgraph_matches_jax(ref, planar_io):
    """CostasLoop(num_streams=3) over 3 frames against the JAX block (its
    vmap of the scan), each port within 1e-4 × max|ref|; one batched call
    a frame (the plain form on the CPU)."""
    n, k = 512, 3
    xr, xi = streams_of(k, 3 * n, (0.01, -0.02, 0.005), seed=40)

    def build(mod, fg, **compile_kw):
        blk = mod.CostasLoop(0.02, 2, planar=planar_io, num_streams=k)
        g = fg()
        for p in range(k):
            g.external_input(blk, p)
        names = [g.tap(blk, p, name=f"s{p}") for p in range(k)]
        return g.compile(frame_size=n, **compile_kw), names

    jr, jn = build(j_blocks, JFlowgraph)
    tr, tn = build(blocks, Flowgraph, device="cpu")
    for f in range(3):
        sl = slice(f * n, (f + 1) * n)
        if planar_io:
            want = jr.step(*(j_planar.PC(jnp.asarray(xr[p, sl]),
                                         jnp.asarray(xi[p, sl]))
                             for p in range(k)))
            got = tr.step(*(planar.PC(torch.from_numpy(xr[p, sl]),
                                      torch.from_numpy(xi[p, sl]))
                            for p in range(k)))
            pairs = [(g_, w_) for p in range(k) for g_, w_ in (
                (got[tn[p]].re, want[jn[p]].re),
                (got[tn[p]].im, want[jn[p]].im))]
        else:
            z = (xr[:, sl] + 1j * xi[:, sl]).astype(np.complex64)
            want = jr.step(*(z[p] for p in range(k)))
            got = tr.step(*(torch.from_numpy(z[p]) for p in range(k)))
            pairs = [(g_, w_) for p in range(k) for g_, w_ in (
                (got[tn[p]].real, np.asarray(want[jn[p]]).real),
                (got[tn[p]].imag, np.asarray(want[jn[p]]).imag))]
        for g_, w_ in pairs:
            close(g_, w_, FLOW_TOL * float(np.abs(np_of(w_)).max()))
    st = tr.states[0]
    assert isinstance(st, demod.CostasState) and st.freq.shape == (k,)
    close(st.freq, np.asarray(jr.states[0].freq), FREQ_TOL)


def test_chunked_flowgraph_matches_jax(ref):
    """CostasLoop(planar, chunked) over 3 frames against the JAX block, on
    the loop that acquires within its warm-up (bw 0.0628, warm-up 256,
    chunk 1024: BENCH_TPU.md's "faster loop" row), so every frame is
    locked: outputs within 1e-4 × max|ref|, the "lock" messages' residuals
    under the JAX test's 1e-3 on both sides and their branch hops equal."""
    from test_torch_costas_chunked import bpsk

    n = 4096
    xr, xi = bpsk(3 * n, 0.005, seed=41)

    def build(mod, fg, **compile_kw):
        blk = mod.CostasLoop(0.0628, 2, planar=True, chunked=True,
                             chunk=1024, warmup=256)
        g = fg()
        g.external_input(blk)
        t = g.tap(blk)
        r = g.compile(frame_size=n, **compile_kw)
        msgs = []
        r.on_message("CostasLoop.lock", msgs.append)
        return r, t, msgs

    jr, jt, jm = build(j_blocks, JFlowgraph)
    tr, tt, tm = build(blocks, Flowgraph, device="cpu")
    for f in range(3):
        sl = slice(f * n, (f + 1) * n)
        want = jr.step(j_planar.PC(jnp.asarray(xr[sl]), jnp.asarray(xi[sl])))[jt]
        got = tr.step(planar.PC(torch.from_numpy(xr[sl]),
                                torch.from_numpy(xi[sl])))[tt]
        scale = float(np.abs(np.asarray(want.re) + 1j * np.asarray(
            want.im)).max())
        close(got.re, want.re, FLOW_TOL * scale)
        close(got.im, want.im, FLOW_TOL * scale)
    assert len(tm) == len(jm) == 3
    for d, jd in zip(tm, jm):
        assert float(d["residual"]) < 1e-3 and float(jd["residual"]) < 1e-3
        assert int(d["branch_hops"]) == int(jd["branch_hops"])


def test_runner_state_from_reference(ref):
    """A stream begun in the JAX package continues in the port: the
    CostasState moves over as the port's CostasState of 0-d tensors."""
    n = 1024
    xr, xi = stream(2 * n, 2, seed=15)

    def build(mod, fg, **compile_kw):
        blk = mod.CostasLoop(0.02, 2, planar=True)
        g = fg()
        g.external_input(blk)
        t = g.tap(blk)
        return g.compile(frame_size=n, **compile_kw), t

    jr, jt = build(j_blocks, JFlowgraph)
    tr, tt = build(blocks, Flowgraph, device="cpu")
    jr.step(j_planar.PC(jnp.asarray(xr[:n]), jnp.asarray(xi[:n])))
    states = [tuple(np.asarray(v) for v in s) for s in jr.states]
    tr.states = P.runner_state_from_reference(tr, states, [None])
    st = tr.states[0]
    assert isinstance(st, demod.CostasState) and st.phase.dim() == 0
    assert float(st.freq) == float(jr.states[0].freq)
    want = jr.step(j_planar.PC(jnp.asarray(xr[n:]), jnp.asarray(xi[n:])))[jt]
    got = tr.step(planar.PC(torch.from_numpy(xr[n:]),
                            torch.from_numpy(xi[n:])))[tt]
    close(got.re, want.re, OUT_TOL)
    close(got.im, want.im, OUT_TOL)


@pytest.mark.parametrize("shape", ["chunked", "streams"])
def test_runner_state_from_reference_chunked_and_streams(ref, shape):
    """A chunked loop's (CostasState, tail PC) and a multi-stream loop's
    [N] CostasState move from a JAX Runner to the port's, and the stream
    continues within 1e-4 × max|ref|."""
    from test_torch_costas_chunked import bpsk

    n, k = 1024, 2
    if shape == "chunked":
        kw = dict(planar=True, chunked=True, chunk=512, warmup=256)
        xs = [bpsk(2 * n, 0.005, seed=42)]
        bw = 0.0628
    else:
        kw = dict(planar=True, num_streams=k)
        xs = [stream(2 * n, 2, seed=43 + i, omega=0.01) for i in range(k)]
        bw = 0.02

    def build(mod, fg, **compile_kw):
        blk = mod.CostasLoop(bw, 2, **kw)
        g = fg()
        for p in range(len(xs)):
            g.external_input(blk, p)
        names = [g.tap(blk, p, name=f"s{p}") for p in range(len(xs))]
        return g.compile(frame_size=n, **compile_kw), names

    jr, jn = build(j_blocks, JFlowgraph)
    tr, tn = build(blocks, Flowgraph, device="cpu")
    jr.step(*(j_planar.PC(jnp.asarray(x[0][:n]), jnp.asarray(x[1][:n]))
              for x in xs))
    import jax

    states = jax.tree.map(np.asarray, jr.states)
    tr.states = P.runner_state_from_reference(tr, states, [None])
    st = tr.states[0]
    if shape == "chunked":
        lag, tail = st
        assert isinstance(lag, demod.CostasState) and lag.phase.dim() == 0
        assert isinstance(tail, planar.PC) and tail.re.shape == (256,)
        assert float(lag.freq) == float(jr.states[0][0].freq)
    else:
        assert isinstance(st, demod.CostasState) and st.phase.shape == (k,)
        assert torch.equal(st.freq, torch.from_numpy(np.asarray(
            jr.states[0].freq)))
    want = jr.step(*(j_planar.PC(jnp.asarray(x[0][n:]), jnp.asarray(x[1][n:]))
                     for x in xs))
    got = tr.step(*(planar.PC(torch.from_numpy(x[0][n:]),
                              torch.from_numpy(x[1][n:])) for x in xs))
    for t_name, j_name in zip(tn, jn):
        scale = float(np.abs(np.asarray(want[j_name].re)
                             + 1j * np.asarray(want[j_name].im)).max())
        close(got[t_name].re, want[j_name].re, FLOW_TOL * scale)
        close(got[t_name].im, want[j_name].im, FLOW_TOL * scale)


TWO_PI_F32 = float(np.float32(2 * np.pi))


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("phase", [-7.0, 100.0, TWO_PI_F32, -TWO_PI_F32],
                         ids=["m7", "100", "2pi", "m2pi"])
def test_plain_form_matches_jax_scan_from_wrapping_states(ref, order, phase):
    """From carried phases the kernel takes through its full sin/cos (the
    wrap has not bounded them yet) or that sit on the wrap's bound, the
    plain form against JAX's scan form."""
    xr, xi = stream(1024, order, seed=16)
    j_run = j_demod.make_costas_loop_planar(0.02, order)
    j_st = j_demod.CostasState(phase=jnp.float32(phase),
                               freq=jnp.float32(0.003),
                               error=jnp.float32(0.0))
    j_st, j_out = j_run(j_st, j_planar.PC(jnp.asarray(xr), jnp.asarray(xi)))
    st = demod.CostasState(*(torch.tensor(v, dtype=torch.float32)
                             for v in (phase, 0.003, 0.0)))
    st, out = demod.make_costas_loop_planar(0.02, order)(
        st, planar.PC(torch.from_numpy(xr), torch.from_numpy(xi)))
    close(out.re, j_out.re, OUT_TOL)
    close(out.im, j_out.im, OUT_TOL)
    close(st.phase, j_st.phase, PHASE_TOL)
    close(st.freq, j_st.freq, FREQ_TOL)
    close(st.error, j_st.error, OUT_TOL)


@pytest.mark.parametrize("raw,clipped", [(2 ** 24 + 2, 2.0), (2 ** 24 + 4, 0.0),
                                         (2 ** 24, 0.5), (2 ** 25 + 4, 0.0),
                                         (-(2 ** 24 + 2), -2.0)],
                         ids=["2^24+2", "2^24+4", "2^24", "2^25+4", "neg"])
def test_error_clip_reaches_two_in_float32(ref, raw, clipped):
    """For a raw error of 2 mod 4 in [2^24, 2^25), e + 1 rounds up and
    e − 1 down, so 0.5·(|e+1| − |e−1|) is 2, not 1, in the port's step as
    in JAX's (order 2, from phase 0: the rotation leaves the sample as it
    is, and s_r·s_i = raw exactly); the kernel's wrap bound counts on it."""
    s_r, s_i = np.float32(2.0), np.float32(raw / 2)
    assert float(s_r) * float(s_i) == raw
    gains = (*demod.costas_gains(0.02), -1.0, 1.0)
    t_step = demod._costas_step_planar(
        2, *(torch.tensor(v, dtype=torch.float32) for v in gains))
    j_step = j_demod._costas_step_planar(2, *(jnp.float32(v) for v in gains))
    z = np.float32(0.0)
    (_, _, t_er), _ = t_step(tuple(torch.tensor(z) for _ in range(3)),
                             (torch.tensor(s_r), torch.tensor(s_i)))
    (_, _, j_er), _ = j_step((z, z, z), (jnp.float32(s_r), jnp.float32(s_i)))
    assert float(t_er) == float(j_er) == clipped


@pytest.mark.parametrize("order", [2, 4])
def test_clip_two_stream_clips_every_error_to_two(order):
    """The card test's stream: every step of the plain form clips its
    error to 2, and the phase crosses 2π (and wraps) from 4.8."""
    from clenabled_tpu_torch.tools.costas_ab import clip_two_stream

    alpha, beta = demod.costas_gains(0.02)
    xr, xi = clip_two_stream(order, 64, 4.8, 0.0, alpha, beta, -0.01, 0.01)
    step = demod._costas_step_planar(order, *(
        torch.tensor(v, dtype=torch.float32)
        for v in (alpha, beta, -0.01, 0.01)))
    carry = tuple(torch.tensor(v, dtype=torch.float32) for v in (4.8, 0.0, 0.0))
    phases = []
    for t in range(64):
        carry, _ = step(carry, (torch.tensor(xr[t]), torch.tensor(xi[t])))
        assert float(carry[2]) == 2.0
        phases.append(float(carry[0]))
    assert max(phases) <= 2 * np.pi and min(phases[:16]) < 1.0


def test_costas_ab_cli_arguments():
    """The variants tool's arguments; without a card it exits non-zero."""
    from clenabled_tpu_torch.tools import costas_ab as cli

    args = cli.parse_args([])
    assert (args.sources, args.n, args.rounds, args.calls, args.batched) == (
        [], 1 << 16, 7, 10, None)
    args = cli.parse_args(["a=x.cu", "b=y.cu", "--n", "4096"])
    assert (args.sources, args.n) == (["a=x.cu", "b=y.cu"], 4096)
    args = cli.parse_args(["--batched", "8192", "--n", "4096", "a=x.cu",
                           "old=y.cu"])
    assert (args.batched, args.n, args.sources) == (
        8192, 4096, ["a=x.cu", "old=y.cu"])
    if not torch.cuda.is_available():
        assert cli.main(["--n", "64"]) == 1
        assert cli.main(["--batched", "33", "--n", "64"]) == 1


@pytest.mark.parametrize("order", [2, 4])
def test_error_clip_keeps_float32_rounding(ref, order):
    """0.5·(|e+1| − |e−1|) is not a clamp in float32: an error of about
    1e-8 comes out 0 (e ± 1 round to ±1), in the port's step as in JAX's.
    From phase 0 the rotation leaves the sample as it is."""
    s_r, s_i = (1e-4, 1e-4) if order == 2 else (2e-8, 1e-8)
    gains = (*demod.costas_gains(0.02), -1.0, 1.0)
    t_step = demod._costas_step_planar(
        order, *(torch.tensor(v, dtype=torch.float32) for v in gains))
    j_step = j_demod._costas_step_planar(
        order, *(jnp.float32(v) for v in gains))
    z = np.float32(0.0)
    (t_ph, t_fr, t_er), t_out = t_step(
        tuple(torch.tensor(z) for _ in range(3)),
        (torch.tensor(np.float32(s_r)), torch.tensor(np.float32(s_i))))
    (j_ph, j_fr, j_er), j_out = j_step(
        (z, z, z), (jnp.float32(s_r), jnp.float32(s_i)))
    raw = np.float32(s_r) * np.float32(s_i) if order == 2 else (
        np.float32(s_i) - np.float32(s_r))
    assert 5e-9 < abs(float(raw)) < 2e-8
    assert float(t_er) == 0.0 and float(j_er) == 0.0
    assert float(t_fr) == 0.0 and float(j_fr) == 0.0
    assert float(t_out[0]) == float(j_out[0]) == np.float32(s_r)
    assert float(t_out[1]) == float(j_out[1]) == np.float32(s_i)
    # a clamp would keep the error itself
    assert float(np.clip(raw, -1, 1)) != 0.0


def same_bits(got, want) -> bool:
    """Bit for bit, two NaNs agreeing."""
    for g_, w_ in zip(got, want):
        nan = torch.isnan(w_)
        if not (torch.equal(torch.isnan(g_), nan)
                and torch.equal(g_[~nan], w_[~nan])):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
def test_costas_kernel_matches_plain_on_card(card, order):
    xr, xi = stream(4096, order, seed=20, omega=0.005, noise=0.05)
    x = torch.from_numpy(np.stack([xr, xi])).to(card)
    alpha, beta = demod.costas_gains(0.00628)
    args = (x[0], x[1], 0.3, 0.001, 0.0, order, alpha, beta)
    before = hk.costas_scalar.launches
    got = hk.costas_scalar(*args)
    torch.cuda.synchronize()
    assert hk.costas_scalar.launches == before + 1
    want = hk.costas_scalar_plain(*args)
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


@pytest.mark.cuda
def test_costas_sincos_probe_on_card(card):
    """The chain's sin/cos device function against the CUDA math library's
    sinf/cosf on every float32 of its domain (|x| <= 2π, or NaN), and the
    special ranges by name: ±0, the NaNs (in the domain) and ±inf with
    the large |x| (outside it: only the first sample sees them, through
    cosf/sinf themselves)."""
    got = hk.costas_sincos_probe(device=card)
    assert got["in_domain"] == hk.COSTAS_LOOP_PATTERNS
    assert got["loop"] == 0
    for first, count, inside in ((0x00000000, 1, 1), (0x80000000, 1, 1),
                                 (0x7F800001, (1 << 23) - 1, (1 << 23) - 1),
                                 (0xFF800001, (1 << 23) - 1, (1 << 23) - 1),
                                 (0x7F800000, 1, 0), (0xFF800000, 1, 0),
                                 (0x47CE4780, 0x7F800000 - 0x47CE4780, 0)):
        part = hk.costas_sincos_probe(first, count, device=card)
        assert part["loop"] == 0 and part["in_domain"] == inside, (
            hex(first), part)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("state", [(0.3, 0.0), (-7.0, 0.0), (100.0, 0.0),
                                   (1e6, 0.0), (0.2, 0.01)],
                         ids=["0.3", "m7", "100", "1e6", "fmax"])
def test_costas_kernel_from_carried_states_on_card(card, order, state):
    """Bit for bit from carried phases inside and outside the wrap's bound
    and from a frequency held at f_max (f_max = 0.01)."""
    xr, xi = stream(4096, order, seed=22, omega=0.005, noise=0.05)
    x = torch.from_numpy(np.stack([xr, xi])).to(card)
    alpha, beta = demod.costas_gains(0.00628)
    args = (x[0], x[1], state[0], state[1], 0.0, order, alpha, beta, -0.01,
            0.01)
    got = hk.costas_scalar(*args)
    torch.cuda.synchronize()
    want = hk.costas_scalar_plain(*args)
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("gains", [(0.01, 1.4e-45), (4.2e-45, 1e-4),
                                   (0.5, 0.25)],
                         ids=["beta_subnormal", "alpha_subnormal", "wide"])
def test_costas_kernel_gains_on_card(card, gains):
    """Gains whose halves are not exact take the kernel's instantiation
    without the clip's 0.5 folded into them; wide gains keep the phase
    bound from clearing any group, so every sample takes the wrap test."""
    xr, xi = stream(4096 + 5, 4, seed=25)
    x = torch.from_numpy(np.stack([xr, xi])).to(card)
    args = (x[0], x[1], 0.3, 0.0, 0.0, 4, *gains)
    got = hk.costas_scalar(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g_, w_)
               for g_, w_ in zip(got, hk.costas_scalar_plain(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("phase", [4.8, 6.1], ids=["4.8", "6.1"])
def test_costas_kernel_clipped_error_two_on_card(card, order, phase):
    """Bit for bit on a stream whose every clipped error is 2 (raw errors
    of 2 mod 4 in [2^24, 2^25), as int16-scale samples give): the wrap
    bound must allow 2·(|alpha| + |beta|) of growth a sample, or a group it
    clears carries the phase past 2π without the wrap."""
    from clenabled_tpu_torch.tools.costas_ab import clip_two_stream

    alpha, beta = demod.costas_gains(0.02)
    xr, xi = clip_two_stream(order, 512, phase, 0.0, alpha, beta, -0.01,
                             0.01, device=card)
    x = torch.from_numpy(np.stack([xr, xi])).to(card)
    args = (x[0], x[1], phase, 0.0, 0.0, order, alpha, beta, -0.01, 0.01)
    got = hk.costas_scalar(*args)
    torch.cuda.synchronize()
    want = hk.costas_scalar_plain(*args)
    assert float(want[4]) == 2.0
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [float("inf"), float("-inf"), float("nan"),
                                   -0.0, 3e38])
def test_costas_kernel_special_phases_on_card(card, phase):
    """Carried phases that only the first sample, through the library's
    cosf/sinf, can take."""
    xr, xi = stream(256, 2, seed=23)
    x = torch.from_numpy(np.stack([xr, xi])).to(card)
    args = (x[0], x[1], phase, 0.0, 0.0, 2, *demod.costas_gains(0.02))
    got = hk.costas_scalar(*args)
    torch.cuda.synchronize()
    assert same_bits(got, hk.costas_scalar_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 4096 + 37])
@pytest.mark.parametrize("order", [2, 4])
def test_costas_kernel_frame_lengths_on_card(card, n, order):
    """Empty, one-sample and ragged frames (not a multiple of the ring's
    chunk or of the read-ahead group) equal the plain form bit for bit."""
    xr, xi = stream(max(n, 1), order, seed=24)
    x = torch.from_numpy(np.stack([xr, xi])[:, :n].copy()).to(card)
    args = (x[0], x[1], 0.5, 0.002, 0.1, order, *demod.costas_gains(0.02))
    got = hk.costas_scalar(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g_, w_)
               for g_, w_ in zip(got, hk.costas_scalar_plain(*args)))


@pytest.mark.cuda
def test_costas_seam_on_card(card):
    """Chained frames through the block equal one call over the joined
    stream bit for bit: the state stays on the card between frames."""
    xr, xi = stream(4 * 2048, 2, seed=21)
    x = torch.from_numpy(np.stack([xr, xi])).to(card)
    run = demod.make_costas_loop_planar(0.02, 2)
    st, outs = demod.costas_init(device=card), []
    for k in range(4):
        sl = slice(k * 2048, (k + 1) * 2048)
        st, o = run(st, planar.PC(x[0, sl], x[1, sl]))
        outs.append(o)
    alpha, beta = demod.costas_gains(0.02)
    whole = hk.costas_scalar(x[0], x[1], 0.0, 0.0, 0.0, 2, alpha, beta)
    assert torch.equal(torch.cat([o.re for o in outs]), whole[0])
    assert torch.equal(torch.stack(list(st)), torch.stack(whole[2:]))
