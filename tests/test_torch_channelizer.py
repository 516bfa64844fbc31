"""Port parity: the polyphase channelizer, critically sampled and
oversampled, the fused oversampled step (B.3) and its block.

The same numpy inputs go to the JAX function and the port's torch form on
the CPU.  Tolerances: the XLA forms (branch sums, rotation, reverse FFT)
within 1e-5 × max|ref| — float32 sums in the same order, apart from the
DFT; the fused kernel's plain form against ``pfb_oversampled_fused`` in
interpret mode (tile_rows = 8) and against ``_pfb_oversampled_planar``
within 1e-5 × max|ref| over 2 chained frames, carried tails bit-equal;
flowgraphs over 3 frames within 1e-4 × max|ref|.  On a card (``cuda``
marker; skipped without one) the kernel is held to its plain form within
1e-4 × max|plain|.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu.dsp import channelizer as j_chan
    from clenabled_tpu.dsp import pallas_kernels as j_pk
    from clenabled_tpu.dsp import planar as j_planar
    from clenabled_tpu.streaming import Flowgraph as JFlowgraph
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import channelizer as chan
from clenabled_tpu_torch.dsp import firdes
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.streaming import Flowgraph

TOL = 1e-5
FLOW_TOL = 1e-4


def np_of(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, tol=TOL):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.complex128) - want).max())
    assert err <= tol * scale, (err, tol * scale)


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


def proto(m, ntaps=None):
    """test_scaling's prototype (firdes.low_pass(1, M, 0.5, 0.25)) or an
    ntaps windowed sinc, zero-padded to a multiple of M."""
    if ntaps is None:
        p = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    else:
        p = (np.sinc(np.linspace(-4, 4, ntaps)) * np.hanning(ntaps)).astype(
            np.float32)
    return np.concatenate([p, np.zeros((-len(p)) % m, np.float32)])


def samples(shape, seed):
    return np.random.default_rng(seed).standard_normal(
        (2,) + tuple(shape)).astype(np.float32)


# --------------------------------------------------------------------------
# sizing and envelope
# --------------------------------------------------------------------------

def test_os_tail_len_matches_jax(ref):
    for m, r, nt in [(16, 8, 160), (64, 16, 1600), (32, 4, 96), (8, 2, 40),
                     (128, 64, 4096), (16, 4, 2000)]:
        assert hk.os_tail_len(m, r, nt) == j_pk.os_tail_len(m, r, nt)


def test_fused_supported_matches_jax_semantics(ref):
    """The port keeps JAX's semantic conditions and replaces its TPU VMEM
    budget with the card's shared memory; the two differ only where the
    banded matrices outgrow the TPU budget (named in the docstring)."""
    differ = []
    for m in (4, 8, 16, 32, 64, 128, 24):
        for r in (1, 2, 3, 4, 8, 16, 32, 64, m):
            for nt in (16, 160, 400, 1600, 4000):
                mine = chan.fused_oversampled_supported(m, r, nt)
                theirs = j_chan.fused_oversampled_supported(m, r, nt)
                if mine != theirs:
                    differ.append((m, r, nt, mine))
    assert differ, "expected the VMEM-budget configurations to differ"
    # every difference: the port accepts where JAX's VMEM budget refuses
    assert all(mine for *_, mine in differ), differ
    assert (64, 8, 1600, True) in differ
    assert not chan.fused_oversampled_supported(16, 16, 160)   # R == M
    assert not chan.fused_oversampled_supported(16, 6, 160)    # R ∤ M
    assert not chan.fused_oversampled_supported(48, 8, 160)    # M ∤ 128


# M=128, R=64, 40000 taps: the reach fits the halo, but one group's window
# (313 · 128 samples of both components, 315 KiB) outgrows an H100 block's
# 227 KiB of opt-in shared memory
BIG_WINDOW = (128, 64, 40000)


def test_fused_supported_has_no_shared_memory_limit_on_cpu():
    """The shared-memory condition is the card's: the CPU's plain form
    takes any window whose reach fits the halo."""
    assert chan.fused_oversampled_supported(*BIG_WINDOW, device="cpu")
    assert chan.fused_oversampled_supported(16, 8, 160, device="cpu")
    assert not chan.fused_oversampled_supported(16, 16, 160, device="cpu")


@pytest.mark.parametrize("n", [2048, 1536, 4096, 1024, 3072])
def test_fused_frame_rule_matches_jax(ref, n):
    """Both packages accept and refuse the same frames (JAX's tile rule)."""
    taps = proto(16)
    j_init, j_apply = j_chan.make_channelizer_fused_oversampled(
        taps, 16, 8, list(range(16)), interpret=True)
    t_init, t_apply = chan.make_channelizer_fused_oversampled(
        taps, 16, 8, list(range(16)), device="cpu")
    x = samples((n,), seed=n)
    try:
        j_apply(j_init(), j_planar.PC(jnp.asarray(x[0]), jnp.asarray(x[1])))
        j_ok = True
    except ValueError:
        j_ok = False
    if j_ok:
        t_apply(t_init(), planar.PC(torch.from_numpy(x[0]),
                                    torch.from_numpy(x[1])))
    else:
        with pytest.raises(ValueError):
            t_apply(t_init(), planar.PC(torch.from_numpy(x[0]),
                                        torch.from_numpy(x[1])))


# --------------------------------------------------------------------------
# the XLA forms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,r,i_offset", [(16, 8, 3), (8, 2, 1), (12, 8, 2)])
def test_oversampled_branch_sums_match_jax(ref, m, r, i_offset):
    """_pfb_oversampled and _pfb_oversampled_planar (rotation included),
    R | M and not."""
    taps = proto(m, 61)
    taps_rm, ntaps = chan._pfb_constants(taps, m, r)
    ell = m // np.gcd(m, r)
    nout = 4 * ell
    x = samples((ntaps - 1 + nout * r,), seed=m * r + i_offset)
    want = j_chan._pfb_oversampled(jnp.asarray(x[0]), jnp.asarray(taps_rm),
                                   m, r, ntaps, nout, i_offset)
    close(chan._pfb_oversampled(torch.from_numpy(x[0]), taps_rm, m, r, ntaps,
                                nout, i_offset), want)
    wr, wi = j_chan._pfb_oversampled_planar(
        jnp.asarray(x[0]), jnp.asarray(x[1]), jnp.asarray(taps_rm), m, r,
        ntaps, nout, i_offset)
    gr, gi = chan._pfb_oversampled_planar(
        torch.from_numpy(x[0]), torch.from_numpy(x[1]), taps_rm, m, r, ntaps,
        nout, i_offset)
    close(gr, wr)
    close(gi, wi)


@pytest.mark.parametrize("m,r,ch_map", [(16, 8, [0, 3, 5, 15]),
                                        (16, 16, [2, 1, 9]),
                                        (8, 4, list(range(8)))])
def test_polyphase_channelize_matches_jax(ref, m, r, ch_map):
    taps = proto(m, 45)
    n = 64 * m
    x = samples((len(taps) - 1 + n,), seed=7)
    z = (x[0] + 1j * x[1]).astype(np.complex64)
    want = j_chan.polyphase_channelize(z, taps, m, r, ch_map)
    got = chan.polyphase_channelize(torch.from_numpy(z), taps, m, r, ch_map)
    assert got.dtype == torch.complex64
    close(got, want)
    close(chan.polyphase_channelize(z, taps, m, r, ch_map, device="cpu"), want)
    with pytest.raises(ValueError, match="multiple"):
        chan.polyphase_channelize(torch.from_numpy(z[:-3]), taps, m, r,
                                  ch_map)


@pytest.mark.parametrize("planar_", [True, False], ids=["planar", "complex"])
@pytest.mark.parametrize("r", [4, 16])
def test_make_channelizer_matches_jax(ref, planar_, r):
    """The streaming form over 3 frames, the ntaps−1 history carried."""
    m, n = 16, 1024
    taps = proto(m, 100)
    ch_map = [1, 4, 7, 0]
    j_init, j_apply = j_chan.make_channelizer(taps, m, r, ch_map,
                                              planar=planar_)
    t_init, t_apply = chan.make_channelizer(taps, m, r, ch_map,
                                            planar=planar_, device="cpu")
    js, ts = j_init(), t_init()
    for k in range(3):
        x = samples((n,), seed=30 + k)
        if planar_:
            js, jo = j_apply(js, j_planar.PC(jnp.asarray(x[0]),
                                             jnp.asarray(x[1])))
            ts, to = t_apply(ts, planar.PC(torch.from_numpy(x[0]),
                                           torch.from_numpy(x[1])))
            close(to.re, jo.re)
            close(to.im, jo.im)
        else:
            z = (x[0] + 1j * x[1]).astype(np.complex64)
            js, jo = j_apply(js, z)
            ts, to = t_apply(ts, torch.from_numpy(z))
            close(to, jo)
    if planar_:
        assert np.array_equal(np_of(ts[0]), np.asarray(js[0]))
        assert np.array_equal(np_of(ts[1]), np.asarray(js[1]))
    else:
        assert np.array_equal(np_of(ts), np.asarray(js))


def test_factories_default_to_the_card(monkeypatch):
    """The dsp factories allocate state on the card unless asked for the
    CPU; without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    taps = proto(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chan.make_channelizer(taps, 16, 8, list(range(16)), planar=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chan.make_channelizer_fused_oversampled(taps, 16, 8, list(range(16)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chan.polyphase_channelize(np.zeros(1183, np.complex64), taps, 16, 8,
                                  [0])


# --------------------------------------------------------------------------
# the fused oversampled kernel's plain form
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,r,n,i_offset", [
    (16, 8, 2048, 0), (16, 8, 2048, 5), (64, 16, 2048, 0), (32, 4, 2048, 3)],
    ids=["0", "5", "m64_r16", "m32_r4_ioff3"])
def test_plain_form_matches_pallas_kernel(ref, m, r, n, i_offset):
    """pfb_oversampled_fused (plain) against the Pallas kernel in interpret
    mode (tile_rows = 8) and against JAX's _pfb_oversampled_planar on the
    virtual stream, over 2 chained frames: at M = 16, R = 8 (the path) and
    at BENCH_TPU.md's 64 channels, R = 16 and 32 channels, R = 4, the
    channel counts whose card body is pfb_os_wide_kernel."""
    taps_rm, ntaps = chan._pfb_constants(proto(m), m, r)
    h = hk.os_tail_len(m, r, ntaps)
    w = taps_rm.shape[0]
    tail = samples((h,), seed=40)
    hk.reset_launch_counts()
    for k in range(2):
        x = samples((n,), seed=41 + k)
        want = j_pk.pfb_oversampled_fused(
            *(jnp.asarray(a) for a in (x[0], x[1], tail[0], tail[1])),
            taps_rm, m, r, tile_rows=8, i_offset=i_offset, interpret=True)
        got = hk.pfb_oversampled_fused(
            *(torch.from_numpy(a) for a in (x[0], x[1], tail[0], tail[1])),
            taps_rm, m, r, i_offset=i_offset)
        close(got[0], want[0])
        close(got[1], want[1])
        v = np.concatenate([tail, x], axis=1)
        xr_, xi_ = j_chan._pfb_oversampled_planar(
            jnp.asarray(v[0]), jnp.asarray(v[1]), jnp.asarray(taps_rm), m, r,
            w * m, n // r, i_offset)
        xla = j_planar.ifft_unscaled(j_planar.PC(xr_, xi_))
        close(got[0], xla.re)
        close(got[1], xla.im)
        tail = x[:, n - h:]
    assert hk.pfb_oversampled_fused.launches == 0
    other = hk.pfb_oversampled_fused(*(torch.from_numpy(a) for a in (
        x[0], x[1], tail[0], tail[1])), taps_rm, m, r, i_offset=i_offset + 1)
    assert not torch.equal(other[0], got[0])      # the rotation moved


def test_wrapper_checks():
    m, r = 16, 8
    taps_rm, ntaps = chan._pfb_constants(proto(m), m, r)
    h = hk.os_tail_len(m, r, ntaps)
    x = torch.zeros(2048)
    t = torch.zeros(h)
    with pytest.raises(ValueError, match="R | M"):
        hk.pfb_oversampled_fused(x, x, t, t, chan._pfb_constants(
            proto(16), 16, 6)[0], 16, 6)
    with pytest.raises(ValueError, match="critical"):
        hk.pfb_oversampled_fused(x, x, t, t, taps_rm, 16, 16)
    with pytest.raises(ValueError, match="halo"):
        hk.pfb_oversampled_fused(x, x, t[:128], t[:128],
                                 chan._pfb_constants(proto(m, 1600), m, r)[0],
                                 m, r)
    with pytest.raises(ValueError, match="multiple of R·L"):
        hk.pfb_oversampled_fused(x[:2040], x[:2040], t, t, taps_rm, m, r)
    with pytest.raises(ValueError, match="multiple of 128"):
        hk.pfb_oversampled_fused(x, x, t[:100], t[:100], taps_rm, m, r)


@pytest.mark.parametrize("ch_map", [list(range(16)), [0, 3, 5, 15]],
                         ids=["identity", "subset"])
def test_fused_stream_matches_jax(ref, ch_map):
    """make_channelizer_fused_oversampled over 3 frames against JAX's
    (interpret mode), tails bit-equal; and the fixed latency: the fused
    stream equals make_channelizer's for the input delayed by
    os_tail_len − ntaps + 1 samples."""
    m, r, n = 16, 8, 2048
    taps = proto(m)
    j_init, j_apply = j_chan.make_channelizer_fused_oversampled(
        taps, m, r, ch_map, interpret=True)
    t_init, t_apply = chan.make_channelizer_fused_oversampled(
        taps, m, r, ch_map, device="cpu")
    js, ts = j_init(), t_init()
    xs = [samples((n,), seed=50 + k) for k in range(3)]
    outs = []
    for x in xs:
        js, jo = j_apply(js, j_planar.PC(jnp.asarray(x[0]), jnp.asarray(x[1])))
        ts, to = t_apply(ts, planar.PC(torch.from_numpy(x[0]),
                                       torch.from_numpy(x[1])))
        close(to.re, jo.re)
        close(to.im, jo.im)
        outs.append(to)
    assert np.array_equal(np_of(ts[0]), np.asarray(js[0]))
    assert np.array_equal(np_of(ts[1]), np.asarray(js[1]))
    # latency: zeros delayed by d, then the same stream through the unfused
    ntaps = len(taps)
    d = hk.os_tail_len(m, r, ntaps) - ntaps + 1
    stream = np.concatenate(xs, axis=1)
    delayed = np.concatenate([np.zeros((2, d), np.float32), stream],
                             axis=1)[:, :3 * n]
    u_init, u_apply = chan.make_channelizer(taps, m, r, ch_map, planar=True,
                                            device="cpu")
    _, uo = u_apply(u_init(), planar.PC(torch.from_numpy(delayed[0].copy()),
                                        torch.from_numpy(delayed[1].copy())))
    fused = torch.cat([o.re for o in outs])
    close(fused, uo.re, FLOW_TOL)


# --------------------------------------------------------------------------
# the block and the flowgraph
# --------------------------------------------------------------------------

def _flowgraphs(fused, ch_map, n):
    taps = proto(16)

    def build(mod, fg, **kw):
        blk = mod.PolyphaseChannelizer(taps, n, 16, 8, ch_map, planar=True,
                                       fused=fused)
        g = fg()
        g.external_input(blk)
        t = g.tap(blk)
        return g.compile(frame_size=n, **kw), t, blk

    return build(j_blocks, JFlowgraph), build(blocks, Flowgraph, device="cpu")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "xla"])
def test_flowgraph_matches_jax(ref, fused):
    """PolyphaseChannelizer flowgraphs over 3 frames against JAX's."""
    n = 2048
    (jr, jt, _), (tr, tt, blk) = _flowgraphs(fused, [0, 2, 9, 15], n)
    assert blk.fused == fused and blk.rate == 4 / 8
    for k in range(3):
        x = samples((n,), seed=60 + k)
        want = jr.step(j_planar.PC(jnp.asarray(x[0]), jnp.asarray(x[1])))[jt]
        got = tr.step(planar.PC(torch.from_numpy(x[0]),
                                torch.from_numpy(x[1])))[tt]
        assert got.re.shape == (n // 8 * 4,)
        close(got.re, want.re, FLOW_TOL)
        close(got.im, want.im, FLOW_TOL)


def test_block_checks_and_alias():
    taps = proto(16)
    with pytest.raises(ValueError, match="planar-only"):
        blocks.PolyphaseChannelizer(taps, 2048, 16, 8, [0], fused=True)
    with pytest.raises(ValueError, match="1024"):
        blocks.PolyphaseChannelizer(taps, 1536 + 16, 16, 8, [0], planar=True,
                                    fused=True)
    with pytest.raises(ValueError, match="num_channels"):
        blocks.PolyphaseChannelizer(taps, 2050, 16, 8, [0])
    crit = blocks.PolyphaseChannelizer(taps, 2048, 16, 16, [0], planar=True,
                                       fused=True)
    assert not crit.fused                 # R == M takes the critical form
    assert blocks.clPolyphaseChannelizer is blocks.PolyphaseChannelizer


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "xla"])
def test_runner_state_from_reference(ref, fused):
    """A stream begun in the JAX package continues in the port, for both
    tail forms; a hand-over between the two forms is refused."""
    n = 2048
    (jr, jt, _), (tr, tt, _) = _flowgraphs(fused, list(range(16)), n)
    x = samples((2 * n,), seed=70)
    jr.step(j_planar.PC(jnp.asarray(x[0, :n]), jnp.asarray(x[1, :n])))
    states = [tuple(np.asarray(v) for v in s) for s in jr.states]
    tr.states = P.runner_state_from_reference(tr, states, [None])
    want = jr.step(j_planar.PC(jnp.asarray(x[0, n:]), jnp.asarray(x[1, n:])))[jt]
    got = tr.step(planar.PC(torch.from_numpy(x[0, n:]),
                            torch.from_numpy(x[1, n:])))[tt]
    close(got.re, want.re, FLOW_TOL)
    (_, _, _), (other, _, _) = _flowgraphs(not fused, list(range(16)), n)
    with pytest.raises(ValueError, match="shape"):
        P.runner_state_from_reference(other, states, [None])


# --------------------------------------------------------------------------
# pfb_os_reg_kernel (csrc/pfb_oversampled.cu, M in {2, 4, 8, 16}) modelled
# in numpy: 2048 outputs of each component a block (G = 2048/M output
# groups on U = G/L window rows), 128 threads, FIR strips of S = 16 rows
# (8 at L = 16) with 2 pad rows of M words after each strip's rows
# --------------------------------------------------------------------------

OS_OUTS, OS_THREADS, OS_STRIP, OS_PAD_ROWS = 2048, 128, 16, 2
# every (M, L) the body is instantiated for
OS_REG_ML = [(m, ell) for m in (2, 4, 8, 16) for ell in (2, 4, 8, 16)
             if ell <= m]


def _zswz(x):
    """The sums' word of logical float x (the kernel's zswz)."""
    return x ^ (((x >> 5) & 15) << 1)


def _os_shape(m, r, w):
    """(G, U, S, wpad): a block's output groups, their window rows, the
    FIR strip, and the padded window floats of one component (U + W + 1
    rows: the FIR's last refill of a strip reads row U + W)."""
    g = OS_OUTS // m
    u = g // (m // r)
    s = min(u, OS_STRIP)
    return g, u, s, -(-(u + w + 1) // s) * (s + OS_PAD_ROWS) * m


def _os_word(k, m, s):
    """The window word of window sample k: 2·M pad words after every S·M
    samples."""
    return k + k // (s * m) * OS_PAD_ROWS * m


def _os_stage(frame, tail, blk, m, r, w, vec=True):
    """The kernel's staging of tail ++ frame for block ``blk``: 4-sample
    group i of a component holds window samples k = 4i .. 4i + 3 (v index
    base + k, base = blk·U·M); with ``vec`` (16-byte aligned streams) a
    group inside the tail or the frame loads as one vector, any other
    sample by sample; samples at or past span = (ucount + W)·M − R are 0;
    each group is stored as one vector at _os_word(k); a component's groups
    are counted up to whole store phases (8 lanes), the extra lanes idle.
    Returns the [2, wpad] window (words never stored are 0), the valid
    groups and the thread-ordered record of reads and vector stores."""
    n, h = frame.shape[1], tail.shape[1]
    g, u, s, wpad = _os_shape(m, r, w)
    gcount = min(g, n // r - blk * g)
    span = (gcount // (m // r) + w) * m - r
    base = blk * u * m
    groups = -(-span // 4)
    per_c = -(-groups // 8) * 8
    win = np.zeros((2, wpad), np.float32)
    rec = {"reads_t": [], "reads_f": [], "vector_store": [], "staged": []}
    for e in range(2 * per_c):
        c, i = divmod(e, per_c)
        if i >= groups:                           # an idle lane
            rec["vector_store"].append(None)
            continue
        k = 4 * i
        q = base + k
        f = q - h
        val = np.zeros(4, np.float32)
        if vec and (f < 0 or f + 4 <= n):
            src, lo, kind = ((frame, f, "reads_f") if f >= 0
                             else (tail, q, "reads_t"))
            assert lo % 4 == 0
            rec[kind] += range(lo, lo + 4)
            val[:] = src[c, lo:lo + 4]
            val[k + np.arange(4) >= span] = 0
        else:
            for x in range(4):
                if k + x < span:
                    if q + x < h:
                        rec["reads_t"].append(q + x)
                        val[x] = tail[c, q + x]
                    else:
                        rec["reads_f"].append(q + x - h)
                        val[x] = frame[c, q + x - h]
        rec["staged"] += [(c, q + x) for x in range(4) if k + x < span]
        word = _os_word(k, m, s)
        win[c, word:word + 4] = val
        rec["vector_store"].append(c * wpad + word)
    return win, gcount, rec


def _os_fir_lanes(m, r, w):
    """The FIR jobs, thread-ordered (job e runs on thread e mod 128, a warp
    takes 32 consecutive jobs): component c, strip q, phase p, branch j
    (fastest); the lane's window column x = p·R + M − 1 − j (row shift 1
    where x ≥ M) and its first window word."""
    ell = m // r
    _, u, s, wpad = _os_shape(m, r, w)
    e = np.arange(2 * (u // s) * ell * m)
    c, rem = np.divmod(e, (u // s) * ell * m)
    q, rem = np.divmod(rem, ell * m)
    p, j = np.divmod(rem, m)
    x = p * r + m - 1 - j
    return c, q, p, j, x, c * wpad + q * (s + OS_PAD_ROWS) * m + x


def _os_fir(win, taps_rm, m, r, gcount):
    """The FIR jobs on one block's window: S sums and an S-slot window of
    rows u0 + sh .. in registers, one tap load and one window load per S
    multiply-adds, the slots rotating with the tap step; the strip's last
    row (S − 1) of a chunk sits PAD_ROWS·M words further where x ≥ M (it is
    the next strip's first row); the sums stored at _zswz(g·M) ^ j of their
    component, g = L·(u0 + s) + p.  Jobs whose strip holds no valid group
    skip.  Returns the [2, 2048] sums buffer and every warp-wide word
    address by kind (all lanes, skipped ones too)."""
    w = taps_rm.shape[0]
    ell = m // r
    _, u, s, _ = _os_shape(m, r, w)
    c, q, p, j, x, wp = _os_fir_lanes(m, r, w)
    hop = np.where(x >= m, OS_PAD_ROWS * m, 0)
    flat = win.reshape(-1)
    tapr = taps_rm[::-1]                          # tapr[d, j] = taps[W-1-d, j]
    seen = {"window": [], "sums": []}

    def load(k):
        a = wp + k * m + (hop if k == s - 1 else 0)
        seen["window"].append(a)
        return flat[a]

    wv = [load(k) for k in range(s)]
    acc = [np.zeros(len(c), np.float32) for _ in range(s)]
    wp = wp + (s + OS_PAD_ROWS) * m
    for d0 in range(0, w, s):
        for rr in range(min(s, w - d0)):
            tap = tapr[d0 + rr, j]
            for ss in range(s):
                acc[ss] = (tap * wv[(ss + rr) % s] + acc[ss]).astype(np.float32)
            wv[rr] = load(rr)
        wp = wp + (s + OS_PAD_ROWS) * m
    live = q * s < gcount // ell
    sums = np.zeros((2, OS_OUTS), np.float32)
    for ss in range(s):
        word = _zswz((ell * (q * s + ss) + p) * m) ^ j
        sums[c[live], word[live]] = acc[ss][live]
        seen["sums"].append(c * OS_OUTS + word)
    return sums, seen


def _os_twiddle(a, q, ell):
    """a · exp(−2πi·q/L) as the kernel takes it: at L ≤ 4 whole quarter
    turns as exact swaps and signs (at L = 2 a sign); at L = 8 and 16 one
    complex product (float32) by the table entry exp(−2πi·q/L), built in
    float64 and cast."""
    ar, ai = a.real.astype(np.float32), a.imag.astype(np.float32)
    if ell <= 4:
        quarter = q * (4 // ell)
        br, bi = np.where(quarter & 1, ai, ar), np.where(quarter & 1, -ar, ai)
        sign = np.where(quarter & 2, -1, 1).astype(np.float32)
        return br * sign + 1j * (bi * sign)
    tw = np.exp(-2j * np.pi * np.arange(ell) / ell)
    tw = np.where(abs(tw.real) < 1e-12, 0, tw.real) + 1j * np.where(
        abs(tw.imag) < 1e-12, 0, tw.imag)             # sincospi: 0 at π/2
    tw = tw.astype(np.complex64)[q]
    cr, ci = tw.real, tw.imag
    return ((ar * cr - ai * ci).astype(np.float32)
            + 1j * (ar * ci + ai * cr).astype(np.float32))


def _os_dft(sums, m, r, i_offset, gcount):
    """The DFT stage: thread t loads the 16 sums 16t .. 16t + 15 of both
    components (16/M groups) as float2 pairs at _zswz(16t) ^ 2k, takes
    their unscaled inverse M-point DFTs (float64 here), multiplies output k
    of group g by exp(−2πi·((g + i_offset)·k mod L)/L) and stores them back
    in place; after a barrier, thread t copies out the valid floats
    a = 4t + 512i, each 16-byte run from two float2 loads at _zswz(a) and
    _zswz(a + 2).  Returns the valid groups' outputs [gcount, M] (complex)
    and the float2 access words of each warp-wide access."""
    ell = m // r
    t = np.arange(OS_THREADS)
    b = _zswz(16 * t)
    vals = np.zeros((OS_THREADS, 16), np.complex128)
    words = []
    for k in range(8):
        o = b ^ (2 * k)
        words.append(o)
        vals[:, 2 * k] = sums[0, o] + 1j * sums[1, o]
        vals[:, 2 * k + 1] = sums[0, o + 1] + 1j * sums[1, o + 1]
    y = np.fft.ifft(vals.reshape(OS_THREADS, 16 // m, m), axis=-1) * m
    g = (16 // m) * t[:, None] + np.arange(16 // m)
    q = ((g + i_offset) % ell)[..., None] * np.arange(m) % ell
    y = _os_twiddle(y, q, ell).reshape(OS_THREADS, 16)
    buf = np.zeros(OS_OUTS, np.complex128)
    for k in range(8):
        buf[b ^ (2 * k)] = y[:, 2 * k]
        buf[(b ^ (2 * k)) + 1] = y[:, 2 * k + 1]
    out = np.zeros(OS_OUTS, np.complex128)
    for i in range(OS_OUTS // (4 * OS_THREADS)):
        a = 4 * (t + OS_THREADS * i)
        for x in (0, 2):
            words.append(_zswz(a + x))
            out[a + x] = buf[_zswz(a + x)]
            out[a + x + 1] = buf[_zswz(a + x) + 1]
    return out.reshape(-1, m)[:gcount], words


def _banks_ok(words, width=1):
    """Each warp access (32 lanes, ``width`` consecutive words a lane) is
    served without a bank conflict: in each phase of 32/width lanes, no
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


def _os_case(m, r, ntaps, n, seed=90):
    taps_rm, nt = chan._pfb_constants(proto(m, ntaps), m, r)
    h = hk.os_tail_len(m, r, nt)
    return taps_rm, samples((n,), seed), samples((h,), seed + 1)


# --------------------------------------------------------------------------
# pfb_os_wide_kernel (M in {32, 64, 128}, L in {2, 4, 8, 16}) modelled in
# numpy: 256 threads, chunks of 4096 outputs of each component (4096/M
# groups on CU = 4096/(M L) window rows) behind one staged window of U =
# chunks · CU rows (no pad rows), FIR strips of S = min(CU, 8) rows over
# both components, complex sums in float2 slots, each group's M-point DFT
# on Q = M/16 lanes in two passes through its warp's tile of 512 slots,
# each warp copying its tile out
# --------------------------------------------------------------------------

OSW_OUTS, OSW_THREADS, OSW_STRIP = 4096, 256, 8
OSW_CHUNKS = 2                 # chunks a block (kOsWideChunks) where 3 fit an SM
H100_OPTIN = 232448            # an H100's opt-in shared memory a block
H100_SM_SMEM, H100_RESERVED = 233472, 1024   # an SM's shared memory; kept a block
# every (M, L) the body is instantiated for
OSW_ML = [(m, ell) for m in (32, 64, 128) for ell in (2, 4, 8, 16)]


def _osw_shape(m, r, w, chunks):
    """(CU, S, U, wlen): a chunk's window rows, the FIR strip, a block's
    window rows and the window floats of one component (U + W + 1 rows:
    the last strip's last refill reads row U + W)."""
    cu = OSW_OUTS // (m * (m // r))
    u = chunks * cu
    return cu, min(cu, OSW_STRIP), u, (u + w + 1) * m


def _osw_smem_bytes(m, r, w, chunks=1):
    """Shared memory of a block of ``chunks`` chunks: the window of both
    components, one chunk's complex sums and the two twiddle tables ([M]
    and [16] float2); ``clen_os_smem_bytes(..., body=2)`` on the card."""
    return 4 * (2 * _osw_shape(m, r, w, chunks)[3] + 2 * OSW_OUTS) + 8 * (m + 16)


def _osw_fir_slot(g, j, m):
    """The sums' float2 slot of (chunk group g, branch j) as the FIR
    stores it: warp tile g // GW (GW = 32/Q groups, 512 slots), row j // Q,
    column Q·((g mod GW) XOR (row mod GW)) + j mod Q."""
    q_ = m // 16
    gw = 32 // q_
    row = j // q_
    return (g // gw) * 512 + row * 32 + q_ * ((g % gw) ^ (row % gw)) + j % q_


def _osw_pass1_slot(g, q, k1, m):
    """The slot of (group g, pass-1 lane q, bin k1) as pass 1 leaves it:
    row k1, column Q·(g mod GW) + (q XOR k1 mod Q)."""
    q_ = m // 16
    gw = 32 // q_
    return (g // gw) * 512 + k1 * 32 + q_ * (g % gw) + (q ^ (k1 % q_))


def _osw_out_slot(g, k, m):
    """The slot of output (g, k): g·M + (k XOR Q·(g mod GW) XOR 2·(bit 4
    of k)), an even mask that is one for each run of 4 outputs."""
    q_ = m // 16
    return g * m + (k ^ (q_ * (g % (32 // q_))) ^ (((k >> 4) & 1) << 1))


def _osw_stage(frame, tail, blk, m, r, w, chunks, vec=True):
    """The kernel's staging of tail ++ frame for block ``blk``: two calls,
    window samples [0, (CU + W)·M) (chunk 0's rows) and the rest up to span
    = (ucount + W)·M − R; in each, 4-sample group i of a component holds
    samples k = 4i .. 4i + 3 (v index base + k, base = blk·U·M), a
    component's groups counted up to whole store phases (8 lanes, the extra
    ones idle).  With ``vec`` one 16-byte copy a group, zero-filled past
    span; without, sample by sample.  Returns the [2, wlen] window (words
    never stored are 0), the block's valid groups and the thread-ordered
    record of reads and 16-byte stores."""
    n, h = frame.shape[1], tail.shape[1]
    ell = m // r
    cu, _, u, wlen = _osw_shape(m, r, w, chunks)
    gcount = min(u * ell, n // r - blk * u * ell)
    span = (gcount // ell + w) * m - r
    base = blk * u * m
    win = np.zeros((2, wlen), np.float32)
    rec = {"reads_t": [], "reads_f": [], "vector_store": [], "staged": []}
    first = (cu + w) * m
    for k0, k1 in ((0, first), (first, span)):
        groups = max(0, (min(k1, span) - k0 + 3) // 4)
        per_c = -(-groups // 8) * 8
        for e in range(2 * per_c):
            c, i = divmod(e, per_c)
            k = k0 + 4 * i
            if k >= span or k >= k1:
                rec["vector_store"].append(None)
                continue
            q = base + k
            if vec:                               # one source, 16-byte aligned
                assert q % 4 == 0 and (q + 3 < h or q >= h)
            val = np.zeros(4, np.float32)
            for x in range(min(4, span - k)):
                src, at, kind = ((tail, q + x, "reads_t") if q + x < h
                                 else (frame, q + x - h, "reads_f"))
                rec[kind].append(at)
                val[x] = src[c, at]
            rec["staged"] += [(c, q + x) for x in range(min(4, span - k))]
            win[c, k:k + 4] = val
            rec["vector_store"].append(c * wlen + k)
    return win, gcount, rec


def _osw_fir(win, taps_rm, m, r, chunks, ch, gcount):
    """Chunk ``ch``'s FIR jobs on one block's window, thread-ordered (job e
    on thread e mod 256, a warp takes 32 consecutive jobs): strip s, phase
    p, branch j (fastest), both components; S sums and an S-slot window of
    column x = p·R + M − 1 − j of each (x < 2M: the row shift is in the
    sample index) in registers, one tap load and two window loads per 2·S
    multiply-adds, the slots rotating with the tap step; the complex sums
    stored at float2 slot _osw_fir_slot.  Strips past the valid rows skip.
    Returns the chunk's [4096] complex sums by slot and every warp-wide
    access by kind as word addresses (all lanes; the sums' are 2·slot)."""
    w = taps_rm.shape[0]
    ell = m // r
    cu, s, _, wlen = _osw_shape(m, r, w, chunks)
    u0 = ch * cu
    e = np.arange((cu // s) * ell * m)
    sq, rem = np.divmod(e, ell * m)
    p, j = np.divmod(rem, m)
    wp = (u0 + sq * s) * m + p * r + m - 1 - j
    flat = win.reshape(-1)
    tapr = taps_rm[::-1]
    seen = {"window": [], "sums": []}

    def load(k):
        a = wp + k * m
        seen["window"] += [a, a + wlen]
        return flat[a], flat[a + wlen]

    wv = [load(k) for k in range(s)]
    acc = [[np.zeros(len(e), np.float32) for _ in range(s)] for _ in range(2)]
    wp = wp + s * m
    for d0 in range(0, w, s):
        for rr in range(min(s, w - d0)):
            tap = tapr[d0 + rr, j]
            for ss in range(s):
                for c in range(2):
                    acc[c][ss] = (tap * wv[(ss + rr) % s][c]
                                  + acc[c][ss]).astype(np.float32)
            wv[rr] = load(rr)
        wp = wp + s * m
    live = u0 + sq * s < gcount // ell
    sums = np.zeros(OSW_OUTS, np.complex128)
    for ss in range(s):
        slot = _osw_fir_slot(ell * (sq * s + ss) + p, j, m)
        sums[slot[live]] = acc[0][ss][live] + 1j * acc[1][ss][live].astype(
            np.float64)
        seen["sums"].append(2 * slot)
    return sums, seen


def _osw_lanes(m):
    """Each thread's (group g, lane q of its group, group in its warp gl)."""
    t = np.arange(OSW_THREADS)
    q_ = m // 16
    lane = t % 32
    gl, q = np.divmod(lane, q_)
    return (t // 32) * (32 // q_) + gl, q, gl


def _osw_dft(sums, m, r, i_offset):
    """The transform of one chunk's complex sums (by slot): thread (g, q)
    loads points j = q + Q·m at _osw_fir_slot, takes their 16-point
    unscaled inverse DFT (float64 here), multiplies bin k1 by the float32
    table entry exp(+2πi·q·k1/M) and stores it at _osw_pass1_slot(g, q,
    k1); then loads, for its bins k1 = a·Q + q and every q', the slots
    _osw_pass1_slot(g, q', k1), takes the Q-point DFTs over q' (bins k1 +
    16·k2), multiplies bin k by exp(−2πi·((g + i_offset)·k mod L)/L) and
    stores it at _osw_out_slot(g, k).  Returns the chunk's outputs [4096/M,
    M] (complex, in natural order as each warp copies its tile out: lane l
    reads 16-byte slot pairs at _osw_out_slot(a) and (a + 2), a = 4l +
    128i in the tile's 512 outputs) and the word addresses of every
    warp-wide access by kind (2·slot; the table's float2 entries at
    2·index)."""
    ell = m // r
    q_ = m // 16
    g, q, _ = _osw_lanes(m)
    words = {"pass1_load": [], "pass1_store": [], "pass2_load": [],
             "pass2_store": [], "table": [], "copy_out": []}
    x = np.zeros((OSW_THREADS, 16), np.complex128)
    for mm in range(16):
        slot = _osw_fir_slot(g, q + q_ * mm, m)
        words["pass1_load"].append(2 * slot)
        x[:, mm] = sums[slot]
    y = np.fft.ifft(x, axis=1) * 16
    k1 = np.arange(16)
    tw1 = np.exp(2j * np.pi * np.arange(16)[:, None] * np.arange(q_) / m)
    y = y * tw1.astype(np.complex64)[k1[None, :], q[:, None]]
    words["table"] = [2 * (k * q_ + q) for k in range(1, 16)]
    buf = np.zeros(OSW_OUTS, np.complex128)
    for k in range(16):
        slot = _osw_pass1_slot(g, q, k, m)
        words["pass1_store"].append(2 * slot)
        buf[slot] = y[:, k]
    v = np.zeros((OSW_THREADS, 16 // q_, q_), np.complex128)
    for a in range(16 // q_):
        for b in range(q_):
            slot = _osw_pass1_slot(g, b, a * q_ + q, m)
            words["pass2_load"].append(2 * slot)
            v[:, a, b] = buf[slot]
    big = np.fft.ifft(v, axis=2) * q_                 # [t, a, k2]
    out = np.zeros(OSW_OUTS, np.complex128)
    for a in range(16 // q_):
        for k2 in range(q_):
            k = a * q_ + q + 16 * k2
            tq = ((g + i_offset) * k) % ell
            slot = _osw_out_slot(g, k, m)
            words["pass2_store"].append(2 * slot)
            out[slot] = _os_twiddle(big[:, a, k2], tq, ell)
    res = np.zeros(OSW_OUTS, np.complex128)
    t = np.arange(OSW_THREADS)
    for i in range(512 // 128):
        a = (t // 32) * 512 + 4 * (t % 32) + 128 * i   # in the warp's tile
        for dx in (0, 2):
            slot = _osw_out_slot(a // m, a % m + dx, m)
            words["copy_out"].append(2 * slot)
            res[a + dx] = out[slot]
            res[a + dx + 1] = out[slot + 1]
    return res.reshape(-1, m), words


def _osw_chunks(m, r, w):
    """The C entry's os_wide_chunks on an H100: OSW_CHUNKS where three
    such blocks, each with the shared memory the card keeps for a block,
    fit an SM, else 1."""
    fits = 3 * (_osw_smem_bytes(m, r, w, OSW_CHUNKS) + H100_RESERVED)
    return OSW_CHUNKS if fits <= H100_SM_SMEM else 1


def _osw_block(frame, tail, blk, taps_rm, m, r, i_offset):
    """Block ``blk`` of pfb_os_wide_kernel replayed: its valid outputs
    [gcount, M] (complex) and the staging record."""
    w = taps_rm.shape[0]
    chunks = _osw_chunks(m, r, w)
    cu = _osw_shape(m, r, w, chunks)[0]
    win, gcount, rec = _osw_stage(frame, tail, blk, m, r, w, chunks)
    outs = []
    for ch in range(chunks):
        if ch * cu >= gcount // (m // r):
            break
        sums, _ = _osw_fir(win, taps_rm, m, r, chunks, ch, gcount)
        outs.append(_osw_dft(sums, m, r, i_offset)[0])
    return np.concatenate(outs)[:gcount], gcount, rec


# (M, R, ntaps, n, i_offset): L = 2, 4, 8 and 16, each n leaving a ragged
# last tile (at M = 2 also a frame length that is 2 mod 4); at M >= 32
# pfb_os_wide_kernel at BENCH_TPU.md's 64 and 32 channels and at 128
OS_REPLAY = [(16, 8, None, 3200, 0), (16, 8, 1600, 3200, 0),
             (16, 4, None, 3200, 3), (16, 2, None, 3200, 0),
             (16, 1, None, 3216, 7), (8, 2, None, 2056, 5),
             (4, 2, None, 1204, 0), (2, 1, None, 1202, 1),
             (64, 16, 1600, 12352, 0), (32, 4, 96, 8352, 3),
             (128, 16, None, 8576, 5)]
OS_REPLAY_IDS = ["m16_r8", "m16_r8_1600taps", "m16_r4_ioff3", "m16_r2",
                 "m16_r1_ioff7", "m8_r2_ioff5", "m4_r2", "m2_r1_ioff1",
                 "m64_r16_1600taps", "m32_r4_96taps_ioff3", "m128_r16_ioff5"]


def _os_blocks(m, r, w):
    """(output groups, window rows) of a block of the body the card takes
    at M = m: pfb_os_reg_kernel's, or pfb_os_wide_kernel's at the chunks
    an H100 gets."""
    if m < 32:
        g, u, _, _ = _os_shape(m, r, w)
        return g, u
    u = _osw_shape(m, r, w, _osw_chunks(m, r, w))[2]
    return u * (m // r), u


@pytest.mark.parametrize("m,r,ntaps,n,i_offset", OS_REPLAY, ids=OS_REPLAY_IDS)
def test_pfb_os_reg_schedule_matches_plain(m, r, ntaps, n, i_offset):
    """A replay of the register-tiled bodies' staging, FIR and DFT/twiddle
    schedule (pfb_os_reg_kernel at M <= 16, pfb_os_wide_kernel's chunks
    and two-pass transforms at M >= 32) rebuilds
    pfb_oversampled_fused_plain's outputs on the block whose window crosses
    the tail/frame seam and on the ragged last tile."""
    taps_rm, frame, tail = _os_case(m, r, ntaps, n)
    w, h = taps_rm.shape[0], tail.shape[1]
    zr, zi = hk.pfb_oversampled_fused_plain(
        *(torch.from_numpy(a) for a in (frame[0], frame[1], tail[0], tail[1])),
        taps_rm, m, r, i_offset)
    want = np_of(zr) + 1j * np_of(zi)
    g, u = _os_blocks(m, r, w)
    nblk = -(-(n // r) // g)
    assert (n // r) % g                          # the last tile is ragged
    seam = (h - 1) // (u * m)                    # its window holds v[h-1], v[h]
    assert seam < nblk - 1
    for blk in (seam, nblk - 1):
        if m >= 32:
            got, gcount, rec = _osw_block(frame, tail, blk, taps_rm, m, r,
                                          i_offset)
        else:
            win, gcount, rec = _os_stage(frame, tail, blk, m, r, w)
            sums, _ = _os_fir(win, taps_rm, m, r, gcount)
            got, _ = _os_dft(sums, m, r, i_offset, gcount)
        assert bool(rec["reads_t"]) == (blk == seam) and rec["reads_f"]
        close(got, want[blk * g: blk * g + gcount])


@pytest.mark.parametrize("m,r,ntaps,n,vec", [
    (16, 8, 1600, 3200, True), (16, 1, None, 3216, True),
    (2, 1, None, 1202, True), (2, 1, None, 1202, False),
    (8, 2, None, 2056, False), (64, 16, 1600, 12352, True),
    (32, 4, 96, 8352, False), (128, 16, None, 8576, True)],
    ids=["m16_r8_1600taps", "m16_r1", "m2_r1_n2mod4", "m2_r1_scalar",
         "m8_r2_scalar", "m64_r16_1600taps", "m32_r4_96taps_scalar",
         "m128_r16"])
def test_pfb_os_reg_staging_reads_stay_inside(m, r, ntaps, n, vec):
    """The register-tiled bodies' staging, replayed for every block, with
    16-byte-aligned streams (vector loads, or at M >= 32 16-byte cp.async
    copies zero-filled past the span; at n = 2 mod 4 the frame's last group
    sample by sample) and without (every sample alone): every read lies
    inside the tail or the frame, and every sample the block's valid
    outputs need is staged once."""
    taps_rm, frame, tail = _os_case(m, r, ntaps, n)
    w, h = taps_rm.shape[0], tail.shape[1]
    g, u = _os_blocks(m, r, w)
    for blk in range(-(-(n // r) // g)):
        if m >= 32:
            _, gcount, rec = _osw_stage(frame, tail, blk, m, r, w,
                                        _osw_chunks(m, r, w), vec)
        else:
            _, gcount, rec = _os_stage(frame, tail, blk, m, r, w, vec)
        assert all(0 <= i < h for i in rec["reads_t"])
        assert all(0 <= i < n for i in rec["reads_f"])
        base, span = blk * u * m, (gcount // (m // r) + w) * m - r
        assert base + span <= h + n
        need = [(c, base + k) for c in range(2) for k in range(span)]
        assert sorted(rec["staged"]) == need


def _quarter_warp_stores_ok(st):
    """Each quarter-warp phase of 16-byte stores (8 lanes, idle ones None)
    hits distinct banks."""
    for w0 in range(0, len(st) - 31, 32):
        for ph in range(4):
            seg = [x for x in st[w0 + 8 * ph: w0 + 8 * ph + 8] if x is not None]
            words = np.add.outer(seg, np.arange(4)).reshape(-1)
            if len(np.unique(words % 32)) != len(words):
                return False
    return True


def _osw_banks(m, ell):
    """pfb_os_wide_kernel's shared-memory accesses at (M, L), each warp-wide
    one checked; its three layouts bijective on a chunk's 4096 words."""
    r = m // ell
    for w in (10, 100):
        chunks = _osw_chunks(m, r, w)
        taps_rm = np.ones((w, m), np.float32)
        frame, tail = samples((64 * OSW_OUTS,), 3), samples((2048,), 4)
        win, gcount, rec = _osw_stage(frame, tail, 1, m, r, w, chunks)
        assert _quarter_warp_stores_ok(rec["vector_store"])
        for ch in range(chunks):
            for kind, addrs in _osw_fir(win, taps_rm, m, r, chunks, ch,
                                        gcount)[1].items():
                assert _banks_ok(addrs, 2 if kind == "sums" else 1), kind
    _, words = _osw_dft(np.zeros(OSW_OUTS, np.complex128), m, r, 0)
    for kind, addrs in words.items():
        assert _banks_ok(addrs, 4 if kind == "copy_out" else 2), kind
    g, j = np.divmod(np.arange(OSW_OUTS), m)
    assert sorted(_osw_fir_slot(g, j, m)) == list(range(OSW_OUTS))
    out = _osw_out_slot(g, j, m)
    assert sorted(out) == list(range(OSW_OUTS))
    assert (out[j % 2 == 1] == out[j % 2 == 0] + 1).all()  # pairs stay whole
    assert (out[j % 4 == 0] % 2 == 0).all()
    g, rest = np.divmod(np.arange(OSW_OUTS), m)
    q, k1 = np.divmod(rest, 16)
    assert sorted(_osw_pass1_slot(g, q, k1, m)) == list(range(OSW_OUTS))


@pytest.mark.parametrize("m,ell", OS_REG_ML + OSW_ML)
def test_pfb_os_reg_shared_memory_banks(m, ell):
    """Every warp-wide shared-memory access of the register-tiled bodies is
    on 32 distinct banks.  pfb_os_reg_kernel (M <= 16): the staging's
    16-byte stores (quarter-warp phases), the FIR's window loads (the
    row-shifted lanes' hop included) and its sums' stores, and the DFT
    stage's float2 loads and in-place stores and its copy-out's float2
    loads (half-warp phases); the window layout and the sums' swizzle are
    bijective.  pfb_os_wide_kernel (M >= 32): the staging's stores, the
    FIR's window loads and sums' stores in every chunk, both passes' loads
    and stores through the warp tiles, the pass-1 twiddle table's float2
    loads (equal entries broadcast) and the copy-out's float2 loads; the
    FIR, pass-1 and output layouts are bijective."""
    if m >= 32:
        _osw_banks(m, ell)
        return
    r = m // ell
    for w in (10, 100):
        taps_rm = np.ones((w, m), np.float32)
        _, u, s, wpad = _os_shape(m, r, w)
        frame, tail = samples((8 * OS_OUTS,), 3), samples((1024,), 4)
        win, gcount, rec = _os_stage(frame, tail, 1, m, r, w)
        assert _quarter_warp_stores_ok(rec["vector_store"])
        for kind, addrs in _os_fir(win, taps_rm, m, r, gcount)[1].items():
            assert _banks_ok(addrs), kind
        k = np.arange((u + w + 1) * m)
        words = _os_word(k, m, s)
        assert len(np.unique(words)) == k.size and words.max() < wpad
    x = np.arange(OS_OUTS)
    assert sorted(_zswz(x)) == list(x)
    t, k = np.divmod(x, m)
    assert (_zswz(x) == _zswz(t * m) ^ k).all()
    sums = np.zeros((2, OS_OUTS), np.float32)
    for o in _os_dft(sums, m, r, 0, 0)[1]:
        assert _banks_ok(o, width=2)


@pytest.mark.parametrize("ell", [2, 4, 8, 16])
def test_pfb_os_twiddle_is_the_rotation(ell):
    """The DFT stage's phase twiddle is exp(−2πi·q/L) for every q < L,
    exactly (swaps and signs) where it is a whole number of quarter
    turns."""
    a = np.complex64(0.375 - 1.25j)
    for q in range(ell):
        got = _os_twiddle(np.array(a), np.array(q), ell)
        want = a * np.exp(-2j * np.pi * q / ell)
        assert abs(got - want) <= 1e-7 * abs(a)
        if 4 * q % ell == 0:                      # quarter turns: exact
            assert got == a * (1, -1j, -1, 1j)[4 * q // ell]


@pytest.mark.parametrize("m,ell,i_offset", [
    (32, 2, 1), (32, 8, 3), (64, 4, 0), (64, 16, 7), (128, 8, 5),
    (128, 16, 2)])
def test_pfb_os_wide_two_pass_transform(m, ell, i_offset):
    """pfb_os_wide_kernel's transform of one chunk, replayed: the 16-point
    passes on Q = M/16 lanes a group, the exp(+2πi·q·k1/M) twiddles, the
    exchange through the warp tiles, the Q-point passes and the phase
    twiddle give, in natural order, the unscaled inverse DFT of each
    group's rotated sums out[(j + s_g) mod M] = acc[g, j], s_g = ((g +
    i_offset)·(M − R)) mod M, within 1e-6 of the largest output."""
    r = m // ell
    acc = np.random.default_rng(m + ell).standard_normal(
        (2, OSW_OUTS // m, m)).astype(np.float32)
    sums = np.zeros(OSW_OUTS, np.complex128)
    g, j = np.divmod(np.arange(OSW_OUTS), m)
    sums[_osw_fir_slot(g, j, m)] = (acc[0] + 1j * acc[1].astype(
        np.float64)).reshape(-1)
    got, _ = _osw_dft(sums, m, r, i_offset)
    z = acc[0].astype(np.float64) + 1j * acc[1]
    s = ((np.arange(OSW_OUTS // m) + i_offset) * (m - r)) % m
    rotated = np.stack([np.roll(row, sh) for row, sh in zip(z, s)])
    want = np.fft.ifft(rotated, axis=1) * m
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_os_body_asks_the_library_once(monkeypatch):
    """os_body takes pfb_os_wide_kernel's one-chunk block size from the C
    library (clen_os_smem_bytes, body 2) and the card's opt-in shared
    memory, once for each (m, r, w, card); a block that does not fit keeps
    pfb_os_kernel, and M <= 16 never asks."""
    asked = []

    class Lib:
        @staticmethod
        def clen_os_smem_bytes(m, r, w, groups, body):
            asked.append((m, r, w, groups, body))
            return _osw_smem_bytes(m, r, w, groups)

    monkeypatch.setattr(hk, "_load", lambda: Lib)
    monkeypatch.setattr(hk, "_smem_optin", lambda index: H100_OPTIN)
    hk._os_body_code.cache_clear()
    try:
        for _ in range(3):
            assert hk.os_body(64, 16, 25, "cuda:0") == "pfb_os_wide_kernel"
        assert hk.os_body(128, 64, 188, "cuda") == "pfb_os_kernel"
        assert hk.os_body(16, 8, 10, "cuda") == "pfb_os_reg_kernel"
        assert asked == [(64, 16, 25, 1, 2), (128, 64, 188, 1, 2)]
    finally:
        hk._os_body_code.cache_clear()


def test_os_wide_two_chunks_fit_three_an_sm():
    """At BENCH_TPU.md's wide configurations and 128 channels, R = 16, a
    block of two chunks fits three an H100 SM, so the C entry runs two; a
    deep prototype whose two-chunk block does not falls back to one."""
    for m, r, ntaps in [(64, 16, 192), (64, 16, 1600), (32, 4, 96),
                        (128, 16, None)]:
        w = chan._pfb_constants(proto(m, ntaps), m, r)[0].shape[0]
        assert _osw_chunks(m, r, w) == 2
        assert 3 * (_osw_smem_bytes(m, r, w, 2) + H100_RESERVED) <= H100_SM_SMEM
    assert _osw_smem_bytes(64, 16, 25, 2) == 63104
    assert _osw_chunks(128, 64, 100) == 1
    assert _osw_smem_bytes(128, 64, 100) <= H100_OPTIN


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64, 128])
def test_os_body_by_m(m):
    """The rule at L = 4 (2 at m = 2; m = 1 has no oversampled form) and
    10 tap rows on an H100's opt-in shared memory."""
    r = max(1, m // 4)
    want = ("pfb_os_kernel" if m == 1 else "pfb_os_reg_kernel" if m <= 16
            else "pfb_os_wide_kernel")
    assert hk._pick_os_body(m, r, _osw_smem_bytes(m, r, 10),
                            H100_OPTIN) == want
    assert want in hk.OS_BODIES


# (M, R, ntaps) that keep pfb_os_kernel: BIG_WINDOW (neither body fits);
# 24000 taps at 128 channels, R = 64 (W = 188: pfb_os_wide_kernel's
# one-chunk block of 205 rows does not fit, pfb_os_kernel's one-group
# block does); and L = M/R > 16
OS_FIRST = [BIG_WINDOW, (128, 64, 24000), (32, 1, None), (64, 2, None),
            (128, 4, None)]


@pytest.mark.parametrize("m,r,ntaps", OS_FIRST,
                         ids=["big_window", "m128_r64_24000taps", "m32_r1",
                              "m64_r2", "m128_r4"])
def test_os_body_keeps_the_first_body(m, r, ntaps):
    w = chan._pfb_constants(proto(m, ntaps), m, r)[0].shape[0]
    assert hk._pick_os_body(m, r, _osw_smem_bytes(m, r, w),
                            H100_OPTIN) == "pfb_os_kernel"
    if (m, r, ntaps) == (128, 64, 24000):
        assert w == 188
        assert _osw_smem_bytes(m, r, w) > H100_OPTIN
        assert 8 * (w * m) + 16 * m <= H100_OPTIN  # os_smem_bytes, 1 group


def test_os_body_refuses_m_not_dividing_128():
    for m in (0, 3, 24, 256):
        with pytest.raises(ValueError, match="divide"):
            hk.os_body(m, 1, 1, "cuda")
    with pytest.raises(ValueError, match="CUDA kernel body"):
        hk.os_body(64, 16, 3, "cpu")


def test_os_ab_cli_arguments():
    """The oversampled-PFB variants tool's arguments; without a card it
    exits non-zero."""
    from clenabled_tpu_torch.tools import os_ab as cli

    args = cli.parse_args([])
    assert (args.variants, args.n, args.m, args.r, args.ntaps, args.rounds,
            args.calls) == ([], 1 << 23, 16, 8, None, 7, 10)
    args = cli.parse_args(["old=_local/pfb_oversampled_old.cu",
                           "fir=-DOS_STOP_AFTER=2", "--m", "8", "--r", "2",
                           "--ntaps", "1600", "--rounds", "3"])
    assert (args.variants, args.m, args.r, args.ntaps, args.rounds) == (
        ["old=_local/pfb_oversampled_old.cu", "fir=-DOS_STOP_AFTER=2"], 8, 2,
        1600, 3)
    if not torch.cuda.is_available():
        assert cli.main(["--n", "4096"]) == 1


def test_step_ab_os_path_arguments():
    """The path step A/B tool's oversampled channelizer path: ``--path os``
    with M and R (the default stays the planar FX step); without a card it
    exits non-zero."""
    from clenabled_tpu_torch.tools import step_ab as cli

    args = cli.parse_args([])
    assert (args.path, args.m, args.r) == ("fx", 16, 8)
    args = cli.parse_args(["parent=_local/parent", "tree=.", "--path", "os",
                           "--samples", str(1 << 23), "--m", "64", "--r",
                           "16", "--rounds", "2"])
    assert (args.variants, args.path, args.samples, args.m, args.r,
            args.rounds) == (["parent=_local/parent", "tree=."], "os",
                             1 << 23, 64, 16, 2)
    with pytest.raises(SystemExit):
        cli.parse_args(["--path", "xengine"])
    if not torch.cuda.is_available():
        assert cli.main(["--path", "os", "--samples", "4096"]) == 1


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,r,ntaps,n,i_offset", [
    (16, 8, None, 1 << 20, 0), (64, 16, 1600, 1 << 18, 0),
    (32, 4, 96, 1 << 18, 3), (8, 2, 40, 4096, 1),
    # pfb_os_reg_kernel at L = 2 .. 16, each n leaving a ragged last block
    (16, 8, None, (1 << 20) + 80, 0), (16, 8, 1600, (1 << 18) + 80, 5),
    (16, 4, None, (1 << 18) + 48, 3), (16, 2, None, (1 << 18) + 32, 0),
    (16, 1, None, (1 << 18) + 16, 7), (8, 1, None, (1 << 16) + 8, 2),
    (4, 2, None, (1 << 16) + 4, 0), (4, 1, None, (1 << 16) + 4, 3),
    (2, 1, None, (1 << 16) + 2, 1)])
def test_pfb_oversampled_kernel_matches_plain_on_card(card, m, r, ntaps, n,
                                                      i_offset):
    """Both bodies against the plain form; the rows are allocated apart,
    so every stream is 16-byte aligned (at M = 2 the frame is 2 mod 4
    samples long: its last group loads sample by sample)."""
    taps_rm, nt = chan._pfb_constants(proto(m, ntaps), m, r)
    h = hk.os_tail_len(m, r, nt)
    x = [torch.from_numpy(a).to(card) for a in samples((n,), seed=80)]
    t = [torch.from_numpy(a).to(card) for a in samples((h,), seed=81)]
    args = (x[0], x[1], t[0], t[1], torch.as_tensor(taps_rm, device=card), m,
            r, i_offset)
    before = hk.pfb_oversampled_fused.launches
    got = hk.pfb_oversampled_fused(*args)
    torch.cuda.synchronize()
    assert hk.pfb_oversampled_fused.launches == before + 1
    want = hk.pfb_oversampled_fused_plain(*args)
    for g_, w_ in zip(got, want):
        close(g_, w_, FLOW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,r,shift", [(16, 8, 1), (16, 1, 2), (2, 1, 3)])
def test_pfb_os_reg_unaligned_streams_on_card(card, m, r, shift):
    """Frame and tail rows that are not 16-byte aligned (views ``shift``
    floats into their rows) are staged sample by sample, with the plain
    form's outputs."""
    n = (1 << 16) + 2 * m
    taps_rm, nt = chan._pfb_constants(proto(m), m, r)
    h = hk.os_tail_len(m, r, nt)
    x = torch.from_numpy(samples((n + shift,), seed=84)).to(card)[:, shift:]
    t = torch.from_numpy(samples((h + shift,), seed=85)).to(card)[:, shift:]
    args = (x[0], x[1], t[0], t[1], torch.as_tensor(taps_rm, device=card), m,
            r, 1)
    assert x[0].data_ptr() % 16
    got = hk.pfb_oversampled_fused(*args)
    want = hk.pfb_oversampled_fused_plain(*args)
    for g_, w_ in zip(got, want):
        close(g_, w_, FLOW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4, 8, 16, 32, 64, 128])
def test_pfb_oversampled_launches_its_body_on_card(card, m):
    """A call at every M dividing 128 (R = M/2) launches the body that
    os_body names (torch.profiler's kernel names) and nothing of the
    others, and agrees with its plain form."""
    from clenabled_tpu_torch.runtime.device import launched_kernels

    r = m // 2
    taps_rm, nt = chan._pfb_constants(proto(m), m, r)
    h = hk.os_tail_len(m, r, nt)
    x = torch.from_numpy(samples((1 << 15,), seed=86)).to(card)
    t = torch.from_numpy(samples((h,), seed=87)).to(card)
    args = (x[0], x[1], t[0], t[1], torch.as_tensor(taps_rm, device=card), m,
            r, 0)
    body = hk.os_body(m, r, taps_rm.shape[0], card)
    assert body == ("pfb_os_reg_kernel" if m <= 16 else "pfb_os_wide_kernel")
    others = set(hk.OS_BODIES) - {body}
    got, events = launched_kernels(lambda: hk.pfb_oversampled_fused(*args))
    assert sum(body in e for e in events) == 1
    assert not any(o in e for o in others for e in events)
    for g_, w_ in zip(got, hk.pfb_oversampled_fused_plain(*args)):
        close(g_, w_, FLOW_TOL)


def _first_body_call(args):
    """The call ``pfb_oversampled_fused`` makes, forced onto pfb_os_kernel
    (body 0 of the C entry), uncounted."""
    xr, xi, tr, ti, taps, m, r, ioff = args
    zr = torch.empty((xr.shape[-1] // r, m), device=xr.device)
    zi = torch.empty_like(zr)
    err = hk._load().clen_pfb_oversampled(
        xr.data_ptr(), xi.data_ptr(), tr.data_ptr(), ti.data_ptr(),
        taps.data_ptr(), hk._twiddles(m, xr.device).data_ptr(), zr.data_ptr(),
        zi.data_ptr(), xr.shape[-1], tr.shape[-1], m, r, taps.shape[0], ioff,
        max(1, hk._OS_GROUPS // m), hk.OS_BODIES.index("pfb_os_kernel"),
        torch.cuda.current_stream(xr.device).cuda_stream)
    assert err == 0
    return zr, zi


@pytest.mark.cuda
@pytest.mark.parametrize("m,r,ntaps,n,i_offset", [
    (64, 16, 192, (1 << 18) + 64 * 3, 0), (64, 16, 1600, (1 << 18) + 64, 5),
    (32, 4, 96, (1 << 18) + 32 * 5, 3), (128, 16, None, (1 << 18) + 128, 7),
    (128, 8, None, 1 << 17, 1), (32, 2, 640, 1 << 17, 0)],
    ids=["m64_r16_192taps", "m64_r16_1600taps", "m32_r4_96taps",
         "m128_r16", "m128_r8", "m32_r2_640taps"])
def test_pfb_os_wide_and_first_body_match_plain_on_card(card, m, r, ntaps, n,
                                                        i_offset):
    """At BENCH_TPU.md's wide configurations (ragged last blocks, rotation
    offsets) and at L = 16, both bodies against the plain form: the
    wrapper's call on pfb_os_wide_kernel (one launch counted) and
    pfb_os_kernel forced through the C entry; the C entry's block sizes are
    the numpy replay's."""
    taps_rm, nt = chan._pfb_constants(proto(m, ntaps), m, r)
    h = hk.os_tail_len(m, r, nt)
    w = taps_rm.shape[0]
    x = [torch.from_numpy(a).to(card) for a in samples((n,), seed=88)]
    t = [torch.from_numpy(a).to(card) for a in samples((h,), seed=89)]
    args = (x[0], x[1], t[0], t[1], torch.as_tensor(taps_rm, device=card), m,
            r, i_offset)
    assert hk.os_body(m, r, w, card) == "pfb_os_wide_kernel"
    for chunks in (1, OSW_CHUNKS):
        assert hk._load().clen_os_smem_bytes(m, r, w, chunks, 2) == (
            _osw_smem_bytes(m, r, w, chunks))
    before = hk.pfb_oversampled_fused.launches
    got = hk.pfb_oversampled_fused(*args)
    torch.cuda.synchronize()
    assert hk.pfb_oversampled_fused.launches == before + 1
    first = _first_body_call(args)
    torch.cuda.synchronize()
    want = hk.pfb_oversampled_fused_plain(*args)
    for g_, f_, w_ in zip(got, first, want):
        close(g_, w_, FLOW_TOL)
        close(f_, w_, FLOW_TOL)


@pytest.mark.cuda
def test_fused_supported_asks_the_cards_shared_memory(card):
    assert chan.fused_oversampled_supported(16, 8, 160, device=card)
    assert chan.fused_oversampled_supported(64, 8, 1600, device=card)
    assert not chan.fused_oversampled_supported(*BIG_WINDOW, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        chan.make_channelizer_fused_oversampled(
            proto(128, 40000), 128, 64, [0], device=card)


@pytest.mark.cuda
def test_channelizer_flowgraph_on_card_launches_kernel(card):
    n = 1 << 16
    taps = proto(16)
    blk = blocks.PolyphaseChannelizer(taps, n, 16, 8, list(range(16)),
                                      planar=True, fused=True)
    g = Flowgraph()
    g.external_input(blk)
    t = g.tap(blk)
    r = g.compile(frame_size=n, device=card)
    before = hk.pfb_oversampled_fused.launches
    x = torch.from_numpy(samples((n,), seed=82)).to(card)
    out = r.step(planar.PC(x[0], x[1]))[t]
    torch.cuda.synchronize()
    assert hk.pfb_oversampled_fused.launches == before + 1
    z = torch.zeros(r.states[0][0].shape[0], device=card)
    want = hk.pfb_oversampled_fused_plain(x[0], x[1], z, z,
                                          chan._pfb_constants(taps, 16, 8)[0],
                                          16, 8)
    close(out.re, want[0].reshape(-1), FLOW_TOL)
