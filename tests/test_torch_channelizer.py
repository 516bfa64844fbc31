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

@pytest.mark.parametrize("i_offset", [0, 5])
def test_plain_form_matches_pallas_kernel(ref, i_offset):
    """pfb_oversampled_fused (plain) against the Pallas kernel in interpret
    mode (n = 2048, M = 16, R = 8, tile_rows = 8) and against JAX's
    _pfb_oversampled_planar on the virtual stream, over 2 chained frames."""
    m, r, n = 16, 8, 2048
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
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,r,ntaps,n,i_offset", [
    (16, 8, None, 1 << 20, 0), (64, 16, 1600, 1 << 18, 0),
    (32, 4, 96, 1 << 18, 3), (8, 2, 40, 4096, 1)])
def test_pfb_oversampled_kernel_matches_plain_on_card(card, m, r, ntaps, n,
                                                      i_offset):
    taps_rm, nt = chan._pfb_constants(proto(m, ntaps), m, r)
    h = hk.os_tail_len(m, r, nt)
    x = torch.from_numpy(samples((n,), seed=80)).to(card)
    t = torch.from_numpy(samples((h,), seed=81)).to(card)
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
