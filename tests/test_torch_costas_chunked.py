"""Port parity: the chunk-parallel Costas loop and the batched kernel entry.

``demod.make_costas_loop_chunked`` runs its chunks' windows as rows of
``hopper_kernels.costas_batched`` (on the CPU its plain form, one torch
step a sample over all rows at once).  It is held to the JAX package's
``make_costas_loop_chunked`` as tests/test_siggen_demod.py:122-191 and
tests/test_costas_acquisition.py hold JAX's to its scan:

- on locked frames (both sides' residual under the JAX test's 1e-3):
  outputs within 1e-4 × max|JAX| and the same branch hops;
- on an acquisition frame above that bound only that both sides flag it:
  before lock the loop is not contracting, and the ulp-level differences
  between JAX's and torch's sin/cos need not stay small;
- the port's own certificate: ``exact`` ⇒ outputs bit for bit the port's
  sequential form (``costas_scalar``'s plain form), and a frame that falls
  back is bit for bit that form from its carried state.

The batched plain form is held to row-by-row ``costas_scalar`` calls
within tests/test_torch_costas.py's tolerances (the CPU's sin/cos of a
tensor may take a vectorised path, so not bit for bit here).  On a card
(``cuda`` marker, skipped without one) the kernel is held to its plain
form and to ``costas_scalar`` row by row, bit for bit, strided windows
included.  Frames stay at or below 4096 samples a row where the plain loop
runs sequentially: it costs one Python step a sample.
"""

import math

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu.dsp import demod as j_demod
    from clenabled_tpu.dsp import planar as j_planar
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch.dsp import demod
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.dsp import planar

OUT_TOL, PHASE_TOL, FREQ_TOL = 5e-6, 1e-5, 1e-6
REL = 1e-4
LOCKED = 1e-3          # the JAX test's residual bound for a locked frame
CHUNK, WARMUP, FRAME = 1024, 512, 4096


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def bpsk(n, w, seed, phase0=0.0, amp=0.02, order=2, symbol=32):
    """tests/test_costas_acquisition.py's signal: symbols held ``symbol``
    samples at ``w`` rad/sample of offset, with noise, as float32 (re, im);
    QPSK for order 4."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, order, (n + symbol - 1) // symbol).repeat(symbol)[:n]
    sym = np.pi * k if order == 2 else np.pi / 4 * (2 * k + 1)
    x = np.exp(1j * (phase0 + w * np.arange(n) + sym))
    x = x + amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def frames(xr, xi, n=FRAME):
    return [(xr[k:k + n], xi[k:k + n]) for k in range(0, len(xr), n)]


def t_pc(fr):
    return planar.PC(torch.from_numpy(fr[0]), torch.from_numpy(fr[1]))


def j_pc(fr):
    return j_planar.PC(jnp.asarray(fr[0]), jnp.asarray(fr[1]))


def run_both(bw, order, frs, **kw):
    """Each frame through the port's and JAX's chunked loops: lists of
    (out, diag) as numpy, and the port's states before each frame."""
    t_run = demod.make_costas_loop_chunked(bw, order, **kw)
    j_run = j_demod.make_costas_loop_chunked(bw, order, **kw)
    ts, js = t_run.init_state(device="cpu"), j_run.init_state()
    got, want, states = [], [], []
    for fr in frs:
        states.append(ts)
        ts, to, td = t_run(ts, t_pc(fr))
        js, jo, jd = j_run(js, j_pc(fr))
        got.append((to, {k: v.item() for k, v in td.items()}))
        want.append((jo, {k: np.asarray(v).item() for k, v in jd.items()}))
    return got, want, states


def sequential(bw, order, frs):
    """The port's sequential plain form over the joined frames."""
    alpha, beta = demod.costas_gains(bw)
    xr = torch.from_numpy(np.concatenate([f[0] for f in frs]))
    xi = torch.from_numpy(np.concatenate([f[1] for f in frs]))
    return hk.costas_scalar_plain(xr, xi, 0.0, 0.0, 0.0, order, alpha, beta)


def same_out(o, ref_r, ref_i) -> bool:
    return torch.equal(o.re, ref_r) and torch.equal(o.im, ref_i)


def close_to_jax(o, jo):
    """Within 1e-4 × max|JAX| of the complex output."""
    got = o.re.numpy() + 1j * o.im.numpy()
    want = np.asarray(jo.re) + 1j * np.asarray(jo.im)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


def held(k, got, want, seq=None):
    """Frame k of the two chunked loops held to each other (locked) or
    both flagged (acquisition); ``exact`` ⇒ bit-equal to ``seq``."""
    (o, d), (jo, jd) = got[k], want[k]
    if d["residual"] < LOCKED and jd["residual"] < LOCKED:
        close_to_jax(o, jo)
        assert d["branch_hops"] == jd["branch_hops"]
    else:
        assert d["residual"] >= LOCKED and jd["residual"] >= LOCKED, (d, jd)
    if d["exact"] and seq is not None:
        sl = slice(k * FRAME, (k + 1) * FRAME)
        assert same_out(o, seq[0][sl], seq[1][sl])


def test_chunked_matches_jax_and_sequential(ref):
    """tests/test_siggen_demod.py:122-159's stream (bw 0.1, BPSK at 0.002
    cycles/sample, chunk 1024, warm-up 512, 3 frames of 4096)."""
    rng = np.random.default_rng(0)
    n, nfr = 4096, 3
    bits = rng.integers(0, 2, nfr * n) * 2 - 1
    t = np.arange(nfr * n)
    x = (bits * np.exp(1j * (2 * np.pi * 0.002 * t + 0.7))).astype(
        np.complex64)
    frs = frames(x.real.copy(), x.imag.copy(), n)
    got, want, _ = run_both(0.1, 2, frs, chunk=1024, warmup=512)
    seq = sequential(0.1, 2, frs)
    for k in range(nfr):
        (o, d), (_, jd) = got[k], want[k]
        assert d["residual"] < LOCKED and jd["residual"] < LOCKED
        held(k, got, want, seq)
        sl = slice(k * n, (k + 1) * n)
        np.testing.assert_allclose(o.re.numpy(), seq[0][sl].numpy(),
                                   atol=2e-2)
        np.testing.assert_allclose(o.im.numpy(), seq[1][sl].numpy(),
                                   atol=2e-2)


def test_chunked_ulp_residual_when_locked(ref):
    """tests/test_siggen_demod.py:162-180: after acquisition the seam
    residual sits at the float32 floor and no branch hops occur, on both
    sides."""
    rng = np.random.default_rng(3)
    n = 1 << 15
    bits = rng.integers(0, 2, 2 * n) * 2 - 1
    t = np.arange(2 * n)
    x = (bits * np.exp(1j * (2 * np.pi * 0.002 * t + 0.7))).astype(
        np.complex64)
    frs = frames(x.real.copy(), x.imag.copy(), n)
    got, want, _ = run_both(0.1, 2, frs, chunk=4096, warmup=2048)
    for (o, d), (jo, jd) in zip(got, want):
        assert d["residual"] < 1e-5 and jd["residual"] < 1e-5
        close_to_jax(o, jo)
    assert got[-1][1]["branch_hops"] == want[-1][1]["branch_hops"] == 0


def test_chunked_validates(ref):
    """The JAX function's ValueErrors: a frame that is not a positive
    multiple of the chunk, warmup > chunk, an order other than 2 or 4."""
    run = demod.make_costas_loop_chunked(0.1, 2, chunk=1024, warmup=256)
    st = run.init_state(device="cpu")
    for n in (1000, 0, 1536):
        with pytest.raises(ValueError, match="multiple of 1024"):
            run(st, planar.PC(torch.zeros(n), torch.zeros(n)))
    j_run = j_demod.make_costas_loop_chunked(0.1, 2, chunk=1024, warmup=256)
    with pytest.raises(ValueError):
        j_run(j_run.init_state(), j_planar.PC(np.zeros(1000, np.float32),
                                              np.zeros(1000, np.float32)))
    for mod in (demod, j_demod):
        with pytest.raises(ValueError, match="warmup"):
            mod.make_costas_loop_chunked(0.1, 2, chunk=256, warmup=512)
        with pytest.raises(ValueError, match="order"):
            mod.make_costas_loop_chunked(0.1, 3)


def test_init_state_and_device():
    """(CostasState of 0-d zeros, PC of ``warmup`` zeros) on the device
    asked for; the card by default, which raises without one."""
    run = demod.make_costas_loop_chunked(0.1, 2, chunk=1024, warmup=300)
    lag, tail = run.init_state(device="cpu")
    assert all(v.dim() == 0 and float(v) == 0.0 for v in lag)
    assert tail.re.shape == tail.im.shape == (300,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.init_state()


def test_cold_start_flagged_then_certified(ref):
    """tests/test_costas_acquisition.py:40-70: from a zero state with a
    real offset both sides flag the acquisition transient, then certify;
    the port's locked tail agrees with its sequential form."""
    frs = frames(*bpsk(6 * FRAME, 0.005, seed=0))
    got, want, _ = run_both(0.01, 2, frs, chunk=CHUNK, warmup=WARMUP)
    seq = sequential(0.01, 2, frs)
    resids = [d["residual"] for _, d in got]
    for k in range(len(frs)):
        held(k, got, want, seq)
    assert resids[-1] < 1e-4, resids
    first = next(i for i, r in enumerate(resids) if r < 1e-4)
    assert first <= 2, resids
    out = np.concatenate([o.re.numpy() + 1j * o.im.numpy() for o, _ in got])
    whole = seq[0].numpy() + 1j * seq[1].numpy()
    tail = slice((first + 1) * FRAME, None)
    np.testing.assert_allclose(out[tail], whole[tail], atol=5e-3)


def test_lock_loss_flagged_then_recertified(ref):
    """tests/test_costas_acquisition.py:73-92: a mid-stream phase and
    frequency step spikes the residual on both sides, and the loop
    re-certifies after re-locking."""
    a = bpsk(4 * FRAME, 0.005, seed=1)
    b = bpsk(4 * FRAME, -0.008, seed=2, phase0=2.0)
    frs = frames(np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]))
    got, want, _ = run_both(0.01, 2, frs, chunk=CHUNK, warmup=WARMUP)
    for k in range(len(frs)):
        held(k, got, want)
    for res in (got, want):
        resids = [d["residual"] for _, d in res]
        assert max(resids[4:6]) > 10 * max(min(resids[1:4]), 1e-7), resids
        assert resids[-1] < 1e-4, resids


def test_exact_fallback_bit_equal_to_sequential(ref):
    """tests/test_costas_acquisition.py:95-120: frames whose residual
    exceeds ``exact_fallback_residual`` rerun the sequential recurrence —
    bit for bit the port's sequential form from the carried state, the
    cold-start frame bit for bit the sequential form over the stream — and
    report exact and fell_back on both sides."""
    frs = frames(*bpsk(5 * FRAME, 0.005, seed=3))
    got, want, states = run_both(0.01, 2, frs, chunk=CHUNK, warmup=WARMUP,
                                 exact_fallback_residual=1e-4)
    alpha, beta = demod.costas_gains(0.01)
    seq = sequential(0.01, 2, frs)
    fell = [k for k, (_, d) in enumerate(got) if d["fell_back"]]
    assert fell and fell[0] == 0, fell
    assert [d["fell_back"] for _, d in want][0]
    for k in fell:
        (o, d), (lag, tail) = got[k], states[k]
        assert d["exact"]
        xr = torch.cat([tail.re, torch.from_numpy(frs[k][0])])
        xi = torch.cat([tail.im, torch.from_numpy(frs[k][1])])
        s = hk.costas_scalar_plain(xr, xi, *lag, 2, alpha, beta)
        assert same_out(o, s[0][WARMUP:], s[1][WARMUP:])
    assert same_out(got[0][0], seq[0][:FRAME], seq[1][:FRAME])
    for k, ((o, d), (jo, jd)) in enumerate(zip(got, want)):
        if not d["fell_back"]:
            assert d["residual"] <= 1e-4
        if not (d["fell_back"] or jd["fell_back"]):
            close_to_jax(o, jo)


@pytest.mark.parametrize("order", [2, 4])
def test_one_chunk_frame(ref, order):
    """A frame of exactly one chunk: no seam, so residual 0 (JAX's
    ``initial=0.0``), exact, no branch hop, and chunk 0 is the sequential
    loop from the carried state, bit for bit."""
    frs = frames(*bpsk(2 * CHUNK, 0.005, seed=4, order=order), CHUNK)
    got, want, _ = run_both(0.02, order, frs, chunk=CHUNK, warmup=WARMUP)
    seq = sequential(0.02, order, frs)
    for k, ((o, d), (jo, jd)) in enumerate(zip(got, want)):
        assert d == {"exact": True, "residual": 0.0, "branch_hops": 0,
                     "fell_back": False}
        assert jd["residual"] == 0.0 and jd["exact"]
        sl = slice(k * CHUNK, (k + 1) * CHUNK)
        assert same_out(o, seq[0][sl], seq[1][sl])
        close_to_jax(o, jo)


@pytest.mark.parametrize("order", [2, 4])
def test_branch_correction(ref, order):
    """Chunk k warm-started a whole branch κ·k away (the carried frequency
    off by κ/chunk): every seam hops one branch, the residual stays at the
    float floor, and the exact correction (sign flips for order 2,
    quadrant swaps for order 4) gives the sequential trajectory — the same
    on both sides."""
    kappa = math.pi if order == 2 else math.pi / 2
    w0, n = 0.01, 4 * CHUNK
    xr, xi = bpsk(WARMUP + n, w0, seed=5, order=order, amp=0.01)
    tail = (xr[:WARMUP], xi[:WARMUP])
    fr = (xr[WARMUP:], xi[WARMUP:])
    alpha, beta = demod.costas_gains(0.1)
    freq = np.float32(w0 + kappa / CHUNK)
    t_run = demod.make_costas_loop_chunked(0.1, order, chunk=CHUNK,
                                           warmup=WARMUP)
    j_run = j_demod.make_costas_loop_chunked(0.1, order, chunk=CHUNK,
                                             warmup=WARMUP)
    # the lag state, WARMUP samples before the frame
    t_st = (demod.CostasState(*(torch.tensor(v, dtype=torch.float32)
                                for v in (0.0, freq, 0.0))),
            planar.PC(*(torch.from_numpy(v) for v in tail)))
    j_st = (j_demod.CostasState(jnp.float32(0.0), jnp.float32(freq),
                                jnp.float32(0.0)), j_pc(tail))
    _, o, d = t_run(t_st, t_pc(fr))
    _, jo, jd = j_run(j_st, j_pc(fr))
    assert int(d["branch_hops"]) == int(jd["branch_hops"]) >= 1
    assert float(d["residual"]) < 1e-5 and float(jd["residual"]) < 1e-5
    close_to_jax(o, jo)
    s = hk.costas_scalar_plain(torch.from_numpy(xr), torch.from_numpy(xi),
                               0.0, float(freq), 0.0, order, alpha, beta)
    np.testing.assert_allclose(o.re.numpy(), s[0][WARMUP:].numpy(),
                               atol=2e-2)
    np.testing.assert_allclose(o.im.numpy(), s[1][WARMUP:].numpy(),
                               atol=2e-2)


# chip_smoke.py phase 12's chunked configuration: MIGRATION.md's loop
# bandwidth at BENCH_TPU.md:376's chunk and warm-up, frames of 2^20 of BPSK
# (a symbol a sample) at 0.005 rad/sample with noise
BENCH_BW, BENCH_CHUNK, BENCH_WARMUP, BENCH_FRAME = 0.00628, 4096, 512, 1 << 20


def bench_configuration(nframes, seed=12):
    """Each frame of that configuration through the port's and JAX's
    chunked loops: rows of (port diag, JAX diag, the largest distance of
    JAX's chunked output from JAX's sequential scan on the frame)."""
    frs = frames(*bpsk(nframes * BENCH_FRAME, 0.005, seed, phase0=0.7,
                       amp=0.05, symbol=1), BENCH_FRAME)
    got, want, _ = run_both(BENCH_BW, 2, frs, chunk=BENCH_CHUNK,
                            warmup=BENCH_WARMUP)
    seq = j_demod.make_costas_loop_planar(BENCH_BW, 2)
    st = j_demod.CostasState(*(jnp.float32(0.0),) * 3)
    rows = []
    for fr, (_, d), (jo, jd) in zip(frs, got, want):
        st, so = seq(st, j_pc(fr))
        dist = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                   for a, b in ((jo.re, so.re), (jo.im, so.im)))
        rows.append((d, jd, dist))
    return rows


def test_bench_configuration_flagged_on_both_sides(ref):
    """At bandwidth 0.00628 a 512-sample warm-up does not bring a chunk's
    guess onto the sequential trajectory: every frame is flagged and none
    is exact, in the port as in JAX's form, and over 8 chained frames
    JAX's own chunked output does not stay within its test's 2e-2 of its
    sequential scan from the third frame on.  So that tolerance holds
    there only for certified or fallen-back frames (chip_smoke.py phase
    12)."""
    rows = bench_configuration(8)
    for d, jd, _ in rows:
        assert d["residual"] >= LOCKED and jd["residual"] >= LOCKED, (d, jd)
        assert not d["exact"] and not jd["exact"]
    assert max(dist for _, _, dist in rows[2:]) > 2e-2, rows


@pytest.mark.parametrize("order", [2, 4])
def test_batched_plain_matches_scalar_plain(order):
    """costas_batched's plain form against one costas_scalar_plain call a
    row, from per-row states (a phase outside ±2π among them)."""
    rows = [bpsk(512, 0.004 * (k - 1), seed=30 + k, order=order)
            for k in range(3)]
    xr = torch.from_numpy(np.stack([r[0] for r in rows]))
    xi = torch.from_numpy(np.stack([r[1] for r in rows]))
    states = [torch.tensor(v, dtype=torch.float32)
              for v in ([0.0, 7.5, -0.4], [0.0, 0.002, -0.003],
                        [0.0, 0.1, 0.0])]
    alpha, beta = demod.costas_gains(0.02)
    hk.reset_launch_counts()
    got = hk.costas_batched(xr, xi, *states, order, alpha, beta)
    assert hk.costas_batched.launches == 0
    assert got[0].shape == (3, 512) and got[2].shape == (3,)
    for b in range(3):
        want = hk.costas_scalar_plain(xr[b], xi[b], *(s[b] for s in states),
                                      order, alpha, beta)
        for g, w, tol in zip([v[b] for v in got], want,
                             (OUT_TOL, OUT_TOL, PHASE_TOL, FREQ_TOL,
                              OUT_TOL)):
            assert float((g - w).abs().max()) <= tol


def test_batched_contract():
    """[G, R, L] rows, states broadcast from floats, empty rows and empty
    row sets, shape and order checks; NaN limits refused off the CPU."""
    x = torch.from_numpy(np.stack(bpsk(300, 0.01, seed=40))).reshape(2, 3,
                                                                      100)
    g = hk.costas_batched(x[0][None], x[1][None], 0.0, 0.0, 0.0, 2, 0.1,
                          0.01)
    assert g[0].shape == (1, 3, 100) and g[2].shape == (1, 3)
    e = hk.costas_batched(x[0, :, :0], x[1, :, :0], 0.5, 0.1, 0.2, 2, 0.1,
                          0.01)
    assert e[0].shape == (3, 0)
    assert [float(v[1]) for v in e[2:]] == pytest.approx([0.5, 0.1, 0.2])
    with pytest.raises(ValueError, match="order"):
        hk.costas_batched(x[0], x[1], 0.0, 0.0, 0.0, 3, 0.1, 0.01)
    with pytest.raises(ValueError, match="one shape"):
        hk.costas_batched(x[0], x[1, :2], 0.0, 0.0, 0.0, 2, 0.1, 0.01)
    with pytest.raises(ValueError, match=r"\[B, L\]"):
        hk.costas_batched(x[0, 0], x[1, 0], 0.0, 0.0, 0.0, 2, 0.1, 0.01)
    m = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="NaN"):
        hk.costas_batched(m, m, 0.0, 0.0, 0.0, 2, 0.1, 0.01, float("nan"))


@pytest.mark.parametrize("rows, sms, body", [
    (1, 132, "block"), (256, 132, "block"), (264, 132, "block"),
    (265, 132, "lane"), (528, 132, "lane"), (1024, 132, "lane"),
    (2048, 114, "lane"), (8192, 132, "lane"), (132, 66, "block"),
    (133, 66, "lane"), (3, 1, "lane")])
def test_costas_body_picker(rows, sms, body):
    """The batched entry's body: the block body while each row has a
    block slot at one chain's rate (two blocks an SM), the lane body past
    it."""
    assert hk.COSTAS_FULL_RATE_BLOCKS == 2
    assert hk._pick_costas_body(rows, sms) == body


def test_batched_body_argument():
    """``body`` is None, "block" or "lane"; an unknown name raises on any
    device.  On the CPU every body is the plain form; ``costas_body``
    names CUDA bodies only."""
    x = torch.from_numpy(np.stack(bpsk(96, 0.01, seed=41))).reshape(2, 3, 32)
    args = (x[0], x[1], 0.2, 0.001, 0.0, 2, 0.1, 0.01)
    want = hk.costas_batched_plain(*args)
    for body in (None, *hk.COSTAS_BODIES):
        got = hk.costas_batched(*args, body=body)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert hk.COSTAS_BODIES == ("block", "lane")
    for bad in ("warp", "Lane", 1):
        with pytest.raises(ValueError, match="unknown Costas body"):
            hk.costas_batched(*args, body=bad)
    m = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="unknown Costas body"):
        hk.costas_batched(m, m, 0.0, 0.0, 0.0, 2, 0.1, 0.01, body="rows")
    with pytest.raises(ValueError, match="CUDA"):
        hk.costas_body(4, "cpu")


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

def card_rows(card, b, n, order, seed):
    rows = [bpsk(n, 0.005, seed=seed + k, order=order, amp=0.05)
            for k in range(b)]
    x = torch.from_numpy(np.stack([np.stack(r) for r in rows], 1))
    return x.to(card)                      # [2, b, n]


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
def test_batched_kernel_matches_plain_on_card(card, order):
    """Bit for bit against its plain form and, row by row, against
    costas_scalar on that row alone, from per-row states with phases
    outside ±2π and a frequency at the clamp."""
    x = card_rows(card, 8, 4096, order, seed=50)
    st = (torch.tensor([0.0, 0.3, -1.0, 7.5, -9.0, 2.0, 100.0, -0.5],
                       device=card),
          torch.tensor([0.0, 0.001, -0.002, 0.003, 0.01, -0.01, 0.0, 0.004],
                       device=card),
          torch.zeros(8, device=card))
    args = (x[0], x[1], *st, order, *demod.costas_gains(0.00628), -0.01,
            0.01)
    before = hk.costas_batched.launches
    got = hk.costas_batched(*args)
    torch.cuda.synchronize()
    assert hk.costas_batched.launches == before + 1
    want = hk.costas_batched_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for b in range(8):
        one = hk.costas_scalar(x[0, b], x[1, b], *(s[b] for s in st),
                               *args[5:])
        assert all(torch.equal(g, w[b]) for g, w in zip(one, got))


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
def test_batched_kernel_strided_windows_on_card(card, order):
    """Overlapping windows read in place ([nch, w + c] at a stride of c,
    and [S, nch, w + c] over S streams) equal the same rows copied."""
    x = card_rows(card, 3, 4096 + 300, order, seed=60)
    c, w, nch = 1000, 300, 4
    alpha, beta = demod.costas_gains(0.02)
    for view in ((nch, w + c), (3, nch, w + c)):
        stride = (c, 1) if len(view) == 2 else (x.shape[-1], c, 1)
        win = [e.as_strided(view, stride) for e in x]
        got = hk.costas_batched(*win, 0.1, 0.002, 0.0, order, alpha, beta)
        want = hk.costas_batched(*(v.contiguous() for v in win), 0.1, 0.002,
                                 0.0, order, alpha, beta)
        torch.cuda.synchronize()
        assert all(torch.equal(g, v) for g, v in zip(got, want))


@pytest.mark.cuda
def test_chunked_on_card_counts_and_exact(card):
    """The chunked loop on the card: three batched launches a frame and
    no other kernel; an exact frame equals one costas_scalar call over the
    joined stream, bit for bit; a fallen-back frame equals it too."""
    xr, xi = bpsk(4 * FRAME, 0.005, seed=70)
    x = torch.from_numpy(np.stack([xr, xi])).to(card)
    alpha, beta = demod.costas_gains(0.0628)
    whole = hk.costas_scalar(x[0], x[1], 0.0, 0.0, 0.0, 2, alpha, beta)
    for fb in (None, 1e-30):
        run = demod.make_costas_loop_chunked(0.0628, 2, chunk=CHUNK,
                                             warmup=256,
                                             exact_fallback_residual=fb)
        st = run.init_state(card)
        hk.reset_launch_counts()
        for k in range(4):
            sl = slice(k * FRAME, (k + 1) * FRAME)
            st, o, d = run(st, planar.PC(x[0, sl], x[1, sl]))
            if bool(d["exact"]) or fb is not None:
                assert torch.equal(o.re, whole[0][sl])
                assert torch.equal(o.im, whole[1][sl])
        counts = {k: v for k, v in hk.launch_counts().items() if v}
        assert counts["costas_batched"] == 12
        assert counts.get("costas_scalar", 0) % 2 == 0


def row_states(b, card, seed):
    """Per-row (phase, freq, error) of b rows: phases over ±12 (outside
    ±2π among them), frequencies over ±0.008, errors over ±1."""
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.uniform(-s, s, b).astype(np.float32),
                              device=card) for s in (12.0, 0.008, 1.0))


def held_to_scalar(x, st, got, order, gains):
    """Each row of a batched result equals costas_scalar on that row."""
    for b in range(x.shape[1]):
        one = hk.costas_scalar(x[0, b], x[1, b], *(s[b] for s in st), order,
                               *gains)
        assert all(torch.equal(o, g[b]) for o, g in zip(one, got)), b


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 4096])
@pytest.mark.parametrize("b", [1, 31, 32, 33, 1024])
def test_lane_body_matches_block_and_scalar_on_card(card, b, n, order):
    """The lane body against the block body and against costas_scalar on
    each row, bit for bit, over partial warps, ragged lengths and empty
    rows, from per-row states."""
    x = card_rows(card, b, n, order, seed=80 + b)
    st = row_states(b, card, seed=n)
    gains = (*demod.costas_gains(0.00628), -0.01, 0.01)
    lane = hk.costas_batched(x[0], x[1], *st, order, *gains, body="lane")
    block = hk.costas_batched(x[0], x[1], *st, order, *gains, body="block")
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(lane, block))
    held_to_scalar(x, st, lane, order, gains)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
def test_lane_body_mixed_wraps_in_a_warp_on_card(card, order):
    """One warp whose lanes wrap in the same group and lanes that do not
    (phases just below 2π moving up, beside phases at 0 standing still),
    then the same state on every lane, so that the warp's vote passes:
    bit for bit the block body and costas_scalar on each row."""
    n, b = 4096, 32
    x = card_rows(card, b, n, order, seed=90)
    near = torch.arange(b, device=card) % 2 == 0
    phase = torch.where(near, 6.2 + 0.002 * torch.arange(b, device=card),
                        torch.zeros(b, device=card))
    freq = torch.where(near, torch.full((b,), 0.008, device=card),
                       torch.zeros(b, device=card))
    gains = (*demod.costas_gains(0.00628), -0.01, 0.01)
    same = x[:, :1].expand(2, b, n)
    for xs, st in ((x, (phase, freq, torch.zeros(b, device=card))),
                   (same, (0.3, 0.001, 0.0))):
        lane = hk.costas_batched(xs[0], xs[1], *st, order, *gains,
                                 body="lane")
        block = hk.costas_batched(xs[0], xs[1], *st, order, *gains,
                                  body="block")
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(lane, block))
        rows = tuple(torch.as_tensor(v, device=card).expand(b) for v in st)
        held_to_scalar(xs, rows, lane, order, gains)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4])
def test_lane_body_strided_and_unaligned_on_card(card, order):
    """[nch, w + c] and [G, nch, w + c] windows read in place, at a
    16-byte stride and at a stride that leaves 16-byte alignment, and rows
    that start one float past it: the lane body equals the same rows copied
    and the block body, bit for bit."""
    x = card_rows(card, 3, 4400, order, seed=95)
    alpha, beta = demod.costas_gains(0.02)
    for c, w, off in ((1000, 300, 0), (1001, 300, 0), (1000, 300, 1)):
        nch = 4
        for view in ((nch, w + c), (3, nch, w + c)):
            stride = (c, 1) if len(view) == 2 else (x.shape[-1], c, 1)
            win = [e.as_strided(view, stride, e.storage_offset() + off)
                   for e in x]
            lane = hk.costas_batched(*win, 0.1, 0.002, 0.0, order, alpha,
                                     beta, body="lane")
            block = hk.costas_batched(*win, 0.1, 0.002, 0.0, order, alpha,
                                      beta, body="block")
            copied = hk.costas_batched(*(v.contiguous() for v in win), 0.1,
                                       0.002, 0.0, order, alpha, beta,
                                       body="lane")
            torch.cuda.synchronize()
            assert all(torch.equal(g, v) for g, v in zip(lane, block))
            assert all(torch.equal(g, v) for g, v in zip(lane, copied))


@pytest.mark.cuda
def test_costas_body_rule_on_card(card):
    """On the card the rule takes the block body up to two of its blocks
    an SM and the lane body past that."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    slots = sms * hk.COSTAS_FULL_RATE_BLOCKS
    assert hk.costas_body(slots, card) == "block"
    assert hk.costas_body(slots + 1, card) == "lane"
