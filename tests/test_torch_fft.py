"""Port parity: the FFT (B.5), the signal source, the elementwise math and
the core blocks of the spectrum chain.

The same numpy inputs go to the JAX function and the port's torch form on
the CPU.  Tolerances: transforms within 1e-5 × max|ref| (float32 sums of
n terms in another order: two-stage DFT matmuls, ``torch.fft``, the
Pallas kernel's interpret mode); the signal source within 2e-6 rad of
phase (float32 cos/sin of the same angles); elementwise ops within
1e-6 relative (the same float32 op, another libm); the spectrum chain
flowgraph over 3 frames within 1e-4 × max|ref|.  On a card (``cuda``
marker; skipped without one) the kernel is held to its plain form within
1e-4 × max|plain|.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu.dsp import elementwise as j_ew
    from clenabled_tpu.dsp import fft as j_fft
    from clenabled_tpu.dsp import pallas_kernels as j_pk
    from clenabled_tpu.dsp import planar as j_planar
    from clenabled_tpu.dsp import siggen as j_siggen
    from clenabled_tpu.streaming import Flowgraph as JFlowgraph
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import elementwise as ew
from clenabled_tpu_torch.dsp import fft
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.dsp import planar, siggen, window
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
    return torch.device("cuda", 0)


def samples(shape, seed):
    return np.random.default_rng(seed).standard_normal(
        (2,) + tuple(shape)).astype(np.float32)


def tpc(x):
    return planar.PC(torch.from_numpy(x[0]), torch.from_numpy(x[1]))


def jpc(x):
    return j_planar.PC(jnp.asarray(x[0]), jnp.asarray(x[1]))


CASES = [(d, w, s) for d in ("fwd", "rev") for w in (False, True)
         for s in (False, True)]


def _dir(name):
    return (fft.FORWARD, j_fft.FORWARD) if name == "fwd" else (
        fft.REVERSE, j_fft.REVERSE)


# --------------------------------------------------------------------------
# the transforms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,win,shift", CASES)
def test_complex_and_planar_forms_match_jax(ref, d, win, shift):
    """fft, fft_stream (complex64, torch.fft), fft_planar and
    fft_stream_planar(use_pallas=False) against JAX."""
    n = 512
    x = samples((4, n), seed=1)
    w = window.blackman_harris(n) if win else None
    td, jd = _dir(d)
    z = (x[0] + 1j * x[1]).astype(np.complex64)
    close(fft.fft(torch.from_numpy(z), td, w, shift),
          j_fft.fft(z, jd, w, shift))
    close(fft.fft_stream(torch.from_numpy(z.reshape(-1)), n, td, w, shift),
          j_fft.fft_stream(z.reshape(-1), n, jd, w, shift))
    got = fft.fft_planar(tpc(x), td, w, shift)
    want = j_fft.fft_planar(jpc(x), jd, w, shift)
    close(got.re, want.re)
    close(got.im, want.im)
    flat = x.reshape(2, -1)
    got = fft.fft_stream_planar(tpc(flat), n, td, w, shift, use_pallas=False)
    want = j_fft.fft_stream_planar(jpc(flat), n, jd, w, shift,
                                   use_pallas=False)
    close(got.re, want.re)
    close(got.im, want.im)


@pytest.mark.parametrize("d", ["fwd", "rev"])
def test_real_input_matches_jax(ref, d):
    """The float path: the hermitian mirror forward, the unscaled inverse
    returned as complex."""
    x = samples((3, 256), seed=2)[0]
    td, jd = _dir(d)
    w = window.hann(256)
    got = fft.fft(torch.from_numpy(x), td, w)
    assert got.dtype == torch.complex64
    close(got, j_fft.fft(x, jd, w))


@pytest.mark.parametrize("size,inverse,win", [(1024, False, False),
                                              (1024, True, True),
                                              (2048, False, True)])
def test_plain_form_matches_pallas_kernel(ref, size, inverse, win):
    """fft_batched_fused (plain) against the Pallas kernel in interpret
    mode and against fft_stream_planar(use_pallas=False).  (Interpret mode
    at 256 points takes over ten seconds a case; the card tests cover
    256 and 16384.)"""
    x = samples((4 * size,), seed=size)
    w = window.blackman_harris(size) if win else None
    want = j_pk.fft_batched_fused(jnp.asarray(x[0]), jnp.asarray(x[1]), size,
                                  inverse=inverse, window=w, interpret=True)
    hk.reset_launch_counts()
    got = hk.fft_batched_fused(torch.from_numpy(x[0]), torch.from_numpy(x[1]),
                               size, inverse=inverse, window=w)
    assert hk.fft_batched_fused.launches == 0
    close(got[0], want[0])
    close(got[1], want[1])
    jd = j_fft.REVERSE if inverse else j_fft.FORWARD
    xla = j_fft.fft_stream_planar(jpc(x), size, jd, w, use_pallas=False)
    close(got[0], xla.re)
    close(got[1], xla.im)


@pytest.mark.parametrize("d", ["fwd", "rev"])
def test_kernel_shift_matches_jax_routing(ref, d):
    """The kernel's in-index shift against JAX's kernel route, whose shift
    is a concat around the kernel (fft_stream_planar(use_pallas=True))."""
    size = 1024
    x = samples((2 * size,), seed=3)
    w = window.blackman_harris(size)
    td, jd = _dir(d)
    want = j_fft.fft_stream_planar(jpc(x), size, jd, w, shift=True,
                                   use_pallas=True)
    got = fft.fft_stream_planar(tpc(x), size, td, w, shift=True,
                                use_pallas=True)
    close(got.re, want.re)
    close(got.im, want.im)


def test_routing(monkeypatch):
    """"auto" takes the kernel wrapper only with a card and n2 ≥ 8 (JAX's
    rule); True forces it within n2 ∈ [2, 128]; the wrapper runs its plain
    form on CPU tensors and counts no launch."""
    calls = []
    real = hk.fft_batched_fused

    def spy(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(hk, "fft_batched_fused", spy)
    x = tpc(samples((4096,), seed=4))
    fft.fft_stream_planar(x, 1024)
    assert calls == []                         # no card: the plain DFT
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fft.fft_stream_planar(x, 1024)
    fft.fft_stream_planar(x, 512)              # n2 = 4 < 8: plain
    fft.fft_stream_planar(x, 512, use_pallas=True)
    fft.fft_stream_planar(x, 128, use_pallas=True)     # n2 = 1: outside
    fft.fft_stream_planar(x, 1024, use_pallas=False)
    assert calls == [1024, 512]
    assert hk.fft_size_covered(256) and hk.fft_size_covered(16384)
    assert not hk.fft_size_covered(128) and not hk.fft_size_covered(32768)
    assert not hk.fft_size_covered(384)
    with pytest.raises(ValueError, match="multiple of fft_size"):
        fft.fft_stream_planar(x, 3000)
    with pytest.raises(ValueError, match="power of two"):
        hk.fft_batched_fused(x.re, x.im, 384)
    with pytest.raises(ValueError, match="window length"):
        hk.fft_batched_fused(x.re, x.im, 1024, window=np.ones(512))


@pytest.mark.parametrize("lead", [(3,), (2, 2)], ids=["2-D", "3-D"])
def test_forced_kernel_folds_leading_axes(ref, monkeypatch, lead):
    """use_pallas=True on a stream of any rank reaches the kernel's entry
    once, the leading axes folded into its vectors (not the plain DFT),
    and matches the plain route and JAX's fft_stream_planar."""
    calls = []
    real = hk.fft_batched_fused

    def spy(xr, *a, **k):
        calls.append(tuple(xr.shape))
        return real(xr, *a, **k)

    monkeypatch.setattr(hk, "fft_batched_fused", spy)
    size = 1024
    x = samples(lead + (2 * size,), seed=7)
    w = window.blackman_harris(size)
    got = fft.fft_stream_planar(tpc(x), size, fft.FORWARD, w, shift=True,
                                use_pallas=True)
    assert calls == [(int(np.prod(lead)) * 2 * size,)]
    assert tuple(got.re.shape) == tuple(got.im.shape) == lead + (2 * size,)
    plain = fft.fft_stream_planar(tpc(x), size, fft.FORWARD, w, shift=True,
                                  use_pallas=False)
    want = j_fft.fft_stream_planar(jpc(x), size, j_fft.FORWARD, w,
                                   shift=True)
    for g, p_, j_ in ((got.re, plain.re, want.re), (got.im, plain.im,
                                                    want.im)):
        close(g, p_)
        close(g, j_)


def test_kernel_batch_rule(monkeypatch):
    """torch.func.vmap of the kernel's wrapper enters its operator once for
    all frames — batched on any axis, an unbatched operand broadcast, two
    vmaps nested — within 1e-5 × max of one call a frame; a batched
    window raises."""
    entries = []
    plain = hk.fft_batched_fused_plain

    def counted(xr, *a, **k):
        entries.append(tuple(xr.shape))
        return plain(xr, *a, **k)

    monkeypatch.setattr(hk, "fft_batched_fused_plain", counted)
    size, k = 512, 3
    w = torch.as_tensor(window.blackman_harris(size))
    x = torch.from_numpy(samples((k, 2 * size), seed=8))

    def f(re, im):
        return hk.fft_batched_fused(re, im, size, False, w, True)

    want = [f(x[0, j], x[1, j]) for j in range(k)]
    entries.clear()
    for got in (torch.func.vmap(f)(x[0], x[1]),
                torch.func.vmap(f, in_dims=(1, 1))(x[0].T, x[1].T)):
        for j in range(k):
            close(got[0][j], want[j][0])
            close(got[1][j], want[j][1])
    bcast = torch.func.vmap(f, in_dims=(0, None))(x[0], x[1, 0])
    close(bcast[1][2], f(x[0, 2], x[1, 0])[1])
    nested = torch.func.vmap(torch.func.vmap(f))(x[0].reshape(k, 1, -1),
                                                 x[1].reshape(k, 1, -1))
    close(nested[0][1, 0], want[1][0])
    assert entries == [(k * 2 * size,)] * 3 + [(2 * size,)] + [
        (k * 2 * size,)]
    with pytest.raises(ValueError, match="window"):
        torch.func.vmap(lambda re, win: hk.fft_batched_fused(
            re, re, size, window=win))(x[0], w.expand(k, size))


def stockham(x, radices, tw, inverse=False):
    """numpy model of the kernel core's passes (csrc/fft_core.cuh) over the
    last axis, in complex128 with the complex64 pass twiddles: pass p of
    radix R after NS points reads item j's inputs at j + r·n/R, multiplies
    input r by tw_p[r, j mod NS] (conjugated for the inverse), takes the
    R-point DFT and writes output r at (j // NS)·NS·R + r·NS + j mod NS."""
    n = x.shape[-1]
    y = np.asarray(x, np.complex128)
    sign = 1 if inverse else -1
    ns, off = 1, 0
    for r in radices:
        m = n // r
        j = np.arange(m)
        v = y[..., j[None, :] + (np.arange(r) * m)[:, None]]       # [.., r, m]
        if ns > 1:
            w = tw[off:off + r * ns].astype(np.complex128).reshape(r, ns)
            v = v * (np.conj(w) if inverse else w)[:, j % ns]
            off += r * ns
        dft = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r))
                     / r)
        v = np.einsum("ab,...bm->...am", dft, v)
        dst = ((j // ns) * ns * r + j % ns)[None, :] + (np.arange(r) * ns)[:, None]
        out = np.empty_like(y)
        out[..., dst] = v
        y, ns = out, ns * r
    assert off == len(tw) and ns == n
    return y


SIZES = [256, 512, 1024, 2048, 4096, 8192, 16384]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd_order",
                                                        "rev_order"])
def test_kernel_fft_plan_matches_numpy(size, reverse):
    """The radix schedule and pass twiddles the FFT and OFS kernels are
    launched with, through a numpy model of the same passes, against
    np.fft forward and inverse within 1e-5 × max|ref|."""
    radices, tw = hk.fft_passes(size, reverse)
    logn = size.bit_length() - 1
    want = (16,) * (logn // 4) + ((1 << logn % 4,) if logn % 4 else ())
    assert radices == (want[::-1] if reverse else want)
    assert tw.dtype == np.complex64
    x = samples((3, size), seed=size + reverse)
    z = x[0] + 1j * x[1]
    close(stockham(z, radices, tw), np.fft.fft(z))
    close(stockham(z, radices, tw, inverse=True), np.fft.ifft(z) * size)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd_order",
                                                        "rev_order"])
def test_kernel_exchange_layout(size, reverse):
    """The shared-memory exchange of csrc/fft_core.cuh, modelled for one
    block (V = max(1, 128/T) vectors of T = n/16 threads, 16 points each):
    every pass's stores cover the block's buffer exactly once, its loads
    read back each logical index from where it was stored, and each warp
    access of 32 words hits 32 distinct banks."""
    radices = hk.fft_passes(size, reverse)[0]
    t_per_vec = size // 16
    nvec = max(1, 128 // t_per_vec)
    th = np.arange(nvec * t_per_vec)
    lv, t = th // t_per_vec, th % t_per_vec
    vx = (lv * t_per_vec) & 31

    def swz(a, ns, r):
        return a if ns >= 32 else a ^ (((a // (ns * r)) * ns) & 31)

    def conflict_free(addr):
        banks = np.sort((addr % 32).reshape(-1, 32), axis=1)
        return bool((np.diff(banks, axis=1) > 0).all())

    ns = 1
    for r, r2 in zip(radices, radices[1:]):
        owner = np.full(nvec * size, -1)
        for s in range(16 // r):
            j = t + s * t_per_vec
            base = (j // ns) * ns * r + j % ns
            for k in range(r):
                logical = base + k * ns
                addr = lv * size + (swz(logical, ns, r) ^ vx)
                assert conflict_free(addr)
                assert (owner[addr] == -1).all()
                owner[addr] = lv * size + logical
        assert (owner >= 0).all()
        for s in range(16 // r2):
            for k in range(r2):
                logical = t + s * t_per_vec + k * (size // r2)
                addr = lv * size + (swz(logical, ns, r) ^ vx)
                assert conflict_free(addr)
                assert (owner[addr] == lv * size + logical).all()
        ns *= r


def test_kernel_fft_plan_schedules():
    assert hk.fft_passes(2048)[0] == (16, 16, 8)
    assert hk.fft_passes(16384)[0] == (16, 16, 16, 4)
    assert hk.fft_passes(16384, reverse=True)[0] == (4, 16, 16, 16)
    assert hk.fft_passes(256)[0] == (16, 16)
    for n in (128, 384, 32768):
        with pytest.raises(ValueError, match="256 to 16384"):
            hk.fft_passes(n)


def test_fused_supported_matches_jax(ref):
    x1, x2 = tpc(samples((4096,), seed=5)), tpc(samples((2, 2048), seed=5))
    j1, j2 = jpc(samples((4096,), seed=5)), jpc(samples((2, 2048), seed=5))
    for size in (128, 256, 512, 1024, 2048, 4096, 384, 16384):
        assert fft._fused_fft_supported(x1, size) == \
            j_fft._fused_fft_supported(j1, size)
        assert fft._fused_fft_supported(x2, size) == \
            j_fft._fused_fft_supported(j2, size)


# --------------------------------------------------------------------------
# the signal source and the elementwise math
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["complex", "planar", "float_cos",
                                  "float_sin"])
def test_signal_source_matches_jax(ref, kind):
    """Frames and the carried phase over 4 frames (the phase wraps)."""
    fs, f0, n = 1e6, 123e3, 4096
    wf = siggen.SIGSOURCE_SIN if kind == "float_sin" else siggen.SIGSOURCE_COS
    kw = dict(planar=kind == "planar")
    if kind.startswith("float"):
        kw["dtype"] = np.float32
    j_init, j_gen = j_siggen.make_signal_source(fs, wf, f0, 1.5, n, **kw)
    t_init, t_gen = siggen.make_signal_source(fs, wf, f0, 1.5, n,
                                              device="cpu", **kw)
    js, ts = j_init(), t_init()
    for _ in range(4):
        js, jf = j_gen(js)
        ts, tf = t_gen(ts)
        if kind == "planar":
            close(tf.re, jf.re, 2e-6)
            close(tf.im, jf.im, 2e-6)
        else:
            close(tf, jf, 2e-6)
        assert float(ts.phase) == pytest.approx(float(js.phase), abs=1e-6)


def test_signal_source_int_and_default_device(monkeypatch):
    init, gen = siggen.make_signal_source(48e3, 1, 1e3, 100.0, 480,
                                          dtype=np.int32, device="cpu")
    _, frame = gen(init())
    assert frame.dtype == torch.int32 and int(frame[0]) == 100
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        siggen.make_signal_source(48e3, 1, 1e3, 1.0, 480)


OPS = ["MATHOP_MULTIPLY", "MATHOP_ADD", "MATHOP_SUBTRACT",
       "MATHOP_COMPLEX_CONJUGATE", "MATHOP_MULTIPLY_CONJUGATE", "MATHOP_LOG10",
       "MATHOP_LOG", "MATHOP_SNR_HELPER", "MATHOP_EMPTY",
       "MATHOP_EMPTY_W_COPY"]


@pytest.mark.parametrize("op", OPS)
def test_math_ops_match_jax(ref, op):
    code = getattr(ew, op)
    assert code == getattr(j_ew, op)
    a, b = samples((257,), seed=6)
    if op in ("MATHOP_LOG10", "MATHOP_LOG", "MATHOP_SNR_HELPER"):
        a, b = np.abs(a) + 0.1, np.abs(b) + 0.1
        pairs = [(a, b)]
    else:
        za = (a + 1j * b).astype(np.complex64)
        pairs = [(a, b), (za, za[::-1].copy())]
    for x, y in pairs:
        got = ew.math_op(code, torch.from_numpy(x), torch.from_numpy(y))
        close(got, j_ew.math_op(code, jnp.asarray(x), jnp.asarray(y)), 1e-6)
    if op in ("MATHOP_LOG10", "MATHOP_LOG", "MATHOP_SNR_HELPER"):
        with pytest.raises(ValueError, match="planar"):
            ew.math_op(code, tpc(samples((4,), 0)), tpc(samples((4,), 1)))
        return
    x, y = samples((257,), seed=7), samples((257,), seed=8)
    got = ew.math_op(code, tpc(x), tpc(y))
    want = j_ew.math_op(code, jpc(x), jpc(y))
    close(got.re, want.re, 1e-6)
    close(got.im, want.im, 1e-6)


def test_conversions_match_jax(ref):
    x = samples((300,), seed=9)
    z = (x[0] + 1j * x[1]).astype(np.complex64)
    pc = planar.from_complex(z)
    assert np.array_equal(np_of(pc.re), np.asarray(j_planar.from_complex(z).re))
    assert np.array_equal(np_of(planar.to_complex(pc)),
                          j_planar.to_complex(j_planar.from_complex(z)))
    assert planar.from_complex(torch.from_numpy(z)).im.dtype == torch.float32
    for tin, jin in ((torch.from_numpy(z), z), (tpc(x), jpc(x))):
        close(ew.complex_to_mag(tin), j_ew.complex_to_mag(jin), 1e-6)
        close(ew.complex_to_arg(tin), j_ew.complex_to_arg(jin), 1e-6)
        close(ew.multiply_const(tin, 2.5) if not isinstance(tin, planar.PC)
              else ew.multiply_const(tin, 2.5).re,
              j_ew.multiply_const(jin, 2.5) if not isinstance(tin, planar.PC)
              else j_ew.multiply_const(jin, 2.5).re, 1e-6)
    mag, ph = np.abs(x[0]), x[1]
    close(ew.mag_phase_to_complex(mag, ph),
          j_ew.mag_phase_to_complex(mag, ph), 1e-6)
    got = ew.mag_phase_to_complex(mag, ph, planar_out=True)
    close(got.im, j_ew.mag_phase_to_complex(mag, ph, planar_out=True).im, 1e-6)
    got = ew.add_const(tpc(x), 0.5 - 2j)
    want = j_ew.add_const(jpc(x), 0.5 - 2j)
    close(got.im, want.im, 1e-6)
    got = ew.add_const(tpc(x), torch.tensor(0.5 - 2j, dtype=torch.complex64))
    close(got.re, want.re, 1e-6)
    pos = np.abs(x[0]) + 0.1
    close(ew.log10(pos, 10.0, 3.0), j_ew.log10(pos, 10.0, 3.0), 1e-6)
    close(ew.log(pos), j_ew.log(pos), 1e-6)
    close(ew.snr_helper(pos, pos[::-1].copy(), 20.0, -1.0),
          j_ew.snr_helper(pos, pos[::-1].copy(), 20.0, -1.0), 1e-6)
    b = np.random.default_rng(10).integers(-128, 128, 64).astype(np.int8)
    close(ew.char_to_complex(b), j_ew.char_to_complex(b), 1e-7)


# --------------------------------------------------------------------------
# the blocks and the spectrum chain
# --------------------------------------------------------------------------

def _chain(mod, fg, planar_, n, **compile_kw):
    g = fg()
    src = mod.SignalSource(1e6, 1, 250e3, 1.0, n, planar=planar_)
    f = mod.Fft(2048, window=window.blackman_harris(2048), shift=True)
    mc = mod.MultiplyConst(2.0)
    mag = mod.ComplexToMag()
    g.connect(src, f)
    g.connect(f, mc)
    g.connect(mc, mag)
    t = g.tap(mag)
    return g.compile(**compile_kw), t, src


@pytest.mark.parametrize("planar_", [True, False], ids=["planar", "complex"])
def test_spectrum_chain_matches_jax(ref, planar_):
    """SignalSource → Fft(2048, blackman_harris, shift) → MultiplyConst(2)
    → ComplexToMag over 3 frames against the JAX flowgraph, and the tone
    in bin 1536 (250 kHz at 1 MS/s, shifted)."""
    n = 8192
    jr, jt, _ = _chain(j_blocks, JFlowgraph, planar_, n)
    tr, tt, _ = _chain(blocks, Flowgraph, planar_, n, device="cpu")
    for _ in range(3):
        want = jr.step()[jt]
        got = tr.step()[tt]
        close(got, want, FLOW_TOL)
        assert (got.reshape(-1, 2048).argmax(-1) == 1536).all()


def test_signal_source_retune_and_hand_over(ref):
    """set_frequency keeps the carried phase (JAX's contract); a JAX
    Runner's SigGenState continues in the port."""
    n = 4096
    jr, jt, jsrc = _chain(j_blocks, JFlowgraph, True, n)
    tr, tt, tsrc = _chain(blocks, Flowgraph, True, n, device="cpu")
    jr.step()
    states = [tuple(np.asarray(v) for v in s) if isinstance(s, tuple)
              else np.asarray(s) for s in jr.states]
    tr.states = P.runner_state_from_reference(tr, states, [None] * 4)
    assert isinstance(tr.states[0], siggen.SigGenState)
    assert tr.states[0].phase.dim() == 0
    close(tr.step()[tt], jr.step()[jt], FLOW_TOL)
    jsrc.set_frequency(100e3)
    tsrc.set_frequency(100e3)
    jr.refresh() if hasattr(jr, "refresh") else None
    tr.refresh()
    close(tr.step()[tt], jr.step()[jt], FLOW_TOL)
    assert tsrc.frequency() == 100e3


def test_core_blocks_match_jax(ref):
    """MathOp and friends, the constants, the conversions, Log and
    SNRHelper as blocks, against JAX's blocks."""
    x, y = samples((512,), seed=11), samples((512,), seed=12)
    pos = np.abs(x) + 0.1
    cases = [
        ("Multiply", (), (x, y)), ("Add", (), (x, y)),
        ("Subtract", (), (x, y)), ("MultiplyConjugate", (), (x, y)),
        ("ComplexConjugate", (), (x,)), ("MultiplyConst", (1.5,), (x,)),
        ("AddConst", (0.25,), (x,)), ("ComplexToMag", (), (x,)),
        ("ComplexToArg", (), (x,)), ("ComplexToMagPhase", (), (x,)),
        ("Log", (10.0, 1.0), (pos[0],)), ("SNRHelper", (20.0,), pos),
        ("MagPhaseToComplex", (), (pos[0], x[1])),
    ]
    for name, args, ins in cases:
        tb, jb = getattr(blocks, name)(*args), getattr(j_blocks, name)(*args)
        assert getattr(blocks, "cl" + {"MultiplyConst": "MultConst",
                                       "SNRHelper": "SNR"}.get(name, name)) \
            is getattr(blocks, name)
        planar_in = ins[0].ndim == 2
        t_in = [tpc(a) if planar_in else torch.from_numpy(a) for a in ins]
        j_in = [jpc(a) if planar_in else jnp.asarray(a) for a in ins]
        _, t_out, _ = tb.apply(tb.init_state(), t_in)
        _, j_out, _ = jb.apply(jb.init_state(), j_in)
        for g_, w_ in zip(t_out, j_out):
            if isinstance(g_, planar.PC):
                close(g_.re, w_.re, 1e-6)
                close(g_.im, w_.im, 1e-6)
            else:
                close(g_, w_, 1e-6)
    empty = blocks.MathOp(ew.MATHOP_EMPTY)
    assert empty.n_inputs == 1 and empty.apply((), [tpc(x)])[1][0].re is not None
    assert blocks.clFFT is blocks.Fft and blocks.clLog10 is blocks.Log


def test_clenabled_fft_cli_arguments():
    from clenabled_tpu_torch.tools import test_clenabled_fft as cli

    a = cli.parse_args(["4096", "--fft-size", "1024", "--window",
                        "--fft-shift", "--reverse"])
    assert (a.blocksize, a.fft_size, a.window, a.fft_shift, a.reverse) == (
        4096, 1024, True, True, True)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            cli.main([])


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("inverse,win,shift", [(False, False, False),
                                               (True, False, False),
                                               (False, True, True),
                                               (True, True, True)])
def test_fft_kernel_matches_plain_on_card(card, size, inverse, win, shift):
    """21 vectors: not a multiple of the 2-16 vectors a block carries below
    4096 points, so the ragged last block is masked."""
    x = torch.from_numpy(samples((21 * size,), seed=20)).to(card)
    w = (torch.as_tensor(window.blackman_harris(size), device=card)
         if win else None)
    args = (x[0], x[1], size, inverse, w, shift)
    before = hk.fft_batched_fused.launches
    got = hk.fft_batched_fused(*args)
    torch.cuda.synchronize()
    assert hk.fft_batched_fused.launches == before + 1
    want = hk.fft_batched_fused_plain(*args)
    close(got[0], want[0], FLOW_TOL)
    close(got[1], want[1], FLOW_TOL)
    if not (win or shift):
        c = torch.fft.ifft(torch.complex(x[0], x[1]).reshape(-1, size)) * size \
            if inverse else torch.fft.fft(torch.complex(x[0], x[1]).reshape(
                -1, size))
        close(got[0], c.real.reshape(-1), FLOW_TOL)


@pytest.mark.cuda
def test_spectrum_chain_on_card_launches_kernel(card):
    tr, tt, _ = _chain(blocks, Flowgraph, True, 1 << 16, device=card)
    before = hk.fft_batched_fused.launches
    out = tr.step()[tt]
    torch.cuda.synchronize()
    assert hk.fft_batched_fused.launches == before + 1
    assert (out.reshape(-1, 2048).argmax(-1) == 1536).all()
