"""Port parity: the two Hopper kernels of the FX step (B.1 with its flat
entry B.1b, and B.2).

On the CPU each wrapper runs its plain torch form, which is held to the
JAX package's Pallas kernel run in interpret mode with float32 MXU
operands (exact float32 on the CPU), at 1e-5 × max|ref|: float32 sums in
another order than XLA's.  On a card (``cuda`` marker; skipped without
one) each kernel is held to its plain form on the same device at
1e-4 × max|plain|, with TF32 off.  The FX kernel's register-tiled body
(``fx_reg_kernel``) is also replayed in numpy: its staging, its FIR
schedule and the bank of every warp-wide shared-memory access.
"""

import collections

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu.dsp import channelizer as j_chan
    from clenabled_tpu.dsp import pallas_kernels as j_pk
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch.dsp import channelizer as t_chan
from clenabled_tpu_torch.dsp import firdes as t_firdes
from clenabled_tpu_torch.dsp import hopper_kernels as hk

REL_CPU = 1e-5
REL_CARD = 1e-4


def close(got, want, rel):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.detach().cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


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


def _taps(m, ntaps0=None):
    if ntaps0 is None:
        fs = 100e6
        proto = t_firdes.low_pass(1.0, fs, fs / (2 * m) * 0.8,
                                  fs / (2 * m) * 0.2)
    else:
        proto = (np.sinc(np.linspace(-4, 4, ntaps0))
                 * np.hanning(ntaps0)).astype(np.float32)
    proto = np.concatenate([proto, np.zeros((-len(proto)) % m, np.float32)])
    return t_chan._pfb_constants(proto, m, m)


# (id, antennas, dtype, frame length, prototype taps, fd_pairs, xe_pairs,
# channels)
FX_CASES = [
    ("f32", 4, "float32", 2048, None, None, None, 16),
    ("bf16", 2, "bfloat16", 4096, None, None, None, 16),
    ("int8", 2, "int8", 4096, None, None, None, 16),
    ("pairs_autos", 4, "float32", 2048, None, [(0, 3), (2, 2)],
     [(0, 1), (2, 3), (1, 1), (3, 0)], 16),
    ("deep_1600", 2, "float32", 2048, 1600, None, None, 16),
    ("f32_m4", 4, "float32", 2048, None, None, None, 4),
    ("f32_m8", 3, "float32", 2048, None, None, None, 8),
    ("f32_m32", 4, "float32", 4096, None, None, None, 32),
    ("f32_m64", 4, "float32", 4096, None, None, None, 64),
    ("int8_m64", 4, "int8", 4096, None, None, None, 64),
    ("f32_m128", 4, "float32", 4096, None, None, None, 128),
]


def _fx_inputs(case, n=None, seed=0):
    _, a, dt, n0, ntaps0, fdp, xep, m = case
    n = n or n0
    taps_rm, ntaps = _taps(m, ntaps0)
    h = hk.fx_tail_len(dt, m, ntaps)
    rng = np.random.default_rng(seed)
    if dt == "int8":
        mk = lambda s: rng.integers(-127, 128, s).astype(np.int8)
    else:   # float32 values, bf16-representable for the bf16 cases
        mk = lambda s: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(getattr(torch, dt)).float().numpy()
    arrs = [mk((a, n)), mk((a, n)), mk((a, h)), mk((a, h))]
    return arrs, taps_rm, a, m, h, fdp, xep


def _torch(arr, dt, device="cpu"):
    return torch.from_numpy(arr).to(device=device, dtype=getattr(torch, dt))


def _jax(arr, dt):
    return jnp.asarray(arr, dtype=getattr(jnp, dt))


@pytest.mark.parametrize("case", FX_CASES, ids=[c[0] for c in FX_CASES])
def test_fx_plain_matches_jax_v2(ref, case):
    arrs, taps_rm, a, m, h, fdp, xep = _fx_inputs(case)
    dt = case[2]
    want_fd, want_g = j_pk.fx_correlate_streams_v2(
        *[_jax(x, dt) for x in arrs], taps_rm, a, m, tile_rows=h // 128,
        interpret=True, mxu_dtype=jnp.float32, fd_pairs=fdp, xe_pairs=xep)
    got_fd, got_g = hk.fx_correlate_streams_v2_plain(
        *[_torch(x, dt) for x in arrs], torch.from_numpy(taps_rm), a, m,
        fd_pairs=fdp, xe_pairs=xep)
    close(got_fd, want_fd, REL_CPU)
    close(got_g, want_g, REL_CPU)


def test_fx_wrapper_uses_plain_form_on_cpu():
    arrs, taps_rm, a, m, h, fdp, xep = _fx_inputs(FX_CASES[0], seed=1)
    hk.reset_launch_counts()
    args = [torch.from_numpy(x) for x in arrs] + [taps_rm, a, m]
    got = hk.fx_correlate_streams_v2(*args)
    want = hk.fx_correlate_streams_v2_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert hk.fx_correlate_streams_v2.launches == 0
    with pytest.raises(ValueError):   # a tail shorter than the tap reach
        hk.fx_correlate_streams_v2(*args[:2], args[2][:, :100],
                                   args[3][:, :100], taps_rm, a, m)


def _packed_inputs(nout, seed, a=4, m=16, ntaps0=None):
    taps_rm, ntaps = _taps(m, ntaps0)
    rng = np.random.default_rng(seed)
    comps = rng.standard_normal((2 * a, ntaps - 1 + nout * m)).astype(np.float32)
    y, hr = t_chan._pack_streams(torch.from_numpy(comps), taps_rm, m, ntaps,
                                 nout)
    return y.numpy(), hr.numpy(), a, m


def test_pfb_packed_plain_matches_jax(ref):
    y, hr, a, m = _packed_inputs(256, seed=5)
    want = j_pk.pfb_channelize_packed(y, hr, a, m, tile=64, interpret=True)
    got = hk.pfb_channelize_packed_plain(torch.from_numpy(y),
                                         torch.from_numpy(hr), a, m)
    close(got, want, REL_CPU)
    hk.reset_launch_counts()
    got_w = hk.pfb_channelize_packed(torch.from_numpy(y), torch.from_numpy(hr),
                                     a, m)
    assert torch.equal(got_w, got)
    assert hk.pfb_channelize_packed.launches == 0


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("a", [1, 4])
def test_pfb_packed_plain_matches_jax_by_shape(ref, m, a):
    """The plain form against the Pallas kernel in interpret mode at every
    M the register-tiled bodies serve (pfb_packed_reg_kernel at M <= 16,
    pfb_packed_wide_kernel at 32, 64 and 128, on the step's prototypes of
    25 taps a branch), one antenna and four."""
    y, hr, a, m = _packed_inputs(128, seed=7 + m + a, a=a, m=m)
    want = j_pk.pfb_channelize_packed(y, hr, a, m, tile=64, interpret=True)
    got = hk.pfb_channelize_packed_plain(torch.from_numpy(y),
                                         torch.from_numpy(hr), a, m)
    close(got, want, REL_CPU)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FX_CASES, ids=[c[0] for c in FX_CASES])
def test_fx_kernel_matches_plain_on_card(card, case):
    # 2^16 samples: 128 blocks, so every block seam and the tail/frame
    # seam inside block 0 are crossed
    arrs, taps_rm, a, m, h, fdp, xep = _fx_inputs(case, n=1 << 16, seed=2)
    dt = case[2]
    args = [_torch(x, dt, card) for x in arrs]
    taps = torch.from_numpy(taps_rm).to(card)
    before = hk.fx_correlate_streams_v2.launches
    got = hk.fx_correlate_streams_v2(*args, taps, a, m, fd_pairs=fdp,
                                     xe_pairs=xep)
    torch.cuda.synchronize()
    assert hk.fx_correlate_streams_v2.launches == before + 1
    want = hk.fx_correlate_streams_v2_plain(*args, taps, a, m, fd_pairs=fdp,
                                            xe_pairs=xep)
    for g, w in zip(got, want):
        close(g, w, REL_CARD)


@pytest.mark.cuda
def test_fx_kernel_ragged_tile_and_contiguity(card):
    case = ("ragged", 3, "float32", 16 * 1000, None, None, None, 16)
    arrs, taps_rm, a, m, h, fdp, xep = _fx_inputs(case, seed=3)
    args = [_torch(x, "float32", card) for x in arrs]
    taps = torch.from_numpy(taps_rm).to(card)
    got = hk.fx_correlate_streams_v2(*args, taps, a, m)
    want = hk.fx_correlate_streams_v2_plain(*args, taps, a, m)
    for g, w in zip(got, want):
        close(g, w, REL_CARD)
    wide = torch.zeros((a, 2 * h), device=card)
    with pytest.raises(ValueError):
        hk.fx_correlate_streams_v2(args[0], args[1], wide[:, :h], wide[:, h:],
                                   taps, a, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m", [32, 64, 128])
def test_fx_wide_matches_plain_and_first_body_on_card(card, m, dt):
    """fx_wide_kernel at the step's 25 tap rows, 4 antennas, on a frame
    whose last block is ragged (2^16 + 37 m samples): the v2 entry (the
    pipeline's tail) and the flat entry (a W·m − 1 history, odd) against
    their plain forms, and the C entry's body 2 against body 0
    (fx_tile_kernel) on the same inputs, within 1e-4 × max|plain|; also
    with pairs of the caller's."""
    case = (f"m{m}", 4, dt, (1 << 16) + 37 * m, None, None, None, m)
    arrs, taps_rm, a, _, _, _, _ = _fx_inputs(case, seed=40 + m)
    args = [_torch(x, dt, card) for x in arrs]
    taps = torch.from_numpy(taps_rm).to(card)
    assert hk.fx_body(m, a, taps.shape[0], card) == "fx_wide_kernel"
    want = hk.fx_correlate_streams_v2_plain(*args, taps, a, m)
    for g, w in zip(hk.fx_correlate_streams_v2(*args, taps, a, m), want):
        close(g, w, REL_CARD)
    new = hk._launch_fx(*args, taps, a, m, None, None, body="fx_wide_kernel")
    first = hk._launch_fx(*args, taps, a, m, None, None, body="fx_tile_kernel")
    torch.cuda.synchronize()
    for g, f, w in zip(new, first, want):
        close(g, w, REL_CARD)
        close(f, w, REL_CARD)
        close(g, f, REL_CARD)
    fdp, xep = [(3, 1), (2, 2)], [(1, 0), (3, 3), (2, 1), (0, 2)]
    got = hk.fx_correlate_streams_v2(*args, taps, a, m, fd_pairs=fdp,
                                     xe_pairs=xep)
    for g, w in zip(got, hk.fx_correlate_streams_v2_plain(
            *args, taps, a, m, fd_pairs=fdp, xe_pairs=xep)):
        close(g, w, REL_CARD)
    hl = taps.shape[0] * m - 1
    c = torch.cat([args[0], args[1]])[:, : (1 << 16) + 128]
    hi = torch.cat([args[2][:, :hl], args[3][:, :hl]]).contiguous()
    c = c.contiguous()
    got = hk.fx_correlate_streams(c, hi, taps, a, m, tile_rows=1)
    for g, w in zip(got, hk.fx_correlate_streams_plain(c, hi, taps, a, m,
                                                       tile_rows=1)):
        close(g, w, REL_CARD)


@pytest.mark.cuda
def test_pfb_packed_kernel_matches_plain_on_card(card):
    y, hr, a, m = _packed_inputs(8192, seed=6)
    y, hr = torch.from_numpy(y).to(card), torch.from_numpy(hr).to(card)
    before = hk.pfb_channelize_packed.launches
    got = hk.pfb_channelize_packed(y, hr, a, m)
    torch.cuda.synchronize()
    assert hk.pfb_channelize_packed.launches == before + 1
    close(got, hk.pfb_channelize_packed_plain(y, hr, a, m), REL_CARD)


# (id, antennas, channels, prototype taps (None: the step's, W = 25),
# output rows, y 4 bytes off 16-byte alignment)
PK_CARD_CASES = [
    ("m8", 4, 8, None, 8192, False), ("m4", 4, 4, None, 8192, False),
    ("m2", 4, 2, None, 8192, False), ("a1", 1, 16, None, 8192, False),
    ("a3", 3, 16, None, 8192, False), ("a5_two_chunks", 5, 16, None, 8192,
                                       False),
    ("m2_a3_words", 3, 2, None, 8192, False), ("w1", 4, 16, 16, 8192, False),
    ("w100", 4, 16, 1600, 8192, False),
    ("ragged", 4, 16, None, 8192 + 7, False),
    ("short", 4, 16, None, 20, False), ("m32", 4, 32, None, 4096, False),
    ("unaligned", 4, 16, None, 8192 + 7, True),
    ("m64", 4, 64, None, 4096, False), ("m128", 4, 128, None, 2048, False),
    ("m64_a1", 1, 64, None, 4096, False), ("m64_a3", 3, 64, None, 4096, False),
    ("m64_w1", 4, 64, 64, 4096, False),
    ("m64_ragged", 4, 64, None, 4096 + 7, False),
    ("m64_short", 4, 64, None, 20, False),
    ("m64_unaligned", 3, 64, None, 4096 + 7, True),
    ("m128_w100_a1", 1, 128, 12800, 1024, False)]


def _packed_on_card(card, case, seed):
    _, a, m, ntaps0, nout, unaligned = case
    y, hr, _, _ = _packed_inputs(nout, seed=seed, a=a, m=m, ntaps0=ntaps0)
    if unaligned:       # a view one float into its storage
        buf = torch.empty(y.size + 1, device=card)
        yt = buf[1:].view(y.shape)
        yt.copy_(torch.from_numpy(y))
    else:
        yt = torch.from_numpy(y).to(card)
    return yt, torch.from_numpy(hr).to(card), a, m


@pytest.mark.cuda
@pytest.mark.parametrize("case", PK_CARD_CASES, ids=[c[0] for c in PK_CARD_CASES])
def test_pfb_packed_kernel_edge_cases_on_card(card, case):
    """The wrapper at the shapes it accepts beside the step's: every M the
    register-tiled bodies serve, A = 1, 3 and 5 (part-filled and second
    chunks), the word-by-word staging (M = 2 at odd A, and y 4 bytes off
    alignment), W = 1 and 100, ragged and short last blocks; at M = 64
    (pfb_packed_wide_kernel) A = 1 and 3, W = 1, ragged, short and
    unaligned; and M = 128 at W = 100 on one antenna, where the wide block
    does not fit and the first body's does, each held to the plain
    form."""
    y, hr, a, m = _packed_on_card(card, case, seed=31)
    before = hk.pfb_channelize_packed.launches
    got = hk.pfb_channelize_packed(y, hr, a, m)
    torch.cuda.synchronize()
    assert hk.pfb_channelize_packed.launches == before + 1
    close(got, hk.pfb_channelize_packed_plain(y, hr, a, m), REL_CARD)


def _packed_on_body(y, hr, a, m, body):
    """clen_pfb_packed on the named body with its wrapper's rows a block,
    uncounted."""
    w = hr.shape[0]
    out = torch.empty((y.shape[0] - (w - 1), y.shape[1]), device=y.device)
    code = hk.PFB_PACKED_BODIES.index(body)
    err = hk._load().clen_pfb_packed(
        y.data_ptr(), hr.data_ptr(), hk._twiddles(m, y.device).data_ptr(),
        out.data_ptr(), out.shape[0], w, a, m, hk.pfb_packed_tile(a, m, code),
        code, torch.cuda.current_stream(y.device).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in PK_CARD_CASES if c[2] <= 16],
                         ids=[c[0] for c in PK_CARD_CASES if c[2] <= 16])
def test_pfb_packed_reg_matches_first_body_on_card(card, case):
    """pfb_packed_reg_kernel and pfb_packed_kernel through the C entry on
    the same inputs agree within 1e-4 × max|plain| (the branch sums are
    the same fmaf chains; the DFTs sum in other orders)."""
    y, hr, a, m = _packed_on_card(card, case, seed=32)
    new = _packed_on_body(y, hr, a, m, "pfb_packed_reg_kernel")
    first = _packed_on_body(y, hr, a, m, "pfb_packed_kernel")
    want = hk.pfb_channelize_packed_plain(y, hr, a, m)
    close(new, first, REL_CARD)
    close(new, want, REL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in PK_CARD_CASES
                                  if c[2] in hk.PFB_WIDE_M
                                  and c[0] != "m128_w100_a1"],
                         ids=[c[0] for c in PK_CARD_CASES
                              if c[2] in hk.PFB_WIDE_M
                              and c[0] != "m128_w100_a1"])
def test_pfb_packed_wide_matches_first_body_on_card(card, case):
    """pfb_packed_wide_kernel and pfb_packed_kernel through the C entry on
    the same inputs agree within 1e-4 × max|plain| at M = 32, 64 and 128
    and at M = 64's edge cases (the branch sums are the same fmaf chains;
    the DFTs sum in other orders), each within it of the plain form."""
    y, hr, a, m = _packed_on_card(card, case, seed=34)
    new = _packed_on_body(y, hr, a, m, "pfb_packed_wide_kernel")
    first = _packed_on_body(y, hr, a, m, "pfb_packed_kernel")
    want = hk.pfb_channelize_packed_plain(y, hr, a, m)
    close(new, first, REL_CARD)
    close(new, want, REL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("a,m,ntaps0", [(4, 16, None), (3, 2, None),
                                        (4, 32, None), (4, 16, 4800),
                                        (4, 64, None), (3, 128, None),
                                        (1, 128, 12800)],
                         ids=["m16", "m2_a3", "m32", "m16_w300", "m64",
                              "m128_a3", "m128_w100_a1"])
def test_pfb_packed_launches_its_body_on_card(card, a, m, ntaps0):
    """A call launches the body pfb_packed_body names (torch.profiler's
    kernel names), once, and nothing of the others: pfb_packed_reg_kernel
    at M <= 16, pfb_packed_wide_kernel at M = 32, 64 and 128,
    pfb_packed_kernel at W = 300 for M = 16 and W = 100 for M = 128 (one
    antenna), whose register-tiled blocks (4 · 128 · (64 + 2 W) B, and
    8 · 128 · (32 + 2 W + 1) B) would not fit the card's opt-in shared
    memory (the first body's does).  The library's block sizes and rows a block are the
    ones the tests model."""
    from clenabled_tpu_torch.runtime.device import launched_kernels

    y, hr, a, m = _packed_on_card(card, ("", a, m, ntaps0, 1000, False), 33)
    w = hr.shape[0]
    body = hk.pfb_packed_body(m, w, card)
    assert body == ("pfb_packed_reg_kernel" if m <= 16 and w <= 195
                    else "pfb_packed_wide_kernel"
                    if m >= 32 and w <= PK_MAX_W[m] else "pfb_packed_kernel")
    lib = hk._load()
    assert lib.clen_pfb_smem_bytes(a, m, w, hk.PFB_REG_ROWS, 1) == \
        _pk_reg_smem_bytes(w)
    assert lib.clen_pfb_block_rows(m, 1) == (PK_ROWS if m <= 16 else 0)
    if m >= 32:
        assert lib.clen_pfb_smem_bytes(a, m, w, _pw_rows(m), 2) == \
            _pw_smem_bytes(m, w)
        assert lib.clen_pfb_block_rows(m, 2) == _pw_rows(m)
    others = set(hk.PFB_PACKED_BODIES) - {body}
    got, events = launched_kernels(
        lambda: hk.pfb_channelize_packed(y, hr, a, m))
    assert sum(body in e for e in events) == 1
    assert not any(o in e for o in others for e in events)
    close(got, hk.pfb_channelize_packed_plain(y, hr, a, m), REL_CARD)


# (id, fd_pairs, xe_pairs, channels) for the flat-layout entry (B.1b); JAX's
# flat entry carries an 8-row halo, so it takes M = 32 (hist 799) but not
# the W = 25 prototypes at M = 64 and 128
FLAT_CASES = [("default", None, None, 16),
              ("pairs", [(0, 3)], [(0, 1), (2, 3), (1, 1)], 16),
              ("m32", None, None, 32)]


def _flat_inputs(n, seed, a=4, m=16):
    taps_rm, ntaps = _taps(m)
    rng = np.random.default_rng(seed)
    comps = rng.standard_normal((2 * a, n)).astype(np.float32)
    hist = rng.standard_normal((2 * a, ntaps - 1)).astype(np.float32)
    return comps, hist, taps_rm, a, m


@pytest.mark.parametrize("case", FLAT_CASES, ids=[c[0] for c in FLAT_CASES])
def test_fx_flat_entry_matches_jax(ref, case):
    """fx_correlate_streams: the JAX kernel in interpret mode against the
    port's wrapper on the CPU, which is the v2 plain form fed the row
    halves of the flat layout."""
    _, fdp, xep, m = case
    comps, hist, taps_rm, a, m = _flat_inputs(512 * 16, seed=7, m=m)
    want = j_pk.fx_correlate_streams(comps, hist, taps_rm, a, m, tile_rows=8,
                                     interpret=True, fd_pairs=fdp,
                                     xe_pairs=xep)
    hk.reset_launch_counts()
    c, h = torch.from_numpy(comps), torch.from_numpy(hist)
    got = hk.fx_correlate_streams(c, h, taps_rm, a, m, tile_rows=8,
                                  fd_pairs=fdp, xe_pairs=xep)
    assert hk.fx_correlate_streams.launches == 0
    plain = hk.fx_correlate_streams_v2_plain(c[:a], c[a:], h[:a], h[a:],
                                             taps_rm, a, m, fd_pairs=fdp,
                                             xe_pairs=xep)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        close(g, w, REL_CPU)


def test_fx_flat_entry_checks():
    comps, hist, taps_rm, a, m = _flat_inputs(1024, seed=8)
    c, h = torch.from_numpy(comps), torch.from_numpy(hist)
    with pytest.raises(ValueError, match="component streams"):
        hk.fx_correlate_streams(c[:a], h, taps_rm, a, m, tile_rows=8)
    with pytest.raises(ValueError, match="hist shape"):
        hk.fx_correlate_streams(c, h[:, 1:], taps_rm, a, m, tile_rows=8)
    with pytest.raises(ValueError, match="multiple of 8192"):
        hk.fx_correlate_streams(c, h, taps_rm, a, m)     # tile_rows=64


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLAT_CASES, ids=[c[0] for c in FLAT_CASES])
def test_fx_flat_entry_kernel_matches_plain_on_card(card, case):
    _, fdp, xep, m = case
    comps, hist, taps_rm, a, m = _flat_inputs(1 << 16, seed=9, m=m)
    c, h = torch.from_numpy(comps).to(card), torch.from_numpy(hist).to(card)
    taps = torch.from_numpy(taps_rm).to(card)
    before = hk.fx_correlate_streams.launches
    got = hk.fx_correlate_streams(c, h, taps, a, m, fd_pairs=fdp,
                                  xe_pairs=xep)
    torch.cuda.synchronize()
    assert hk.fx_correlate_streams.launches == before + 1
    want = hk.fx_correlate_streams_plain(c, h, taps, a, m, fd_pairs=fdp,
                                         xe_pairs=xep)
    for g, w in zip(got, want):
        close(g, w, REL_CARD)


# --------------------------------------------------------------------------
# fx_reg_kernel (csrc/fx_correlate.cu, M in {2, 4, 8, 16}) modelled in numpy:
# its tile (1024 samples a component), FIR pass (512) and FIR strip (16)
# --------------------------------------------------------------------------

REG_TILE_SAMPLES, SUB_SAMPLES, STRIP = 1024, 512, 16


def _reg_wpad(m, w):
    rows = REG_TILE_SAMPLES // m + w
    return -(-rows // STRIP) * (STRIP + 1) * m + 4


def _zswz(x):
    return x ^ (((x >> 5) & 15) << 1)


def _reg_stage(frame, tail, blk, m, w):
    """The kernel's staging of tail ++ frame for block ``blk``, group by
    group: VW-sample group i of a component holds window samples
    k = VW·i − delta .. (delta = −h mod VW); its frame samples load as one
    VW-aligned vector, its tail samples one by one, samples at or past
    span_valid are 0; it is stored at word delta + k + (k // 16m)·m of its
    row (padded rows, shifted by delta), as one vector unless a pad row
    splits it; a component's groups are counted up to whole store phases
    (32/VW lanes), the extra lanes idle.  Returns the [2A, wpad] window
    (words never stored are 0), tvalid, delta, and the thread-ordered
    record of what each group read and where a vector store put it."""
    a2, n = frame.shape
    h = tail.shape[1]
    tile = REG_TILE_SAMPLES // m
    vw = 4 if m >= 4 else 2
    ch = STRIP * m
    wpad = _reg_wpad(m, w)
    tvalid = min(tile, n // m - blk * tile)
    span_valid = tvalid * m + w * m - 1
    base = blk * tile * m
    delta = (vw - h % vw) % vw
    groups = -(-(span_valid + delta) // vw)
    per_c = -(-groups // (32 // vw)) * (32 // vw)   # whole store phases
    win = np.zeros((a2, wpad), np.float32)
    rec = {"reads_t": [], "reads_f": [], "vector_store": [], "staged": []}
    for e in range(a2 * per_c):
        c, i = divmod(e, per_c)
        if i >= groups:                           # an idle lane
            rec["vector_store"].append(None)
            continue
        k = vw * i - delta
        f = base + k - h
        val = np.zeros(vw, np.float32)
        if f >= 0:
            assert f % vw == 0
            rec["reads_f"] += range(f, f + vw)
            val[:] = frame[c, f:f + vw]
            val[k + np.arange(vw) >= span_valid] = 0
        else:
            for x in range(vw):
                kx, sx = k + x, base + k + x
                if 0 <= kx < span_valid:
                    if sx < h:
                        rec["reads_t"].append(sx)
                        val[x] = tail[c, sx]
                    else:
                        rec["reads_f"].append(sx - h)
                        val[x] = frame[c, sx - h]
        rec["staged"] += [base + k + x for x in range(vw)
                          if 0 <= k + x < span_valid]
        split = delta and k >= 0 and (k + delta) % ch == 0
        if split:
            for x in range(vw):
                win[c, delta + k + x + (k + x) // ch * m] = val[x]
            rec["vector_store"].append(None)
        else:
            word = delta + k + max(k, 0) // ch * m
            assert word % vw == 0
            win[c, word:word + vw] = val
            rec["vector_store"].append(c * wpad + word)
    return win, tvalid, delta, rec


def _reg_fir(win, taps_rm, m, delta=0):
    """The FIR warps' schedule on one block's window: a warp per component
    runs its passes of 512 sums in turn; lane = (strip q, branch j), 16
    sums and a 16-slot window rotating with the tap step, then the sums
    stored at their swizzled words (the kernel puts them at the start of
    the component's window row).  Returns the sums as a [2A, 1024] buffer
    and every warp-wide shared-memory word address, by kind."""
    w = taps_rm.shape[0]
    g, wpad = win.shape
    tapr = taps_rm[::-1].reshape(-1)              # tapr[d*m + j]
    lane = np.arange(32)
    j, q = lane % m, lane // m
    subt = SUB_SAMPLES // m
    zs = np.zeros((g, REG_TILE_SAMPLES), np.float32)
    seen = {"window": [], "sums": []}
    flat = win.reshape(-1)
    for c, sub in np.ndindex(g, REG_TILE_SAMPLES // SUB_SAMPLES):
        p = (c * wpad + delta + (STRIP + 1) * (sub * subt // STRIP + q) * m
             + (m - 1 - j))
        wv = [flat[p + k * m] for k in range(STRIP)]
        seen["window"] += [p + k * m for k in range(STRIP)]
        acc = [np.zeros(32, np.float32) for _ in range(STRIP)]
        p = p + (STRIP + 1) * m
        d0 = 0
        while d0 < w:
            for r in range(min(STRIP, w - d0)):
                tap = tapr[(d0 + r) * m + j]
                for s in range(STRIP):
                    acc[s] = np.float32(tap * wv[(s + r) % STRIP] + acc[s])
                wv[r] = flat[p + r * m]
                seen["window"].append(p + r * m)
            p = p + (STRIP + 1) * m
            d0 += STRIP
        for s in range(STRIP):
            x = (sub * subt + STRIP * q + s) * m + j
            zs[c, _zswz(x)] = acc[s]
            seen["sums"].append(c * wpad + _zswz(x))
    return zs, seen


@pytest.mark.parametrize("m,ntaps0,n,blocks,flat", [
    (16, None, 4096, [0, 3], False), (16, 1600, 2064, [0, 2], False),
    (4, None, 1200, [0, 1], False), (2, 100, 1200, [0, 1], False),
    (16, None, 4096, [0, 1, 3], True), (2, 100, 1202, [0, 1], True)],
    ids=["m16_w25", "m16_w100_ragged", "m4_ragged", "m2_w50_ragged",
         "m16_flat_history", "m2_flat_history_ragged"])
def test_fx_reg_fir_schedule_matches_branch_sums(m, ntaps0, n, blocks, flat):
    """A replay of fx_reg_kernel's branch FIR (the group-wise staging into
    shifted padded rows, the per-lane rotating window, the W % 16
    remainder, the swizzled stores) gives the plain branch sums, across
    the tail/frame seam (block 0) and on a ragged last tile, with the
    pipeline's tail and with the flat entry's W·m − 1 history (shifted
    window, split groups)."""
    a = 2
    taps_rm, ntaps = _taps(m, ntaps0)
    w = taps_rm.shape[0]
    h = w * m - 1 if flat else hk.fx_tail_len("float32", m, ntaps)
    rng = np.random.default_rng(11)
    frame = rng.standard_normal((2 * a, n)).astype(np.float32)
    tail = rng.standard_normal((2 * a, h)).astype(np.float32)
    v = np.concatenate([tail, frame], 1)[:, : w * m - 1 + n]
    want = t_chan._branch_sums_critical_batched(
        torch.from_numpy(v), torch.from_numpy(taps_rm), m, w * m,
        n // m).numpy()                                   # [2A, nout, m]
    tile = REG_TILE_SAMPLES // m
    if n // m % tile:
        assert blocks[-1] == n // m // tile           # the ragged tile
    for blk in blocks:
        win, tvalid, delta, _ = _reg_stage(frame, tail, blk, m, w)
        assert delta == (0 if not flat else (-h) % (4 if m >= 4 else 2))
        zs, _ = _reg_fir(win, taps_rm, m, delta)
        t = np.arange(tvalid)[:, None]
        got = zs[:, _zswz(t * m + np.arange(m))]
        close(got, want[:, blk * tile: blk * tile + tvalid], REL_CPU)


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


@pytest.mark.parametrize("m", hk.FX_REG_M)
def test_fx_reg_shared_memory_banks(m):
    """Every warp-wide shared-memory access of fx_reg_kernel is on 32
    distinct banks: the staging stores, the FIR's tap and window loads and
    its sums' stores (scalar), the DFT stage's float2 loads and stores, and
    the lag and Gram stages' float2 loads, with half-warp phases for 8-byte
    accesses and quarter-warp phases for 16-byte ones.  The swizzle and the row padding are bijective."""
    w = 25 if m == 16 else 7
    taps_rm = np.ones((w, m), np.float32)
    a = 4
    wpad = _reg_wpad(m, w)
    # the staging's vector stores, thread e to group e, as it runs them:
    # VW-word phases of 32/VW lanes; split groups store apart, one by one
    vw = 4 if m >= 4 else 2
    rng = np.random.default_rng(0)
    for h in (hk.fx_tail_len("float32", m, w * m), w * m - 1):
        frame = rng.standard_normal((2 * a, 2 * REG_TILE_SAMPLES))
        tail = rng.standard_normal((2 * a, h))
        _, _, delta, rec = _reg_stage(frame, tail, 1, m, w)
        st = rec["vector_store"]
        for w0 in range(0, len(st) - 31, 32):
            lanes = [x for x in st[w0:w0 + 32]]
            for ph in range(vw):
                seg = [x for x in lanes[ph * 32 // vw:(ph + 1) * 32 // vw]
                       if x is not None]
                words = np.add.outer(seg, np.arange(vw)).reshape(-1)
                assert len(np.unique(words % 32)) == len(words)
        for kind, addrs in _reg_fir(np.zeros((2 * a, wpad), np.float32),
                                    taps_rm, m, delta)[1].items():
            assert _banks_ok(addrs), kind
    x = np.arange(REG_TILE_SAMPLES)
    assert sorted(_zswz(x)) == list(x)
    # the kernel swizzles a vector's base once: zswz(t·m + k) = zswz(t·m) ^ k
    t, k = np.divmod(x, m)
    assert (_zswz(x) == _zswz(t * m) ^ k).all()
    # padded rows: window row u lives at (u + u // 16) * m + column
    u = np.arange(REG_TILE_SAMPLES // m + w)
    phys = (u + u // STRIP)[:, None] * m + np.arange(m)
    assert len(np.unique(phys)) == phys.size and phys.max() < wpad
    lane = np.arange(32)
    for k in range(STRIP // 2):                  # DFT stage, in place
        assert _banks_ok(_zswz(STRIP * lane + 2 * k), width=2)
    for s in range(REG_TILE_SAMPLES // 32 // m):  # lag and Gram loads
        for k in range(m // 2):
            assert _banks_ok(_zswz((lane + 32 * s) * m + 2 * k), width=2)


class _WideLib:
    """A stand-in for the kernel library's clen_fx_smem_bytes (body 2:
    fx_wide_kernel's block, _wide_smem_bytes), recording each call."""

    def __init__(self):
        self.asked = []

    def clen_fx_smem_bytes(self, a, m, w, tile, body):
        self.asked.append((a, m, w, tile, body))
        assert body == 2 and tile * m == WIDE_CHUNKS * WIDE_CHUNK
        return _wide_smem_bytes(a, m)


@pytest.fixture
def h100_rule(monkeypatch):
    """fx_body on an H100 without one: the library stand-in and the card's
    opt-in shared memory, the rule's cache cleared around the test."""
    lib = _WideLib()
    monkeypatch.setattr(hk, "_load", lambda: lib)
    monkeypatch.setattr(hk, "_smem_optin", lambda index: H100_OPTIN)
    hk._fx_body_code.cache_clear()
    yield lib
    hk._fx_body_code.cache_clear()


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64, 128])
def test_fx_body_by_m(h100_rule, m):
    """At 4 antennas and the step's 25 tap rows on an H100: fx_reg_kernel
    at M <= 16, fx_wide_kernel at 32-128, fx_tile_kernel at M = 1; each
    body's tile is its samples a component a block over M."""
    want = ("fx_reg_kernel" if m in (2, 4, 8, 16) else "fx_wide_kernel"
            if m >= 32 else "fx_tile_kernel")
    assert hk.fx_body(m, 4, 25, "cuda:0") == want
    assert want in hk.FX_BODIES
    samples = {"fx_tile_kernel": 512, "fx_reg_kernel": 1024,
               "fx_wide_kernel": 4096}[want]
    assert hk.fx_tile(m, want) == max(1, samples // m)
    if m < 32:       # no card needed
        assert hk.fx_body(m) == want and hk.fx_tile(m) == hk.fx_tile(m, want)


def test_pick_fx_body_rule():
    """The pure rule: the register body at M <= 16 whatever the shared
    memory; the wide body at 32-128 only where its block fits the opt-in;
    the first body at M = 1 and where the wide block does not fit."""
    for m in hk.FX_REG_M:
        assert hk._pick_fx_body(m, 10 ** 9, 0) == "fx_reg_kernel"
    for m in hk.FX_WIDE_M:
        assert hk._pick_fx_body(m, H100_OPTIN, H100_OPTIN) == "fx_wide_kernel"
        assert hk._pick_fx_body(m, H100_OPTIN + 1, H100_OPTIN) == \
            "fx_tile_kernel"
    assert hk._pick_fx_body(1, 0, H100_OPTIN) == "fx_tile_kernel"
    # two blocks an SM up to 5 antennas, one up to 12, none past
    assert 2 * (_wide_smem_bytes(5, 128) + 1024) <= 233472 < 2 * (
        _wide_smem_bytes(6, 32) + 1024)
    assert _wide_smem_bytes(12, 128) <= H100_OPTIN < _wide_smem_bytes(13, 32)


def test_fx_body_asks_the_card_once(h100_rule):
    """fx_body takes fx_wide_kernel's block size from the C library and the
    card's opt-in shared memory once for each (antennas, m, w, card); 13
    antennas' block does not fit and keeps fx_tile_kernel; the CPU has no
    body to name."""
    for _ in range(3):
        assert hk.fx_body(64, 4, 25, "cuda:0") == "fx_wide_kernel"
    assert hk.fx_body(32, 13, 25, "cuda:0") == "fx_tile_kernel"
    assert hk.fx_body(16, 13, 25, "cuda:0") == "fx_reg_kernel"
    assert h100_rule.asked == [(4, 64, 25, 64, 2), (13, 32, 25, 128, 2)]
    with pytest.raises(ValueError, match="CUDA kernel body"):
        hk.fx_body(64, device="cpu")


def test_fx_body_refuses_m_not_dividing_128():
    for m in (0, 3, 24, 256):
        with pytest.raises(ValueError, match="divide"):
            hk.fx_body(m)


def test_fx_ab_cli_arguments():
    """The FX variants tool's arguments; without a card it exits non-zero."""
    from clenabled_tpu_torch.tools import fx_ab as cli

    args = cli.parse_args([])
    assert (args.variants, args.n, args.m, args.dtype, args.rounds,
            args.calls) == ([], 1 << 23, 16, "float32", 7, 10)
    args = cli.parse_args(["a=x.cu", "b=-DFX_STOP_AFTER=2", "--m", "8",
                           "--dtype", "int8", "--rounds", "3"])
    assert (args.variants, args.m, args.dtype, args.rounds) == (
        ["a=x.cu", "b=-DFX_STOP_AFTER=2"], 8, "int8", 3)
    if not torch.cuda.is_available():
        assert cli.main(["--n", "64"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64, 128])
def test_fx_entries_launch_their_body_on_card(card, m):
    """Both FX entries at every m dividing 128: each call launches the body
    that fx_body(m) names (torch.profiler's kernel names: fx_wide_kernel at
    32-128 on an H100) and nothing of the others, and agrees with its plain
    form."""
    from clenabled_tpu_torch.runtime.device import launched_kernels

    case = (f"m{m}", 4, "float32", 1 << 15, None, None, None, m)
    arrs, taps_rm, a, _, _, _, _ = _fx_inputs(case, seed=12)
    args = [_torch(x, "float32", card) for x in arrs]
    taps = torch.from_numpy(taps_rm).to(card)
    comps, hist, _, _, _ = _flat_inputs(1 << 15, seed=13, a=a, m=m)
    c, hi = torch.from_numpy(comps).to(card), torch.from_numpy(hist).to(card)
    body = hk.fx_body(m, a, taps.shape[0], card)
    assert body == hk.fx_body(m)
    if m >= 32:
        assert body == "fx_wide_kernel"
    others = set(hk.FX_BODIES) - {body}
    (got, got1), events = launched_kernels(
        lambda: (hk.fx_correlate_streams_v2(*args, taps, a, m),
                 hk.fx_correlate_streams(c, hi, taps, a, m)), least=2)
    assert sum(body in e for e in events) == 2
    assert not any(o in e for e in events for o in others)
    for g, w in zip(got, hk.fx_correlate_streams_v2_plain(*args, taps, a, m)):
        close(g, w, REL_CARD)
    for g, w in zip(got1, hk.fx_correlate_streams_plain(c, hi, taps, a, m)):
        close(g, w, REL_CARD)


@pytest.mark.parametrize("m,ntaps0,n,h_kind", [
    (16, None, 4096, "tail_len"), (16, None, 4096, "flat"),
    (2, 100, 1202, "flat"), (8, 1600, 8 * 300, "flat"), (4, None, 1200,
                                                         "tail_len")],
    ids=["m16_v2", "m16_flat", "m2_flat_ragged", "m8_flat_w200",
         "m4_v2_ragged"])
def test_fx_reg_staging_reads_stay_inside(m, ntaps0, n, h_kind):
    """fx_reg_kernel's staging, replayed for every block (``_reg_stage``):
    each group's frame samples are one VW-aligned vector, also with the
    flat entry's W·m − 1 history, every read lies inside the tail or the
    frame, and every sample the block's outputs need is staged once."""
    taps_rm, ntaps = _taps(m, ntaps0)
    w = taps_rm.shape[0]
    h = (hk.fx_tail_len("float32", m, ntaps) if h_kind == "tail_len"
         else w * m - 1)
    tile = REG_TILE_SAMPLES // m
    rng = np.random.default_rng(5)
    frame = rng.standard_normal((2, n)).astype(np.float32)
    tail = rng.standard_normal((2, h)).astype(np.float32)
    for blk in range(-(-(n // m) // tile)):
        _, tvalid, _, rec = _reg_stage(frame, tail, blk, m, w)
        assert all(0 <= i < h for i in rec["reads_t"])
        assert all(0 <= i < n for i in rec["reads_f"])
        base, span_valid = blk * tile * m, tvalid * m + w * m - 1
        want = list(range(base, base + span_valid))
        assert sorted(rec["staged"]) == sorted(want + want)   # 2 components


# --------------------------------------------------------------------------
# fx_wide_kernel (csrc/fx_correlate.cu, M in {32, 64, 128}) modelled in
# numpy: a block of WIDE_CHUNKS chunks of WIDE_CHUNK samples a component,
# its FIR strips of 16 vectors read straight from the tail and the frame,
# each chunk's complex sums and z in the float2 slots of warp tiles
# (csrc/wide_dft.cuh's layouts), the lag jobs (two a pair a chunk) with
# their fold, the Gram jobs, the partial rows and fx_reduce_kernel's sum;
# every warp-wide shared-memory access recorded in lane order as word
# addresses (2 a float2 slot)
# --------------------------------------------------------------------------

WIDE_CHUNK, WIDE_CHUNKS, WIDE_STRIP, WIDE_LS, WIDE_WARPS = 2048, 2, 16, 2, 8
H100_OPTIN = 232448            # an H100's opt-in shared memory a block


def _wide_smem_bytes(a, m):
    """clen_fx_smem_bytes(a, m, ., ., 2): a chunk's sums / z of every
    antenna, the warps' lag exchange tiles and the pass-1 table, float2."""
    return 8 * (a * WIDE_CHUNK + WIDE_WARPS * 512 + m)


def _wq(m):
    """(Q lanes a transform, GW groups a warp tile, CU vectors a chunk)."""
    return m // 16, 32 // (m // 16), WIDE_CHUNK // m


def _w_fir_slot(g, j, m):
    q_, gw, _ = _wq(m)
    row = j // q_
    return (g // gw) * 512 + row * 32 + q_ * ((g % gw) ^ (row % gw)) + j % q_


def _w_pass1_slot(g, q, k1, m):
    q_, gw, _ = _wq(m)
    return (g // gw) * 512 + k1 * 32 + q_ * (g % gw) + (q ^ (k1 % q_))


def _w_out_slot(g, k, m):
    q_, gw, _ = _wq(m)
    return g * m + (k ^ (q_ * (g % gw)) ^ (((k >> 4) & 1) << 1))


def _w_kswz(k):
    return k ^ (((k >> 4) & 1) << 1)


def _w_bin(i, q, m):
    """The bin lane q holds in v[i] after the two passes."""
    q_ = m // 16
    return (i // q_) * q_ + q + 16 * (i % q_)


def _w_lanes(m):
    lane = np.arange(32)
    gl, q = np.divmod(lane, m // 16)
    return lane, gl, q


def _w_transform(v, tile, g, q, m, words, kind):
    """widedft::transform on one warp: v [32, 16] holds lane (gl, q)'s
    points q + Q·mm of group g; pass 1 (16-point unscaled inverse DFT,
    float64 here, times the float32 table entry exp(+2πi·q·k1/M)) into the
    tile's pass-1 slots, pass 2 (Q-point DFTs) from them.  Returns [32, 16],
    entry i = bin _w_bin(i, q)."""
    q_ = m // 16
    y = np.fft.ifft(v, axis=1) * 16
    tw1 = np.exp(2j * np.pi * np.arange(16)[None, :] * q[:, None] / m)
    y = y * tw1.astype(np.complex64)
    words[kind + " table"] += [2 * (k1 * q_ + q) for k1 in range(1, 16)]
    for k1 in range(16):
        slot = _w_pass1_slot(g, q, k1, m)
        words[kind + " pass1 store"].append(2 * slot)
        tile[slot] = y[:, k1]
    out = np.zeros((32, 16), np.complex128)
    for aa in range(16 // q_):
        for b in range(q_):
            slot = _w_pass1_slot(g, b, aa * q_ + q, m)
            words[kind + " pass2 load"].append(2 * slot)
            out[:, aa * q_ + b] = tile[slot]
    for aa in range(16 // q_):
        sl = slice(aa * q_, (aa + 1) * q_)
        out[:, sl] = np.fft.ifft(out[:, sl], axis=1) * q_
    return out


def _w_fold(sums, q_):
    """halve_fold<16, 16, Q> over the warp: halving steps on lane bits 16,
    8, .. Q (a lane keeps the upper half where its bit is set)."""
    lane = np.arange(32)
    s, cnt, mask = sums.copy(), sums.shape[1], 16
    while mask >= q_:
        h = cnt // 2
        up = ((lane & mask) != 0)[:, None]
        send = np.where(up, s[:, :h], s[:, h:cnt])
        keep = np.where(up, s[:, h:cnt], s[:, :h])
        s[:, :h] = (keep + send[lane ^ mask]).astype(np.float32)
        cnt, mask = h, mask // 2
    return s[:, :cnt]


def _w_fir(ins, blk, ch, taps_rm, m, z, words, reads):
    """Chunk ``ch``'s FIR jobs of block ``blk``, thread-ordered (a warp takes
    32 consecutive jobs): job (antenna, strip s0 of 16 vectors, branch j), j
    fastest, both components; 16 sums and a 16-row window of column M-1-j
    of each, rotating with the tap step (the last refill reads row 16 + W -
    1), rows from the tail or the frame by v index, 0 past the frame; a
    strip wholly in the frame must read nothing else.  The complex sums go
    to z at _w_fir_slot(antenna·CU + vector, j); strips past the valid
    vectors skip.  Reads (component, v index) go to ``reads``."""
    xr, xi, tr, ti = ins
    a, n = xr.shape
    h = tr.shape[1]
    w = taps_rm.shape[0]
    s = WIDE_STRIP
    _, _, cu = _wq(m)
    nq = cu // s
    t0 = blk * WIDE_CHUNKS * cu
    tvalid = min(WIDE_CHUNKS * cu, n // m - t0)
    tc = ch * cu
    e = np.arange(a * nq * m)
    j = e % m
    s0 = e // m % nq * s
    ant = e // (nq * m)
    live = tc + s0 < tvalid
    rb = (t0 + tc + s0) * m
    fast = (rb >= h) & (rb + (s + w) * m <= h + n)
    col = m - 1 - j

    def load(d):
        x = rb + d * m + col
        in_t = live & (x < h)
        in_f = live & (x >= h) & (x - h < n)
        assert not (live & fast & ~in_f).any()
        re, im = np.zeros(len(e), np.float32), np.zeros(len(e), np.float32)
        re[in_t], im[in_t] = tr[ant[in_t], x[in_t]], ti[ant[in_t], x[in_t]]
        fx = x[in_f] - h
        re[in_f], im[in_f] = xr[ant[in_f], fx], xi[ant[in_f], fx]
        read = in_t | in_f
        reads.append((ant[read], x[read]))
        return re, im

    win = [load(k) for k in range(s)]
    vr, vi = [v[0] for v in win], [v[1] for v in win]
    ar = [np.zeros(len(e), np.float32) for _ in range(s)]
    ai = [np.zeros(len(e), np.float32) for _ in range(s)]
    tapr = taps_rm[::-1]
    for d0 in range(0, w, s):
        for rr in range(min(s, w - d0)):
            tap = tapr[d0 + rr, j]
            for ss in range(s):
                ar[ss] = (tap * vr[(ss + rr) % s] + ar[ss]).astype(np.float32)
                ai[ss] = (tap * vi[(ss + rr) % s] + ai[ss]).astype(np.float32)
            vr[rr], vi[rr] = load(d0 + rr + s)
    for ss in range(s):
        slot = _w_fir_slot(ant * cu + s0 + ss, j, m)
        z[slot[live]] = ar[ss][live] + 1j * ai[ss][live].astype(np.float64)
        words["fir store"].append(2 * slot)


def _w_dft(z, a, m, words):
    """The stage-1 transform of a chunk, in place, tile by tile."""
    _, gw, cu = _wq(m)
    _, gl, q = _w_lanes(m)
    for tile in range(a * cu // gw):
        g = tile * gw + gl
        slots = [_w_fir_slot(g, q + (m // 16) * mm, m) for mm in range(16)]
        words["dft load"] += [2 * sl for sl in slots]
        v = np.stack([z[sl] for sl in slots], 1)
        out = _w_transform(v, z, g, q, m, words, "dft")
        for i in range(16):
            slot = _w_out_slot(g, _w_bin(i, q, m), m)
            words["dft store"].append(2 * slot)
            z[slot] = out[:, i]


def _w_jobs(z, m, fdp, xep, tc, tvalid, words):
    """The chunk's lag jobs (pair f, half of its vectors) and Gram jobs
    (baseline b) on z; returns the chunk's partial-row words: lag runs
    [nfd, LS, M] and Gram sums [nb, 2M]."""
    q_, gw, cu = _wq(m)
    lane, gl, q = _w_lanes(m)
    rpj = cu // gw // WIDE_LS
    v_keep = 16 // gw
    lag = np.full((len(fdp), WIDE_LS, m), np.nan, np.float32)
    for f, (p, pq) in enumerate(fdp):
        for part in range(WIDE_LS):
            tile = np.zeros(512, np.complex128)
            sums = np.zeros((32, 16), np.float32)
            for rd in range(part * rpj, (part + 1) * rpj):
                t = rd * gw + gl
                v = np.zeros((32, 16), np.complex128)
                for mm in range(16):
                    k = q + q_ * mm
                    sp, sq = _w_out_slot(p * cu + t, k, m), _w_out_slot(
                        pq * cu + t, k, m)
                    words["lag load"] += [2 * sp, 2 * sq]
                    v[:, mm] = z[sp] * np.conj(z[sq])
                y = _w_transform(v, tile, gl, q, m, words, "lag")
                ok = tc + t < tvalid
                sums[ok] = (sums[ok] + np.abs(y[ok])).astype(np.float32)
            folded = _w_fold(sums, q_)
            for u in range(v_keep):
                k = _w_bin(gl * v_keep + u, q, m)
                assert np.isnan(lag[f, part, k]).all()    # one owner a word
                lag[f, part, k] = folded[:, u]
    gram = np.zeros((len(xep), 2 * m), np.float32)
    for b, (s1, s2) in enumerate(xep):
        for i in range(m // 32):
            k = lane + 32 * i
            for t in range(min(cu, tvalid - tc)):
                u1 = z[_w_out_slot(s1 * cu + t, k, m)]
                u2 = z[_w_out_slot(s2 * cu + t, k, m)]
                if t < 2:
                    words["gram load"] += [2 * _w_out_slot(s1 * cu + t, k, m),
                                           2 * _w_out_slot(s2 * cu + t, k, m)]
                prod = u1 * np.conj(u2)
                gram[b, k] += prod.real.astype(np.float32)
                gram[b, m + k] += prod.imag.astype(np.float32)
    assert not np.isnan(lag).any()
    return lag, gram


def _w_block(ins, blk, taps_rm, m, fdp, xep, words=None):
    """Block ``blk`` of fx_wide_kernel replayed: its partial row (lag runs,
    then Gram sums) and every (antenna, v index) its FIR read."""
    xr = ins[0]
    a, n = xr.shape
    _, _, cu = _wq(m)
    words = collections.defaultdict(list) if words is None else words
    tvalid = min(WIDE_CHUNKS * cu, n // m - blk * WIDE_CHUNKS * cu)
    z = np.zeros(a * WIDE_CHUNK, np.complex128)
    reads = []
    lag = gram = None
    for ch in range(WIDE_CHUNKS):
        tc = ch * cu
        if tc >= tvalid:
            break
        _w_fir(ins, blk, ch, taps_rm, m, z, words, reads)
        _w_dft(z, a, m, words)
        lg, gr = _w_jobs(z, m, fdp, xep, tc, tvalid, words)
        lag = lg if lag is None else (lag + lg).astype(np.float32)
        gram = gr if gram is None else (gram + gr).astype(np.float32)
    return np.concatenate([lag.reshape(-1), gram.reshape(-1)]), reads, words


def _w_reduce(rows, m, nfd, nb):
    """fx_reduce_kernel over the blocks' partial rows, its index arithmetic
    replayed: output o of the lag sums (o < nfd·M) adds its pair's LS runs
    of every row, each Gram output its one word (shifted past the extra
    runs)."""
    rows = np.asarray(rows, np.float64)
    width, lag = rows.shape[1], nfd * m
    assert width == (nfd * WIDE_LS + 2 * nb) * m
    out = np.zeros(lag + 2 * nb * m)
    for o in range(len(out)):
        in_lag = o < lag
        col = o // m * WIDE_LS * m + o % m if in_lag else o + lag * (WIDE_LS - 1)
        for r in range(WIDE_LS if in_lag else 1):
            assert col + r * m < width
            out[o] += rows[:, col + r * m].sum()
    return out[:lag].reshape(nfd, m), out[lag:].reshape(nb, 2 * m)


def _w_case(m, a, n, h_kind, seed, dt="float32"):
    taps_rm, ntaps = _taps(m)
    w = taps_rm.shape[0]
    h = {"tail_len": hk.fx_tail_len(dt, m, ntaps), "flat": w * m - 1,
         "long": 4096 + 7 * m + 3}[h_kind]
    rng = np.random.default_rng(seed)
    if dt == "int8":
        mk = lambda s: rng.integers(-127, 128, s).astype(np.float32)
    else:
        mk = lambda s: rng.standard_normal(s).astype(np.float32)
    return (mk((a, n)), mk((a, n)), mk((a, h)), mk((a, h))), taps_rm


# (M, antennas, frame, tail kind, fd_pairs, xe_pairs): every case with a
# ragged last block; the pipeline's tail (the seam in block 0), the flat
# entry's W·M − 1 history (odd: every frame read off alignment) and a tail
# longer than a block (the seam in block 1)
WIDE_REPLAY = [
    (32, 2, 2 * 4096 + 32 * 40, "tail_len", None, None),
    (64, 4, 2 * 4096 + 64 * 5, "tail_len", None, None),
    (64, 3, 4096 + 64 * 37, "flat", [(0, 2), (1, 1)], [(2, 0), (1, 1)]),
    (128, 2, 2 * 4096 + 128 * 17, "long", None, None),
    (128, 4, 4096 + 128 * 3, "flat", None, None)]
WIDE_REPLAY_IDS = ["m32_a2", "m64_a4_ragged5", "m64_a3_flat_pairs",
                   "m128_a2_long_tail", "m128_a4_flat"]


@pytest.mark.parametrize("m,a,n,h_kind,fdp,xep", WIDE_REPLAY,
                         ids=WIDE_REPLAY_IDS)
def test_fx_wide_schedule_matches_plain(m, a, n, h_kind, fdp, xep):
    """A replay of fx_wide_kernel on every block (its FIR read from the tail
    and the frame, the stage-1 transforms through the warp tiles, the lag
    jobs' transforms, |.| sums and fold, the Gram jobs, the partial rows
    added over two chunks) and of fx_reduce_kernel's sum over blocks and
    lag runs gives fx_correlate_streams_v2_plain's sums; every read lies in
    the tail or the frame, and every sample the outputs need is read."""
    ins, taps_rm = _w_case(m, a, n, h_kind, seed=m + a)
    h = ins[2].shape[1]
    w = taps_rm.shape[0]
    fd, xe = hk._default_pairs(fdp, xep, a)
    tile = WIDE_CHUNKS * WIDE_CHUNK // m
    nblk = -(-(n // m) // tile)
    rows, seen = [], [set() for _ in range(a)]
    for blk in range(nblk):
        row, reads, _ = _w_block(ins, blk, taps_rm, m, fd.tolist(),
                                 xe.tolist())
        rows.append(row)
        for ant, x in reads:
            assert ((x >= 0) & (x < h + n)).all()
            for c in range(a):
                seen[c].update(x[ant == c].tolist())
    need = set(range(n + (w - 1) * m))
    assert all(need <= s_ for s_ in seen)
    got_fd, got_g = _w_reduce(rows, m, len(fd), len(xe))
    want_fd, want_g = hk.fx_correlate_streams_v2_plain(
        *[torch.from_numpy(x) for x in ins], taps_rm, a, m,
        fd_pairs=fdp, xe_pairs=xep)
    close(got_fd, want_fd, REL_CPU)
    close(got_g, want_g, REL_CPU)


@pytest.mark.parametrize("m", hk.FX_WIDE_M)
def test_fx_wide_shared_memory_banks(m):
    """Every warp-wide shared-memory access of fx_wide_kernel is on 32
    distinct banks (float2: half-warp phases): the FIR's sums' stores, the
    stage-1 transform's loads, exchange and stores, the lag jobs' z loads
    and their exchange through the warp's tile, the Gram jobs' z loads; the
    pass-1 table's entries broadcast.  The three layouts are bijective on
    a chunk, and the fold leaves every lag bin on exactly one lane."""
    a = 4
    ins, taps_rm = _w_case(m, a, 2 * 4096, "tail_len", seed=1)
    _, _, words = _w_block(ins, 1, taps_rm, m, [(0, 1), (0, 3)],
                           [(0, 1), (2, 2), (3, 1)])
    kinds = {"fir store", "dft load", "dft pass1 store", "dft pass2 load",
             "dft store", "dft table", "lag load", "lag pass1 store",
             "lag pass2 load", "lag table", "gram load"}
    assert set(words) == kinds
    for kind, addrs in words.items():
        assert _banks_ok(addrs, width=2), kind
    x = np.arange(a * WIDE_CHUNK)
    g, j = np.divmod(x, m)
    assert sorted(_w_fir_slot(g, j, m)) == list(x)
    assert sorted(_w_out_slot(g, j, m)) == list(x)
    # the kernel's addressing: a lane-dependent base XOR a constant
    assert (_w_out_slot(g, j, m) == _w_out_slot(g, 0, m) ^ _w_kswz(j)).all()
    q_ = m // 16
    c = np.arange(0, m, q_)
    for qq in range(q_):
        assert (_w_kswz(qq | c) == qq ^ _w_kswz(c)).all()
    lanes = np.arange(32)
    for i in range(m // 32):
        assert (_w_kswz(lanes + 32 * i) == _w_kswz(lanes) ^ (32 * i)).all()
    g, rest = np.divmod(x, m)
    q, k1 = np.divmod(rest, 16)
    assert sorted(_w_pass1_slot(g, q, k1, m)) == list(x)
    lane, gl, q = _w_lanes(m)
    keep = 16 // (32 // q_)
    bins = np.stack([_w_bin(gl * keep + u, q, m) for u in range(keep)])
    assert sorted(bins.reshape(-1)) == list(range(m))
    sums = np.random.default_rng(2).standard_normal((32, 16)).astype(
        np.float32)
    folded = _w_fold(sums, q_)
    for u in range(keep):
        i = gl * keep + u
        want = np.array([sums[q == qq][:, ii].sum() for qq, ii in zip(q, i)])
        np.testing.assert_allclose(folded[:, u], want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# pfb_packed_reg_kernel (csrc/pfb_packed.cu, M in {2, 4, 8, 16}) modelled in
# numpy: its block of PK_ROWS output rows by 128 window columns (64 re, 64
# im lanes of a chunk of min(A - a0, 64/M) antennas), its FIR strip (16) and
# its 256 threads; every shared-memory access is recorded in thread order
# (item e runs on thread e mod 256, a warp takes 32 consecutive items)
# --------------------------------------------------------------------------

PK_ROWS, PK_COLS, PK_HALF, PK_STRIP = 32, 128, 64, 16


def _pk_swz(x):
    return x ^ ((x >> 3) & 12)


def _pk_chunk(a, m, chunk):
    """(columns a component the chunk really holds, y's first column of
    its re and of its im lanes)."""
    a0 = chunk * (PK_HALF // m)
    cm = min(PK_HALF // m, a - a0) * m
    return cm, (a0 * m, (a + a0) * m)


def _pk_vec(a, m):
    """Whether the kernel stages and stores 16-byte groups (for aligned
    tensors): every segment a whole number of them."""
    return m % 4 == 0 or a % 2 == 0


def _pk_width(a, m, vec=None):
    """Words an item of the staging and copy-out moves: 4, or 1 word by
    word (``vec`` False, or None for aligned tensors' choice)."""
    return 4 if (_pk_vec(a, m) if vec is None else vec) else 1


def _pk_items(n_rows, vw, cm):
    """The staging's and copy-out's items, thread-ordered: (row, plane,
    column) of each vw-word group of n_rows rows of 128 columns, and
    whether it holds real columns."""
    e = np.arange(n_rows * PK_COLS // vw)
    per_row = PK_COLS // vw
    u, col = e // per_row, e % per_row * vw
    p, c = col // PK_HALF, col % PK_HALF
    return u, p, c, c < cm


def _pk_stage(y, blk, chunk, a, m, w, vec=None):
    """Block (blk, chunk)'s staging of y: window rows [i0, i0 + 32 + W)
    of its columns, rows at or past tvalid + W - 1 zero, words of idle
    columns never written (NaN here).  Returns the window, tvalid and the
    record: y's flat indices read, and the shared word each item stores
    (-1 for an idle lane) with the access width."""
    gm = y.shape[1]
    nout = y.shape[0] - (w - 1)
    cm, off = _pk_chunk(a, m, chunk)
    vw = _pk_width(a, m, vec)
    i0 = blk * PK_ROWS
    tvalid = min(PK_ROWS, nout - i0)
    rvalid = tvalid + w - 1
    win = np.full((PK_ROWS + w, PK_COLS), np.nan, np.float32)
    u, p, c, live = _pk_items(PK_ROWS + w, vw, cm)
    store = np.where(live, u * PK_COLS + p * PK_HALF + c, -1)
    src = (i0 + u)[:, None] * gm + np.asarray(off)[p][:, None] + c[:, None] \
        + np.arange(vw)
    inside = live & (u < rvalid)
    flat = win.reshape(-1)
    words = store[:, None] + np.arange(vw)
    flat[words[live & ~inside].reshape(-1)] = 0.0
    flat[words[inside].reshape(-1)] = y.reshape(-1)[src[inside].reshape(-1)]
    return win, tvalid, {"reads": src[inside].reshape(-1),
                         "store": (store, vw)}


def _pk_stage_taps(hr, a, m, chunk, vec=None):
    """The block's staging of its columns' W tap rows into [W][128] (idle
    columns NaN); returns them and the record, as _pk_stage's."""
    w, gm = hr.shape
    cm, off = _pk_chunk(a, m, chunk)
    vw = _pk_width(a, m, vec)
    tsm = np.full((w, PK_COLS), np.nan, np.float32)
    u, p, c, live = _pk_items(w, vw, cm)
    store = np.where(live, u * PK_COLS + p * PK_HALF + c, -1)
    src = (u * gm + np.asarray(off)[p] + c)[:, None] + np.arange(vw)
    words = store[:, None] + np.arange(vw)
    tsm.reshape(-1)[words[live].reshape(-1)] = hr.reshape(-1)[
        src[live].reshape(-1)]
    return tsm, {"reads": src[live].reshape(-1), "store": (store, vw)}


def _fma32(a, b, c):
    """fmaf as float64 product and sum rounded to float32 (the same
    rounding on both sides of every comparison here)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _pk_first_sums(y, hr):
    """pfb_packed_kernel's branch sums: for each output row and lane one
    fmaf chain from 0 over ascending taps."""
    w = hr.shape[0]
    nout = y.shape[0] - (w - 1)
    acc = np.zeros((nout, y.shape[1]), np.float32)
    for wp in range(w):
        acc = _fma32(hr[wp], y[wp:wp + nout], acc)
    return acc


def _pk_fir(win, tsm, cm, tvalid):
    """The FIR lanes' schedule on one block's window and staged taps: job
    e = (strip q, column), column fastest, strips past the valid rows
    skipped; per lane 16 sums and a 16-slot window rotating with the tap
    step (taps in ascending order, each step an fmaf), the sums stored at
    their swizzled plane words.
    Returns the two planes (NaN where never written) and each warp-wide
    access's words, by kind."""
    w = tsm.shape[0]
    nq = -(-tvalid // PK_STRIP)
    e = np.arange(nq * PK_COLS)
    q, col = e // PK_COLS, e % PK_COLS
    p, c = col // PK_HALF, col % PK_HALF
    live = c < cm
    flat = win.reshape(-1)
    seen = {"window": [], "taps": [], "sums": []}

    def load(row):
        word = np.where(live, row * PK_COLS + col, -1)
        seen["window"].append(word)
        return flat[np.maximum(word, 0)]

    wv = [load(q * PK_STRIP + k) for k in range(PK_STRIP)]
    acc = [np.zeros(e.shape, np.float32) for _ in range(PK_STRIP)]
    for d in range(w):
        rr = d % PK_STRIP
        seen["taps"].append(np.where(live, d * PK_COLS + col, -1))
        tap = tsm[d, col]
        for s in range(PK_STRIP):
            acc[s] = _fma32(tap, wv[(s + rr) % PK_STRIP], acc[s])
        wv[rr] = load(q * PK_STRIP + PK_STRIP + d)
    planes = np.full((2, PK_ROWS * PK_HALF), np.nan, np.float32)
    for s in range(PK_STRIP):
        word = _pk_swz((q * PK_STRIP + s) * PK_HALF + c)
        planes[p[live], word[live]] = acc[s][live]
        seen["sums"].append(np.where(live, word, -1))
    return planes, seen


def _pk_dft(planes, m, cm, tvalid):
    """The DFT lanes: lane t holds plane words 16t .. 16t+15 of both planes
    (16/M groups of row t/4), read and written back as four 16-byte groups
    at pk_swz(16t) ^ 4k; the transform is the unscaled inverse (float64
    here).  Returns the planes and each warp-wide float4 access's words."""
    t = np.arange(PK_ROWS * 4)
    live = ((t >> 2) < tvalid) & (16 * (t & 3) < cm)
    b = _pk_swz(16 * t)
    words = [np.where(live, b ^ (4 * k), -1) for k in range(4)]
    out = planes.copy()
    idx = _pk_swz(16 * t[live][:, None] + np.arange(16))
    z = planes[0][idx].astype(np.float64) + 1j * planes[1][idx]
    z = np.fft.ifft(z.reshape(-1, 16 // m, m), axis=-1) * m
    z = z.reshape(-1, 16)
    out[0][idx] = z.real
    out[1][idx] = z.imag
    return out, {"dft": words}


def _pk_copy_out(planes, out, blk, a, m, chunk, tvalid, vec=None):
    """The copy-out: item e = (row, plane, column group) of the valid rows,
    each group read from pk_swz(r*64 + c) and written to out's row i0 + r
    at the plane's column.  Returns out's flat indices written and the
    reads' words (with width)."""
    gm = out.shape[1]
    cm, off = _pk_chunk(a, m, chunk)
    vw = _pk_width(a, m, vec)
    u, p, c, live = _pk_items(tvalid, vw, cm)
    word = _pk_swz(u * PK_HALF + c)
    dst = (blk * PK_ROWS + u)[:, None] * gm + np.asarray(off)[p][:, None] \
        + c[:, None] + np.arange(vw)
    for x in range(vw):
        out.reshape(-1)[dst[live, x]] = planes[p[live], word[live] + x]
    return dst[live].reshape(-1), (np.where(live, word, -1), vw)


def _pk_reg(y, hr, a, m, vec=None):
    """The whole kernel replayed block by block; returns out (NaN where
    never written), y's and hr's indices read and out's indices written,
    and every block's shared-memory access records."""
    w, gm = hr.shape
    nout = y.shape[0] - (w - 1)
    out = np.full((nout, gm), np.nan, np.float32)
    reads, tap_reads, writes, banks = [], [], [], []
    for blk in range(-(-nout // PK_ROWS)):
        for chunk in range(-(-a // (PK_HALF // m))):
            cm, _ = _pk_chunk(a, m, chunk)
            win, tvalid, rec = _pk_stage(y, blk, chunk, a, m, w, vec=vec)
            tsm, trec = _pk_stage_taps(hr, a, m, chunk, vec=vec)
            planes, seen = _pk_fir(win, tsm, cm, tvalid)
            planes, seen_dft = _pk_dft(planes, m, cm, tvalid)
            wr, copy = _pk_copy_out(planes, out, blk, a, m, chunk, tvalid,
                                    vec=vec)
            reads.append(rec["reads"])
            tap_reads.append(trec["reads"])
            writes.append(wr)
            banks.append({"stage": [rec["store"], trec["store"]],
                          "window": [(x, 1) for x in seen["window"]],
                          "taps": [(x, 1) for x in seen["taps"]],
                          "sums": [(x, 1) for x in seen["sums"]],
                          "dft": [(x, 4) for x in seen_dft["dft"]],
                          "copy_out": [copy]})
    return (out, (np.concatenate(reads), np.concatenate(tap_reads)),
            np.concatenate(writes), banks)


def _pk_warps_conflict_free(words, width):
    """Items in thread order, a warp per 32 consecutive items (-1: an idle
    lane): in each phase of 32/width lanes, no two distinct words share a
    bank (equal words are a broadcast)."""
    words = np.concatenate([words, -np.ones((-len(words)) % 32, int)])
    lanes = 32 // width
    for warp in words.reshape(-1, 32):
        for ph in range(width):
            seg = warp[ph * lanes:(ph + 1) * lanes]
            seg = seg[seg >= 0]
            wds = np.unique((seg[:, None] + np.arange(width)).reshape(-1))
            if len(np.unique(wds % 32)) != len(wds):
                return False
    return True


# (id, channels, antennas, prototype taps (None: the path's 400-tap design,
# W = 25), output rows): A = 1 and 3 part-fill a chunk, A = 5 at M = 16
# takes two chunks; ragged: 2 blocks and 7 rows; short: fewer than a block
PK_CASES = [
    ("m16_a4_w25_ragged", 16, 4, None, 2 * PK_ROWS + 7),
    ("m16_a1_w100_short", 16, 1, 1600, 20),
    ("m16_a3_w1_ragged", 16, 3, 16, PK_ROWS + 7),
    ("m16_a5_w25_two_chunks", 16, 5, None, PK_ROWS + 7),
    ("m8_a4_w1_short", 8, 4, 8, 20),
    ("m8_a1_w25_ragged", 8, 1, None, PK_ROWS + 7),
    ("m8_a3_w100_ragged", 8, 3, 800, PK_ROWS + 7),
    ("m4_a3_w25_short", 4, 3, None, 20),
    ("m4_a1_w1_ragged", 4, 1, 4, PK_ROWS + 7),
    ("m4_a4_w100_ragged", 4, 4, 400, PK_ROWS + 7),
    ("m2_a4_w25_ragged", 2, 4, None, PK_ROWS + 7),
    ("m2_a1_w100_short", 2, 1, 200, 20),
    ("m2_a3_w1_ragged", 2, 3, 2, PK_ROWS + 7),
]


@pytest.mark.parametrize("case", PK_CASES, ids=[c[0] for c in PK_CASES])
def test_pfb_packed_reg_schedule_matches_plain(case):
    """A replay of pfb_packed_reg_kernel (the chunked staging, the per-lane
    rotating window over W in strips of 16, the swizzled sums, the
    in-register DFT lanes, the copy-out) gives the plain form's outputs
    within 1e-5 × max|plain|, on ragged and short last blocks, part-filled
    and second chunks, W = 1, 25 and 100, and the word-by-word staging (M =
    2 at odd A).  Its sums, with every fmaf modelled as one rounding, are
    bit for bit pfb_packed_kernel's chains under the same model, and within
    1e-5 of the plain form's branch sums (a product and a sum rounded)."""
    _, m, a, ntaps0, nout = case
    y, hr, _, _ = _packed_inputs(nout, seed=21, a=a, m=m, ntaps0=ntaps0)
    w = hr.shape[0]
    got, _, _, _ = _pk_reg(y, hr, a, m)
    want = hk.pfb_channelize_packed_plain(torch.from_numpy(y),
                                          torch.from_numpy(hr), a, m)
    assert not np.isnan(got).any()
    close(got, want, REL_CPU)
    # the branch sums alone: one block's FIR planes
    first = _pk_first_sums(y, hr)
    acc = t_chan._packed_branch_sums(torch.from_numpy(y), torch.from_numpy(hr),
                                     nout).numpy()
    cm, off = _pk_chunk(a, m, 0)
    win, tvalid, _ = _pk_stage(y, 0, 0, a, m, w)
    planes, _ = _pk_fir(win, _pk_stage_taps(hr, a, m, 0)[0], cm, tvalid)
    r = np.arange(tvalid)[:, None]
    c = np.arange(cm)
    for p in range(2):
        sums = planes[p][_pk_swz(r * PK_HALF + c)]
        assert np.array_equal(sums, first[:tvalid, off[p]:off[p] + cm])
        close(sums, acc[:tvalid, off[p]:off[p] + cm], REL_CPU)


@pytest.mark.parametrize("case", PK_CASES, ids=[c[0] for c in PK_CASES])
def test_pfb_packed_reg_reads_stay_inside(case):
    """Every block reads only inside y and hr — the rows of its valid
    outputs' reach and every tap row, each of its real columns — and every
    output word is written by exactly one block."""
    _, m, a, ntaps0, nout = case
    y, hr, _, _ = _packed_inputs(nout, seed=22, a=a, m=m, ntaps0=ntaps0)
    w, gm = hr.shape
    _, (reads, tap_reads), writes, _ = _pk_reg(y, hr, a, m)
    assert reads.min() >= 0 and reads.max() < y.size
    assert np.array_equal(np.unique(reads), np.arange(y.size))
    assert np.array_equal(np.unique(tap_reads), np.arange(hr.size))
    nblk = -(-nout // PK_ROWS)
    assert len(tap_reads) == nblk * hr.size     # each block all its taps
    assert np.array_equal(np.sort(writes), np.arange(nout * gm))
    for blk in range(-(-nout // PK_ROWS)):        # each block's own rows
        _, tvalid, rec = _pk_stage(y, blk, 0, a, m, w)
        rows = rec["reads"] // gm
        assert rows.min() == blk * PK_ROWS
        assert rows.max() == blk * PK_ROWS + tvalid + w - 2


@pytest.mark.parametrize("m", [2, 4, 8, 16])
@pytest.mark.parametrize("a", [1, 3, 4])
def test_pfb_packed_reg_shared_memory_banks(m, a):
    """Every warp-wide shared-memory access of pfb_packed_reg_kernel is on
    32 distinct banks: the staging's stores of y and of the taps (16-byte
    cp.async, or words), the FIR's window and tap loads and its sums'
    stores, the DFT's float4 loads
    and stores, the copy-out's loads; quarter-warp phases for 16-byte
    accesses.  The sums' swizzle is a bijection that keeps 16-byte groups
    whole."""
    ntaps0 = {2: None, 4: 100, 8: 200, 16: None}[m]
    y, hr, _, _ = _packed_inputs(PK_ROWS + 7, seed=23, a=a, m=m,
                                 ntaps0=ntaps0)
    for vec in {_pk_vec(a, m), False}:
        _, _, _, banks = _pk_reg(y, hr, a, m, vec=vec)
        for rec in banks:
            for kind, accesses in rec.items():
                for words, width in accesses:
                    assert _pk_warps_conflict_free(words, width), kind
    x = np.arange(PK_ROWS * PK_HALF)
    assert sorted(_pk_swz(x)) == list(x)
    assert (_pk_swz(x) // 4 == _pk_swz(x // 4 * 4) // 4).all()
    t, k = np.divmod(x // 4 * 4, 16)
    assert (_pk_swz(16 * t + k) == _pk_swz(16 * t) ^ k).all()


# --------------------------------------------------------------------------
# pfb_packed_wide_kernel (csrc/pfb_packed.cu, M in {32, 64, 128}) modelled in
# numpy: its block of PW_OUTS / M output rows of one antenna's 2M window
# columns (M re lanes, then M im lanes), its FIR strip and its 256 threads,
# one FIR job a thread; shared-memory accesses recorded in thread order
# --------------------------------------------------------------------------

PW_OUTS, PW_STRIP, PW_THREADS = 4096, 16, 256


def _pw_rows(m):
    return PW_OUTS // m


def _pw_stage(src, u0, nrows, valid, m, off, vec=True):
    """Rows [0, nrows) of the block's 2M columns of ``src`` from its row
    ``u0`` (re lanes at column off[0], im lanes at off[1]) into [nrows][2M],
    rows at or past ``valid`` zero and not read.  Returns them, src's flat
    indices read and the stores' record (item words, width)."""
    gm = src.shape[1]
    vw = 4 if vec else 1
    word = np.arange(nrows * 2 * m // vw) * vw
    u, col = np.divmod(word, 2 * m)
    c = np.where(col < m, off[0] + col, off[1] + col - m)
    inside = u < valid
    dst = np.zeros((nrows, 2 * m), np.float32)
    idx = ((u0 + u) * gm + c)[:, None] + np.arange(vw)
    words = word[:, None] + np.arange(vw)
    dst.reshape(-1)[words[inside].reshape(-1)] = src.reshape(-1)[
        idx[inside].reshape(-1)]
    return dst, idx[inside].reshape(-1), (word, vw)


def _pw_fir(win, tsm, m, words):
    """The FIR jobs on a staged window and taps: job e = (strip e / M of
    PW_STRIP rows, column j = e mod M) on thread e, both components; per
    lane 16 complex sums and a 16-slot window rotating with the tap step
    (ascending taps, each step an fmaf), the last refill reading row 16 +
    W - 1 of the strip.  Returns the sums [rows, M] of each component."""
    w = tsm.shape[0]
    s = PW_STRIP
    e = np.arange(PW_OUTS // s)
    j = e % m
    s0 = e // m * s
    flat, tflat = win.reshape(-1), tsm.reshape(-1)

    def load(row):
        assert row.max() < win.shape[0]
        wd = row * 2 * m + j
        words["window"] += [wd, wd + m]
        return flat[wd], flat[wd + m]

    ring = [load(s0 + k) for k in range(s)]
    vr, vi = [v[0] for v in ring], [v[1] for v in ring]
    ar = [np.zeros(len(e), np.float32) for _ in range(s)]
    ai = [np.zeros(len(e), np.float32) for _ in range(s)]
    for d in range(w):
        rr = d % s
        wd = d * 2 * m + j
        words["taps"] += [wd, wd + m]
        tr, ti = tflat[wd], tflat[wd + m]
        for ss in range(s):
            ar[ss] = _fma32(tr, vr[(ss + rr) % s], ar[ss])
            ai[ss] = _fma32(ti, vi[(ss + rr) % s], ai[ss])
        vr[rr], vi[rr] = load(s0 + s + d)
    rows = _pw_rows(m)
    sr = np.zeros((rows, m), np.float32)
    si = np.zeros((rows, m), np.float32)
    for ss in range(s):
        sr[s0 + ss, j], si[s0 + ss, j] = ar[ss], ai[ss]
    return sr, si


def _pw_block(y, hr, blk, ant, a, m, vec=True, words=None):
    """Block (blk, ant) of pfb_packed_wide_kernel replayed: staging, FIR,
    the sums at their fir_slot (overlaying the window), the two-pass
    transform of each warp's tile, the bins at their out_slot and the
    copy-out.  Returns the FIR sums, the out words written and their
    values, and y's and hr's flat indices read."""
    w, gm = hr.shape
    nout = y.shape[0] - (w - 1)
    rb = _pw_rows(m)
    q_, gw, _ = _wq(m)
    words = collections.defaultdict(list) if words is None else words
    off = (ant * m, (a + ant) * m)
    i0 = blk * rb
    tvalid = min(rb, nout - i0)
    win, reads, st = _pw_stage(y, i0, rb + w, tvalid + w - 1, m, off, vec)
    tsm, tap_reads, tst = _pw_stage(hr, 0, w, w, m, off, vec)
    words["stage"] += [st, tst]
    sr, si = _pw_fir(win, tsm, m, words)
    z = np.zeros(PW_OUTS, np.complex128)
    e = np.arange(PW_OUTS // PW_STRIP)
    for ss in range(PW_STRIP):
        g = e // m * PW_STRIP + ss
        slot = _w_fir_slot(g, e % m, m)
        words["sums"].append(2 * slot)
        z[slot] = sr[g, e % m] + 1j * si[g, e % m].astype(np.float64)
    _, gl, q = _w_lanes(m)
    for warp in range(PW_THREADS // 32):
        g = warp * gw + gl
        slots = [_w_fir_slot(g, q + q_ * mm, m) for mm in range(16)]
        words["dft load"] += [2 * sl for sl in slots]
        v = np.stack([z[sl] for sl in slots], 1)
        out = _w_transform(v, z, g, q, m, words, "dft")
        for i in range(16):
            slot = _w_out_slot(g, _w_bin(i, q, m), m)
            words["dft store"].append(2 * slot)
            z[slot] = out[:, i]
    idx, vals = [], []
    lane = np.arange(32)
    for warp in range(PW_THREADS // 32):
        gw0 = warp * gw
        valid = min(gw, tvalid - gw0) * m
        for x0 in range(0, max(valid, 0), 128):
            x = x0 + 4 * lane
            live = x < valid
            gg, k = gw0 + x // m, x % m
            p0, p1 = _w_out_slot(gg, k, m), _w_out_slot(gg, k + 2, m)
            words["copy-out"] += [np.where(live, 2 * p0, -1),
                                  np.where(live, 2 * p1, -1)]
            bins = np.stack([z[p0], z[p0 + 1], z[p1], z[p1 + 1]], 1)[live]
            row = (i0 + gg[live]) * gm + k[live]
            for c, part in ((off[0], bins.real), (off[1], bins.imag)):
                idx.append((row + c)[:, None] + np.arange(4))
                vals.append(part)
    return ((sr[:tvalid], si[:tvalid]), np.concatenate(idx).reshape(-1),
            np.concatenate(vals).reshape(-1), (reads, tap_reads))


def _pw_kernel(y, hr, a, m, vec=True):
    """Every block replayed; returns out (NaN where never written), the FIR
    sums of every block as [nout, 2AM] lanes, out's flat indices written
    and the reads of y and hr, block by block."""
    w, gm = hr.shape
    nout = y.shape[0] - (w - 1)
    out = np.full((nout, gm), np.nan)
    sums = np.full((nout, gm), np.nan, np.float32)
    writes, reads = [], []
    rb = _pw_rows(m)
    for blk in range(-(-nout // rb)):
        for ant in range(a):
            (sr, si), idx, vals, rd = _pw_block(y, hr, blk, ant, a, m, vec)
            out.reshape(-1)[idx] = vals
            rows = slice(blk * rb, blk * rb + len(sr))
            sums[rows, ant * m:(ant + 1) * m] = sr
            sums[rows, (a + ant) * m:(a + ant + 1) * m] = si
            writes.append(idx)
            reads.append((blk, rd))
    return out, sums, np.concatenate(writes), reads


# (channels, antennas, taps a branch, output rows): every M at A = 1, 3
# and 4 and W = 1 and 25, the rows ragged (two blocks and 7 rows, one and
# 5) or short (20, fewer than a block)
PW_CASES = [(m, a, w, nout(m)) for m in (32, 64, 128)
            for a, w, nout in ((1, 25, lambda m: 2 * _pw_rows(m) + 7),
                               (3, 1, lambda m: _pw_rows(m) + 5),
                               (4, 25, lambda m: 20),
                               (1, 1, lambda m: 20),
                               (3, 25, lambda m: _pw_rows(m) + 5),
                               (4, 1, lambda m: 2 * _pw_rows(m) + 7))]
PW_IDS = [f"m{m}_a{a}_w{w}_n{n}" for m, a, w, n in PW_CASES]


@pytest.mark.parametrize("m,a,w,nout", PW_CASES, ids=PW_IDS)
def test_pfb_packed_wide_schedule_matches_plain(m, a, w, nout):
    """A replay of pfb_packed_wide_kernel (the staging of the window and
    the taps, the per-lane rotating window over W in strips of 16 for both
    components, the sums overlaying the window at fir_slot, the two-pass
    transform of each warp's tile, the copy-out from out_slot) gives the
    plain form's outputs within 1e-5 × max|plain| on ragged and short last
    blocks, W = 1 and 25, A = 1, 3 and 4.  Its sums, with every fmaf
    modelled as one rounding, are bit for bit pfb_packed_kernel's chains
    under the same model."""
    y, hr, _, _ = _packed_inputs(nout, seed=40 + m + a + w, a=a, m=m,
                                 ntaps0=w * m)
    assert hr.shape[0] == w
    got, sums, _, _ = _pw_kernel(y, hr, a, m)
    want = hk.pfb_channelize_packed_plain(torch.from_numpy(y),
                                          torch.from_numpy(hr), a, m)
    assert not np.isnan(got).any()
    close(got, want, REL_CPU)
    assert np.array_equal(sums, _pk_first_sums(y, hr))


@pytest.mark.parametrize("m,a,w,nout", PW_CASES[::2], ids=PW_IDS[::2])
def test_pfb_packed_wide_reads_stay_inside(m, a, w, nout):
    """Every block reads only inside y — the rows of its valid outputs'
    reach (i0 .. i0 + tvalid + W - 2), its antenna's 2M columns — and its
    antenna's 2M tap columns of every row of hr; together the blocks read
    all of y and hr, and every output word is written exactly once."""
    y, hr, _, _ = _packed_inputs(nout, seed=50 + m + a, a=a, m=m,
                                 ntaps0=w * m)
    gm = hr.shape[1]
    _, _, writes, reads = _pw_kernel(y, hr, a, m, vec=False)
    seen_y, seen_hr = [], []
    rb = _pw_rows(m)
    for blk, (ry, rh) in reads:
        assert ry.min() >= 0 and ry.max() < y.size
        rows = ry // gm
        tvalid = min(rb, nout - blk * rb)
        assert rows.min() == blk * rb
        assert rows.max() == blk * rb + tvalid + w - 2
        assert len(rh) == 2 * m * w
        seen_y.append(ry)
        seen_hr.append(rh)
    assert np.array_equal(np.unique(np.concatenate(seen_y)), np.arange(y.size))
    assert np.array_equal(np.unique(np.concatenate(seen_hr)),
                          np.arange(hr.size))
    assert np.array_equal(np.sort(writes), np.arange(nout * gm))


@pytest.mark.parametrize("m", [32, 64, 128])
@pytest.mark.parametrize("vec", [True, False], ids=["vec", "words"])
def test_pfb_packed_wide_shared_memory_banks(m, vec):
    """Every warp-wide shared-memory access of pfb_packed_wide_kernel is on
    32 distinct banks: the staging's stores (16-byte cp.async in
    quarter-warp phases, or words), the FIR's window and tap loads, the
    sums' float2 stores at fir_slot, the transform's loads, exchange and
    out_slot stores (half-warp phases), the copy-out's 16-byte loads; the
    pass-1 table's entries broadcast.  The sums fit the window they
    overlay, and the copy-out's (re, im) pairs sit at even slots."""
    a = 3
    y, hr, _, _ = _packed_inputs(_pw_rows(m) + 5, seed=60 + m, a=a, m=m,
                                 ntaps0=25 * m)
    words = collections.defaultdict(list)
    _pw_block(y, hr, 1, 2, a, m, vec=vec, words=words)
    assert set(words) == {"stage", "window", "taps", "sums", "dft load",
                          "dft pass1 store", "dft pass2 load", "dft store",
                          "dft table", "copy-out"}
    for st, width in words.pop("stage"):
        assert _pk_warps_conflict_free(st, width), "stage"
    for wd in words.pop("copy-out"):
        assert _pk_warps_conflict_free(wd, 4), "copy-out"
        assert (wd[wd >= 0] % 4 == 0).all()
    for kind, addrs in words.items():
        width = 1 if kind in ("window", "taps") else 2
        assert _banks_ok(addrs, width=width), kind
    g, j = np.divmod(np.arange(PW_OUTS), m)    # the sums' slots fill the
    assert sorted(_w_fir_slot(g, j, m)) == list(range(PW_OUTS))   # window's
    assert 2 * PW_OUTS <= 2 * m * (_pw_rows(m) + 1)        # first RB rows


H100_SMEM_OPTIN = 232448    # an H100's opt-in shared memory per block, B


def _pk_reg_smem_bytes(w):
    """pfb_packed_reg_kernel's block: a window of 32 + W rows, two sums
    planes of 32 rows and W tap rows, 128 columns of float32 (the card test
    holds it to clen_pfb_smem_bytes)."""
    return 4 * PK_COLS * (PK_ROWS + w + PK_ROWS + w)


def _pw_smem_bytes(m, w):
    """pfb_packed_wide_kernel's block: a window of 4096/m + W rows (the
    complex sums overlay it), W tap rows, 2m columns of float32, and the
    pass-1 table of m float2 (the card test holds it to
    clen_pfb_smem_bytes)."""
    return 4 * 2 * m * (_pw_rows(m) + w) + 4 * 2 * m * w + 8 * m


# the largest W whose block fits an H100's opt-in shared memory, by body
# and M: pfb_packed_reg_kernel's (any M <= 16) and pfb_packed_wide_kernel's
PK_MAX_W = {2: 195, 4: 195, 8: 195, 16: 195, 32: 389, 64: 194, 128: 97}


def test_pfb_packed_body_by_shape():
    """pfb_packed_reg_kernel at M in {2, 4, 8, 16} and
    pfb_packed_wide_kernel at M in {32, 64, 128}, each wherever its block
    fits the opt-in shared memory (here an H100's 232,448 B: W <= 195 for
    the first, 389, 194 and 97 for the second), pfb_packed_kernel at other
    M and past that size; the rows a block of each body; pfb_packed_body
    names a CUDA body only, and refuses m or w below 1 before it asks a
    card."""
    assert hk.PFB_PACKED_BODIES == ("pfb_packed_kernel",
                                    "pfb_packed_reg_kernel",
                                    "pfb_packed_wide_kernel")
    assert hk.PFB_REG_ROWS == PK_ROWS
    assert hk.PFB_WIDE_M == (32, 64, 128) and hk.PFB_WIDE_OUTS == PW_OUTS
    optin = H100_SMEM_OPTIN
    assert _pk_reg_smem_bytes(25) == 4 * 128 * 114
    assert _pk_reg_smem_bytes(195) == optin
    for m, wmax in PK_MAX_W.items():
        smem = _pk_reg_smem_bytes if m <= 16 else (
            lambda w, m=m: _pw_smem_bytes(m, w))
        assert smem(wmax) <= optin < smem(wmax + 1)
    assert _pw_smem_bytes(64, 25) == 58880      # three blocks an SM
    for m in (1, 2, 3, 4, 8, 16, 32, 48, 64, 128, 256):
        for w in (1, 25, 97, 98, 100, 194, 195, 196, 389, 390):
            fits = w <= PK_MAX_W.get(m, 0)
            want = ("pfb_packed_reg_kernel" if m <= 16 and fits
                    else "pfb_packed_wide_kernel" if fits
                    else "pfb_packed_kernel")
            smem = (_pk_reg_smem_bytes(w) if m in hk.PFB_REG_M
                    else _pw_smem_bytes(m, w) if m in hk.PFB_WIDE_M else 0)
            assert hk._pick_pfb_body(m, smem, optin) == want, (m, w)
    for a, m in ((4, 16), (1, 2), (64, 2)):
        assert hk.pfb_packed_tile(a, m, 1) == PK_ROWS
        assert hk.pfb_packed_tile(a, m, 0) == max(1, 4096 // (2 * a * m))
    for a, m in ((4, 32), (1, 64), (3, 128)):
        assert hk.pfb_packed_tile(a, m, 2) == _pw_rows(m)
        assert hk.pfb_packed_tile(a, m, 0) == max(1, 4096 // (2 * a * m))
    for m, w in ((0, 25), (16, 0)):
        with pytest.raises(ValueError):
            hk.pfb_packed_body(m, w, "cuda")
    with pytest.raises(ValueError):
        hk.pfb_packed_body(16, 25, "cpu")


def test_pfb_ab_cli_arguments():
    """The packed PFB variants tool's arguments, at M = 16 and at the wide
    body's M = 32, 64 and 128; without a card it exits non-zero."""
    from clenabled_tpu_torch.tools import pfb_ab as cli

    args = cli.parse_args([])
    assert (args.variants, args.samples, args.a, args.m, args.rounds,
            args.calls) == ([], [1 << 17, 1 << 23], 4, 16, 7, 10)
    args = cli.parse_args(["old=_local/pfb_packed_old.cu",
                           "s1=-DPFB_STOP_AFTER=1", "pr1=first_body",
                           "--samples", "131072", "--m", "8",
                           "--rounds", "3"])
    assert (args.variants, args.samples, args.m, args.rounds) == (
        ["old=_local/pfb_packed_old.cu", "s1=-DPFB_STOP_AFTER=1",
         "pr1=first_body"], [1 << 17], 8, 3)
    assert set(cli.STAGE_PROBES.values()) == {"-DPFB_STOP_AFTER=1",
                                              "-DPFB_STOP_AFTER=2"}
    for m in hk.PFB_WIDE_M:      # the wide body's shapes and its probes
        args = cli.parse_args(["--m", str(m), "--samples", "8388608"])
        assert (args.m, args.samples, args.variants) == (m, [1 << 23], [])
    if not torch.cuda.is_available():
        assert cli.main(["--samples", "4096"]) == 1
        assert cli.main(["--m", "64", "--samples", "4096"]) == 1


def test_step_ab_cli_arguments():
    """The planar step's tool across trees: its arguments and its default
    variant (the root of the package it runs from); without a card it exits
    non-zero."""
    from clenabled_tpu_torch.tools import step_ab as cli

    args = cli.parse_args([])
    assert (args.variants, args.samples, args.a, args.m, args.steps,
            args.reps, args.rounds, args.child) == (
        [], 1 << 17, 4, 16, 3, 30, 2, None)
    args = cli.parse_args(["parent=_local/parent", "tree=.", "--samples",
                           "4096", "--reps", "5", "--rounds", "1"])
    assert (args.variants, args.samples, args.reps, args.rounds) == (
        ["parent=_local/parent", "tree=."], 4096, 5, 1)
    assert (cli.PACKAGE_ROOT / "clenabled_tpu_torch" / "tools"
            / "step_ab.py").is_file()
    if not torch.cuda.is_available():
        assert cli.main(["--samples", "4096"]) == 1
