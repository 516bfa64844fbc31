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


@pytest.mark.parametrize("m", [2, 4, 8, 16])
@pytest.mark.parametrize("a", [1, 4])
def test_pfb_packed_plain_matches_jax_by_shape(ref, m, a):
    """The plain form against the Pallas kernel in interpret mode at every
    M the register-tiled body serves, one antenna and four."""
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
    ("unaligned", 4, 16, None, 8192 + 7, True)]


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
    register-tiled body serves, A = 1, 3 and 5 (part-filled and second
    chunks), the word-by-word staging (M = 2 at odd A, and y 4 bytes off
    alignment), W = 1 and 100, ragged and short last blocks, and M = 32 (the
    first body), each held to the plain form."""
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
@pytest.mark.parametrize("a,m,ntaps0", [(4, 16, None), (3, 2, None),
                                        (4, 32, None), (4, 16, 4800)],
                         ids=["m16", "m2_a3", "m32", "m16_w300"])
def test_pfb_packed_launches_its_body_on_card(card, a, m, ntaps0):
    """A call launches the body pfb_packed_body names (torch.profiler's
    kernel names), once, and nothing of the other: pfb_packed_reg_kernel
    at M <= 16, pfb_packed_kernel at M = 32 and at W = 300, whose
    register-tiled block (4 · 128 · (64 + 2 W) B) would not fit the card's
    opt-in shared memory (the first body's, 4 · 128 · (63 + W) B, does)."""
    from clenabled_tpu_torch.runtime.device import launched_kernels

    y, hr, a, m = _packed_on_card(card, ("", a, m, ntaps0, 1000, False), 33)
    w = hr.shape[0]
    body = hk.pfb_packed_body(m, w, card)
    assert body == ("pfb_packed_reg_kernel" if m <= 16 and w <= 195
                    else "pfb_packed_kernel")
    assert hk._load().clen_pfb_smem_bytes(a, m, w, hk.PFB_REG_ROWS, 1) == \
        _pk_reg_smem_bytes(w)
    other, = set(hk.PFB_PACKED_BODIES) - {body}
    got, events = launched_kernels(
        lambda: hk.pfb_channelize_packed(y, hr, a, m))
    assert sum(body in e for e in events) == 1
    assert not any(other in e for e in events)
    close(got, hk.pfb_channelize_packed_plain(y, hr, a, m), REL_CARD)


# (id, fd_pairs, xe_pairs) for the flat-layout entry (B.1b)
FLAT_CASES = [("default", None, None),
              ("pairs", [(0, 3)], [(0, 1), (2, 3), (1, 1)])]


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
    _, fdp, xep = case
    comps, hist, taps_rm, a, m = _flat_inputs(512 * 16, seed=7)
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
    _, fdp, xep = case
    comps, hist, taps_rm, a, m = _flat_inputs(1 << 16, seed=9)
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


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64, 128])
def test_fx_body_by_m(m):
    want = "fx_reg_kernel" if m in (2, 4, 8, 16) else "fx_tile_kernel"
    assert hk.fx_body(m) == want
    assert want in hk.FX_BODIES
    assert hk.fx_tile(m) == max(1, (1024 if m in (2, 4, 8, 16) else 512) // m)


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
    that fx_body(m) names (torch.profiler's kernel names) and nothing of
    the other, and agrees with its plain form."""
    from clenabled_tpu_torch.runtime.device import launched_kernels

    case = (f"m{m}", 4, "float32", 1 << 15, None, None, None, m)
    arrs, taps_rm, a, _, _, _, _ = _fx_inputs(case, seed=12)
    args = [_torch(x, "float32", card) for x in arrs]
    taps = torch.from_numpy(taps_rm).to(card)
    comps, hist, _, _, _ = _flat_inputs(1 << 15, seed=13, a=a, m=m)
    c, hi = torch.from_numpy(comps).to(card), torch.from_numpy(hist).to(card)
    body = hk.fx_body(m)
    other, = set(hk.FX_BODIES) - {body}
    (got, got1), events = launched_kernels(
        lambda: (hk.fx_correlate_streams_v2(*args, taps, a, m),
                 hk.fx_correlate_streams(c, hi, taps, a, m)), least=2)
    assert sum(body in e for e in events) == 2
    assert not any(other in e for e in events)
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


H100_SMEM_OPTIN = 232448    # an H100's opt-in shared memory per block, B


def _pk_reg_smem_bytes(w):
    """pfb_packed_reg_kernel's block: a window of 32 + W rows, two sums
    planes of 32 rows and W tap rows, 128 columns of float32 (the card test
    holds it to clen_pfb_smem_bytes)."""
    return 4 * PK_COLS * (PK_ROWS + w + PK_ROWS + w)


def test_pfb_packed_body_by_shape():
    """pfb_packed_reg_kernel at M in {2, 4, 8, 16} wherever its block fits
    the opt-in shared memory (here an H100's 232,448 B: W <= 195),
    pfb_packed_kernel at other M and past that size; pfb_packed_body names
    a CUDA body only, and refuses m or w below 1 before it asks a card."""
    assert hk.PFB_PACKED_BODIES == ("pfb_packed_kernel",
                                    "pfb_packed_reg_kernel")
    assert hk.PFB_REG_ROWS == PK_ROWS
    optin = H100_SMEM_OPTIN
    assert _pk_reg_smem_bytes(25) == 4 * 128 * 114
    assert _pk_reg_smem_bytes(195) == optin
    for m in (1, 2, 3, 4, 8, 16, 32, 64):
        for w in (1, 25, 100, 195, 196):
            want = ("pfb_packed_reg_kernel" if m in (2, 4, 8, 16) and w <= 195
                    else "pfb_packed_kernel")
            assert hk._pick_pfb_body(m, _pk_reg_smem_bytes(w), optin) == want
    for a, m in ((4, 16), (1, 2), (64, 2)):
        assert hk.pfb_packed_tile(a, m, 1) == PK_ROWS
        assert hk.pfb_packed_tile(a, m, 0) == max(1, 4096 // (2 * a * m))
    for m, w in ((0, 25), (16, 0)):
        with pytest.raises(ValueError):
            hk.pfb_packed_body(m, w, "cuda")
    with pytest.raises(ValueError):
        hk.pfb_packed_body(16, 25, "cpu")


def test_pfb_ab_cli_arguments():
    """The packed PFB variants tool's arguments; without a card it exits
    non-zero."""
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
    if not torch.cuda.is_available():
        assert cli.main(["--samples", "4096"]) == 1


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
