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


def _packed_inputs(nout, seed):
    a, m = 4, 16
    taps_rm, ntaps = _taps(m)
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
