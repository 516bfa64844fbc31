"""Port parity: the X-Engine — unpacking, engines, the stacked Gram kernel
B.4 and pipeline integration.

The same numpy inputs (seeded) go through the JAX functions on the CPU
(the Gram's Pallas kernel in interpret mode) and through the port's plain
torch forms.  int8 results must be equal bit for bit (integer sums are
exact on both sides; the scale is one float32 multiply).  float32 and
bfloat16 results are held to 1e-5 × max|ref|: float32 sums in another
order than XLA's (bf16 products of ≤8-bit values are exact in float32).
On a card (``cuda`` marker) the Gram kernel is held to its plain form on
the same device: int8 equal, bfloat16 within 1e-4 × max|plain| (the sums
pass 2^24, where float32 rounds).
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu.dsp import pallas_kernels as j_pk
    from clenabled_tpu.dsp import planar as j_planar
    from clenabled_tpu.dsp import xengine as j_xe
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.dsp import planar
from clenabled_tpu_torch.dsp import xengine as xe

REL = 1e-5
REL_CARD = 1e-4
TRI, FULL = xe.CLXCORR_TRIANGULAR_ORDER, xe.CLXCORR_FULL_MATRIX


def np_of(x):
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(got, want, rel=REL):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def equal(got, want):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def match(got, want, dt):
    (equal if dt == "int8" else close)(got, want)


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


def _ints(seed, shape, lim=127):
    return np.random.default_rng(seed).integers(-lim, lim + 1, shape)


def _t(arr, dt, device="cpu"):
    return torch.from_numpy(np.asarray(arr)).to(device=device,
                                                dtype=getattr(torch, dt))


def _j(arr, dt):
    return jnp.asarray(arr, dtype=getattr(jnp, dt))


# --------------------------------------------------------------------------
# unpacking: every byte value, in both the I and the Q position
# --------------------------------------------------------------------------

_BYTES = np.stack([np.arange(256), np.arange(256)[::-1]], -1).ravel()
UNPACKS = ["unpack_char", "unpack_char_int8", "unpack_char_planar",
           "unpack_packed_4bit", "unpack_packed_4bit_int8",
           "unpack_packed_4bit_planar"]


@pytest.mark.parametrize("name", UNPACKS)
@pytest.mark.parametrize("byte_type", ["uint8", "int8"])
def test_unpack_matches_jax_for_all_bytes(ref, name, byte_type):
    raw = _BYTES.astype(np.uint8).view(byte_type)
    got = getattr(xe, name)(torch.from_numpy(raw.copy()))
    want = getattr(j_xe, name)(raw)
    if name.endswith("_planar") or name.endswith("_int8"):
        want_dt = torch.int8 if name.endswith("_int8") else torch.float32
        for g, w in zip(got, want):
            assert g.dtype == want_dt
            equal(g, w)
    else:
        assert got.dtype == torch.complex64
        equal(torch.view_as_real(got), np.stack(
            [np.asarray(want).real, np.asarray(want).imag], -1))


def test_nib_signed_matches_twos_lut():
    nib = torch.arange(16, dtype=torch.int32)
    assert xe._nib_signed(nib).tolist() == xe._TWOS_LUT.astype(int).tolist()
    re8, im8 = xe.unpack_packed_4bit_int8(torch.arange(256).to(torch.uint8))
    raw = np.arange(256)
    equal(re8, xe._TWOS_LUT[raw >> 4].astype(np.int8))
    equal(im8, xe._TWOS_LUT[raw & 0xF].astype(np.int8))
    re8, im8 = xe.unpack_char_int8([1, -2, 3, -4])
    assert re8.tolist() == [1, 3] and im8.tolist() == [-2, -4]


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------

# (id, channels, frames, stations, pols): k = S·P/128 lane blocks
SHAPES = [("k1", 4, 256, 64, 2), ("k2", 2, 128, 128, 2)]


def _cm_inputs(shape, dt, seed):
    _, f, t, s, p = shape
    q = _ints(seed, (2, f, t, s * p), 63 if dt == "int8" else 127)
    return q[0], q[1], s, p


@pytest.mark.parametrize("fmt", [TRI, FULL], ids=["tri", "full"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_channel_major_matches_jax(ref, shape, dt, fmt):
    qr, qi, s, p = _cm_inputs(shape, dt, 1)
    want = j_xe.xengine_correlate_channel_major(_j(qr, dt), _j(qi, dt), npol=p,
                                                output_format=fmt)
    got = xe.xengine_correlate_channel_major(_t(qr, dt), _t(qi, dt), npol=p,
                                             output_format=fmt)
    close(got.re, want.re)
    close(got.im, want.im)


@pytest.mark.parametrize("fmt", [TRI, FULL], ids=["tri", "full"])
@pytest.mark.parametrize("dt", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_stacked_matches_jax(ref, shape, dt, fmt):
    """The port's stacked engine, through the Gram wrappers (use_kernel,
    their plain forms on the CPU) and through batched products, against
    JAX's einsum path; int8 also against JAX's Pallas kernel."""
    qr, qi, s, p = _cm_inputs(shape, dt, 2)
    scale = 1.0 / 127 ** 2 if dt == "int8" else 1.0
    want = j_xe.xengine_correlate_stacked(_j(qr, dt), _j(qi, dt), npol=p,
                                          output_format=fmt, scale=scale,
                                          use_pallas=False)
    wants = [want]
    if dt == "int8":
        wants.append(j_xe.xengine_correlate_stacked(
            _j(qr, dt), _j(qi, dt), npol=p, output_format=fmt, scale=scale,
            use_pallas=True))
    for use in (True, False):
        got = xe.xengine_correlate_stacked(_t(qr, dt), _t(qi, dt), npol=p,
                                           output_format=fmt, scale=scale,
                                           use_kernel=use)
        assert got.re.dtype == torch.float32
        for w in wants:
            match(got.re, w.re, dt)
            match(got.im, w.im, dt)


@pytest.mark.parametrize("fmt", [TRI, FULL], ids=["tri", "full"])
@pytest.mark.parametrize("dt", ["int8", "bfloat16"])
def test_stacked_kernel_route_pads_lanes(ref, dt, fmt):
    """S·P = 8 (4 stations × 2 pols, the synchronised X-Engine example's
    width) through the Gram wrappers: the lanes are zero-padded to 128 and
    the result is JAX's einsum path's, int8 bit for bit."""
    qr, qi, s, p = _cm_inputs(("s4", 8, 64, 4, 2), dt, 6)
    scale = 1.0 / 127 ** 2 if dt == "int8" else 1.0
    want = j_xe.xengine_correlate_stacked(_j(qr, dt), _j(qi, dt), npol=p,
                                          output_format=fmt, scale=scale,
                                          use_pallas=False)
    got = xe.xengine_correlate_stacked(_t(qr, dt), _t(qi, dt), npol=p,
                                       output_format=fmt, scale=scale,
                                       use_kernel=True)
    match(got.re, want.re, dt)
    match(got.im, want.im, dt)


def test_stacked_auto_rule_and_compute_dtype(ref):
    """Auto routing picks the products on the CPU; compute_dtype casts
    first, as in JAX."""
    qr, qi, s, p = _cm_inputs(SHAPES[0], "float32", 3)
    assert not xe._stacked_use_kernel(_t(qr, "int8"), 128)
    want = j_xe.xengine_correlate_stacked(_j(qr, "float32"), _j(qi, "float32"),
                                          compute_dtype=jnp.bfloat16,
                                          use_pallas=False)
    got = xe.xengine_correlate_stacked(_t(qr, "float32"), _t(qi, "float32"),
                                       compute_dtype=torch.bfloat16)
    close(got.re, want.re)
    close(got.im, want.im)


def test_time_major_engines_match_jax(ref):
    rng = np.random.default_rng(4)
    t, s, f, p = 16, 5, 8, 2
    zr = rng.standard_normal((t, s, f, p)).astype(np.float32)
    zi = rng.standard_normal((t, s, f, p)).astype(np.float32)
    for fmt in (TRI, FULL):
        want = j_xe.xengine_correlate((zr + 1j * zi).astype(np.complex64),
                                      npol=p, output_format=fmt)
        got = xe.xengine_correlate(torch.complex(_t(zr, "float32"),
                                                 _t(zi, "float32")),
                                   npol=p, output_format=fmt)
        close(torch.view_as_real(got), np.stack(
            [np.asarray(want).real, np.asarray(want).imag], -1))
        want = j_xe.xengine_correlate_planar(j_planar.PC(zr, zi), npol=p,
                                             output_format=fmt)
        got = xe.xengine_correlate_planar(planar.PC(_t(zr, "float32"),
                                                    _t(zi, "float32")),
                                          npol=p, output_format=fmt)
        close(got.re, want.re)
        close(got.im, want.im)


@pytest.mark.parametrize("fmt", [TRI, FULL], ids=["triangular", "full"])
def test_planar_compute_dtype_matches_jax(ref, fmt):
    """bf16 operands of 8-bit samples: every product and sum is an integer
    below 2^24, so the port's and JAX's bf16 paths equal each other and
    their float32 paths bit for bit."""
    t, s, f, p = 64, 6, 8, 2
    zr, zi = (_ints(seed, (t, s, f, p), 128).clip(-128, 127)
              .astype(np.float32) for seed in (21, 22))
    want = j_xe.xengine_correlate_planar(j_planar.PC(zr, zi), npol=p,
                                         output_format=fmt,
                                         compute_dtype=jnp.bfloat16)
    want32 = j_xe.xengine_correlate_planar(j_planar.PC(zr, zi), npol=p,
                                           output_format=fmt)
    z = planar.PC(_t(zr, "float32"), _t(zi, "float32"))
    got = xe.xengine_correlate_planar(z, npol=p, output_format=fmt,
                                      compute_dtype=torch.bfloat16)
    got32 = xe.xengine_correlate_planar(z, npol=p, output_format=fmt)
    assert got.re.dtype == got.im.dtype == torch.float32
    for a, b in ((got, want), (got, got32), (want, want32)):
        equal(a.re, b.re)
        equal(a.im, b.im)


# --------------------------------------------------------------------------
# kernel B.4: plain forms against the Pallas kernel, block by block
# --------------------------------------------------------------------------

GRAM_FORMS = ["xengine_gram_stacked", "xengine_gram_stacked_blocks",
              "xengine_gram_stacked_tri"]


@pytest.mark.parametrize("form", GRAM_FORMS)
@pytest.mark.parametrize("dt", ["int8", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_gram_plain_matches_pallas(ref, shape, dt, form):
    qr, qi, _, _ = _cm_inputs(shape, dt, 5)
    want = getattr(j_pk, form)(_j(qr, dt), _j(qi, dt), interpret=True)
    hk.reset_launch_counts()
    got = getattr(hk, form)(_t(qr, dt), _t(qi, dt))     # CPU: plain form
    plain = getattr(hk, form + "_plain")(_t(qr, dt), _t(qi, dt))
    assert hk.gram_launches() == 0
    if form != "xengine_gram_stacked":
        assert got[2] == plain[2] == want[2]             # tri_blocks
    acc = torch.int32 if dt == "int8" else torch.float32
    for g, pl, w in zip(got[:2], plain[:2], want[:2]):
        assert g.dtype == acc
        assert torch.equal(g, pl)
        match(g, w, dt)


# --------------------------------------------------------------------------
# the bf16 tensor-core Gram (csrc/xengine_gram_bf16.cu), modelled in numpy:
# the swizzled frame-major tiles, ldmatrix.x4.trans, the m16n8k16 fragment
# layouts of PTX's mma.sync and the two kernels' ownership of the outputs
# --------------------------------------------------------------------------

LANE = np.arange(32)
# the kernels' (tile columns, frames a tile, tiles a stage, threads):
# diagonal, quadrant
DIAG, QUAD = (128, 64, 2, 384), (64, 32, 4, 128)
# (R, C) of the piece of diagonal-kernel warps 0-9 (kRoleR, kRoleC); warps
# 10 and 11 compute ri of the lower pieces in slots 0-2 and 3-5
DIAG_ROLES = [((0x3332213210 >> 4 * w) & 15, (0x2101003210 >> 4 * w) & 15)
              for w in range(10)]
RI_PIECES = [[(1, 0), (2, 0), (2, 1)], [(3, 0), (3, 1), (3, 2)]]


def _swz(row, chunk, chunks):
    """Byte offset of 16-byte chunk ``chunk`` of frame ``row`` in a tile of
    ``chunks`` chunks a row."""
    return row * chunks * 16 + ((chunk ^ (row & 7)) << 4)


def _stage_phases(cols, frames, tiles, threads):
    """Byte addresses of a stage's cp.async copies, one row per 8-thread
    phase: thread tid copies e = tid + threads·u; copy e is tile
    e // (frames·chunks), frame and chunk from the rest."""
    chunks = cols // 8
    per = frames * chunks
    total = tiles * per
    phases = []
    for u in range(-(-total // threads)):
        e = np.arange(threads) + threads * u
        e = e[e < total]
        s, rem = e // per, e % per
        addr = s * frames * cols * 2 + _swz(rem // chunks, rem % chunks, chunks)
        phases += list(addr.reshape(-1, 8))
    return phases


def _a_addr(piece, mi, ks, chunks):
    """Per-lane ldmatrix row address (bytes) of A = rows × frames for the
    32-row piece ``piece`` of the tile."""
    lr, lq = LANE & 7, LANE >> 3
    return _swz(ks * 16 + lr + 8 * (lq >> 1), piece * 4 + (lq & 1) + 2 * mi,
                chunks)


def _b_addr(piece, npair, ks, chunks):
    """Per-lane ldmatrix row address (bytes) of B = frames × cols, two n8
    tiles of the 32-column piece ``piece``."""
    lr, lq = LANE & 7, LANE >> 3
    return _swz(ks * 16 + lr + 8 * (lq & 1), piece * 4 + (lq >> 1) + 2 * npair,
                chunks)


def _distinct_banks(addr8):
    """The 8 16-byte accesses of one phase cover 32 distinct banks."""
    banks = (np.asarray(addr8)[:, None] // 4 + np.arange(4)) % 32
    return len(np.unique(banks)) == 32


@pytest.mark.parametrize("kernel", [DIAG, QUAD], ids=["diag", "quad"])
def test_gram_bf16_tile_banks(kernel):
    """Every cp.async store phase (8 threads) and every 8-address phase of
    every ldmatrix.x4.trans the kernel issues hits 32 distinct banks, and
    the stores fill the stage exactly once."""
    cols, frames, tiles, threads = kernel
    chunks = cols // 8
    phases = _stage_phases(cols, frames, tiles, threads)
    addr = np.concatenate(phases)
    assert sorted(addr) == list(range(0, tiles * frames * cols * 2, 16))
    for ph in phases:
        assert _distinct_banks(ph)
    for piece in range(cols // 32):
        for sub in range(2):
            for ks in range(frames // 16):
                for lanes in (_a_addr(piece, sub, ks, chunks),
                              _b_addr(piece, sub, ks, chunks)):
                    for q in range(4):
                        assert _distinct_banks(lanes[8 * q:8 * q + 8])


def _ldsm_x4_trans(tile, addr):
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16: lane l gives the row
    address of row l % 8 of matrix l // 8; register q of lane t holds
    M_q[2(t%4) + h][t // 4], h = 0, 1.  Returns [32, 4, 2]."""
    el = addr // 2
    m = np.stack([tile[el[8 * q:8 * q + 8, None] + np.arange(8)]
                  for q in range(4)])            # [q, row, col]
    t = LANE
    return np.stack([m[:, 2 * (t % 4) + h, t // 4] for h in (0, 1)],
                    -1).transpose(1, 0, 2)


def _mma_m16n8k16(a, b0, b1):
    """mma.sync.aligned.m16n8k16.row.col on PTX's fragment layouts: a
    [32, 4, 2] (a0..a7), b0/b1 [32, 2]; returns d [32, 4] (c0..c3)."""
    g, tq = LANE >> 2, LANE & 3
    am = np.zeros((16, 16))
    bm = np.zeros((16, 8))
    for h in (0, 1):
        am[g, 2 * tq + h] = a[:, 0, h]
        am[g + 8, 2 * tq + h] = a[:, 1, h]
        am[g, 2 * tq + 8 + h] = a[:, 2, h]
        am[g + 8, 2 * tq + 8 + h] = a[:, 3, h]
        bm[2 * tq + h, g] = b0[:, h]
        bm[2 * tq + 8 + h, g] = b1[:, h]
    d = am @ bm
    return np.stack([d[g, 2 * tq], d[g, 2 * tq + 1], d[g + 8, 2 * tq],
                     d[g + 8, 2 * tq + 1]], -1)


def _stage_tile(z, kt, c0, cols, frames):
    """One swizzled [frames × cols] tile of channel frames z [T, S·P] from
    frame frames·kt, frames past T zero (the cp.async zero-fill); flat
    elements."""
    chunks = cols // 8
    row, chunk = np.divmod(np.arange(frames * chunks), chunks)
    fr = kt * frames + row
    ok = fr < z.shape[0]
    el = _swz(row, chunk, chunks)[ok] // 2
    tile = np.zeros(frames * cols)
    src = c0 + 8 * chunk[ok, None] + np.arange(8)
    tile[el[:, None] + np.arange(8)] = z[fr[ok, None], src]
    return tile


def _frag_a(tile, piece, ks, chunks):
    return [_ldsm_x4_trans(tile, _a_addr(piece, mi, ks, chunks))
            for mi in range(2)]


def _frag_b(tile, piece, ks, chunks):
    return [_ldsm_x4_trans(tile, _b_addr(piece, p, ks, chunks))
            for p in range(2)]


def _mma_piece(acc, a, b):
    """mma_piece: acc [2, 4, 32, 4] += A B over 16 frames."""
    for mi in range(2):
        for ni in range(4):
            p, h = ni >> 1, 2 * (ni & 1)
            acc[mi, ni] += _mma_m16n8k16(a[mi], b[p][:, h], b[p][:, h + 1])


def _ksteps(tile, chunks):
    return range(len(tile) // (chunks * 8 * 16))


def _warp_tile(acc, s_ri, s_ii, s_rj, s_ij, chunks, a_piece, b_piece, ri):
    """warp_tile: one staged tile into acc [3 (a, ir, ri), 2, 4, 32, 4]."""
    for ks in _ksteps(s_ri, chunks):
        ar, ai = (_frag_a(t, a_piece, ks, chunks) for t in (s_ri, s_ii))
        br, bim = (_frag_b(t, b_piece, ks, chunks) for t in (s_rj, s_ij))
        _mma_piece(acc[0], ar, br)
        _mma_piece(acc[0], ai, bim)
        _mma_piece(acc[1], ai, br)
        if ri:
            _mma_piece(acc[2], ar, bim)


def _ri_tile(acc, s_r, s_i, pieces):
    """ri_tile: ri = zr_R zi_Cᵀ of three lower pieces into acc[0..2]."""
    for ks in _ksteps(s_r, 16):
        for x, (rr, cc) in enumerate(pieces):
            _mma_piece(acc[x], _frag_a(s_r, rr, ks, 16),
                       _frag_b(s_i, cc, ks, 16))


def _pieces(acc):
    """(local row, local col, a, ir, ri) of each accumulator element of a
    warp's 32 × 32 piece, lanes batched."""
    g, tq = LANE >> 2, LANE & 3
    for mi in range(2):
        for ni in range(4):
            for hr in range(2):
                for e in range(2):
                    yield (mi * 16 + g + 8 * hr, ni * 8 + 2 * tq + e,
                           *acc[:, mi, ni, :, 2 * hr + e])


def _put(out, r, c, val):
    assert np.isnan(out[r, c]).all()             # one owner per element
    out[r, c] = val


def _model_gram_bf16(zr, zi, emit_gi):
    """Both kernels' walks and epilogues for zr/zi [F, T, S·P] in float64:
    (a_blk, gi_blk or b_blk) as they write them; NaN where nothing wrote."""
    f, t, sp = zr.shape
    kb = sp // 128
    nbt = kb * (kb + 1) // 2
    a_blk = np.full((f, nbt, 128, 128), np.nan)
    b_blk = np.full((f, nbt, 128, 128) if emit_gi else (f, kb, kb, 128, 128),
                    np.nan)
    for ch in range(f):
        for bi in range(kb):                        # gram_bf16_diag_kernel
            n = bi * (bi + 1) // 2 + bi
            acc = np.zeros((12, 3, 2, 4, 32, 4))
            for kt in range(-(-t // DIAG[1])):
                s_r = _stage_tile(zr[ch], kt, bi * 128, 128, DIAG[1])
                s_i = _stage_tile(zi[ch], kt, bi * 128, 128, DIAG[1])
                for w, (rr, cc) in enumerate(DIAG_ROLES):
                    _warp_tile(acc[w], s_r, s_i, s_r, s_i, 16, rr, cc,
                               ri=False)
                for w, pieces in enumerate(RI_PIECES):
                    _ri_tile(acc[10 + w], s_r, s_i, pieces)
            # the exchange: ri of lower slot s, ir of diagonal piece R
            xs_ri = np.zeros((6, 32, 32))
            xs_ir = np.zeros((4, 32, 32))
            for w in range(2):
                for x in range(3):
                    for lr, lc, v, *_ in _pieces(acc[10 + w, [x]]):
                        xs_ri[3 * w + x, lr, lc] = v
            for w, (rr, cc) in enumerate(DIAG_ROLES):
                if rr == cc:
                    for lr, lc, _, vir, _ in _pieces(acc[w]):
                        xs_ir[rr, lr, lc] = vir
            a_dst = a_blk[ch, n]
            b_dst = b_blk[ch, n] if emit_gi else b_blk[ch, bi, bi]
            for w, (rr, cc) in enumerate(DIAG_ROLES):
                for lr, lc, va, vir, _ in _pieces(acc[w]):
                    r, c = rr * 32 + lr, cc * 32 + lc
                    _put(a_dst, r, c, va)
                    if rr == cc:
                        _put(b_dst, r, c, vir - xs_ir[rr, lc, lr] if emit_gi
                             else vir)
                        continue
                    vri = xs_ri[w - 4, lr, lc]
                    _put(a_dst, c, r, va)
                    if emit_gi:
                        _put(b_dst, r, c, vir - vri)
                        _put(b_dst, c, r, -(vir - vri))
                    else:
                        _put(b_dst, r, c, vir)
                        _put(b_dst, c, r, vri)
        for m in range(kb * (kb - 1) // 2):         # gram_bf16_quad_kernel
            bi = 1
            while (bi + 1) * bi // 2 <= m:
                bi += 1
            bj = m - bi * (bi - 1) // 2
            n = bi * (bi + 1) // 2 + bj
            for quad in range(4):
                qr, qc = quad >> 1, quad & 1
                row0, col0 = bi * 128 + qr * 64, bj * 128 + qc * 64
                acc = np.zeros((4, 3, 2, 4, 32, 4))
                for kt in range(-(-t // QUAD[1])):
                    tiles = [_stage_tile(z[ch], kt, c0, 64, QUAD[1])
                             for c0 in (row0, col0) for z in (zr, zi)]
                    for w in range(4):
                        _warp_tile(acc[w], *tiles, 8, w >> 1, w & 1, ri=True)
                for w in range(4):
                    for lr, lc, va, vir, vri in _pieces(acc[w]):
                        r = qr * 64 + (w >> 1) * 32 + lr
                        c = qc * 64 + (w & 1) * 32 + lc
                        _put(a_blk[ch, n], r, c, va)
                        if emit_gi:
                            _put(b_blk[ch, n], r, c, vir - vri)
                        else:
                            _put(b_blk[ch, bi, bj], r, c, vir)
                            _put(b_blk[ch, bj, bi], c, r, vri)
    return a_blk, b_blk


# (channels, frames, S·P): frames past T zero-filled in the last tile of
# both kernels; kb = 1, 2 and 3
@pytest.mark.parametrize("emit_gi", [True, False], ids=["tri", "blocks"])
@pytest.mark.parametrize("shape", [(2, 48, 128), (1, 80, 256), (1, 16, 384)],
                         ids=["k1_t48", "k2_t80", "k3_t16"])
def test_gram_bf16_fragments_rebuild_gram(shape, emit_gi):
    """The modelled m16n8k16 fragment ownership of both kernels writes every
    output element once and rebuilds a, gi = b − bᵀ and b = zi·zrᵀ equal to
    np.einsum, and equal to the port's plain forms."""
    f, t, sp = shape
    kb = sp // 128
    zr, zi = _ints(11, (2, f, t, sp)).astype(np.float64)
    a_blk, b_blk = _model_gram_bf16(zr, zi, emit_gi)
    a = np.einsum("ftk,ftl->fkl", zr, zr) + np.einsum("ftk,ftl->fkl", zi, zi)
    b = np.einsum("ftk,ftl->fkl", zi, zr)
    gi = b - b.transpose(0, 2, 1)
    tri = [(i, j) for i in range(kb) for j in range(i + 1)]

    def blk(x, i, j):
        return x[:, i * 128:(i + 1) * 128, j * 128:(j + 1) * 128]

    for n, (i, j) in enumerate(tri):
        np.testing.assert_array_equal(a_blk[:, n], blk(a, i, j))
        if emit_gi:
            np.testing.assert_array_equal(b_blk[:, n], blk(gi, i, j))
    if not emit_gi:
        for i in range(kb):
            for j in range(kb):
                np.testing.assert_array_equal(b_blk[:, i, j], blk(b, i, j))
    zt = [_t(z, "bfloat16") for z in (zr, zi)]
    form = (hk.xengine_gram_stacked_tri if emit_gi
            else hk.xengine_gram_stacked_blocks)
    for got, want in zip(form(*zt)[:2], (a_blk, b_blk)):
        equal(got, want)


# --------------------------------------------------------------------------
# the int8 tensor-core Gram (csrc/xengine_gram_int8.cu), modelled in numpy:
# byte tiles, ldmatrix.x4.trans.b16 on column pairs, the prmt regrouping,
# PTX's m16n8k32 s8 fragment layouts and the two kernels' ownership of the
# outputs
# --------------------------------------------------------------------------

# the kernels' (tile columns, tiles a stage, threads, frames a tile):
# diagonal (kDiagFrames), quadrant (kQuadFrames); and tile lengths tried
# in tuning
I8_DIAG, I8_QUAD = (128, 2, 384, 256), (64, 4, 128, 64)
I8_TILE_CASES = [(I8_DIAG, 64), (I8_DIAG, 128), (I8_DIAG, 256),
                 (I8_QUAD, 32), (I8_QUAD, 64), (I8_QUAD, 128)]
G8, T8 = LANE >> 2, LANE & 3
# mma.m16n8k32 .s8: element i of A register q of lane (g, t) is A[g + 8 (q
# % 2)][4t + i + 16 (q // 2)]; element i of B register q is B[4t + i + 16 q]
# [g]; D element e is D[g + 8 (e // 2)][2t + e % 2]
_A_RC = (G8[None, :, None] + 8 * (np.arange(4) % 2)[:, None, None]
         + 0 * np.arange(4),
         4 * T8[None, :, None] + np.arange(4)
         + 16 * (np.arange(4) // 2)[:, None, None])
_B_RC = (4 * T8[None, :, None] + np.arange(4)
         + 16 * np.arange(2)[:, None, None], G8[None, :, None] + 0 * np.arange(4))
_D_RC = (G8[:, None] + 8 * (np.arange(4) // 2), 2 * T8[:, None] + np.arange(4) % 2)


def _swz_i8(row, chunk, chunks):
    """Byte offset of 16-byte chunk ``chunk`` of frame ``row`` in a tile of
    ``chunks`` (8 or 4) chunks a row."""
    key = (row // (8 // chunks)) % chunks
    return row * chunks * 16 + ((chunk ^ key) << 4)


def _stage_phases_i8(cols, tiles, threads, frames):
    """Byte addresses of a stage's cp.async copies, one row per 8-thread
    phase: thread tid copies e = tid + threads·u."""
    chunks = cols // 16
    per = frames * chunks
    total = tiles * per
    phases = []
    for u in range(-(-total // threads)):
        e = np.arange(threads) + threads * u
        e = e[e < total]
        s, rem = e // per, e % per
        addr = s * frames * cols + _swz_i8(rem // chunks, rem % chunks, chunks)
        phases += list(addr.reshape(-1, 8))
    return phases


def _frag_addr_i8(chunk, ks, chunks):
    """Per-lane ldmatrix row address (bytes): lane l gives frame 32 ks + l
    of the chunk."""
    return _swz_i8(32 * ks + LANE, chunk, chunks)


@pytest.mark.parametrize(
    "kernel,frames", I8_TILE_CASES,
    ids=[f"{'diag' if k is I8_DIAG else 'quad'}-{n}" for k, n in I8_TILE_CASES])
def test_gram_int8_tile_banks(kernel, frames):
    """Every cp.async store phase (8 threads) and every 8-address phase of
    every ldmatrix.x4.trans the int8 kernels issue hits 32 distinct banks,
    and the stores fill the stage exactly once."""
    cols, tiles, threads, _ = kernel
    chunks = cols // 16
    phases = _stage_phases_i8(cols, tiles, threads, frames)
    addr = np.concatenate(phases)
    assert sorted(addr) == list(range(0, tiles * frames * cols, 16))
    for ph in phases:
        assert _distinct_banks(ph)
    for chunk in range(chunks):
        for ks in range(frames // 32):
            lanes = _frag_addr_i8(chunk, ks, chunks)
            for q in range(4):
                assert _distinct_banks(lanes[8 * q:8 * q + 8])


def _ldsm_x4_trans_i8(tile, addr):
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16 on a byte tile: lane l gives
    the row address of row l % 8 of matrix l // 8 (8 b16 elements, 16
    bytes); register q of lane t holds elements M_q[2(t%4) + h][t // 4],
    h = 0, 1, each a little-endian byte pair.  Returns bytes [32, 4, 4]."""
    m = np.stack([tile[addr[8 * q:8 * q + 8, None] + np.arange(16)]
                  for q in range(4)])            # [q, row, byte]
    return np.stack([m[:, 2 * T8 + h, 2 * G8 + b] for h in (0, 1)
                     for b in (0, 1)], -1).transpose(1, 0, 2)


def _prmt(x, y, sel):
    """prmt.b32 (``__byte_perm``) without sign replication, per lane."""
    xy = np.concatenate([x, y], -1)
    return xy[:, [(sel >> 4 * n) & 7 for n in range(4)]]


def _frag_i8(tile, addr):
    """frag(): [32, 4 registers, 4 bytes]: the A fragment of a chunk, and
    registers (0, 2) / (1, 3) its even / odd columns' B fragments."""
    r = _ldsm_x4_trans_i8(tile, addr)
    return np.stack([_prmt(r[:, 0], r[:, 1], 0x6420),
                     _prmt(r[:, 0], r[:, 1], 0x7531),
                     _prmt(r[:, 2], r[:, 3], 0x6420),
                     _prmt(r[:, 2], r[:, 3], 0x7531)], 1)


def _mma_m16n8k32(a, b0, b1):
    """mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on PTX's fragment
    layouts: a [32, 4, 4], b0/b1 [32, 4]; returns d [32, 4] (c0..c3)."""
    am = np.zeros((16, 32), np.int64)
    bm = np.zeros((32, 8), np.int64)
    am[_A_RC] = a.transpose(1, 0, 2)
    bm[_B_RC] = np.stack([b0, b1])
    return (am @ bm)[_D_RC]


def _mma_piece_i8(acc, a, b):
    """mma_piece: acc [2, 4, 32, 4] += A Bᵀ over 32 frames."""
    for mi in range(2):
        for yj in range(2):
            for p in range(2):
                acc[mi, 2 * yj + p] += _mma_m16n8k32(a[mi], b[yj][:, p],
                                                     b[yj][:, p + 2])


def _mma_piece_lower_i8(acc, a):
    """mma_piece_lower: a diagonal piece's a, chunk pairs (0, 0), (1, 0),
    (1, 1)."""
    for mi, yj in ((0, 0), (1, 0), (1, 1)):
        for p in range(2):
            acc[mi, 2 * yj + p] += _mma_m16n8k32(a[mi], a[yj][:, p],
                                                 a[yj][:, p + 2])


def _stage_tile_i8(z, kt, c0, cols, frames):
    """One swizzled [frames × cols] byte tile of channel frames z [T, S·P]
    from frame frames·kt, frames past T zero (the cp.async zero-fill)."""
    chunks = cols // 16
    row, chunk = np.divmod(np.arange(frames * chunks), chunks)
    fr = kt * frames + row
    ok = fr < z.shape[0]
    tile = np.zeros(frames * cols, np.int64)
    off = _swz_i8(row, chunk, chunks)[ok]
    tile[off[:, None] + np.arange(16)] = z[fr[ok, None],
                                          c0 + 16 * chunk[ok, None]
                                          + np.arange(16)]
    return tile


def _frags_i8(tile, piece, ks, chunks):
    return [_frag_i8(tile, _frag_addr_i8(2 * piece + h, ks, chunks))
            for h in range(2)]


def _piece_tile_i8(acc, s_ri, s_ii, s_rj, s_ij, chunks, rows, cols, same,
                   ri):
    """piece_tile: one staged tile into acc [3 (a, ir, ri), 2, 4, 32, 4]."""
    for ks in range(len(s_ri) // (chunks * 16 * 32)):
        ar, ai = (_frags_i8(t, rows, ks, chunks) for t in (s_ri, s_ii))
        if same:
            _mma_piece_lower_i8(acc[0], ar)
            _mma_piece_lower_i8(acc[0], ai)
            _mma_piece_i8(acc[1], ai, ar)
            continue
        br, bim = (_frags_i8(t, cols, ks, chunks) for t in (s_rj, s_ij))
        _mma_piece_i8(acc[0], ar, br)
        _mma_piece_i8(acc[0], ai, bim)
        _mma_piece_i8(acc[1], ai, br)
        if ri:
            _mma_piece_i8(acc[2], ar, bim)


def _ri_tile_i8(acc, s_r, s_i, last):
    """ri_tile: ri of lower pieces (1, 0), (2, 0), (2, 1), or with last
    (3, 0), (3, 1), (3, 2), into acc[0..2]."""
    for ks in range(len(s_r) // (8 * 16 * 32)):
        b0, b1 = (_frags_i8(s_i, p, ks, 8) for p in (0, 1))
        if last:
            a0, x = _frags_i8(s_r, 3, ks, 8), _frags_i8(s_i, 2, ks, 8)
            for k, (aa, bb) in enumerate([(a0, b0), (a0, b1), (a0, x)]):
                _mma_piece_i8(acc[k], aa, bb)
        else:
            a0, x = _frags_i8(s_r, 1, ks, 8), _frags_i8(s_r, 2, ks, 8)
            for k, (aa, bb) in enumerate([(a0, b0), (x, b0), (x, b1)]):
                _mma_piece_i8(acc[k], aa, bb)


def _at(acc, mi, yj, hr, j):
    """at(): piece entry (16 mi + 2g + hr, 16 yj + 4t + j) of every lane."""
    return acc[mi, 2 * yj + (j & 1), :, 2 * hr + (j >> 1)]


def _put_piece_i8(xs, acc):
    """put_piece: the lanes' parts of a piece into a [32, 33] slot."""
    for mi, yj, hr, j in np.ndindex(2, 2, 2, 4):
        xs[16 * mi + 2 * G8 + hr, 16 * yj + 4 * T8 + j] = _at(acc, mi, yj,
                                                              hr, j)


def _owned(out, seen):
    """A writer into ``out`` [..., 128, 128] that requires one owner per
    element (the kernel's lanes of one store included)."""
    def put(r, c, val):
        assert len(np.unique(r * 128 + c)) == len(r)
        assert not seen[r, c].any()
        seen[r, c] = True
        out[r, c] = val
    return put


def _model_gram_int8(zr, zi, emit_gi):
    """Both int8 kernels' walks and epilogues for zr/zi [F, T, S·P] int8
    values in int64: (a_blk, gi_blk or b_blk) as they write them, and
    whether every element was written."""
    f, t, sp = zr.shape
    kb = sp // 128
    nbt = kb * (kb + 1) // 2
    d_frames, q_frames = I8_DIAG[3], I8_QUAD[3]
    a_blk = np.zeros((f, nbt, 128, 128), np.int64)
    b_blk = np.zeros((f, nbt, 128, 128) if emit_gi else (f, kb, kb, 128, 128),
                     np.int64)
    seen_a, seen_b = np.zeros(a_blk.shape, bool), np.zeros(b_blk.shape, bool)
    for ch in range(f):
        for bi in range(kb):                        # gram_int8_diag_kernel
            n = bi * (bi + 1) // 2 + bi
            acc = np.zeros((12, 3, 2, 4, 32, 4), np.int64)
            for kt in range(-(-t // d_frames)):
                s_r, s_i = (_stage_tile_i8(z[ch], kt, bi * 128, 128, d_frames)
                            for z in (zr, zi))
                for w, (rr, cc) in enumerate(DIAG_ROLES):
                    _piece_tile_i8(acc[w], s_r, s_i, s_r, s_i, 8, rr, cc,
                                   same=w < 4, ri=False)
                for w in range(2):
                    _ri_tile_i8(acc[10 + w], s_r, s_i, last=w == 1)
            # the exchange, a sentinel where no warp writes
            xs = np.full((10, 32, 33), 1 << 40, np.int64)
            for w in range(2):
                for p in range(3):
                    _put_piece_i8(xs[3 * w + p], acc[10 + w, p])
            if emit_gi:
                for w in range(4):
                    _put_piece_i8(xs[6 + DIAG_ROLES[w][0]], acc[w, 1])
            put_a = _owned(a_blk[ch, n], seen_a[ch, n])
            put_b = (_owned(b_blk[ch, n], seen_b[ch, n]) if emit_gi
                     else _owned(b_blk[ch, bi, bi], seen_b[ch, bi, bi]))
            for w, (rr, cc) in enumerate(DIAG_ROLES):
                for mi, yj, hr in np.ndindex(2, 2, 2):
                    pr, pc = 16 * mi + 2 * G8 + hr, 16 * yj + 4 * T8
                    r, c = rr * 32 + pr, cc * 32 + pc
                    for j in range(4):
                        va = _at(acc[w, 0], mi, yj, hr, j)
                        vb = _at(acc[w, 1], mi, yj, hr, j)
                        if w < 4:
                            if (mi, yj) == (1, 0):
                                put_a(c + j, r, va)
                            if mi >= yj:
                                put_a(r, c + j, va)
                            put_b(r, c + j, vb - xs[6 + rr][pc + j, pr]
                                  if emit_gi else vb)
                            continue
                        ri = xs[w - 4][pr, pc + j]
                        put_a(r, c + j, va)
                        put_a(c + j, r, va)
                        if emit_gi:
                            put_b(r, c + j, vb - ri)
                            put_b(c + j, r, -(vb - ri))
                        else:
                            put_b(r, c + j, vb)
                            put_b(c + j, r, ri)
        for m in range(kb * (kb - 1) // 2):         # gram_int8_quad_kernel
            bi = 1
            while (bi + 1) * bi // 2 <= m:
                bi += 1
            bj = m - bi * (bi - 1) // 2
            n = bi * (bi + 1) // 2 + bj
            put_a = _owned(a_blk[ch, n], seen_a[ch, n])
            put_ij = (_owned(b_blk[ch, n], seen_b[ch, n]) if emit_gi
                      else _owned(b_blk[ch, bi, bj], seen_b[ch, bi, bj]))
            put_ji = (None if emit_gi
                      else _owned(b_blk[ch, bj, bi], seen_b[ch, bj, bi]))
            for quad in range(4):
                qr, qc = quad >> 1, quad & 1
                row0, col0 = bi * 128 + qr * 64, bj * 128 + qc * 64
                acc = np.zeros((4, 3, 2, 4, 32, 4), np.int64)
                for kt in range(-(-t // q_frames)):
                    tiles = [_stage_tile_i8(z[ch], kt, c0, 64, q_frames)
                             for c0 in (row0, col0) for z in (zr, zi)]
                    for w in range(4):
                        _piece_tile_i8(acc[w], *tiles, 4, w >> 1, w & 1,
                                       same=False, ri=True)
                for w in range(4):
                    for mi, yj, hr in np.ndindex(2, 2, 2):
                        r = qr * 64 + (w >> 1) * 32 + 16 * mi + 2 * G8 + hr
                        c = qc * 64 + (w & 1) * 32 + 16 * yj + 4 * T8
                        for j in range(4):
                            va, vb, ri = (_at(acc[w, x], mi, yj, hr, j)
                                          for x in range(3))
                            put_a(r, c + j, va)
                            if emit_gi:
                                put_ij(r, c + j, vb - ri)
                            else:
                                put_ij(r, c + j, vb)
                                put_ji(c + j, r, ri)
    return a_blk, b_blk, seen_a.all() and seen_b.all()


def test_gram_int8_mma_layout_is_a_bijection():
    """The modelled m16n8k32 fragment maps cover A [16 × 32], B [32 × 8] and
    D [16 × 8] once each, and a frag() of a chunk holds every (column,
    frame) byte of its 32 frames once, in the A rows and K slots of the
    head note (row g ↔ column 2g, row g + 8 ↔ column 2g + 1; K slot 4t + j
    ↔ frame 2t + j, j < 2, or 2t + 6 + j)."""
    for rc, shape in ((_A_RC, (16, 32)), (_B_RC, (32, 8)), (_D_RC, (16, 8))):
        flat = np.ravel_multi_index([np.broadcast_to(x, rc[0].shape)
                                     for x in rc], shape).ravel()
        assert sorted(flat) == list(range(shape[0] * shape[1]))
    # a tile whose byte is (column, frame) coded as 32 column + frame
    tile = np.zeros(32 * 128, np.int64)
    row, col = np.divmod(np.arange(32 * 128), 128)
    off = _swz_i8(row, col // 16, 8) + col % 16
    tile[off] = 32 * col + row
    for chunk in range(8):
        fr = _frag_i8(tile, _frag_addr_i8(chunk, 0, 8))
        am = np.zeros((16, 32), np.int64)
        am[_A_RC] = fr.transpose(1, 0, 2)
        k = np.arange(32)
        frame = 16 * (k // 16) + 2 * ((k % 16) // 4) + np.where(
            k % 4 < 2, k % 4, k % 4 + 6)
        m = np.arange(16)
        column = 16 * chunk + 2 * (m % 8) + m // 8
        np.testing.assert_array_equal(am, 32 * column[:, None] + frame)


# (channels, frames, S·P): the last tile ragged (frames past T zero-filled)
# at kb = 1 (two diagonal tiles) and kb = 4, whose six off-diagonal blocks
# run the quadrant kernel
@pytest.mark.parametrize("emit_gi", [True, False], ids=["tri", "blocks"])
@pytest.mark.parametrize("shape", [(2, 288, 128), (1, 96, 512)],
                         ids=["k1_t288", "k4_t96"])
def test_gram_int8_fragments_rebuild_gram(shape, emit_gi):
    """The modelled int8 kernels (ldmatrix.trans.b16, the prmt selectors,
    the m16n8k32 fragment ownership, the diagonal role map and the
    epilogue's permuted writes) write every output element once and rebuild
    a, gi = b − bᵀ and b = zi·zrᵀ equal to int64 np.einsum, and equal to
    the port's plain forms; bytes at −128 and 127 included."""
    f, t, sp = shape
    kb = sp // 128
    rng = np.random.default_rng(17)
    zr, zi = rng.integers(-128, 128, (2, f, t, sp))
    zr[:, :8], zi[:, 8:16] = -128, 127
    a_blk, b_blk, every = _model_gram_int8(zr, zi, emit_gi)
    assert every
    a = np.einsum("ftk,ftl->fkl", zr, zr) + np.einsum("ftk,ftl->fkl", zi, zi)
    b = np.einsum("ftk,ftl->fkl", zi, zr)
    gi = b - b.transpose(0, 2, 1)
    tri = [(i, j) for i in range(kb) for j in range(i + 1)]

    def blk(x, i, j):
        return x[:, i * 128:(i + 1) * 128, j * 128:(j + 1) * 128]

    for n, (i, j) in enumerate(tri):
        np.testing.assert_array_equal(a_blk[:, n], blk(a, i, j))
        if emit_gi:
            np.testing.assert_array_equal(b_blk[:, n], blk(gi, i, j))
    if not emit_gi:
        for i in range(kb):
            for j in range(kb):
                np.testing.assert_array_equal(b_blk[:, i, j], blk(b, i, j))
    zt = [_t(z, "int8") for z in (zr, zi)]
    form = (hk.xengine_gram_stacked_tri if emit_gi
            else hk.xengine_gram_stacked_blocks)
    for got, want in zip(form(*zt)[:2], (a_blk, b_blk)):
        equal(got, want)


def test_gram_ab_cli_arguments(tmp_path):
    """The int8 Gram variants tool: its arguments, the sources each kind of
    variant builds, and without a card a non-zero exit."""
    from clenabled_tpu_torch.tools import gram_ab as cli

    args = cli.parse_args([])
    assert (args.variants, args.f, args.t, args.sp, args.rounds,
            args.calls) == ([], 256, 8192, 128, 7, 10)
    tree = ["xengine_gram.cu", "xengine_gram_int8.cu", "xengine_gram_bf16.cu"]
    srcs, flags = cli.variant_sources("tree")
    assert [s.name for s in srcs] == tree and flags == []
    srcs, flags = cli.variant_sources(cli.PROBES["mma_only"])
    assert [s.name for s in srcs] == tree
    assert flags == ["-DGRAM_I8_COMPUTE_ONLY", "-DGRAM_I8_MMA_ONLY"]
    old = tmp_path / "xengine_gram_dp4a.cu"       # int8 in the file itself
    old.write_text("int clen_gram_bf16_launch(const void* zr);\n"
                   "int clen_gram_int8_launch(const void* zr) {\n"
                   "  return 0;\n}\n"
                   "int f() { return clen_gram_int8_launch(0) + "
                   "clen_gram_bf16_launch(0); }\n")
    srcs, flags = cli.variant_sources(f"{old} -DNDEBUG")
    assert [s.name for s in srcs] == [old.name, "xengine_gram_bf16.cu"]
    assert flags == ["-DNDEBUG"] and all(s.exists() for s in srcs)
    if not torch.cuda.is_available():
        assert cli.main(["--f", "1", "--t", "32"]) == 1


def test_gram_checks_match_jax():
    z = torch.zeros((2, 64, 100), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 128"):
        hk.xengine_gram_stacked(z, z)
    z = torch.zeros((2, 48, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="tileable"):
        hk.xengine_gram_stacked_tri(z, z)
    with pytest.raises(ValueError, match="dtypes"):
        hk.xengine_gram_stacked_blocks(z, z.to(torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel for device"):
        hk._launch_gram(z, z, emit_gi=True)
    zb = torch.zeros((2, 48, 128), dtype=torch.bfloat16)   # 16 | 48: fine
    assert hk.xengine_gram_stacked(zb, zb)[0].shape == (2, 128, 128)


# --------------------------------------------------------------------------
# pipeline integration
# --------------------------------------------------------------------------

def _run(apply, state, frames):
    outs = []
    for fr in frames:
        state, (out, ready) = apply(state, fr)
        outs.append((out, bool(ready)))
    return state, outs


def _check_emissions(got, want):
    assert [r for _, r in got] == [bool(r) for _, r in want]
    for (go, _), (wo, _) in zip(got, want):
        if isinstance(go, planar.PC):
            close(go.re, wo.re)
            close(go.im, wo.im)
        else:
            close(torch.view_as_real(go), np.stack(
                [np.asarray(wo).real, np.asarray(wo).imag], -1))


@pytest.mark.parametrize("dt", ["int8", "float32"])
def test_channel_major_pipeline_emits_like_jax(ref, dt):
    """6 calls with pipeline_integration=3: zeros and ready=False on calls
    1, 2, 4, 5; the 3-call sums on calls 3 and 6."""
    f, t, s, p = 4, 32, 8, 2
    scale = 1.0 / 127 ** 2 if dt == "int8" else 1.0
    frames = [(_ints(10 + k, (f, t, s * p)), _ints(20 + k, (f, t, s * p)))
              for k in range(6)]
    kw = dict(num_inputs=s, num_channels=f, npol=p, integration_time=t,
              pipeline_integration=3, scale=scale)
    jinit, japply = j_xe.make_xengine_channel_major(**kw)
    tinit, tapply = xe.make_xengine_channel_major(**kw, device="cpu")
    _, want = _run(japply, jinit(), [(_j(a, dt), _j(b, dt)) for a, b in frames])
    _, got = _run(tapply, tinit(), [(_t(a, dt), _t(b, dt)) for a, b in frames])
    assert [r for _, r in got] == [False, False, True] * 2
    for out, ready in got:
        if not ready:
            assert not out.re.any() and not out.im.any()
    _check_emissions(got, want)
    if dt == "int8":   # integer sums, 3 exact float32 adds of scaled sums
        for (go, _), (wo, _) in zip(got, want):
            equal(go.re, wo.re)


@pytest.mark.parametrize("planar_mode", [False, True], ids=["complex", "planar"])
def test_time_major_pipeline_emits_like_jax(ref, planar_mode):
    rng = np.random.default_rng(7)
    t, s, f, p = 8, 3, 4, 2
    kw = dict(num_inputs=s, num_channels=f, npol=p, integration_time=t,
              pipeline_integration=3, planar=planar_mode)
    jinit, japply = j_xe.make_xengine(**kw)
    tinit, tapply = xe.make_xengine(**kw, device="cpu")
    zs = [(rng.standard_normal((t, s, f, p)).astype(np.float32),
           rng.standard_normal((t, s, f, p)).astype(np.float32))
          for _ in range(6)]
    if planar_mode:
        jf = [j_planar.PC(a, b) for a, b in zs]
        tf = [planar.PC(_t(a, "float32"), _t(b, "float32")) for a, b in zs]
    else:
        jf = [(a + 1j * b).astype(np.complex64) for a, b in zs]
        tf = [torch.complex(_t(a, "float32"), _t(b, "float32")) for a, b in zs]
    _, want = _run(japply, jinit(), jf)
    _, got = _run(tapply, tinit(), tf)
    _check_emissions(got, want)


def test_pipeline_emit_resets_count():
    acc = torch.zeros(3)
    acc, n, out, ready = xe._pipeline_emit(acc, torch.ones(3), 0, 2)
    assert (n, ready) == (1, False) and not out.any() and acc.tolist() == [1] * 3
    acc, n, out, ready = xe._pipeline_emit(acc, torch.ones(3), n, 2)
    assert (n, ready) == (0, True) and out.tolist() == [2] * 3
    assert not acc.any()


@pytest.mark.parametrize("maker", ["make_xengine", "make_xengine_channel_major"])
def test_engines_default_to_the_card(monkeypatch, maker):
    """Without ``device`` the engines integrate on the card, so with no
    card they raise; ``device="cpu"`` keeps the host accumulator."""
    kw = dict(num_inputs=3, num_channels=4, npol=2, integration_time=8,
              pipeline_integration=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(xe, maker)(**kw)
    init, _ = getattr(xe, maker)(**kw, device="cpu")
    st = init()
    acc = st.accum.re if isinstance(st.accum, planar.PC) else st.accum
    assert acc.device.type == "cpu" and st.count == 0


def test_state_from_reference_continues_jax_run(ref):
    """Two of three integrations in JAX, the rest of the run in the port
    from JAX's state: the same emissions as JAX's uninterrupted run."""
    f, t, s, p = 4, 32, 8, 2
    scale = 1.0 / 127 ** 2
    frames = [(_ints(30 + k, (f, t, s * p)), _ints(40 + k, (f, t, s * p)))
              for k in range(5)]
    kw = dict(num_inputs=s, num_channels=f, npol=p, integration_time=t,
              pipeline_integration=3, scale=scale)
    jinit, japply = j_xe.make_xengine_channel_major(**kw)
    jframes = [(_j(a, "int8"), _j(b, "int8")) for a, b in frames]
    jstate, _ = _run(japply, jinit(), jframes[:2])
    _, want = _run(japply, jstate, jframes[2:])
    state = P.xengine_state_from_reference(np.asarray(jstate.accum.re),
                                           np.asarray(jstate.accum.im),
                                           np.asarray(jstate.count), "cpu")
    assert state.count == 2 and state.accum.re.dtype == torch.float32
    _, tapply = xe.make_xengine_channel_major(**kw, device="cpu")
    _, got = _run(tapply, state,
                  [(_t(a, "int8"), _t(b, "int8")) for a, b in frames[2:]])
    _check_emissions(got, want)
    equal(got[0][0].re, want[0][0].re)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

# (channels, frames, S·P): k = 1, 2 and 3, with a ragged last T tile
CARD_SHAPES = [(8, 4096, 128), (4, 1056, 256), (2, 544, 384)]
# int8 only: T % 64 == 32 (half a quadrant tile; the diagonal kernel's
# 256-frame tiles ragged too), kb = 4, one channel, and extreme bytes: all
# −128, and −128 / 127 alternating
I8_CARD_CASES = [("k1-t2080", (2, 2080, 128), "randint"),
                 ("k4", (2, 1056, 512), "randint"),
                 ("f1", (1, 4096, 256), "randint"),
                 ("k1-min", (4, 2048, 128), "min"),
                 ("k2-alt", (2, 1056, 256), "alt")]
CARD_CASES = ([pytest.param(s, dt, "randint", id=f"k{k}-{dt}")
               for k, s in enumerate(CARD_SHAPES, 1)
               for dt in ("int8", "bfloat16")]
              + [pytest.param(s, "int8", fill, id=f"{name}-int8")
                 for name, s, fill in I8_CARD_CASES])


def _card_bytes(shape, fill):
    """(zr, zi) int values: seeded in [−127, 127], all −128, or −128 and
    127 alternating by frame and column (zi the opposite of zr)."""
    if fill == "randint":
        return _ints(8, (2, *shape))
    if fill == "min":
        return np.full((2, *shape), -128)
    _, t, sp = shape
    alt = np.where((np.arange(t)[:, None] + np.arange(sp)) % 2, 127, -128)
    return np.repeat(np.stack([alt, -1 - alt])[:, None], shape[0], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("form", GRAM_FORMS)
@pytest.mark.parametrize("shape,dt,fill", CARD_CASES)
def test_gram_kernel_matches_plain_on_card(card, shape, dt, fill, form):
    f, t, sp = shape
    qr, qi = _card_bytes(shape, fill)
    zr, zi = _t(qr, dt, card), _t(qi, dt, card)
    before = hk.gram_launches()
    got = getattr(hk, form)(zr, zi)
    torch.cuda.synchronize()
    assert hk.gram_launches() == before + 1
    want = getattr(hk, form + "_plain")(zr, zi)
    for g, w in zip(got[:2], want[:2]):
        if dt == "int8":
            assert torch.equal(g, w)
        else:
            close(g, w, REL_CARD)


@pytest.mark.cuda
def test_stacked_engine_uses_kernel_on_card(card):
    qr, qi = _ints(9, (2, 4, 512, 256))
    zr, zi = _t(qr, "int8", card), _t(qi, "int8", card)
    before = hk.xengine_gram_stacked_tri.launches
    got = xe.xengine_correlate_stacked(zr, zi, scale=1 / 127 ** 2)
    assert hk.xengine_gram_stacked_tri.launches == before + 1
    want = xe.xengine_correlate_stacked(zr.cpu(), zi.cpu(), scale=1 / 127 ** 2)
    assert torch.equal(got.re.cpu(), want.re)
    assert torch.equal(got.im.cpu(), want.im)
    with pytest.raises(ValueError, match="int8 or bfloat16"):
        hk.xengine_gram_stacked(zr.float(), zi.float())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [TRI, FULL], ids=["tri", "full"])
def test_stacked_engine_pads_lanes_on_card(card, fmt):
    """S·P = 8: the auto rule takes the kernel on lanes padded to 128, one
    launch, bit-equal to the CPU's plain form."""
    qr, qi = _ints(10, (2, 32, 64, 8))
    zr, zi = _t(qr, "int8", card), _t(qi, "int8", card)
    hk.reset_launch_counts()
    got = xe.xengine_correlate_stacked(zr, zi, output_format=fmt,
                                       scale=1 / 127 ** 2)
    assert hk.gram_launches() == 1
    want = xe.xengine_correlate_stacked(zr.cpu(), zi.cpu(), output_format=fmt,
                                        scale=1 / 127 ** 2)
    assert torch.equal(got.re.cpu(), want.re)
    assert torch.equal(got.im.cpu(), want.im)


# (channels, frames, S·P): T % 32 == 16, kb = 4, one channel
BF16_CARD_SHAPES = [(4, 1040, 256), (2, 512, 512), (1, 2048, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", GRAM_FORMS)
@pytest.mark.parametrize("shape", BF16_CARD_SHAPES,
                         ids=["t1040", "k4", "f1"])
def test_gram_bf16_randn_matches_plain_on_card(card, shape, form):
    """randn bf16 operands (not only small integers) through the
    tensor-core kernel, within 1e-4 × max|plain|."""
    g = torch.Generator(device=card)
    g.manual_seed(sum(shape))
    zr, zi = (torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
              for _ in range(2))
    got = getattr(hk, form)(zr, zi)
    torch.cuda.synchronize()
    want = getattr(hk, form + "_plain")(zr, zi)
    for gt, w in zip(got[:2], want[:2]):
        assert gt.dtype == torch.float32
        close(gt, w, REL_CARD)


@pytest.mark.cuda
def test_gram_launches_its_kernels_on_card(card):
    """A CUDA call runs its dtype's tensor-core kernels (at kb = 2 the
    diagonal and the quadrant kernel, once each) and nothing of the other
    dtype's; the int8 forms stay equal to their plain forms."""
    from clenabled_tpu_torch.runtime.device import launched_kernels

    qr, qi = _ints(12, (2, 2, 512, 256))
    for dt, names, other in (
            ("bfloat16", ("gram_bf16_diag_kernel", "gram_bf16_quad_kernel"),
             "gram_int8"),
            ("int8", ("gram_int8_diag_kernel", "gram_int8_quad_kernel"),
             "gram_bf16")):
        zr, zi = _t(qr, dt, card), _t(qi, dt, card)

        def call():
            before = hk.gram_launches()
            got = [getattr(hk, form)(zr, zi) for form in GRAM_FORMS]
            return got, hk.gram_launches() - before

        (got, launched), events = launched_kernels(
            call, least=len(names) * len(GRAM_FORMS))
        assert launched == len(GRAM_FORMS)
        for name in names:
            assert sum(name in e for e in events) == len(GRAM_FORMS)
        assert not any(other in e for e in events)
        if dt == "int8":
            for form, out in zip(GRAM_FORMS, got):
                want = getattr(hk, form + "_plain")(zr, zi)
                for g, w in zip(out[:2], want[:2]):
                    assert torch.equal(g, w)


# --------------------------------------------------------------------------
# the benchmark CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--int8"], ["--stacked", "--bf16"],
                                   ["--stacked", "--no-kernel"],
                                   ["--channel-major", "--bf16"],
                                   ["--planar"], ["--single-polarization"]],
                         ids=lambda f: " ".join(f) or "complex")
def test_cli_engines_run_on_cpu(flags):
    from clenabled_tpu_torch.tools import test_clxengine as cli

    args = cli.parse_args(["4", "--num_inputs", "64", "--integration-time",
                           "64", *flags])
    fn, label = cli.build_case(args, "cpu")
    out = fn()
    p = 1 if args.single_pol else 2
    shape = (4, xe.num_baselines(64), p * p)
    assert tuple((out.re if isinstance(out, planar.PC) else out).shape) == shape
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):     # it times on a card only
            cli.main(["4", *flags])
