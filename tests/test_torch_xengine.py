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


@pytest.mark.cuda
@pytest.mark.parametrize("form", GRAM_FORMS)
@pytest.mark.parametrize("dt", ["int8", "bfloat16"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["k1", "k2", "k3"])
def test_gram_kernel_matches_plain_on_card(card, shape, dt, form):
    f, t, sp = shape
    qr, qi = _ints(8, (2, f, t, sp))
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
    """A bf16 CUDA call runs the tensor-core kernels (at kb = 2 the
    diagonal and the quadrant kernel, once each) and nothing of the int8
    kernel; the int8 forms run the dp4a kernel and stay equal to their
    plain forms."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    qr, qi = _ints(12, (2, 2, 512, 256))
    for dt, names, other in (
            ("bfloat16", ("gram_bf16_diag_kernel", "gram_bf16_quad_kernel"),
             "gram_kernel"),
            ("int8", ("gram_kernel",), "gram_bf16")):
        zr, zi = _t(qr, dt, card), _t(qi, dt, card)
        before = hk.gram_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = [getattr(hk, form)(zr, zi) for form in GRAM_FORMS]
            torch.cuda.synchronize()
        assert hk.gram_launches() == before + len(GRAM_FORMS)
        events = [e.name for e in prof.events() if e.device_type == cuda]
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
