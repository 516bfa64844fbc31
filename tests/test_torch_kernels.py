"""Port parity: the two Hopper kernels of the FX step.

On the CPU each wrapper runs its plain torch form, which is held to the
JAX package's Pallas kernel run in interpret mode with float32 MXU
operands (exact float32 on the CPU), at 1e-5 × max|ref|: float32 sums in
another order than XLA's.  On a card (``cuda`` marker; skipped without
one) each kernel is held to its plain form on the same device at
1e-4 × max|plain|, with TF32 off.
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


# (id, antennas, dtype, frame length, prototype taps, fd_pairs, xe_pairs)
FX_CASES = [
    ("f32", 4, "float32", 2048, None, None, None),
    ("bf16", 2, "bfloat16", 4096, None, None, None),
    ("int8", 2, "int8", 4096, None, None, None),
    ("pairs_autos", 4, "float32", 2048, None, [(0, 3), (2, 2)],
     [(0, 1), (2, 3), (1, 1), (3, 0)]),
    ("deep_1600", 2, "float32", 2048, 1600, None, None),
]


def _fx_inputs(case, n=None, seed=0):
    _, a, dt, n0, ntaps0, fdp, xep = case
    n = n or n0
    m = 16
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
    case = ("ragged", 3, "float32", 16 * 1000, None, None, None)
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
