"""Port parity: the quadrature demodulator (B.8) and its block.

The plain forms (``torch.atan2``) are held to the JAX package's XLA forms
within 1e-6·|gain| rad, as wrapped angles (float32 atan2 of the same
products: a few ulps of π, and a product on the negative real axis may
round to either side of the branch cut).  The Pallas kernel's polynomial
atan2 is held from sample 1 on within 5e-6·|gain| (its stated error is
about 1e-5 rad at the worst; measured below 2e-6).  Sample 0 of a first
frame differs by design: with the carried sample zero the product is a
signed zero, which ``atan2`` maps to ±π or ±0 and the polynomial always to
+0 — the port follows the XLA forms.  On a card (``cuda`` marker; skipped
without one) the kernel is held to its plain form within 1e-6·|gain|.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu.dsp import demod as j_demod
    from clenabled_tpu.dsp import pallas_kernels as j_pk
    from clenabled_tpu.dsp import planar as j_planar
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import blocks
from clenabled_tpu_torch.dsp import demod
from clenabled_tpu_torch.dsp import hopper_kernels as hk
from clenabled_tpu_torch.dsp import planar

XLA_TOL = 1e-6
PALLAS_TOL = 5e-6


def np_of(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def angles_close(got, want, gain, tol):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    d = np.angle(np.exp(1j * (got.astype(np.float64) - want) / gain))
    err = np.abs(d).max() * abs(gain)
    assert err <= tol * abs(gain), err
    return err


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


def samples(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2,) + tuple(shape)).astype(np.float32)


GAINS = [1.0, -2.5, 0.37]


@pytest.mark.parametrize("gain", GAINS)
def test_planar_demod_matches_xla(ref, gain):
    """quadrature_demod_planar (plain) against JAX's XLA form, first frame
    (no carried sample) and a carried one."""
    x = samples((4096,), seed=1)
    last = samples((1,), seed=2)
    got, got_last = demod.quadrature_demod_planar(
        planar.PC(torch.from_numpy(x[0]), torch.from_numpy(x[1])), gain)
    want, want_last = j_demod.quadrature_demod_planar(
        j_planar.PC(jnp.asarray(x[0]), jnp.asarray(x[1])), gain,
        use_pallas=False)
    angles_close(got, want, gain, XLA_TOL)
    assert np_of(got_last.re) == np_of(want_last.re)
    got, _ = demod.quadrature_demod_planar(
        planar.PC(torch.from_numpy(x[0]), torch.from_numpy(x[1])), gain,
        last_sample=planar.PC(torch.from_numpy(last[0]),
                              torch.from_numpy(last[1])))
    want, _ = j_demod.quadrature_demod_planar(
        j_planar.PC(jnp.asarray(x[0]), jnp.asarray(x[1])), gain,
        last_sample=j_planar.PC(jnp.asarray(last[0]), jnp.asarray(last[1])),
        use_pallas=False)
    angles_close(got, want, gain, XLA_TOL)


@pytest.mark.parametrize("gain", GAINS)
def test_complex_demod_matches_xla(ref, gain):
    x = samples((3000,), seed=3)
    z = (x[0] + 1j * x[1]).astype(np.complex64)
    last = np.array([0.3 - 0.8j], np.complex64)
    for ls in (None, last):
        got, got_last = demod.quadrature_demod(
            torch.from_numpy(z), gain,
            None if ls is None else torch.from_numpy(ls))
        want, want_last = j_demod.quadrature_demod(z, gain, ls)
        angles_close(got, want, gain, XLA_TOL)
        assert np_of(got_last) == np.asarray(want_last)


@pytest.mark.parametrize("gain", GAINS)
def test_plain_form_matches_pallas_kernel(ref, gain):
    """qdemod_fused's plain form against the Pallas kernel in interpret
    mode, from sample 1 on (sample 0's carried sample is nonzero here, so
    it is compared too)."""
    x = samples((8192,), seed=4)
    lr, li = 0.6, -0.25
    want = j_pk.qdemod_fused(jnp.asarray(x[0]), jnp.asarray(x[1]), lr, li,
                             gain, interpret=True)
    hk.reset_launch_counts()
    got = hk.qdemod_fused(torch.from_numpy(x[0]), torch.from_numpy(x[1]),
                          torch.tensor(lr), torch.tensor(li), gain)
    assert hk.qdemod_fused.launches == 0
    assert torch.equal(got, hk.qdemod_fused_plain(
        torch.from_numpy(x[0]), torch.from_numpy(x[1]), torch.tensor(lr),
        torch.tensor(li), gain))
    angles_close(got[1:], np.asarray(want)[1:], gain, PALLAS_TOL)
    angles_close(got[:1], np.asarray(want)[:1], gain, PALLAS_TOL)


def test_signed_zero_first_sample(ref):
    """x[0] = −1−1j after a zero carried sample: the product is (−0, +0),
    atan2 gives π in both XLA forms and the port, the Pallas polynomial 0.
    The Pallas kernel agrees from sample 1 on."""
    x = samples((1024,), seed=5)
    x[:, 0] = -1.0
    zero = torch.zeros(())
    got = hk.qdemod_fused(torch.from_numpy(x[0]), torch.from_numpy(x[1]),
                          zero, zero, 1.0)
    assert float(got[0]) == pytest.approx(np.pi)
    xla, _ = j_demod.quadrature_demod_planar(
        j_planar.PC(jnp.asarray(x[0]), jnp.asarray(x[1])), 1.0,
        last_sample=j_planar.PC(jnp.zeros(1), jnp.zeros(1)), use_pallas=False)
    cplx, _ = j_demod.quadrature_demod((x[0] + 1j * x[1]).astype(np.complex64),
                                       1.0, jnp.zeros(1, jnp.complex64))
    pallas = j_pk.qdemod_fused(jnp.asarray(x[0]), jnp.asarray(x[1]), 0.0, 0.0,
                               1.0, interpret=True)
    assert float(xla[0]) == float(cplx[0]) == pytest.approx(np.pi)
    assert float(pallas[0]) == 0.0
    angles_close(got, np.asarray(xla), 1.0, XLA_TOL)
    angles_close(got[1:], np.asarray(pallas)[1:], 1.0, PALLAS_TOL)


def test_wrapper_any_length_and_rows():
    """Any n ≥ 1 (the TPU kernel needs multiples of 1024), and leading
    rows with one carried sample each; shape checks."""
    for n in (1, 7, 1001):
        x = torch.from_numpy(samples((n,), seed=n))
        y = hk.qdemod_fused(x[0], x[1], torch.tensor(0.5), torch.tensor(0.5),
                            2.0)
        assert y.shape == (n,) and torch.isfinite(y).all()
    x = torch.from_numpy(samples((3, 257), seed=6))
    last = torch.from_numpy(samples((3, 1), seed=7))
    y = hk.qdemod_fused(x[0], x[1], last[0], last[1], 1.0)
    for r in range(3):
        assert torch.equal(y[r], hk.qdemod_fused(x[0, r], x[1, r], last[0, r],
                                                 last[1, r], 1.0))
    with pytest.raises(ValueError, match="carried sample per row"):
        hk.qdemod_fused(x[0], x[1], last[0, :2], last[1, :2], 1.0)
    with pytest.raises(ValueError, match="one shape"):
        hk.qdemod_fused(x[0], x[1, :2], last[0], last[1], 1.0)


@pytest.mark.parametrize("planar_", [True, False], ids=["planar", "complex"])
def test_block_matches_jax_over_frames(ref, planar_):
    """QuadratureDemod over 3 frames, state carried, against the JAX
    block (first frame's sample 0 included: both start from zeros)."""
    tb = blocks.QuadratureDemod(0.8, planar=planar_)
    jb = j_blocks.QuadratureDemod(0.8, planar=planar_)
    ts, js = tb.init_state(), jb.init_state()
    for seed in range(3):
        x = samples((2048,), seed=10 + seed)
        if planar_:
            tin = planar.PC(torch.from_numpy(x[0]), torch.from_numpy(x[1]))
            jin = j_planar.PC(jnp.asarray(x[0]), jnp.asarray(x[1]))
        else:
            tin = torch.from_numpy((x[0] + 1j * x[1]).astype(np.complex64))
            jin = (x[0] + 1j * x[1]).astype(np.complex64)
        ts, (ty,), _ = tb.apply(ts, (tin,))
        js, (jy,), _ = jb.apply(js, (jin,))
        angles_close(ty, jy, 0.8, XLA_TOL)
    if planar_:
        assert np_of(ts.re) == np.asarray(js.re)
    else:
        assert np_of(ts) == np.asarray(js)


@pytest.mark.cuda
def test_demod_kernel_matches_plain_on_card(card):
    for shape in ((1 << 16,), (1001,), (3, 777)):
        x = torch.from_numpy(samples(shape, seed=20)).to(card)
        last = torch.from_numpy(samples(shape[:-1] + (1,), seed=21)).to(card)
        before = hk.qdemod_fused.launches
        got = hk.qdemod_fused(x[0], x[1], last[0], last[1], -1.7)
        torch.cuda.synchronize()
        assert hk.qdemod_fused.launches == before + 1
        want = hk.qdemod_fused_plain(x[0], x[1], last[0], last[1], -1.7)
        angles_close(got, want, -1.7, XLA_TOL)


@pytest.mark.cuda
def test_demod_kernel_signed_zero_on_card(card):
    x = torch.from_numpy(samples((4096,), seed=22)).to(card)
    x[:, 0] = -1.0
    z = torch.zeros((), device=card)
    got = hk.qdemod_fused(x[0], x[1], z, z, 1.0)
    assert float(got[0]) == pytest.approx(np.pi)
    y, last = demod.quadrature_demod_planar(planar.PC(x[0], x[1]), 1.0,
                                            planar.PC(z[None], z[None]))
    assert torch.equal(y, got) and last.re.device == x.device
    with pytest.raises(ValueError, match="one device"):
        hk.qdemod_fused(x[0], x[1], z.cpu(), z.cpu(), 1.0)
