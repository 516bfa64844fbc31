"""Port parity: the three forms of the FX receive step over chained steps.

Each port pipeline runs 3 chained steps of 4 antennas × 2^14 samples on
the CPU beside its JAX counterpart (the fused one with its Pallas kernel
in interpret mode and float32 MXU operands) and is held to 1e-4 × max|ref|
per output: float32 sums in another order than XLA's, accumulated over a
step.  Carried tails must be equal.  A stream begun in JAX continues in the
port through ``carry_from_reference``.  On a card (``cuda`` marker) the
kernel forms are held to the plain forms on the CPU.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu import pipelines as J
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

from clenabled_tpu_torch import pipelines as P

REL = 1e-4
N = 1 << 14
STEPS = 3
CFG = P.FxPipelineConfig(num_antennas=4, num_channels=16, samples_per_step=N)


def close(got, want, rel=REL):
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


def _real_frames(dt: str, seed: int, a: int = 4):
    rng = np.random.default_rng(seed)
    if dt == "int8":
        mk = lambda: rng.integers(-127, 128, (a, N)).astype(np.int8)
    else:   # float32 values, bf16-representable for bf16
        mk = lambda: torch.from_numpy(rng.standard_normal((a, N)).astype(
            np.float32)).to(getattr(torch, dt)).float().numpy()
    return [(mk(), mk()) for _ in range(STEPS)]


def _t(x, dt="float32", device="cpu"):
    return torch.from_numpy(np.asarray(x, np.float32) if dt == "bfloat16"
                            else np.asarray(x)).to(device, getattr(torch, dt))


def test_complex_pipeline_matches_jax(ref):
    rng = np.random.default_rng(0)
    jfn, (_, jh) = J.make_fx_pipeline(CFG)
    tfn, (_, th) = P.make_fx_pipeline(CFG, device="cpu")
    for _ in range(STEPS):
        x = (rng.standard_normal((4, N))
             + 1j * rng.standard_normal((4, N))).astype(np.complex64)
        jfd, jx, jh = jfn(x, jh)
        tfd, tx, th = tfn(torch.from_numpy(x), th)
        close(tfd, jfd)
        close(torch.view_as_real(tx), np.stack(
            [np.asarray(jx).real, np.asarray(jx).imag], -1))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_planar_pipeline_matches_jax(ref):
    jfn, (_, _, jhr, jhi) = J.make_fx_pipeline_planar(CFG, use_pallas=False)
    tfn, (_, _, thr, thi) = P.make_fx_pipeline_planar(CFG, device="cpu")
    for xr, xi in _real_frames("float32", 1):
        jout = jfn(xr, xi, jhr, jhi)
        tout = tfn(_t(xr), _t(xi), thr, thi)
        for g, w in zip(tout[:3], jout[:3]):
            close(g, w)
        jhr, jhi, thr, thi = jout[3], jout[4], tout[3], tout[4]
        np.testing.assert_array_equal(thr.numpy(), np.asarray(jhr))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def test_planar_pipeline_64ch_matches_jax(ref):
    """The planar step at 64 channels (the step's own 1600-tap prototype,
    25 taps a branch: pfb_packed_wide_kernel's shape on a card) against
    JAX's over two chained frames, tails bit-equal."""
    cfg = CFG._replace(num_channels=64)
    jfn, (_, _, jhr, jhi) = J.make_fx_pipeline_planar(cfg, use_pallas=False)
    tfn, (_, _, thr, thi) = P.make_fx_pipeline_planar(cfg, device="cpu")
    assert tfn.taps_rm.shape == (25, 64)
    for xr, xi in _real_frames("float32", 11)[:2]:
        jout = jfn(xr, xi, jhr, jhi)
        tout = tfn(_t(xr), _t(xi), thr, thi)
        for g, w in zip(tout[:3], jout[:3]):
            close(g, w)
        jhr, jhi, thr, thi = jout[3], jout[4], tout[3], tout[4]
        np.testing.assert_array_equal(thr.numpy(), np.asarray(jhr))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def test_planar_use_kernel_on_cpu():
    tfn, args = P.make_fx_pipeline_planar(CFG, use_kernel=True, device="cpu")
    with pytest.raises(ValueError):
        tfn(*args)
    off, _ = P.make_fx_pipeline_planar(CFG, use_kernel=False, device="cpu")
    auto, _ = P.make_fx_pipeline_planar(CFG, device="cpu")
    xr, xi = (_t(x) for x in _real_frames("float32", 2)[0])
    for g, w in zip(auto(xr, xi, *args[2:]), off(xr, xi, *args[2:])):
        assert torch.equal(g, w)


FUSED = [
    ("f32", "float32", None, None),
    ("int8", "int8", None, None),
    ("f32_pairs", "float32", [(0, 2), (3, 3)], [(1, 0), (2, 2), (0, 3)]),
]


def _run_jax_fused(dt, fdp, xep, frames, tails=None, cfg=CFG):
    jfn, (_, _, jtr, jti) = J.make_fx_pipeline_fused(
        cfg, in_dtype=getattr(jnp, dt), interpret=True, mxu_dtype=jnp.float32,
        fd_pairs=fdp, xe_pairs=xep)
    if tails is not None:
        jtr, jti = tails
    outs = []
    for xr, xi in frames:
        o = jfn(jnp.asarray(xr, getattr(jnp, dt)),
                jnp.asarray(xi, getattr(jnp, dt)), jtr, jti)
        outs.append(o)
        jtr, jti = o[3], o[4]
    return outs


# the fused step at 16 channels (400 taps) and at 64 (the 1600-tap
# prototype, fx_wide_kernel's on a card), each case's id kept at 16
FUSED_M = [(c, 16) for c in FUSED] + [(c, 64) for c in FUSED]
FUSED_M_IDS = [c[0] for c in FUSED] + [c[0] + "_m64" for c in FUSED]


@pytest.mark.parametrize("case,channels", FUSED_M, ids=FUSED_M_IDS)
def test_fused_pipeline_matches_jax(ref, case, channels):
    _, dt, fdp, xep = case
    cfg = CFG._replace(num_channels=channels)
    frames = _real_frames(dt, 3)
    jouts = _run_jax_fused(dt, fdp, xep, frames, cfg=cfg)
    tfn, (_, _, ttr, tti) = P.make_fx_pipeline_fused(
        cfg, in_dtype=getattr(torch, dt), fd_pairs=fdp, xe_pairs=xep,
        device="cpu")
    # the tails fx_tail_len sizes: 8/32 rows of 128 at 400 taps, 16/32 at
    # 1600 (f32/int8)
    assert ttr.shape[-1] == {(16, "float32"): 1024, (16, "int8"): 4096,
                             (64, "float32"): 2048, (64, "int8"): 4096}[
                                 channels, dt]
    for (xr, xi), jo in zip(frames, jouts):
        to = tfn(_t(xr, dt), _t(xi, dt), ttr, tti)
        for g, w in zip(to[:3], jo[:3]):
            close(g, w)
        ttr, tti = to[3], to[4]
        np.testing.assert_array_equal(ttr.float().numpy(),
                                      np.asarray(jo[3], np.float32))
        np.testing.assert_array_equal(tti.float().numpy(),
                                      np.asarray(jo[4], np.float32))


def test_stream_handover_from_jax_mid_stream(ref):
    """Two bf16 steps in JAX, the third in the port from JAX's carried
    tails (ml_dtypes.bfloat16 arrays), equals JAX's third step."""
    dt = "bfloat16"
    frames = _real_frames(dt, 4)
    jouts = _run_jax_fused(dt, None, None, frames)
    tr, ti = P.carry_from_reference(np.asarray(jouts[1][3]),
                                    np.asarray(jouts[1][4]), torch.bfloat16,
                                    "cpu")
    assert tr.dtype == torch.bfloat16 and tr.shape == (4, 2048)
    tfn, _ = P.make_fx_pipeline_fused(CFG, in_dtype=torch.bfloat16,
                                      device="cpu")
    xr, xi = frames[2]
    to = tfn(_t(xr, dt), _t(xi, dt), tr, ti)
    for g, w in zip(to[:3], jouts[2][:3]):
        close(g, w)
    proto = J.firdes.low_pass(1.0, 100e6, 100e6 / 32 * 0.8, 100e6 / 32 * 0.2)
    proto = np.concatenate([proto, np.zeros(15, np.float32)])
    taps = P.taps_from_reference(J.dsp_chan._pfb_constants(proto, 16, 16)[0])
    assert taps.dtype == torch.float32
    assert torch.equal(taps, torch.from_numpy(P._prototype(16, 100e6)[0]))


def test_fused_pipeline_rejects_short_frames():
    with pytest.raises(ValueError):
        P.make_fx_pipeline_fused(P.FxPipelineConfig(samples_per_step=512),
                                 device="cpu")


@pytest.mark.parametrize("helper", ["carry", "xengine"])
def test_reference_state_defaults_to_the_card(monkeypatch, helper):
    """The hand-over helpers put their tensors on the card unless asked
    for the CPU: without a visible card, the default raises."""
    a = np.zeros((2, 8), np.float32)
    call = {"carry": lambda **kw: P.carry_from_reference(a, a, **kw),
            "xengine": lambda **kw: P.xengine_state_from_reference(
                a, a, 1, **kw)}[helper]
    out = call(device="cpu")
    first = out[0] if helper == "carry" else out.accum.re
    assert first.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("dt,channels", [("float32", 16), ("int8", 16),
                                         ("float32", 64), ("int8", 64)],
                         ids=["float32", "int8", "float32_m64", "int8_m64"])
def test_fused_pipeline_on_card_matches_cpu(card, dt, channels):
    """The fused step on the card (fx_reg_kernel at 16 channels,
    fx_wide_kernel at 64) against its plain form on the CPU over 3 chained
    steps, tails equal."""
    cfg = CFG._replace(num_channels=channels)
    frames = _real_frames(dt, 5)
    gfn, (_, _, gtr, gti) = P.make_fx_pipeline_fused(
        cfg, in_dtype=getattr(torch, dt), device=card)
    cfn, (_, _, ctr, cti) = P.make_fx_pipeline_fused(
        cfg, in_dtype=getattr(torch, dt), device="cpu")
    for xr, xi in frames:
        go = gfn(_t(xr, dt, card), _t(xi, dt, card), gtr, gti)
        co = cfn(_t(xr, dt), _t(xi, dt), ctr, cti)
        for g, w in zip(go[:3], co[:3]):
            close(g, w)
        gtr, gti, ctr, cti = go[3], go[4], co[3], co[4]
        assert torch.equal(gtr.cpu(), ctr)


@pytest.mark.cuda
def test_planar_pipeline_64ch_kernel_on_card_matches_cpu(card):
    """The 64-channel planar step on the card (pfb_packed_wide_kernel, one
    launch a step) against its plain form on the CPU over 3 chained steps,
    tails equal."""
    from clenabled_tpu_torch.dsp import hopper_kernels as hk

    cfg = CFG._replace(num_channels=64)
    gfn, (_, _, ghr, ghi) = P.make_fx_pipeline_planar(cfg, device=card)
    cfn, (_, _, chr_, chi) = P.make_fx_pipeline_planar(cfg, device="cpu")
    assert hk.pfb_packed_body(64, 25, card) == "pfb_packed_wide_kernel"
    before = hk.pfb_channelize_packed.launches
    for xr, xi in _real_frames("float32", 12):
        go = gfn(_t(xr, device=card), _t(xi, device=card), ghr, ghi)
        co = cfn(_t(xr), _t(xi), chr_, chi)
        for g, w in zip(go[:3], co[:3]):
            close(g, w)
        ghr, ghi, chr_, chi = go[3], go[4], co[3], co[4]
        assert torch.equal(ghr.cpu(), chr_) and torch.equal(ghi.cpu(), chi)
    assert hk.pfb_channelize_packed.launches == before + STEPS


@pytest.mark.cuda
def test_planar_pipeline_kernel_on_card_matches_cpu(card):
    gfn, (_, _, ghr, ghi) = P.make_fx_pipeline_planar(CFG, device=card)
    cfn, (_, _, chr_, chi) = P.make_fx_pipeline_planar(CFG, device="cpu")
    for xr, xi in _real_frames("float32", 6):
        go = gfn(_t(xr, device=card), _t(xi, device=card), ghr, ghi)
        co = cfn(_t(xr), _t(xi), chr_, chi)
        for g, w in zip(go[:3], co[:3]):
            close(g, w)
        ghr, ghi, chr_, chi = go[3], go[4], co[3], co[4]
