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
