"""Golden parity for the port: its CPU forms against the vectors compiled
from the original gr-clenabled C++ (``tests/golden/``), with the
tolerances of ``tests/test_golden_kernels.py`` and
``tests/test_golden_streaming.py``.

From ``kernels_golden.json``: the streaming PFB (its R < M groups that the
reference reads past its buffer for are left out, as the JAX test leaves
them out), the clFFT assemblies, the FD correlator and the X-Engine's
cxmac integration and the time-domain lag scan with its argmax (complex
and planar).  From ``streaming_golden.json``: the overlap-add filter's
tail carry, the Costas trajectories (512 samples), the quadrature
demodulator, the float FIR variants and the short-dtype FIRs (scc
widening, fsf's truncating cast, also at decimation 2).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from clenabled_tpu_torch.dsp import (channelizer, demod, fft, fft_filter,
                                     fir_filter, firdes, planar, xcorr,
                                     xengine)

HERE = pathlib.Path(__file__).parent / "golden"
KERNELS = json.loads((HERE / "kernels_golden.json").read_text())
STREAMING = json.loads((HERE / "streaming_golden.json").read_text())


def as_complex(flat):
    a = np.asarray(flat, np.float32)
    return (a[0::2] + 1j * a[1::2]).astype(np.complex64)


def _c(key):
    a = np.asarray(STREAMING[key], np.float32)
    return (a[:, 0] + 1j * a[:, 1]).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("idx", range(len(KERNELS["pfb"])))
def test_pfb_streaming_golden(idx):
    g = KERNELS["pfb"][idx]
    m, r, ntaps, b = g["m"], g["r"], g["ntaps"], g["buf_items"]
    taps = np.asarray(g["taps"], np.float32)
    stream = as_complex(g["stream"])
    groups, nch = b // r, len(g["ch_map"])
    n_ok = groups - g["skip_last_groups"]
    init, apply = channelizer.make_channelizer(taps, m, r, g["ch_map"],
                                               device="cpu")
    state = init()
    for call, want_flat in enumerate(g["calls"]):
        frame = stream[(ntaps - 1) + call * b:(ntaps - 1) + (call + 1) * b]
        state, out = apply(state, _t(frame))
        got = out.numpy().reshape(groups, nch)[:n_ok]
        want = as_complex(want_flat).reshape(groups, nch)[:n_ok]
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"call {call}")


@pytest.mark.parametrize("case", [c["case"] for c in KERNELS["clfft"]])
def test_clfft_golden(case):
    g = next(c for c in KERNELS["clfft"] if c["case"] == case)
    n = g["n"]
    want = as_complex(g["output"])
    if case == "float_fwd":
        got = fft.fft(_t(np.asarray(g["input"], np.float32)), fft.FORWARD)
    elif case == "fwd_window":
        got = fft.fft(_t(as_complex(g["input"])), fft.FORWARD,
                      window=np.asarray(g["window"], np.float32))
    else:
        direction = fft.FORWARD if case == "fwd_shift" else fft.REVERSE
        got = fft.fft(_t(as_complex(g["input"])), direction, shift=True)
    got = got.numpy()
    keep = np.ones(n, bool)
    if g.get("hermitian_mid_unspecified"):
        keep[n // 2] = False              # out[N/2] unset in the reference
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("fft_first", [False, True])
def test_fd_xcorr_golden(fft_first):
    g = next(e for e in KERNELS["fd_xcorr"] if e["fft_first"] == fft_first)
    v = _t(np.stack([as_complex(g["ref"]), as_complex(g["sig"])]))
    got = xcorr.fd_xcorr(v, perform_fft_first=fft_first).numpy()[0]
    want = np.asarray(g["output"], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())


@pytest.mark.parametrize("form", ["complex", "planar"])
def test_td_xcorr_golden(form):
    """The normalized lag scan and find_max: the window-energy endpoints
    and the shift sign are the pinned semantics (rtol/atol 1e-4, as
    ``tests/test_golden_kernels.py``)."""
    g = KERNELS["td_xcorr"]
    sigs = np.stack([as_complex(g["ref"]), as_complex(g["sig"])])
    if form == "complex":
        res = xcorr.td_xcorr(_t(sigs), g["max_shift"])
    else:
        res = xcorr.td_xcorr_planar(planar.pabs(planar.from_complex(sigs)),
                                    g["max_shift"])
    got = res.corr_vectors.numpy()[0]
    want = np.asarray(g["corr"], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert int(np.argmax(got)) == g["max_index"]
    assert int(res.lag[0]) == g["max_index"] - g["max_shift"]


@pytest.mark.parametrize("mode", ["ichar", "packed4"])
def test_xengine_cxmac_golden(mode):
    g = next(e for e in KERNELS["xengine"] if e["mode"] == mode)
    a, p, f, t = (g["num_inputs"], g["npol"], g["num_channels"],
                  g["integration_time"])
    nb = xengine.num_baselines(a)
    accum = torch.zeros((f, nb, p * p), dtype=torch.complex64)
    for call in g["calls"]:
        raw = _t(np.asarray(call["bytes"], np.uint8))
        if mode == "ichar":
            re8, im8 = xengine.unpack_char_int8(raw)
            z = torch.complex(re8.float(), im8.float()) / 127.0
        else:
            z = xengine.unpack_packed_4bit(raw)
        z = z.reshape(t, a, f, p).to(torch.complex64)
        accum += xengine.xengine_correlate(z, npol=p)
        want_flat = np.asarray(call["accum"], np.float32)
        want = (want_flat[0::2] + 1j * want_flat[1::2]).reshape(f, nb, p * p)
        np.testing.assert_allclose(accum.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tag,decim", [("d1", 1), ("d2", 2)])
def test_fft_filter_streaming_golden(tag, decim):
    taps = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    assert len(taps) == STREAMING["fftfilt_lp_ntaps"]
    init, apply, plan = fft_filter.make_fft_filter(taps, decimation=decim)
    assert plan.nsamples == STREAMING[f"fftfilt_{tag}_nsamples"]
    assert plan.fftsize == STREAMING[f"fftfilt_{tag}_fftsize"]
    state = init()
    for call in range(3):
        want = _c(f"fftfilt_{tag}_call{call}_out")
        state, got = apply(state, _t(_c(f"fftfilt_{tag}_call{call}_in")))
        got = got.numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * max(1e-9, np.abs(want).max()),
                                   err_msg=f"call {call}")


@pytest.mark.parametrize("order", [2, 4])
def test_costas_trajectory_golden(order):
    tag = f"o{order}"
    x = _c(f"costas_{tag}_in")
    want = _c(f"costas_{tag}_out")
    final = np.asarray(STREAMING[f"costas_{tag}_final"], np.float32)
    run = demod.make_costas_loop_planar(0.0628318, order)
    st, out = run(demod.costas_init(device="cpu"),
                  planar.PC(_t(x.real.astype(np.float32)),
                            _t(x.imag.astype(np.float32))))
    got = out.re.numpy() + 1j * out.im.numpy()
    np.testing.assert_allclose(got[:64], want[:64], atol=5e-4)
    np.testing.assert_allclose(got[-128:], want[-128:], atol=5e-3)
    np.testing.assert_allclose(float(st.freq), final[1], atol=2e-3)


def test_quadrature_demod_golden():
    x = _c("qdemod_in")
    want_libm = np.asarray(STREAMING["qdemod_libm_atan2"], np.float32)
    want_fast = np.asarray(STREAMING["qdemod_fast_atan2f"], np.float32)
    got, _ = demod.quadrature_demod(_t(x[1:]), 2.5, last_sample=_t(x[:1]))
    got = got.numpy()
    assert got.shape == want_libm.shape
    np.testing.assert_allclose(got, want_libm, atol=5e-5)
    assert np.abs(got - want_fast).max() < 2.5e-3


def _fir_case(variant):
    ftaps = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    ctaps = np.asarray(firdes.complex_band_pass(1.0, 1e6, -100e3, 200e3, 50e3))
    if variant == "fff":
        return (np.asarray(STREAMING["fir_fff_in"], np.float32), ftaps, 1,
                np.asarray(STREAMING["fir_fff_out"], np.float32))
    if variant == "ccf":
        return _c("fir_ccf_in"), ftaps, 2, _c("fir_ccf_outdec2")
    if variant == "fcc":
        return (np.asarray(STREAMING["fir_fcc_in"], np.float32), ctaps, 1,
                _c("fir_fcc_out"))
    return _c("fir_ccc_in"), ctaps, 1, _c("fir_ccc_out")


@pytest.mark.parametrize("variant", ["fff", "ccf", "fcc", "ccc"])
def test_fir_float_variants_golden(variant):
    x, taps, decim, want = _fir_case(variant)
    got = fir_filter.fir_filter(_t(x), taps, decim).numpy()
    if decim > 1:                  # the reference's buffer runs past the input
        want = want[: got.shape[0]]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-6 * np.abs(want).max())


def test_fir_scc_golden():
    """int16 widened, complex taps (atol 3e-5 × max, as the JAX test)."""
    ctaps = firdes.complex_band_pass(1.0, 1e6, -100e3, 200e3, 50e3)
    x = np.asarray(STREAMING["fir_scc_in"], np.int16)
    want = _c("fir_scc_out")
    got = fir_filter.fir_filter_scc(x, ctaps).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("decim", [1, 2])
def test_fir_fsf_truncation_golden(decim):
    """fsf's (int16) truncation: a float dot in another summation order may
    land on the other side of an integer, so at most one count on under 5%
    of the samples (``fir_fsf_out`` and ``fir_fsf_outdec2``)."""
    taps = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    x = np.asarray(STREAMING["fir_fsf_in"], np.float32)
    want = np.asarray(STREAMING["fir_fsf_out"], np.int16)
    n = want.shape[0]
    if decim == 1:
        got = fir_filter.fir_filter_fsf(x[: n + len(taps) - 1], taps)
    else:
        want = np.asarray(STREAMING["fir_fsf_outdec2"], np.int16)
        got = fir_filter.fir_filter_fsf(x, taps, decimation=2)[:n]
    got = got.numpy()
    assert got.dtype == np.int16 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.05
