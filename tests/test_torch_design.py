"""Port parity: design-time constants and the plain torch DSP modules of
``clenabled_tpu_torch`` against the JAX package on the CPU.

Windows and firdes designs are NumPy copies and must be bit-equal to the
JAX package; against the golden vectors (compiled from the reference's
C++) they keep the JAX package's own tolerances.  The torch DSP functions
are held to 1e-5 × max|ref|: float32 sums in another order than XLA's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # every test here needs the reference

from clenabled_tpu.dsp import channelizer as j_chan
from clenabled_tpu.dsp import firdes as j_firdes
from clenabled_tpu.dsp import pallas_kernels as j_pk
from clenabled_tpu.dsp import planar as j_planar
from clenabled_tpu.dsp import window as j_window
from clenabled_tpu.dsp import xcorr as j_xcorr
from clenabled_tpu.dsp import xengine as j_xengine
from clenabled_tpu_torch.dsp import channelizer as t_chan
from clenabled_tpu_torch.dsp import firdes as t_firdes
from clenabled_tpu_torch.dsp import hopper_kernels as t_hk
from clenabled_tpu_torch.dsp import planar as t_planar
from clenabled_tpu_torch.dsp import window as t_window
from clenabled_tpu_torch.dsp import xcorr as t_xcorr
from clenabled_tpu_torch.dsp import xengine as t_xengine

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden",
                                     "firdes_golden.json")))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


WINDOWS = [
    ("window_hamming_53", lambda w: w.hamming(53)),
    ("window_hann_64", lambda w: w.hann(64)),
    ("window_blackman_47", lambda w: w.blackman(47)),
    ("window_blackman_harris_128", lambda w: w.blackman_harris(128)),
    ("window_kaiser_65_b7.5", lambda w: w.kaiser(65, 7.5)),
    ("window_bartlett_33", lambda w: w.bartlett(33)),
    ("window_flattop_50", lambda w: w.flattop(50)),
    ("window_rect_17", lambda w: w.rectangular(17)),
]


@pytest.mark.parametrize("name,fn", WINDOWS, ids=[c[0] for c in WINDOWS])
def test_window_matches_jax_and_golden(name, fn):
    got = fn(t_window)
    np.testing.assert_array_equal(got, fn(j_window))
    np.testing.assert_allclose(got, np.asarray(GOLDEN[name], np.float32),
                               rtol=2e-5, atol=2e-6)


FIRDES = [
    ("lp_g1_fs1M_c100k_t50k_hamming",
     lambda f: f.low_pass(1.0, 1e6, 100e3, 50e3, f.WIN_HAMMING, 6.76)),
    ("lp2_g2_fs1M_c150k_t40k_70db_blackman",
     lambda f: f.low_pass_2(2.0, 1e6, 150e3, 40e3, 70.0, f.WIN_BLACKMAN, 6.76)),
    ("hp_g1_fs1M_c200k_t60k_hann",
     lambda f: f.high_pass(1.0, 1e6, 200e3, 60e3, f.WIN_HANN, 6.76)),
    ("bp_g1_fs1M_l100k_h200k_t50k_hamming",
     lambda f: f.band_pass(1.0, 1e6, 100e3, 200e3, 50e3, f.WIN_HAMMING, 6.76)),
    ("br_g1_fs1M_l100k_h200k_t50k_hamming",
     lambda f: f.band_reject(1.0, 1e6, 100e3, 200e3, 50e3, f.WIN_HAMMING,
                             6.76)),
    ("rrc_g1_fs1M_sym250k_a035_41",
     lambda f: f.root_raised_cosine(1.0, 1e6, 250e3, 0.35, 41)),
]


@pytest.mark.parametrize("name,fn", FIRDES, ids=[c[0] for c in FIRDES])
def test_firdes_matches_jax_and_golden(name, fn):
    got = fn(t_firdes)
    np.testing.assert_array_equal(got, fn(j_firdes))
    np.testing.assert_allclose(got, np.asarray(GOLDEN[name], np.float32),
                               rtol=3e-5, atol=1e-6)


def test_flagship_prototype_and_pfb_constants():
    """The step's 385-tap Hamming prototype, zero-padded to 400 taps."""
    fs, m = 100e6, 16
    args = (1.0, fs, fs / (2 * m) * 0.8, fs / (2 * m) * 0.2)
    proto = t_firdes.low_pass(*args)
    assert len(proto) == 385
    np.testing.assert_array_equal(proto, j_firdes.low_pass(*args))
    for taps, r in ((proto, 16), (proto[:100], 8)):
        t_rm, t_n = t_chan._pfb_constants(taps, m, r)
        j_rm, j_n = j_chan._pfb_constants(taps, m, r)
        assert t_n == j_n
        np.testing.assert_array_equal(t_rm, np.asarray(j_rm))
    with pytest.raises(ValueError):
        t_chan._pfb_constants(proto, 8, 16)


@pytest.mark.parametrize("m,a", [(16, 4), (8, 2), (32, 1)])
def test_idft_block_matrix(m, a):
    np.testing.assert_array_equal(t_hk._idft_block_matrix(m, a),
                                  j_pk._idft_block_matrix(m, a))


def test_fx_tail_len_all_dtypes_and_depths():
    got = {}
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16), (torch.int8, jnp.int8)):
        assert t_hk.fx_tail_len(tdt) == j_pk.fx_tail_len(jdt)
        for m, ntaps in ((16, 400), (16, 1600), (16, 3200), (8, 4000),
                         (32, 1600)):
            got[(str(tdt), m, ntaps)] = t_hk.fx_tail_len(tdt, m, ntaps)
            assert got[(str(tdt), m, ntaps)] == j_pk.fx_tail_len(jdt, m, ntaps)
    assert [got[(str(d), 16, 400)] for d in
            (torch.float32, torch.bfloat16, torch.int8)] == [1024, 2048, 4096]
    # the tail grows with deeper prototypes
    assert got[("torch.float32", 16, 3200)] > got[("torch.float32", 16, 1600)] \
        > got[("torch.float32", 16, 400)]
    with pytest.raises(ValueError):
        t_hk.fx_tail_len(torch.float16)


def test_baselines_and_triangular_index():
    for s in range(1, 9):
        assert t_xengine.num_baselines(s) == j_xengine.num_baselines(s)
        np.testing.assert_array_equal(t_xengine.baseline_stations(s),
                                      j_xengine.baseline_stations(s))
        for p in (1, 2):
            tr, tc = t_xengine._triangular_index(s, p)
            jr, jc = j_xengine._triangular_index(s, p)
            np.testing.assert_array_equal(tr, np.asarray(jr))
            np.testing.assert_array_equal(tc, np.asarray(jc))


@pytest.mark.parametrize("n", [16, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_planar_fft(n, inverse):
    rng = np.random.default_rng(n)
    x = cplx(rng, 3, n)
    want = j_planar.fft(j_planar.from_complex(x), inverse=inverse)
    got = t_planar.fft(t_planar.PC(torch.from_numpy(x.real.copy()),
                                   torch.from_numpy(x.imag.copy())),
                       inverse=inverse)
    close(got.re, want.re)
    close(got.im, want.im)


def test_branch_sums_and_packing():
    rng = np.random.default_rng(1)
    m, g, nout = 16, 8, 64
    taps = t_firdes.low_pass(1.0, 16.0, 0.5, 0.25)
    taps_rm, ntaps = t_chan._pfb_constants(taps, m, m)
    comps = rng.standard_normal((g, ntaps - 1 + nout * m)).astype(np.float32)
    tc = torch.from_numpy(comps)
    close(t_chan._branch_sums_critical_batched(tc, taps_rm, m, ntaps, nout),
          j_chan._branch_sums_critical_batched(comps, taps_rm, m, ntaps, nout))
    close(t_chan._branch_sums_critical(tc[0], taps_rm, m, ntaps, nout),
          j_chan._branch_sums_critical(comps[0], taps_rm, m, ntaps, nout))
    ty, thr = t_chan._pack_streams(tc, taps_rm, m, ntaps, nout)
    jy, jhr = j_chan._pack_streams(comps, taps_rm, m, ntaps, nout)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(thr.numpy(), np.asarray(jhr))


def test_channelize_complex_and_planar():
    rng = np.random.default_rng(2)
    m = 16
    taps = t_firdes.low_pass(1.0, float(m), 0.5, 0.25)
    taps_rm, ntaps = t_chan._pfb_constants(taps, m, m)
    x = cplx(rng, 2, 32 * m + ntaps - 1)
    ch = np.arange(m)[::-1].copy()
    kw = dict(num_channels=m, ninputs_per_iter=m, ntaps=ntaps)
    want = np.stack([np.asarray(j_chan._channelize(
        xa, taps_rm, ch.astype(np.int32), **kw)) for xa in x])
    got = t_chan._channelize(torch.from_numpy(x), taps_rm,
                             torch.from_numpy(ch), **kw)
    close(got.numpy(), want)
    want_p = j_chan._channelize_planar(j_planar.from_complex(x[0]), taps_rm,
                                       ch.astype(np.int32), **kw)
    got_p = t_chan._channelize_planar(
        t_planar.PC(torch.from_numpy(x[0].real.copy()),
                    torch.from_numpy(x[0].imag.copy())),
        taps_rm, torch.from_numpy(ch), **kw)
    close(got_p.re, want_p.re)
    close(got_p.im, want_p.im)
    # the oversampled (R < M) path, ported since: the same rows as JAX's
    kw_os = dict(kw, ninputs_per_iter=8)
    taps_os, _ = t_chan._pfb_constants(taps, m, 8)
    want_os = np.stack([np.asarray(j_chan._channelize(
        xa, taps_os, ch.astype(np.int32), **kw_os)) for xa in x])
    close(t_chan._channelize(torch.from_numpy(x), taps_os,
                             torch.from_numpy(ch), **kw_os).numpy(), want_os)


def test_fd_xcorr_complex_and_planar():
    rng = np.random.default_rng(3)
    v = cplx(rng, 3, 5, 64)
    close(t_xcorr.fd_xcorr(torch.from_numpy(v)), j_xcorr.fd_xcorr(v))
    close(t_xcorr.fd_xcorr(torch.from_numpy(v), perform_fft_first=True),
          j_xcorr.fd_xcorr(v, perform_fft_first=True))
    pc = t_planar.PC(torch.from_numpy(v.real.copy()),
                     torch.from_numpy(v.imag.copy()))
    close(t_xcorr.fd_xcorr_planar(pc),
          j_xcorr.fd_xcorr_planar(j_planar.from_complex(v)))


@pytest.mark.parametrize("npol", [1, 2])
def test_xengine_complex_and_planar(npol):
    rng = np.random.default_rng(4 + npol)
    z = cplx(rng, 24, 4, 8, npol)
    for fmt in (t_xengine.CLXCORR_TRIANGULAR_ORDER,
                t_xengine.CLXCORR_FULL_MATRIX):
        close(t_xengine.xengine_correlate(torch.from_numpy(z), npol, fmt),
              j_xengine.xengine_correlate(z, npol, fmt))
        got = t_xengine.xengine_correlate_planar(
            t_planar.PC(torch.from_numpy(z.real.copy()),
                        torch.from_numpy(z.imag.copy())), npol, fmt)
        want = j_xengine.xengine_correlate_planar(j_planar.from_complex(z),
                                                  npol, fmt)
        close(got.re, want.re)
        close(got.im, want.im)


def test_port_imports_no_jax():
    """Importing the port and every submodule leaves jax unimported."""
    mods = ["clenabled_tpu_torch", "clenabled_tpu_torch.pipelines",
            "clenabled_tpu_torch.streaming.ingest",
            "clenabled_tpu_torch.runtime.device", "clenabled_tpu_torch._build",
            "clenabled_tpu_torch.dsp.hopper_kernels",
            "clenabled_tpu_torch.dsp.xengine", "clenabled_tpu_torch.blocks",
            "clenabled_tpu_torch.streaming.graph",
            "clenabled_tpu_torch.tools.test_clxengine",
            "clenabled_tpu_torch.dsp.fir_filter",
            "clenabled_tpu_torch.dsp.fft_filter",
            "clenabled_tpu_torch.dsp.demod",
            "clenabled_tpu_torch.blocks.filters",
            "clenabled_tpu_torch.blocks.demod",
            "clenabled_tpu_torch.tools.test_clfilter",
            "clenabled_tpu_torch.tools.costas_ab",
            "clenabled_tpu_torch.tools.gram_ab",
            "clenabled_tpu_torch.tools.fx_ab",
            "clenabled_tpu_torch.tools.fir_ab",
            "clenabled_tpu_torch.tools.os_ab",
            "clenabled_tpu_torch.tools.pfb_ab",
            "clenabled_tpu_torch.tools.step_ab",
            "clenabled_tpu_torch.tools.variant_ab",
            "clenabled_tpu_torch.sharding",
            "clenabled_tpu_torch.sharding.mesh",
            "clenabled_tpu_torch.sharding.collectives",
            "clenabled_tpu_torch.sharding.halo",
            "clenabled_tpu_torch.sharding.launch",
            "clenabled_tpu_torch.entry",
            "clenabled_tpu_torch.tools.sharded_scaling",
            "clenabled_tpu_torch.dsp.xcorr",
            "clenabled_tpu_torch.blocks.correlators",
            "clenabled_tpu_torch.runtime.dtypes",
            "clenabled_tpu_torch.runtime.config",
            "clenabled_tpu_torch.sharding.xcorr_sharded",
            "clenabled_tpu_torch.tools.test_clxcorrelate"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from clenabled_tpu_torch.runtime import (DeviceContext, "
            "get_context, set_default_mesh)\n"
            "from clenabled_tpu_torch.pipelines import ("
            "make_sharded_fx_pipeline, make_sharded_fx_pipeline_fused)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith(('jax.', 'jaxlib', 'clenabled_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
