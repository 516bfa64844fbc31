"""At a tiny size the plain reference agrees with the port's plain CPU
paths: the planar FX step (``use_kernel=False``), the fused step's plain
form, and the ``XEngine`` flowgraph on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import firdes, round_tf32
from benchmark.reference import fx as ref_fx
from benchmark.reference import xengine as ref_xe

A, M, N = 4, 16, 4096
FD = [(0, 1), (0, 2), (0, 3)]
XE = [(0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1),
      (3, 2), (3, 3)]


def _taps():
    return firdes.branch_taps(firdes.low_pass(1.0, 100e6, 2.5e6, 0.625e6), M)


def test_prototype_matches_the_port():
    from clenabled_tpu_torch import pipelines

    taps_rm, ntaps = pipelines._prototype(M, 100e6)
    assert ntaps == 400
    assert np.array_equal(np.asarray(taps_rm), _taps())


def test_tail_rule_matches_the_port():
    from clenabled_tpu_torch.dsp import hopper_kernels as hk

    for dt, size in ((torch.float32, 4), (torch.bfloat16, 2), (torch.int8, 1)):
        for m, ntaps in ((16, 400), (64, 1600), (128, 3200), (4, 64)):
            assert (ref_fx.tail_len(size, m, ntaps)
                    == hk.fx_tail_len(dt, m, ntaps))


def _frames(seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((A, N), generator=g) for _ in range(4)]


def test_fx_reference_matches_the_planar_step():
    """The reference over (previous frame, frame) is the planar step over
    the stream it reads: H − (W·M − 1) samples late."""
    from clenabled_tpu_torch import pipelines

    pr, pi, fr, fi = _frames(3)
    taps = _taps()
    h = ref_fx.tail_len(4, M, taps.size)
    fd, g_re, g_im = ref_fx.fx_step(fr, fi, pr, pi, taps, h, FD, XE)
    fn, _ = pipelines.make_fx_pipeline_planar(
        pipelines.FxPipelineConfig(A, M, N), use_kernel=False, device="cpu")
    hist = taps.size - 1
    vr = torch.cat([pr[:, N - h:], fr], -1)
    vi = torch.cat([pi[:, N - h:], fi], -1)
    p_fd, p_re, p_im, _, _ = fn(vr[:, hist:hist + N], vi[:, hist:hist + N],
                                vr[:, :hist], vi[:, :hist])
    torch.testing.assert_close(p_fd.double(), fd, rtol=0,
                               atol=1e-5 * float(fd.abs().max()))
    scale = float(g_re.abs().max())
    torch.testing.assert_close(p_re[:, :, 0].T.double(), g_re, rtol=0,
                               atol=1e-5 * scale)
    torch.testing.assert_close(p_im[:, :, 0].T.double(), g_im, rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("first", [True, False])
def test_fx_reference_matches_the_fused_plain_form(first):
    from clenabled_tpu_torch import pipelines

    pr, pi, fr, fi = _frames(5)
    taps = _taps()
    h = ref_fx.tail_len(4, M, taps.size)
    fn, (_, _, tail, _) = pipelines.make_fx_pipeline_fused(
        pipelines.FxPipelineConfig(A, M, N), device="cpu")
    tr = torch.zeros_like(tail) if first else pr[:, N - h:]
    ti = torch.zeros_like(tail) if first else pi[:, N - h:]
    p_fd, p_re, p_im, n_tr, n_ti = fn(fr, fi, tr, ti)
    fd, g_re, g_im = ref_fx.fx_step(fr, fi, None if first else pr,
                                    None if first else pi, taps, h, FD, XE)
    fd_scale = float(fd.abs().max())
    assert float((p_fd.double() - fd).abs().max()) <= 1e-5 * fd_scale
    assert float((p_re[:, :, 0].T.double() - g_re).abs().max()) <= \
        1e-5 * float(g_re.abs().max())
    assert torch.equal(n_tr, fr[:, N - h:])
    assert torch.equal(n_ti, fi[:, N - h:])


@pytest.mark.parametrize("data_type", [5, 6])
def test_xengine_reference_matches_the_flowgraph(data_type):
    """Bit for bit, as the integer sums are exact on both sides."""
    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.streaming import Flowgraph

    s, p, f, t = 4, 2, 8, 64
    xe = blocks.XEngine(data_type=data_type, polarization=p, num_inputs=s,
                        num_channels=f, integration=t, planar=True)
    g = Flowgraph()
    for i in range(s):
        g.external_input(xe, i)
    r = g.compile(xe.quantum, device="cpu")
    got = []
    r.on_message("xengine.xcorr", got.append)
    gen = torch.Generator().manual_seed(data_type)
    raw = torch.randint(-128, 128, (s, xe.quantum), generator=gen,
                        dtype=torch.int8)
    if data_type == 6:
        raw = raw.view(torch.uint8)
    r.step(*raw)
    want_re, want_im = ref_xe.product(raw, data_type, t, f, p, block=3)
    assert torch.equal(got[0]["matrix"].re, want_re)
    assert torch.equal(got[0]["matrix"].im, want_im)


def test_xengine_reference_triangular_order():
    st = ref_xe.baselines(4)
    assert st.tolist() == [[0, 0], [1, 0], [1, 1], [2, 0], [2, 1], [2, 2],
                           [3, 0], [3, 1], [3, 2], [3, 3]]


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -10,
                      3.0e-5, -7.25e8])
    y = round_tf32(x)
    assert torch.equal(y.view(torch.int32) & 0x1FFF,
                       torch.zeros(6, dtype=torch.int32))
    # ties to even, one unit of the 10-bit mantissa is 2^-10 at 1.0
    assert y[:4].tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -10]
    assert float(((y - x).abs() / x.abs()).max()) <= 2 ** -11
