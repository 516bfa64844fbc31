"""A run whose timed path is broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at a tiny size, with one fault planted in the program: a step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest, an answer altered where it is produced.  (The cells
run on one card, so no exchange between cards can be left out.)"""

from __future__ import annotations

import pytest
import torch

from benchmark.tests.helpers import tiny_run

FX = "fx4x16.f32.resident"
XE = ["xe64x256.ichar.resident", "xe64x256.packed4.resident"]


@pytest.mark.parametrize("workload", [FX] + XE)
def test_sound_run_is_correct(workload):
    out = tiny_run(workload)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_fx_state_unchanged(monkeypatch):
    from clenabled_tpu_torch import pipelines

    forward = pipelines.FxPipelineFused.forward

    def stale(self, xr, xi, tr, ti):
        fd, xre, xim, _, _ = forward(self, xr, xi, tr, ti)
        return fd, xre, xim, tr, ti

    monkeypatch.setattr(pipelines.FxPipelineFused, "forward", stale)
    out = tiny_run(FX)
    assert not out["correct"]
    assert out["checks"]["tail_mismatch"]["value"] > 0


def test_fx_half_the_batch(monkeypatch):
    from clenabled_tpu_torch.dsp import hopper_kernels

    fused = hopper_kernels.fx_correlate_streams_v2

    def half(xr, xi, tr, ti, taps, a, m, **kw):
        n = xr.shape[-1] // 2
        fd, gram = fused(xr[:, :n].contiguous(), xi[:, :n].contiguous(),
                         tr, ti, taps, a, m, **kw)
        return fd * 2, gram * 2

    monkeypatch.setattr(hopper_kernels, "fx_correlate_streams_v2", half)
    out = tiny_run(FX)
    assert not out["correct"]


def test_fx_answer_altered(monkeypatch):
    from clenabled_tpu_torch.dsp import hopper_kernels

    fused = hopper_kernels.fx_correlate_streams_v2

    def altered(*args, **kw):
        fd, gram = fused(*args, **kw)
        gram = gram.clone()
        gram[1, 3] += 1e-3 * float(gram.abs().max())
        return fd, gram

    monkeypatch.setattr(hopper_kernels, "fx_correlate_streams_v2", altered)
    out = tiny_run(FX)
    assert not out["correct"]
    gram = out["checks"]["gram_err"]
    assert gram["value"] > gram["limit"]


@pytest.mark.parametrize("workload", XE)
def test_xengine_half_the_batch(monkeypatch, workload):
    from clenabled_tpu_torch.dsp import xengine

    stacked = xengine.xengine_correlate_stacked

    def half(zr, zi, *args, **kw):
        t = zr.shape[1] // 2
        g = stacked(zr[:, :t], zi[:, :t], *args, **kw)
        return type(g)(g.re * 2, g.im * 2)

    monkeypatch.setattr(xengine, "xengine_correlate_stacked", half)
    out = tiny_run(workload)
    assert not out["correct"]


@pytest.mark.parametrize("workload", XE)
def test_xengine_answer_altered(monkeypatch, workload):
    from clenabled_tpu_torch.dsp import xengine

    stacked = xengine.xengine_correlate_stacked

    def altered(*args, **kw):
        g = stacked(*args, **kw)
        re = g.re.clone()
        ulp = torch.finfo(torch.float32).eps
        re[2, 5, 1] += ulp * max(1.0, float(re[2, 5, 1].abs()))
        return type(g)(re, g.im)

    monkeypatch.setattr(xengine, "xengine_correlate_stacked", altered)
    out = tiny_run(workload)
    assert not out["correct"]
    assert out["checks"]["mismatched"]["value"] > 0
