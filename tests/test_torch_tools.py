"""The port's CLI tools, each through its ``main([...])`` on the CPU at
small sizes: ``clview``, ``test_clenabled`` (complex64 and planar),
``test_clkernel`` (all four example kernels, outputs held to the JAX
package's example kernels on the same inputs), ``test_clfilter``
(complex64 default and planar per call), ``profile`` (the trace file),
``test_ingest`` (f32, int8, and packed 4-bit with the rolling writer),
``test_scaling`` (1 and 2 gloo ranks), ``test_multihost`` (two launcher
processes of one rank, held to the unsharded step) and leg 4 of
``entry.dryrun_multichip``."""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_clview_cpu():
    from clenabled_tpu_torch.tools import clview

    rec = clview.main(["--cpu"])
    assert rec["complex"] is True
    (cpu,) = rec["devices"]
    assert cpu["platform"] == "cpu" and cpu["cores"] >= 1


@pytest.mark.parametrize("planar", [False, True])
def test_clenabled_rows(planar, capsys):
    from clenabled_tpu_torch.tools import test_clenabled

    rows = test_clenabled.main(["4096", "--iterations", "2", "--cpu"]
                               + (["--planar"] if planar else []))
    names = [r["name"] for r in rows]
    assert names[0] == "empty w/copy (baseline)"
    kernel_rows = {n for n, r in zip(names, rows) if r["has_kernel"]}
    assert {"quadrature demod", "fft 2048 fwd+win+shift"} <= kernel_rows
    assert any(n.startswith("FIR filter") for n in kernel_rows)
    assert any(n.startswith("FFT filter") for n in kernel_rows)
    # on the CPU every wrapper runs its plain form: no launch counted
    assert all(r["launches"] == {} for r in rows)
    assert all(r["msps"] > 0 and np.isfinite(r["msps"]) for r in rows)
    if not planar:
        assert {"FIR scc (49 taps, short in)", "signal source"} <= set(names)
    assert "0 (plain form)" in capsys.readouterr().out


def _jax_kernel(name: str, fn: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, fn)


@pytest.mark.parametrize("name,fn,flags", [
    ("kernel1to1_multiply_const_complex", "multiply_const_complex",
     ["--1to1", "--complex"]),
    ("kernel1to1_multiply_const_float", "multiply_float_const",
     ["--1to1", "--float"]),
    ("kernel1to1_sincos", "sincos", ["--1to1", "--complex"]),
    ("kernel2to1_multiply_complex", "multiply_complex",
     ["--2to1", "--complex"]),
])
def test_clkernel_matches_jax_examples(name, fn, flags):
    from clenabled_tpu_torch.tools import test_clkernel

    path = os.path.join(REPO, "clenabled_tpu_torch", "examples", f"{name}.py")
    rec = test_clkernel.main([f"--kernelfile={path}", f"--fnname={fn}",
                              "4096", "--iterations", "2", "--cpu", *flags])
    want = np.asarray(_jax_kernel(name, fn)(*rec["inputs"]))
    assert rec["output"].dtype == want.dtype
    np.testing.assert_allclose(rec["output"], want, rtol=1e-6, atol=1e-6)
    assert rec["msps"] > 0


@pytest.mark.parametrize("flags", [[], ["--planar", "--percall"]])
def test_clfilter_modes(flags):
    from clenabled_tpu_torch.tools import test_clfilter

    rows = test_clfilter.main(["--ntaps", "49", "--blocksize", "4096",
                               "--iterations", "2", "--cpu", *flags])
    assert [r["name"].split(" (")[0] for r in rows] == [
        "time-domain FIR", "freq-domain OFS"]
    assert all(r["msps"] > 0 for r in rows)


def test_profile_writes_trace(tmp_path):
    from clenabled_tpu_torch.tools import profile

    rec = profile.main(["--cpu", "--steps", "2", "--samples-per-step",
                        "8192", "--outdir", str(tmp_path)])
    assert os.path.getsize(rec["trace"]) > 0
    with open(rec["trace"]) as f:
        assert json.load(f)["traceEvents"]
    assert 1 <= len(rec["top"]) <= 5


def test_ingest_f32_and_int8():
    from clenabled_tpu_torch.tools import test_ingest

    rec = test_ingest.main(["--cpu", "--steps", "3", "--samples-per-step",
                            "13"])
    assert set(rec) == {"f32", "int8"}
    for r in rec.values():
        assert r["steps"] == 3 and r["samples"] == 8192
        assert r["link_gbs"] > 0 and r["device_msps"] > 0 \
            and r["e2e_msps"] > 0
    assert rec["int8"]["frame_bytes"] * 4 == rec["f32"]["frame_bytes"]


def test_ingest_packed4_with_writer(tmp_path):
    """Staggered starts align at timestamp 4 (block multiple 2); antenna
    2's dropped frame forces one resync; the writer leaves a file and a
    sidecar."""
    from clenabled_tpu_torch.tools import test_ingest

    rec = test_ingest.main(["--cpu", "--packed4", "--steps", "6",
                            "--samples-per-step", "13", "--outdir",
                            str(tmp_path)])["packed4"]
    assert rec["steps"] == 6
    assert rec["events"] == [("sync", 4), ("resync", 5, 6)]
    assert rec["files"] >= 1 and rec["writer_bytes"] > 0
    bins = sorted(p for p in os.listdir(tmp_path) if p.endswith(".bin"))
    metas = sorted(p for p in os.listdir(tmp_path) if p.endswith(".json"))
    assert len(bins) == len(metas) == rec["files"]
    assert sum(os.path.getsize(tmp_path / b) for b in bins) \
        == rec["writer_bytes"]
    assert json.load(open(tmp_path / metas[0]))["antennas"] == 4


def test_ingest_packed4_no_disk(tmp_path):
    from clenabled_tpu_torch.tools import test_ingest

    rec = test_ingest.main(["--cpu", "--packed4", "--no-disk", "--steps",
                            "4", "--samples-per-step", "13", "--outdir",
                            str(tmp_path / "unused")])["packed4"]
    assert rec["files"] == 0 and rec["writer_bytes"] == 0
    assert not os.path.exists(tmp_path / "unused")


@pytest.mark.parametrize("leg", ["fx", "xengine"])
def test_scaling_two_ranks(leg):
    """1 and 2 gloo ranks; every rank's check passes inside the run."""
    from clenabled_tpu_torch.tools import test_scaling

    extra = {"fx": [], "xengine": ["--xengine", "--channels", "8",
                                   "--integration", "32"]}[leg]
    rec = test_scaling.main(["--cpu", "--devices", "1", "2",
                             "--samples-per-chip", "8192", "--iterations",
                             "2", *extra])
    assert rec["leg"] == leg
    assert [r["ranks"] for r in rec["rows"]] == [1, 2]
    for r in rec["rows"]:
        assert r["worst_over_tol"] <= 1.0 and r["step_ms"] > 0
        assert len(r["ms_by_rank"]) == r["ranks"]
    assert rec["rows"][0]["efficiency_pct"] == 100.0


def test_multihost_two_launchers():
    """Two launcher processes of one rank each, one world over a TCP
    store: rank 0 within the tolerance of the unsharded step, rank 1's
    outputs equal to rank 0's."""
    from clenabled_tpu_torch.tools import test_multihost

    rec = test_multihost.main(["--procs", "2", "--ranks-per-proc", "1",
                               "--device", "cpu"])
    assert rec["worst_over_tol"] <= 1.0
    assert [r["rank"] for r in rec["results"]] == [0, 1]
    assert all(r["world"] == 2 for r in rec["results"])


def test_dryrun_leg4_runs_the_multihost_tool(monkeypatch):
    """``dryrun_multichip(2, "cpu")``'s leg 4: two launchers of one rank
    each; legs 1-3e (``tests/test_torch_sharding.py``) are stubbed out
    here."""
    from clenabled_tpu_torch import entry
    from clenabled_tpu_torch.sharding import launch

    spawn = launch.spawn

    def legs_1_to_3e_stubbed(fn, n, dev, *args, **kw):
        if fn is entry._dryrun_rank:
            return [{} for _ in range(n)]
        return spawn(fn, n, dev, *args, **kw)

    monkeypatch.setattr(launch, "spawn", legs_1_to_3e_stubbed)
    out = entry.dryrun_multichip(2, "cpu")
    assert [sorted(r) for r in out] == [["4"], ["4"]]
    fd, xmat, hist = out[0]["4"]
    assert fd.shape == (3, 16) and xmat.shape == (16, 10, 1)
    for a, b in zip(out[0]["4"], out[1]["4"]):
        np.testing.assert_array_equal(a, b)
    one = entry.dryrun_multichip(1, "cpu")      # no second host at n = 1
    assert one == [{}]
