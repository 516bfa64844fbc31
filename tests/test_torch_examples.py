"""The port's example scripts (``clenabled_tpu_torch/examples/``) against
the JAX package's (``examples/*.py``) on the CPU.

Each JAX script is loaded from its file and run through its ``main()``
with ``sys.argv`` set; the port's ``main([..., "--cpu"])`` runs beside it
on the same seeded inputs.  Their printed lines must agree line by line,
rate lines left out: names and integers equal, floats within 1e-3
relative.  The arrays behind the lines are held too: the X-Engine
scripts' written files (the int8 engine's bit for bit, the complex one
within 1e-4 × max|JAX|), and the other scripts' outputs against the JAX
package's blocks and pipelines run with the script's parameters on the
port's inputs, within 1e-4 × max|JAX|.  Without ``--cpu`` and without a
card every script exits non-zero.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
import tempfile

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu import native as j_native
    from clenabled_tpu import pipelines as j_pipelines
    from clenabled_tpu.dsp import planar as j_planar
    from clenabled_tpu.dsp import xcorr as j_xcorr
    from clenabled_tpu.streaming import Flowgraph as JFlowgraph
except ImportError:  # a card machine without JAX runs the card tests only
    jnp = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4          # × max|JAX|, arrays
LINE_REL = 1e-3     # relative, printed floats
NAMES = ("fft_xcorr", "fm_receiver", "streaming_ingest", "flagship",
         "xcorr_max_rate", "xcorr_test", "xengine_demo",
         "xengine_synchronized")
JAX_FILES = {"flagship": "tpu_flagship"}
_NUM = re.compile(r"(-?\d+(?:\.\d+)?(?:e[-+]?\d+)?)")


@pytest.fixture
def ref():
    if jnp is None:
        pytest.skip("needs JAX, the reference")


def _port(name):
    return importlib.import_module(f"clenabled_tpu_torch.examples.{name}")


def run_jax(name, argv, monkeypatch, capsys) -> list[str]:
    """The JAX script's printed lines, run from its file."""
    fname = JAX_FILES.get(name, name)
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{fname}", os.path.join(REPO, "examples", f"{fname}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{fname}.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def run_port(name, argv, capsys) -> tuple[dict, list[str]]:
    capsys.readouterr()
    rec = _port(name).main([*argv, "--cpu"])
    assert rec["device"] == "cpu"
    return rec, capsys.readouterr().out.splitlines()


def same_lines(got: list[str], want: list[str]) -> None:
    """Line by line, rate lines left out: text and integers equal, floats
    within LINE_REL relative."""
    got = [ln for ln in got if "MSPS" not in ln]
    want = [ln for ln in want if "MSPS" not in ln]
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        gp, wp = _NUM.split(g), _NUM.split(w)
        assert len(gp) == len(wp), (g, w)
        for k, (a, b) in enumerate(zip(gp, wp)):
            if k % 2 == 0:
                assert a == b, (g, w)
            elif "." in b or "e" in b:
                assert abs(float(a) - float(b)) <= LINE_REL * abs(float(b)), \
                    (g, w)
            else:
                assert int(a) == int(b), (g, w)


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_same_lines_reads_numbers():
    same_lines(["a 1.0000 b -37 ant2–ant0", "x 5.0 MSPS"],
               ["a 1.0005 b -37 ant2–ant0"])
    for got in ("a 1.01 b -37 ant2–ant0", "a 1.0 b -36 ant2–ant0",
                "a 1.0 b -37 ant1–ant0"):
        with pytest.raises(AssertionError):
            same_lines([got], ["a 1.0 b -37 ant2–ant0"])


def test_fft_xcorr_matches_jax(ref, monkeypatch, capsys):
    want_lines = run_jax("fft_xcorr", [], monkeypatch, capsys)
    rec, lines = run_port("fft_xcorr", [], capsys)
    same_lines(lines, want_lines)
    assert (rec["peak"], rec["delay"]) == (999, 25)
    fft = j_blocks.Fft(2048, num_streams=2)
    xc = j_blocks.XCorrelateFFTVCF(2048, num_inputs=2)
    g = JFlowgraph()
    g.external_input(fft, 0)
    g.external_input(fft, 1)
    g.connect(fft, xc, src_port=0, dst_port=0)
    g.connect(fft, xc, src_port=1, dst_port=1)
    tap = g.tap(xc, name="corr_mag")
    want = np.asarray(g.compile(frame_size=2048).step(*rec["inputs"])[tap])
    close(rec["corr"], want)


def test_fm_receiver_matches_jax(ref, monkeypatch, capsys):
    want_lines = run_jax("fm_receiver", [], monkeypatch, capsys)
    rec, lines = run_port("fm_receiver", [], capsys)
    same_lines(lines, want_lines)
    fs, frame = 1e6, rec["frame"]
    lpf = j_blocks.LowPassFilter(1, 1.0, fs, 150e3, 50e3, use_time=True)
    qd = j_blocks.QuadratureDemod(fs / (2 * np.pi * 75e3))
    g = JFlowgraph()
    g.external_input(lpf)
    g.connect(lpf, qd)
    tap = g.tap(qd, name="audio")
    r = g.compile(frame_size=frame)
    assert rec["group_delay"] == (len(lpf.taps()) - 1) // 2
    for i in range(3):
        want = np.asarray(r.step(rec["iq"][i * frame:(i + 1) * frame])[tap])
        close(rec["audio"][i], want)


def test_xcorr_test_matches_jax(ref, monkeypatch, capsys):
    want_lines = run_jax("xcorr_test", [], monkeypatch, capsys)
    rec, lines = run_port("xcorr_test", [], capsys)
    same_lines(lines, want_lines)
    assert rec["lags"] == [-37] * 4
    fs, frame = 2.4e6, 8192
    lpfs = [j_blocks.LowPassFilter(1, 1.0, fs, 300e3, 100e3, use_time=True)
            for _ in range(2)]
    xc = j_blocks.XCorrelate(2, signal_length=frame, max_search_index=512)
    g = JFlowgraph()
    for k, lpf in enumerate(lpfs):
        g.external_input(lpf)
        g.connect(lpf, xc, dst_port=k)
    r = g.compile(frame_size=frame)
    msgs = []
    r.on_message("xcorr.corr", msgs.append)
    for feeds in rec["feeds"]:
        r.step(*feeds)
    close(rec["corr"], [float(np.asarray(m["corr"])[0]) for m in msgs])
    assert rec["lags"] == [int(np.asarray(m["corrective_lags"])[0])
                           for m in msgs]
    close(rec["corrvect"], np.stack([np.asarray(m["corrvect"])[0]
                                     for m in msgs]))


def test_xcorr_max_rate_matches_jax(ref, monkeypatch, capsys):
    argv = ["--frames", "2", "--signal_length", "4096", "--max_search", "64"]
    want_lines = run_jax("xcorr_max_rate", argv, monkeypatch, capsys)
    rec, lines = run_port("xcorr_max_rate", argv, capsys)
    assert len(lines) == len(want_lines) == 1
    assert "2 frames of 4096 samples, ±64 lags; cpu" in lines[0]
    same_lines(lines, want_lines)
    assert rec["msps"] > 0
    want = j_xcorr.td_xcorr(jnp.asarray(rec["signals"]), 64)
    close(rec["corr"], want.corr)
    np.testing.assert_array_equal(rec["lag"], np.asarray(want.lag))
    close(rec["corr_vectors"], want.corr_vectors)


def _jax_ingest_chain(frame):
    lpf = j_blocks.LowPassFilter(1, 1.0, 10e6, 1.5e6, 500e3, use_time=True,
                                 planar=True)
    qd = j_blocks.QuadratureDemod(1.0, planar=True)
    g = JFlowgraph()
    g.external_input(lpf)
    g.connect(lpf, qd)
    tap = g.tap(qd, name="audio")
    r = g.compile(frame_size=frame)
    return lambda raw: np.asarray(
        r.step(j_planar.PC(*j_native.unpack_4bit_planar(raw)))[tap])


def test_streaming_ingest_matches_jax(ref, monkeypatch, capsys):
    """The scripts side by side (their only line is the rate), the port's
    last frame held to JAX's chain over its last two frames, and the chain
    itself on two seeded frames of 4096 bytes."""
    argv = ["--seconds", "0.5", "--frame", "4096"]
    want_lines = run_jax("streaming_ingest", argv, monkeypatch, capsys)
    rec, lines = run_port("streaming_ingest", argv, capsys)
    assert len(lines) == len(want_lines) == 1
    same_lines(lines, want_lines)
    assert rec["frames"] >= 2 and rec["msps"] > 0
    jax_chain = _jax_ingest_chain(4096)
    jax_chain(rec["raws"][0])
    close(rec["audio"], jax_chain(rec["raws"][1]))

    mod = _port("streaming_ingest")
    r, tap, lpf = mod.build_chain(4096, torch.device("cpu"))
    assert len(lpf.taps()) == 49
    jax_chain = _jax_ingest_chain(4096)
    rng = np.random.default_rng(7)
    for _ in range(2):
        raw = rng.integers(0, 256, 4096, dtype=np.uint8)
        close(mod.step(r, raw)[tap].numpy(), jax_chain(raw))


def test_flagship_cpu_matches_jax(ref, monkeypatch, capsys):
    want_lines = run_jax("flagship", [], monkeypatch, capsys)
    rec, lines = run_port("flagship", [], capsys)
    assert len(lines) == len(want_lines) == 2
    same_lines(lines, want_lines)
    assert rec["baseline"] == (2, 0)
    n = rec["samples_per_step"]
    assert n == 1 << 17 and rec["timed_steps"] == 3
    cfg = j_pipelines.FxPipelineConfig(num_antennas=4, num_channels=16,
                                       samples_per_step=n)
    fn, (_, _, hr, hi) = j_pipelines.make_fx_pipeline_planar(
        cfg, use_pallas=False)
    xr, xi = (jnp.asarray(x) for x in rec["inputs"])
    for _ in range(3):
        fd, xre, xim, hr, hi = fn(xr, xi, hr, hi)
    close(rec["fd"], fd)
    close(rec["xre"], xre)
    close(rec["xim"], xim)
    for got, want in zip(rec["tails"], (hr, hi)):
        np.testing.assert_array_equal(got, np.asarray(want))


def _outdirs(monkeypatch, tmp_path):
    """tempfile.mkdtemp handing out tmp_path/out0, out1, ... in turn."""
    made = []

    def mkdtemp(prefix="", **_):
        path = tmp_path / f"out{len(made)}"
        path.mkdir()
        made.append(str(path))
        return str(path)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    return made


def _written(outdir):
    files = sorted(os.listdir(outdir))
    bins = {f: np.fromfile(os.path.join(outdir, f), np.float32)
            for f in files if f.endswith(".bin")}
    sidecars = {}
    for f in files:
        if f.endswith(".json"):
            with open(os.path.join(outdir, f)) as fh:
                sidecars[f] = json.load(fh)
    return files, bins, sidecars


@pytest.mark.parametrize("name", ["xengine_demo", "xengine_synchronized"])
def test_xengine_scripts_write_jax_files(ref, name, monkeypatch, capsys,
                                         tmp_path):
    made = _outdirs(monkeypatch, tmp_path)
    want_lines = run_jax(name, [], monkeypatch, capsys)
    rec, lines = run_port(name, [], capsys)
    same_lines(lines, want_lines)
    assert made == [os.path.dirname(made[0]) + "/out0",
                    rec["outdir"]]
    wfiles, wbins, wside = _written(made[0])
    gfiles, gbins, gside = _written(made[1])
    assert gfiles == wfiles == rec["files"]
    assert gside == wside
    mats = rec["matrices"]
    assert np.array_equal(np.concatenate(list(gbins.values())),
                          mats.view(np.float32).ravel())
    for f in wbins:
        if name == "xengine_synchronized":       # int8 sums: exact
            np.testing.assert_array_equal(gbins[f], wbins[f])
        else:
            close(gbins[f], wbins[f])
    if name == "xengine_synchronized":
        assert rec["events"] == [("sync", 4), ("resync", 13, 16)]
        assert rec["baselines"] == [(2, 0)] * 4
        # windows 4-12 and 16-23: four integrations of 4, one left over
        assert len(rec["windows"]) == 9 + 8
    else:
        assert rec["baselines"] == [(2, 0)] * 3


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_a_card_without_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _port(name).main([])
    assert e.value.code not in (0, None)
    assert "--cpu" in str(e.value.code)
