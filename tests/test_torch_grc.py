"""The port's GRC descriptors (``clenabled_tpu_torch/grc/``) and example
flowgraphs (``clenabled_tpu_torch/examples/grc/``): the generators
reproduce the committed files byte for byte; every flowgraph parses and
connects; every ``clenabled_tpu_torch_*`` block instantiates a real port
block through the port's ``gr_compat.wrap`` (under the fake GR of
``tests/test_gr_compat.py``) with the flowgraph's own values, each of
those values declared in the block's descriptor; the FFT round trip's
rescale follows ``fft_size``; and the descriptor set has the JAX set's
block ids, parameters and ports."""

from __future__ import annotations

import glob
import os
import re
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from test_gr_compat import _FakeBasicBlock

from clenabled_tpu_torch.tools.gen_grc_yaml import PLANAR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "clenabled_tpu_torch")
YML_DIR = os.path.join(PORT, "grc")
GRC_DIR = os.path.join(PORT, "examples", "grc")
JAX_YML_DIR = os.path.join(REPO, "grc")
GRC_FILES = sorted(glob.glob(os.path.join(GRC_DIR, "*.grc")))
PREFIX = "clenabled_tpu_torch_"
# fields GRC adds to every block, not the block's own parameters
BOILERPLATE = {"comment", "affinity", "alias", "maxoutbuf", "minoutbuf"}


@pytest.fixture()
def fake_gr(monkeypatch):
    gr_mod = types.ModuleType("gnuradio.gr")
    gr_mod.basic_block = _FakeBasicBlock
    gnuradio = types.ModuleType("gnuradio")
    gnuradio.gr = gr_mod
    pmt_mod = types.ModuleType("pmt")
    pmt_mod.intern = lambda s: ("sym", s)
    pmt_mod.to_pmt = lambda x: ("pmt", x)
    monkeypatch.setitem(sys.modules, "gnuradio", gnuradio)
    monkeypatch.setitem(sys.modules, "gnuradio.gr", gr_mod)
    monkeypatch.setitem(sys.modules, "pmt", pmt_mod)
    # the caller asks for the CPU: the descriptors' wrap() takes the default
    from clenabled_tpu_torch import gr_compat

    monkeypatch.setattr(gr_compat, "default_device",
                        lambda: torch.device("cpu"))
    return gr_mod


def _load(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def _yml(block_id: str) -> dict:
    path = os.path.join(YML_DIR, f"{block_id}.block.yml")
    assert os.path.exists(path), f"no descriptor {path} for {block_id}"
    return _load(path)


def _eval_variables(doc) -> dict:
    """The flowgraph's ``variable`` blocks evaluated into a namespace
    (variables may reference each other)."""
    ns = {"np": np}
    pending = {b["name"]: b["parameters"]["value"]
               for b in doc["blocks"] if b["id"] == "variable"}
    for _ in range(len(pending) + 1):
        for name, expr in list(pending.items()):
            try:
                ns[name] = eval(expr, dict(ns))  # noqa: S307 - test corpus
                del pending[name]
            except Exception:
                continue
    assert not pending, f"unresolvable variables: {pending}"
    return ns


def _own_params(block: dict) -> dict:
    return {k: v for k, v in block["parameters"].items()
            if k not in BOILERPLATE}


def _render_make(yml: dict, grc_params: dict, ns: dict):
    """The make template with ${param} replaced by the flowgraph's values
    (the descriptor's defaults for the rest), evaluated.  A flowgraph
    value for a parameter the descriptor does not declare fails."""
    defaults = {p["id"]: str(p["default"]) for p in yml.get("parameters", [])}
    undeclared = set(grc_params) - set(defaults)
    assert not undeclared, f"{yml['id']}: undeclared parameters {undeclared}"
    values = dict(defaults)
    values.update(grc_params)

    def sub(m):
        pid = m.group(1)
        assert pid in values, f"{yml['id']}: template uses undeclared {pid!r}"
        return str(values[pid])

    make = re.sub(r"\$\{\s*([a-zA-Z_0-9]+)\s*\}", sub, yml["templates"]["make"])
    import clenabled_tpu_torch.blocks
    import clenabled_tpu_torch.gr_compat

    glb = dict(ns)
    glb["clenabled_tpu_torch"] = clenabled_tpu_torch
    return eval(make, glb)  # noqa: S307 - rendered descriptor template


def _same_tree(a: str, b: str, pattern: str):
    names_a = sorted(os.path.basename(p) for p in glob.glob(os.path.join(a, pattern)))
    names_b = sorted(os.path.basename(p) for p in glob.glob(os.path.join(b, pattern)))
    assert names_a == names_b
    for name in names_a:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), f"{name} differs"


def test_gen_grc_yaml_reproduces_descriptors(tmp_path):
    from clenabled_tpu_torch.tools import gen_grc_yaml

    paths = gen_grc_yaml.main(["--outdir", str(tmp_path)])
    assert len(paths) == 31
    _same_tree(str(tmp_path), YML_DIR, "*.block.yml")


def test_gen_grc_examples_reproduces_corpus(tmp_path):
    from clenabled_tpu_torch.tools import gen_grc_examples

    paths = gen_grc_examples.main(["--outdir", str(tmp_path)])
    assert len(paths) == 28
    _same_tree(str(tmp_path), GRC_DIR, "*.grc")


def _ports(doc: dict, key: str) -> list:
    return [{k: v for k, v in p.items() if k != "optional"}
            for p in doc.get(key, [])]


def test_descriptor_set_matches_jax():
    """Same block ids (less the prefix), parameters (ids, defaults) and
    stream/message ports as the JAX package's grc/."""
    port = {os.path.basename(p)[len(PREFIX):]: _load(p)
            for p in glob.glob(os.path.join(YML_DIR, "*.block.yml"))}
    jax = {os.path.basename(p)[len("clenabled_tpu_"):]: _load(p)
           for p in glob.glob(os.path.join(JAX_YML_DIR, "*.block.yml"))}
    assert set(port) == set(jax) and len(port) == 31
    for name, doc in port.items():
        want = jax[name]
        assert [(p["id"], p["default"]) for p in doc.get("parameters", [])] \
            == [(p["id"], p["default"]) for p in want.get("parameters", [])], \
            name
        for key in ("inputs", "outputs"):
            assert _ports(doc, key) == _ports(want, key), (name, key)
        assert doc["id"] == PREFIX + name[:-len(".block.yml")]
        assert "clenabled_tpu_torch.gr_compat.wrap(clenabled_tpu_torch." \
            "blocks." in doc["templates"]["make"]
        assert "clenabled_tpu." not in doc["templates"]["make"]


@pytest.mark.parametrize("path", GRC_FILES,
                         ids=[os.path.basename(p) for p in GRC_FILES])
def test_flowgraph_parses_and_connects(path):
    doc = _load(path)
    assert doc["metadata"]["file_format"] == 1
    assert doc["options"]["parameters"]["title"]
    names = {b["name"] for b in doc["blocks"]}
    assert len(names) == len(doc["blocks"]), "duplicate block names"
    assert not any(b["id"].startswith("clenabled_tpu_")
                   and not b["id"].startswith(PREFIX) for b in doc["blocks"])
    for src, sport, dst, dport in doc["connections"]:
        assert src in names and dst in names
        assert re.fullmatch(r"\d+|[a-z_]+", str(sport))
        assert re.fullmatch(r"\d+|[a-z_]+", str(dport))


@pytest.mark.parametrize("path", GRC_FILES,
                         ids=[os.path.basename(p) for p in GRC_FILES])
def test_port_blocks_instantiate_from_descriptors(path, fake_gr,
                                                  monkeypatch):
    """Each clenabled_tpu_torch_* block's make template, rendered with the
    flowgraph's values, instantiates a wrapped port block whose signatures
    and message ports fit the flowgraph's connections."""
    monkeypatch.chdir(REPO)   # clKernel1To1 filenames are repo-relative
    doc = _load(path)
    ns = _eval_variables(doc)
    made = {}
    for b in doc["blocks"]:
        if not b["id"].startswith(PREFIX):
            continue
        yml = _yml(b["id"])
        g = _render_make(yml, _own_params(b), ns)
        assert hasattr(g, "general_work"), b["id"]
        assert type(g._blk).__module__.startswith("clenabled_tpu_torch.")
        if b["id"][len(PREFIX):] in PLANAR:      # the kernels' form
            assert g._blk.planar is True, b["id"]
        made[b["name"]] = g
    assert made, "flowgraph without a port block"
    for src, sport, dst, dport in doc["connections"]:
        if src in made and str(sport).isdigit():
            assert int(sport) < len(made[src]._out_sig)
        if src in made and not str(sport).isdigit():
            assert ("sym", sport) in made[src].registered_ports
        if dst in made and str(dport).isdigit():
            assert int(dport) < len(made[dst]._in_sig)


def test_planar_descriptors_match_numpy(fake_gr):
    """The LowPass (time domain), QuadratureDemod and FFT descriptors,
    which build the blocks' planar forms, turn complex64 offers into the
    numpy results through their make lines."""
    from clenabled_tpu_torch.dsp import firdes

    rng = np.random.default_rng(4)
    n = 4096
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)

    def run(block_id, params, out_dtype, ns=None):
        g = _render_make(_yml(PREFIX + block_id), params, ns or {"np": np})
        assert g._blk.planar is True
        out = np.zeros(n, out_dtype)
        m = g.general_work([x], [out])
        g.flush()
        rest = np.zeros(n, out_dtype)
        k = g._emit([rest])
        return np.concatenate([out[:m], rest[:k]])

    lp = run("clLowPassFilter", {"samp_rate": "10e6", "cutoff_freq": "1.5e6",
                                 "transition_width": "500e3",
                                 "use_time": "True"}, np.complex64)
    taps = firdes.low_pass(1.0, 10e6, 1.5e6, 500e3)
    want = np.convolve(x, taps)[:n]
    np.testing.assert_allclose(lp, want, atol=1e-4 * np.abs(want).max())
    qd = run("clQuadratureDemod", {"gain": "1.0"}, np.float32)
    prev = np.concatenate([[0], x[:-1]]).astype(np.complex64)
    want = np.angle(x * np.conj(prev)).astype(np.float32)
    np.testing.assert_allclose(qd[1:], want[1:], atol=1e-4 * np.pi)
    spec = run("clFFT", {"fft_size": "1024"}, np.complex64)
    want = np.fft.fft(x.reshape(-1, 1024), axis=-1).reshape(-1)
    np.testing.assert_allclose(spec, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("fft_size", [2048, 512])
def test_fft_rev_rescale_tracks_fft_size(fake_gr, fft_size):
    """The round trip's rescale is 1/fft_size of the flowgraph's own
    variable (the JAX corpus hard-codes 1/2048)."""
    doc = _load(os.path.join(GRC_DIR, "test_fft_rev.grc"))
    for b in doc["blocks"]:
        if b["name"] == "fft_size":
            b["parameters"]["value"] = str(fft_size)
    ns = _eval_variables(doc)
    (resc,) = [b for b in doc["blocks"] if b["name"] == "rescale"]
    g = _render_make(_yml(resc["id"]), _own_params(resc), ns)
    assert g._blk.k() == pytest.approx(1.0 / fft_size)
    x = np.full(8, 3.0 + 1j, np.complex64)
    out = np.zeros(8, np.complex64)
    assert g.general_work([x], [out]) == 8
    np.testing.assert_allclose(out, x / fft_size, rtol=1e-6)
