"""What a run loads: never JAX nor the JAX package (compared by whole
top-level names, since ``clenabled_tpu_torch`` begins with
``clenabled_tpu``), and a reference that loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest

from benchmark import harness
from benchmark.tests.helpers import tiny_run

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         capture_output=True, text=True, check=True,
                         cwd=harness.REPO, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    mods = _top_level("import benchmark.run, benchmark.reference, "
                      "benchmark.drivers.fx, benchmark.drivers.xengine, "
                      "benchmark.calibrate, benchmark.trace, "
                      "clenabled_tpu_torch.pipelines, "
                      "clenabled_tpu_torch.blocks\n"
                      "from benchmark import harness\n"
                      "for m in harness.load_spec()['per_layer']:\n"
                      "    harness.reader(m['name'])")
    assert "clenabled_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _top_level("import benchmark.reference.fx, "
                      "benchmark.reference.xengine, "
                      "benchmark.reference.firdes, benchmark.roofline")
    assert not mods & (set(harness.FORBIDDEN) | {"clenabled_tpu_torch"})


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    assert harness.forbidden_loaded() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "clenabled_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxish", object())
    assert not {"clenabled_tpu_torch_x", "jaxish"} & set(
        harness.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "clenabled_tpu.dsp", object())
    assert "clenabled_tpu" in harness.forbidden_loaded()


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    try:
        tiny_run("fx4x16.f32.resident")
    except SystemExit as e:
        assert "jax" in str(e)
    else:
        raise AssertionError("a run with jax loaded went on")


def _plant_jax():
    sys.modules["jax"] = types.ModuleType("jax")


@pytest.mark.parametrize("where", ["judge", "reader"])
def test_jax_loaded_after_the_window_gives_no_result(monkeypatch, where):
    """JAX loaded by the comparison or by a per-layer reader, after the
    window has closed, still stops the run before a result."""
    from benchmark.drivers import fx

    if where == "judge":
        judge = fx.Driver.judge

        def loading(self, answers):
            _plant_jax()
            return judge(self, answers)

        monkeypatch.setattr(fx.Driver, "judge", loading)
    else:
        read = harness.reader

        def loading_reader(name, root=harness.REPO):
            def planted(trace):
                _plant_jax()
                return read(name, root)(trace)
            return planted

        monkeypatch.setattr(harness, "reader", loading_reader)
    had = "jax" in sys.modules
    try:
        with pytest.raises(SystemExit, match="jax"):
            tiny_run("fx4x16.f32.resident", trace=where == "reader",
                     seconds=1.0)
    finally:
        if not had:
            sys.modules.pop("jax", None)


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fx4x16.f32.resident", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=harness.REPO, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
