"""The harness finds every part of a cell by name, and a new cell or
per-layer metric is new files and entries only."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark import harness
from benchmark.tests.helpers import tiny_cell, tiny_run

SPEC = harness.load_spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves(workload):
    cell = harness.find_cell(SPEC, workload)
    assert harness.driver_class(cell.kind).__name__ == "Driver"
    assert set(cell.limits)
    assert cell.traffic["kind"] == cell.kind
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in names


def test_every_config_and_metric_has_its_file():
    for c in SPEC["configs"]:
        cfg = json.loads((harness.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for m in SPEC["per_layer"]:
        assert (harness.REPO / "benchmark" / "metrics"
                / f"{m['name']}.py").is_file()


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    """A copy of the benchmark gains a cell of an existing kind (a traffic
    file, a limits file, a workloads entry) and a per-layer metric (a
    reader file, a per_layer entry); the old files stay byte for byte and
    the new cell runs, reporting the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    data = root / "benchmark"
    traffic = json.loads((data / "traffic" / "f32.resident.json").read_text())
    # the profiler starts early in the 1 s window, so that a slow step on
    # a busy host cannot close the window before it
    traffic.update(ring=2, in_flight=2, trace_after=0.1)
    (data / "traffic" / "f32.ring2.json").write_text(json.dumps(traffic))
    (data / "limits" / "fx4x16.f32.ring2.json").write_bytes(
        (data / "limits" / "fx4x16.f32.resident.json").read_bytes())
    (data / "metrics" / "steps_traced.fx.py").write_text(
        "def read(trace):\n    return float(trace.steps) or None\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "fx4x16.f32.ring2", "config": "fx4x16",
                              "traffic": "f32.ring2", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "fx4x16.f32.resident" in m["workloads"]:
            m["workloads"].append("fx4x16.f32.ring2")
    spec["per_layer"].append({"name": "steps_traced.fx", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "step", "moves": "fx_msps",
                              "workloads": ["fx4x16.f32.ring2"]})
    out = tiny_run("fx4x16.f32.ring2", trace=True, seconds=1.0, spec=spec,
                   root=root)
    assert out["correct"]
    assert out["metrics"]["steps_traced.fx"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_benchmark_json_keys():
    """The contract's keys, checked entry by entry, so that a later cell,
    configuration or metric needs no edit here."""
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["layer"]
        for w in m.get("workloads", []):
            assert harness._applies(e2e[m["moves"]], w)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_has_tiny_sizes(workload):
    """Each cell's configuration gives the sizes of its CPU form."""
    cell = tiny_cell(workload)
    assert cell.config["tiny"]
    assert all(cell.config[k] == v for k, v in cell.config["tiny"].items())


def test_a_configuration_without_tiny_sizes_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / "benchmark" / "configs" / "fx4x16.json"
    cfg = json.loads(path.read_text())
    del cfg["tiny"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(KeyError, match="tiny"):
        tiny_cell("fx4x16.f32.resident", root=root)
