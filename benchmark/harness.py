"""Find a cell's parts by name and run it: set-up, window, comparison.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  Its
configuration's file (``configs/<config>.json``) names the driver by its
``kind``; the traffic mix is ``traffic/<mix>.json``; its limits are
``limits/<workload>.json``; each per-layer metric that lists the cell (or
lists no cells) is read by ``metrics/<metric>.py``.  Adding a cell of an
existing kind, or a per-layer metric, adds files and entries and edits
none.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

# the checkout: the parent of this package, where the program lies too
REPO = Path(__file__).resolve().parent.parent
# the reference package and what it runs on, never loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "clenabled_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    root: Path             # the checkout its files were read from
    config: dict
    traffic: dict
    kind: str
    limits: dict
    end_to_end: list       # BENCHMARK.json entries the cell reports
    per_layer: list


def load_spec(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(spec: dict, workload: str, root: Path = REPO) -> Cell:
    """The cell ``workload`` of ``spec``, its files read under the
    checkout ``root``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    data = root / "benchmark"
    traffic = json.loads(
        (data / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((data / "limits" / f"{workload}.json").read_text())
    return Cell(workload, root, config, traffic, config["kind"], limits,
                [m for m in spec["end_to_end"] if _applies(m, workload)],
                [m for m in spec["per_layer"] if _applies(m, workload)])


def driver_class(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}").Driver


def reader(metric: str, root: Path = REPO):
    """``benchmark/metrics/<metric>.py``'s ``read(trace)`` under ``root``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_program_in(root: Path) -> None:
    """Raise unless ``clenabled_tpu_torch`` imports from the checkout
    ``root``: a run measures the program beside its benchmark, never an
    installed copy."""
    import clenabled_tpu_torch

    where = Path(clenabled_tpu_torch.__file__).resolve().parent
    if where.parent != Path(root).resolve():
        raise SystemExit(f"clenabled_tpu_torch imports from {where}, not "
                         f"from the checkout {root}")


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def checks_of(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number against its
    limit; a number without one, or one that is not finite, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, checks


def run(cell: Cell, seed: int, seconds: float, trace: bool, card,
        started: float, control: bool = False) -> dict:
    """One run of ``cell``: its result line as a dict, ``checks`` last.
    ``started`` is the process's start on ``time.perf_counter``'s clock:
    set-up runs from it to the window's start.  With ``control`` the
    reference one precision below the configuration's takes the
    program's place and no window runs (``benchmark.calibrate``).

    Once everything that might load a module has run (the window, the
    comparison, the trace's reading and every reader), a run with JAX or
    the JAX package loaded raises ``SystemExit`` and gives no result."""
    out = _run(cell, seed, seconds, trace, card, started, control)
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"modules of the JAX package or JAX are loaded: "
                         f"{', '.join(bad)}")
    return out


def _judged(drv, answers, limits: dict) -> tuple:
    t_judge = time.perf_counter()
    numbers, failed = drv.judge(answers)
    print(f"judge_s {time.perf_counter() - t_judge:.3f}", file=sys.stderr)
    correct, checks = checks_of(numbers, limits)
    return bool(correct and failed == 0), failed, checks


def _run(cell, seed, seconds, trace, card, started, control) -> dict:
    from benchmark.trace import Tracer

    require_program_in(REPO)
    before = time.perf_counter() - started
    drv = driver_class(cell.kind)(cell.config, cell.traffic, seed, card)
    if control:
        drv.release()
        correct, failed, checks = _judged(drv, drv.control(), cell.limits)
        return {"correct": correct, "failed": failed, "checks": checks}
    tracer = None
    if trace:
        tracer = Tracer(card, cell.traffic["trace_steps"],
                        cell.traffic.get("trace_after", 0.3) * seconds,
                        drv.params)
    # the set-up's objects go to a generation the collector no longer
    # walks, so its passes inside the window stay short (``run.py`` keeps
    # the collector off through the set-up's imports)
    gc.collect()
    gc.freeze()
    gc.enable()
    setup_s = time.perf_counter() - started
    parts = " ".join(f"{k} {v:.3f}" for k, v in drv.phases.items())
    print(f"setup_s {setup_s:.3f}: start {before:.3f} {parts}",
          file=sys.stderr)
    res = drv.window(seconds, tracer)
    gc.unfreeze()
    device = card.describe()
    device["memory_peak_bytes"] = card.peak_bytes()
    answers = drv.answers()
    drv.release()
    correct, failed, checks = _judged(drv, answers, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": failed}
    if trace:
        tr = tracer.read()
        metrics = {}
        for m in cell.per_layer if tr is not None else ():
            value = reader(m["name"], cell.root)(tr)
            if value is not None:
                metrics[m["name"]] = value
        if tr is not None:
            device["busy_s"] = tr.busy_us() / 1e6
            device["window_s"] = tr.window_us / 1e6
            out["breakdown"] = tr.breakdown()
    else:
        values = dict(res["metrics"], setup_s=setup_s)
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the {cell.kind} driver reports no {missing}")
        metrics = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    out["metrics"] = {k: {"value": v, "unit": units[k]}
                      for k, v in metrics.items()}
    out["device"] = device
    out["checks"] = checks
    return out
