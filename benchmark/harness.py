"""What every cell shares: finding a cell and its metrics by name, the
process clock, the per-layer readers, and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its pieces are files
found by name, so that a configuration, a traffic mix, a cell or a metric is
added by adding files and manifest entries:
  - the configuration's file, named by its `file` key;
  - benchmark/traffic/<traffic>.json: the mix's parameters and its `driver`,
    the module benchmark/drivers/<driver>.py that runs it;
  - benchmark/workloads/<cell>.json: the limits of the cell's correctness
    comparison;
  - benchmark/metrics/<metric>.py: one reader per per-layer metric, or
    benchmark/metrics/<stem>.py for every metric <stem>.<part> that has no
    file of its own (one quantity split by the end-to-end metric it moves).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the run must not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "proqa_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file
    traffic: dict           # benchmark/traffic/<traffic>.json
    limits: dict            # benchmark/workloads/<cell>.json's "limits"
    end_to_end: list        # the manifest's end-to-end metric entries this cell reports
    per_layer: list         # the manifest's per-layer metric entries this cell reports

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files read. Raises
    KeyError for a name the manifest lacks."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == w["config"])
    bench = root / "benchmark"
    spec = json.loads((bench / "workloads" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=spec["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
    )


def load_driver(name: str):
    """benchmark/drivers/<name>.py: its `run` runs a cell once, its `control`
    gives the control's readings."""
    return importlib.import_module(f"benchmark.drivers.{name}")


def load_reader(metric: str, root: Path = ROOT):
    """benchmark/metrics/<metric>.py, else <the name up to its first dot>.py;
    its `read(ctx)` returns the metric's value, or None where the window
    holds nothing for it to read."""
    metrics = root / "benchmark" / "metrics"
    path = metrics / f"{metric}.py"
    if not path.exists():
        path = metrics / f"{metric.split('.')[0]}.py"
    return _load(path, "benchmark_metric_" + path.stem.replace(".", "_").replace("-", "_"))


def _load(path: Path, module_name: str):
    if module_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
    return sys.modules[module_name]


def process_age_s() -> float:
    """Seconds since this process started, from /proc (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22, starttime; fields[0] is field 3
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Clock:
    """perf_counter() at the process's start, for setup_s."""
    start: float = dataclasses.field(
        default_factory=lambda: time.perf_counter() - process_age_s())


@dataclasses.dataclass
class Outcome:
    """What a driver's run returns to the harness."""
    attempted: int
    failed: int
    end_to_end: dict          # metric name -> value (timed runs)
    checks: dict              # number compared -> (value, limit); correct iff value <= limit
    memory_peak_bytes: int
    trace: object = None      # trace.TraceSummary of the traced run
    work: dict = dataclasses.field(default_factory=dict)  # shapes and counts for the readers


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer_metrics(cell: Cell, outcome: Outcome, root: Path = ROOT) -> dict:
    """Each per-layer metric's reader applied to the traced window; a reader
    that finds nothing to read leaves its metric out."""
    ctx = {"trace": outcome.trace, "work": outcome.work, "config": cell.config,
           "traffic": cell.traffic}
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"], root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: Cell, outcome: Outcome, *, trace: bool, device: dict) -> dict:
    """The run's last line: correct, attempted, failed, metrics, device,
    breakdown (traced runs) and, last, every number compared beside its
    limit."""
    if trace:
        metrics = per_layer_metrics(cell, outcome)
        device = {**device, "busy_s": outcome.trace.busy_s, "window_s": outcome.trace.window_s}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in outcome.end_to_end.items()
                   if k in units}
    correct = all(v <= lim for v, lim in outcome.checks.values())
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": {**device,
                                           "memory_peak_bytes": outcome.memory_peak_bytes}}
    if trace:
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line
