"""Find everything one cell needs by the names in BENCHMARK.json.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration is
the file its `configs` entry names; its traffic mix is
traffic/mixes/<traffic>.json, which names its drive, drives/<drive>.py; the
limits of its output check are workloads/<cell>.json; each per-layer metric
is metrics/<metric>.py. A new cell, configuration, traffic mix, drive or
metric is new files and new entries: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    drive: object  # the drive module
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name):
    """metrics/<name>.py's read(record) -> number or None."""
    return load_module(BENCH / "metrics" / f"{name}.py", f"slambench_metric_{name}").read


def load(workload, root=ROOT):
    """The Cell named `workload` in root/BENCHMARK.json; KeyError if none."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / "mixes" / f"{entry['traffic']}.json").read_text())
    drive = load_module(BENCH / "drives" / f"{mix['drive']}.py", f"slambench_drive_{mix['drive']}")
    limits = json.loads((BENCH / "workloads" / f"{workload}.json").read_text())["limits"]
    return Cell(
        name=workload, chips=int(entry["chips"]), config=config, mix=mix, drive=drive, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )
