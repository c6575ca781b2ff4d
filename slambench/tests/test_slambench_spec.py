"""BENCHMARK.json against the contract's shape, and the harness finding a
cell, configuration, traffic mix, drive and metric added as files only."""
import json
import re
import shutil

import pytest

from harness import cell as cellrun
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slambench"] and BENCH["command"][1] == "slambench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("slambench/") and (spec.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_metrics_follow_the_contract():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved) & cells
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2 and any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    c = spec.load(cell)
    assert c.chips == 1 and c.limits["unanswered"] == 0
    assert callable(c.drive.warm_up) and callable(c.drive.measure)
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_frames_rendered_follow_the_mix():
    """The camera's frames over the window, or the mix's cap where it is lower."""
    c = spec.load("tartan_mono_window")
    assert cellrun.frames_needed(c, 51) == 48 + 20 * 51
    c.mix = {k: v for k, v in c.mix.items() if k != "render_per_s"}
    assert cellrun.frames_needed(c, 51) == 48 + 30 * 51


def test_new_cell_is_files_only(tmp_path):
    """A new configuration, traffic mix, drive, metric and cell: new files
    and new BENCHMARK.json entries, with no file of the harness edited."""
    shutil.copytree(spec.BENCH, tmp_path / "slambench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((spec.ROOT / BENCH["configs"][0]["file"]).read_text())
    config["name"] = "new_config"
    (tmp_path / "slambench/configs/new_config.json").write_text(json.dumps(config))
    (tmp_path / "slambench/traffic/mixes/new_mix.json").write_text(json.dumps(
        {"drive": "new_drive", "warmup": {"frames": 4}, "scene": {"n_points": 50}}))
    (tmp_path / "slambench/drives/new_drive.py").write_text(
        "def warm_up(system, feed, mix, span):\n    return {}, 4\n\n\n"
        "def measure(system, feed, start, mix, deadline, clock, span):\n    return {}\n")
    (tmp_path / "slambench/metrics/new_metric.py").write_text("def read(record):\n    return 7.0\n")
    (tmp_path / "slambench/workloads/new_cell.json").write_text(json.dumps({"limits": {"unanswered": 0}}))
    bench["configs"].append({"name": "new_config", "source": "x", "file": "slambench/configs/new_config.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new_cell", "config": "new_config", "traffic": "new_mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "Mapper", "moves": "frames_per_s", "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    copied = spec.load_module(tmp_path / "slambench/harness/spec.py", "slambench_spec_copy")
    cell = copied.load("new_cell", root=tmp_path)
    assert cell.config["name"] == "new_config" and cell.mix["drive"] == "new_drive"
    assert cell.drive.warm_up(None, [], cell.mix, None) == ({}, 4)
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert copied.metric_reader("new_metric")({}) == 7.0
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
