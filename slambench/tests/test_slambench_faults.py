"""A run with its timed path broken underneath, or with the control in the
program's place, comes out not correct; a sound run comes out correct.

Each case drives the rest of a run (set-up, warm-up, window, output check)
without the harness's look for a card: on the CPU at a 10-second window,
and, marked `cuda`, on the card (python -m pytest -m cuda slambench/tests).
"""
import json
import time

import pytest

from harness import cell as cellrun
from harness import faults, spec

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SECONDS = 10.0  # the check needs 3 answers


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda":
        import torch

        if not torch.cuda.is_available():
            pytest.skip("no CUDA card")
    return request.param


@pytest.mark.parametrize("plant", sorted(faults.FAULTS) + ["control"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(cell, plant, device):
    """Every fault and the control fail the check."""
    c = spec.load(cell)
    result, numbers = cellrun.run(c, 20240917, SECONDS, False, time.perf_counter(), device=device,
                                  plant=faults.plant(c, plant, SECONDS))
    assert result["correct"] is False, numbers
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(c.limits)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_well_formed(cell, device):
    c = spec.load(cell)
    result, numbers = cellrun.run(c, 31337, SECONDS, False, time.perf_counter(), device=device)
    assert result["correct"] is True, numbers
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(result)
