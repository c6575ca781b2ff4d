"""Parent against change, call by call: the port's BA solves on one card.

    python3 tools/chip_ba_pairs.py PARENT_ROOT [PAIRS]

Loads this checkout's movslam_tpu_torch and, under the name parent_port,
the one under PARENT_ROOT (e.g. a parent commit unpacked with git archive;
the port imports itself only relatively, so both live in one process and
each builds its kernels into its own _build/). Builds
tools/chip_ba_times.ba_problems with this checkout (the local BA of
chip_smoke.py phase 3's map, 10 LM iterations; the global BA of that map
and of chip_smoke.top_bucket_map at the caps, 20) and times each solver's
ba_solve_wire on the same wire in PAIRS pairs (default 20), a synchronize
around each call, the side that runs first alternating from pair to pair. Host noise moves whole runs of
the process; pairs taken a few ms apart share it. Prints, per problem, the
medians, the parent's interquartile spread, how many pairs the change won
and whether the two results are bit-equal, and one JSON line with every
time and the card's name. Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_alias(root, alias):
    """Import ROOT/movslam_tpu_torch as the package `alias`."""
    pkg = os.path.join(os.path.abspath(root), "movslam_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def timed_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def main(argv):
    import torch

    if len(argv) < 2:
        print(__doc__, flush=True)
        return 2
    if not torch.cuda.is_available():
        print("chip_ba_pairs: no CUDA card", flush=True)
        return 1
    pairs = int(argv[2]) if len(argv) > 2 else 20
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import chip_ba_times
    import chip_smoke as cs
    from movslam_tpu_torch.config.settings import Settings
    from movslam_tpu_torch.core import local_mapping as lm
    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.verbose import Verbose
    from movslam_tpu_torch.ops import ba, kernels

    load_alias(argv[1], "parent_port")
    parent_ba = importlib.import_module("parent_port.ops.ba")
    importlib.import_module("parent_port.ops.kernels").build()
    kernels.build()
    Verbose.level = Verbose.QUIET
    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    cam = s.camera1
    intr = [cam.fx, cam.fy, cam.cx, cam.cy]
    problems = chip_ba_times.ba_problems(cs, s)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"parent_root": os.path.abspath(argv[1]), "card": card, "pairs": pairs}
    for name, (prob, iters) in problems.items():
        wire_np, (K, P, O, mopp) = lm.problem_wire(prob)
        wire = torch.as_tensor(wire_np, device="cuda")
        solvers = {side: (lambda mod=mod: mod.ba_solve_wire(wire, intr, 0.0, K=K, P=P, O=O, MOPP=mopp, iters=iters))
                   for side, mod in (("parent", parent_ba), ("change", ba))}
        results = {side: fn() for side, fn in solvers.items()}  # warm-up, and the results compared
        times = {"parent": [], "change": []}
        for i in range(pairs):
            for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                times[side].append(timed_ms(solvers[side])[0])
        p, c = times["parent"], times["change"]
        q = statistics.quantiles(p, n=4)
        row = {"K_P_O": [K, P, O], "iters": iters, "parent_ms": p, "change_ms": c,
               "parent_median_ms": statistics.median(p), "change_median_ms": statistics.median(c),
               "parent_iqr_ms": q[2] - q[0], "change_wins": sum(b < a for a, b in zip(p, c)),
               "bit_equal": bool(torch.equal(results["parent"], results["change"]))}
        out[name] = row
        print(f"{name} (K={K}, P={P}, O={O}, {iters} LM iterations), {pairs} pairs: parent median "
              f"{row['parent_median_ms']:.2f} ms (interquartile {row['parent_iqr_ms']:.2f} ms), change median "
              f"{row['change_median_ms']:.2f} ms; change faster in {row['change_wins']} of {pairs} pairs; results "
              f"bit-equal {row['bit_equal']} on {card}", flush=True)
    print(json.dumps({"ba_pairs": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
