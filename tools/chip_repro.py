"""Run-to-run reproducibility of the port's monocular drives on one card.

    python3 tools/chip_repro.py [ROOT] [RUNS]

Imports movslam_tpu_torch from ROOT (default: this checkout; another
unpacked commit, such as a parent, compares the two in one call) and drives
chip_smoke.py's phase 3 and phase 5 drives RUNS times each (default 2)
with the same seeds: the per-frame drive of SyntheticStream(n_points=400,
seed=11) over 40 frames, and the windowed drive of SyntheticStream(
n_points=400, seed=42) over phase 5's 160 mapped frames in its batches.
Per run: the post-hoc ATE (scale-aligned frame_trajectory(), chip_smoke's
0.10 m gate) and whether the gate passed; across runs: whether every
dispatched program's wire, every pose and the trajectory were bit-equal,
and the first dispatch whose wire differs. Prints one JSON line per drive.
Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    root = os.path.abspath(argv[1]) if len(argv) > 1 else HERE
    runs = int(argv[2]) if len(argv) > 2 else 2
    import torch

    if not torch.cuda.is_available():
        print("chip_repro: no CUDA card", flush=True)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # its helpers import the port lazily, from ROOT below

    sys.path.insert(0, root)
    from movslam_tpu_torch.config.settings import MONOCULAR, Settings
    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.io.synthetic import SyntheticStream
    from movslam_tpu_torch.multistream_eval import scale_aligned_ate
    from movslam_tpu_torch.ops import kernels

    import movslam_tpu_torch

    assert os.path.dirname(os.path.dirname(os.path.abspath(movslam_tpu_torch.__file__))) == root
    kernels.build()
    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    n_mapped = cs.W_WARM + cs.W_TIMED + cs.W_PROFILED
    windowed = ([(k, k + cs.W_BATCH, k + cs.W_BATCH >= cs.W_WARM) for k in range(0, cs.W_WARM, cs.W_BATCH)]
                + [(k, k + cs.W_BATCH, False) for k in range(cs.W_WARM, cs.W_WARM + cs.W_TIMED, cs.W_BATCH)]
                + [(0, 0, True)]
                + [(k, k + cs.W_BATCH, False) for k in range(cs.W_WARM + cs.W_TIMED, n_mapped, cs.W_BATCH)]
                + [(0, 0, True)])
    for label, seed, n, batches in (("per_frame", 11, cs.N_FRAMES, None), ("windowed", 42, n_mapped, windowed)):
        stream = SyntheticStream(n_points=400, seed=seed)
        frames = [stream.frame(k) for k in range(n)]
        gt = lambda k: -(stream.gt_pose(k)[0].T @ stream.gt_pose(k)[1])  # noqa: E731
        results = []
        for _ in range(runs):
            t0 = time.perf_counter()
            system, rec = cs.repro_drive(System, s, MONOCULAR, frames, batches)
            traj = system.frame_trajectory()
            ate = scale_aligned_ate([gt(round(ts * 30.0)) for ts, _, _, _ in traj],
                                    [-(R.T @ t) for _, R, t, _ in traj])[0]
            results.append({"ate_post": ate, "gate_passed": ate < cs.POSTHOC_ATE_MAX,
                            "lost": system.get_total_lost(), "keyframes": system.atlas.current.n_keyframes(),
                            "dispatches": len(rec["wires"]), "seconds": time.perf_counter() - t0, **rec})
        first = [cs.first_difference(results[0]["wires"], r["wires"]) for r in results[1:]]
        print(json.dumps({"drive": label, "root": root, "runs": runs, "card": torch.cuda.get_device_name(0),
                          "ate_post": [r["ate_post"] for r in results],
                          "gate_passed": [r["gate_passed"] for r in results],
                          "lost": [r["lost"] for r in results], "keyframes": [r["keyframes"] for r in results],
                          "dispatches": [r["dispatches"] for r in results],
                          "seconds": [r["seconds"] for r in results],
                          "wires_equal": [f is None for f in first], "first_wire_difference": first,
                          "poses_equal": [r["poses"] == results[0]["poses"] for r in results[1:]],
                          "trajectory_equal": [r["trajectory"] == results[0]["trajectory"] for r in results[1:]]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
