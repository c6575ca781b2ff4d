"""Spread of the 60-frame golden-ATE drive (tests/test_torch_golden_ate.py)
over runs, for the port under ROOT.

    python3 tools/golden_spread.py ROOT RUNS DEVICE [SEEDS]

Imports movslam_tpu_torch from ROOT (another unpacked commit, such as a
parent, or this checkout) and drives the windowed golden drive of
tests/test_torch_golden_ate.py (60 frames of SyntheticStream(n_points=400,
seed), batches of 8, each call flushing) RUNS times per seed (default seeds
7 and 42) on DEVICE ("cuda" or "cpu"). Per run it prints the scale-aligned
post-hoc ATE as % of the span, the frames lost, and the Sim3 scale fitted on
each third of the trajectory (a map whose scale drifts shows three
different values).
"""
from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    if len(argv) < 4:
        print(__doc__)
        return 1
    root, runs, device = os.path.abspath(argv[1]), int(argv[2]), argv[3]
    seeds = [int(s) for s in argv[4].split(",")] if len(argv) > 4 else [7, 42]
    sys.path.insert(0, HERE)
    sys.path.insert(0, root)
    import numpy as np

    import movslam_tpu_torch
    from movslam_tpu_torch.multistream_eval import umeyama_alignment
    from movslam_tpu_torch.ops import kernels

    assert os.path.dirname(os.path.dirname(os.path.abspath(movslam_tpu_torch.__file__))) == root
    if device == "cuda":
        kernels.build()
    spec = importlib.util.spec_from_file_location("golden", os.path.join(HERE, "tests", "test_torch_golden_ate.py"))
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)  # the drive of this checkout's test, the port of ROOT
    for seed in seeds:
        for run in range(runs):
            system, stream = golden._windowed_drive(device, seed, 60, flush_each_batch=True)
            traj = system.frame_trajectory()
            ks = np.array([round(ts * 30.0) for ts, _, _, _ in traj])
            gt = np.array([-(stream.gt_pose(k)[0].T @ stream.gt_pose(k)[1]) for k in ks])
            est = np.array([-(R.T @ t) for _, R, t, _ in traj])
            s, R, t = umeyama_alignment(gt, est)
            ate = float(np.sqrt(np.mean(np.sum((gt - (s * est @ R.T + t)) ** 2, axis=1))))
            span = float(np.linalg.norm(np.ptp(gt, axis=0)))
            thirds = [umeyama_alignment(gt[(ks >= a) & (ks < a + 20)], est[(ks >= a) & (ks < a + 20)])[0]
                      for a in (0, 20, 40)]
            print(f"{root} {device} seed {seed} run {run}: {100 * ate / span:.3f}% of span, lost "
                  f"{system.get_total_lost()}, scale by thirds {' '.join(f'{x:.2f}' for x in thirds)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
