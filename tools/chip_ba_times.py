"""Times of the port's BA solves on one card, for the port under ROOT.

    python3 tools/chip_ba_times.py [ROOT]

Imports movslam_tpu_torch from ROOT (default: this checkout; run it once
per unpacked commit, in turns, to compare two in one call) and times, with
a synchronize around each call (median of 5 after one warm-up call):
  local_ba  ops/ba.ba_solve_wire on the local-BA problem the per-frame
            mapper would launch on the map of chip_smoke.py's phase 3 drive
            (SyntheticStream(n_points=400, seed=11), 40 frames);
  gba_drive the global-BA problem of that map (20 LM iterations);
  gba_caps  the global-BA problem of chip_smoke.top_bucket_map (512
            keyframes, 16,384 points, 65,536 observations; 20 iterations);
  vi_ba     LocalMapping._local_ba_vi on the map of a per-frame VI drive
            (SyntheticVIStream(n_points=400, seed=11), 24 frames,
            vi_min_kfs = 4).
Prints one JSON line with the ms of each and the card's name. Needs a CUDA
card; exits 1 without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def ba_problems(cs, settings):
    """The BA problems timed here, built with the movslam_tpu_torch on
    sys.path: name -> (problem, LM iterations) for local_ba, gba_drive and
    gba_caps (see the module docstring)."""
    from movslam_tpu_torch.config.settings import MONOCULAR
    from movslam_tpu_torch.core import local_mapping as lm
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.io.synthetic import SyntheticStream
    from movslam_tpu_torch.ops.ba import LM_ITERS

    stream = SyntheticStream(n_points=400, seed=11)
    system, _, _, _ = cs.drive(System, settings, [stream.frame(k) for k in range(cs.N_FRAMES)], MONOCULAR)
    system.shutdown()
    m = system.atlas.current
    n_local, kfs, mps = system.mapper._select_local_ba(m, lm.MAX_BA_MP)
    out = {"local_ba": (lm.assemble_ba_problem(kfs, n_local, mps, m.init_kf_id, lm.MAX_OPT_KF + lm.MAX_FIX_KF),
                        LM_ITERS)}
    (w_kfs, n_anchor), = lm.gba_windows(m)
    out["gba_drive"] = (lm.gba_problem(m, w_kfs, n_anchor)[1], 20)
    tm, _ = cs.top_bucket_map(cs.GBA_TOP_KF, cs.GBA_TOP_MP, cs.GBA_TOP_PER_KF)
    (w_kfs, n_anchor), = lm.gba_windows(tm)
    out["gba_caps"] = (lm.gba_problem(tm, w_kfs, n_anchor)[1], 20)
    return out


def main(argv):
    root = os.path.abspath(argv[1]) if len(argv) > 1 else HERE
    import torch

    if not torch.cuda.is_available():
        print("chip_ba_times: no CUDA card", flush=True)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # its helpers import the port lazily, from ROOT below

    sys.path.insert(0, root)
    from movslam_tpu_torch.config.settings import IMU_MONOCULAR, Settings
    from movslam_tpu_torch.core import local_mapping as lm
    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.core.verbose import Verbose
    from movslam_tpu_torch.io.synthetic_vi import SyntheticVIStream
    from movslam_tpu_torch.ops import kernels
    from movslam_tpu_torch.ops.ba import ba_solve_wire

    Verbose.level = Verbose.QUIET
    kernels.build()
    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)

    def solve(prob, iters):
        wire, (K, P, O, mopp) = lm.problem_wire(prob)
        wire = torch.as_tensor(wire, device="cuda")
        cam = s.camera1
        return lambda: ba_solve_wire(wire, [cam.fx, cam.fy, cam.cx, cam.cy], 0.0, K=K, P=P, O=O, MOPP=mopp,
                                     iters=iters), (K, P, O)

    out = {"root": root, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    for name, (prob, iters) in ba_problems(cs, s).items():
        fn, shape = solve(prob, iters)
        out[name] = {"ms": timed(fn, reps=3 if name == "gba_caps" else 5), "K_P_O": shape}

    vs = Settings()
    vs.camera1 = s.camera1
    vs.fps, vs.sensor = 30.0, IMU_MONOCULAR
    vsys = System(vs, IMU_MONOCULAR, device="cuda")
    vsys.mapper.vi_min_kfs = 4
    for ts, smv, imu in SyntheticVIStream(n_points=400, seed=11).items(24):
        vsys.track_monocular(ts, smv, imu=imu)
    vsys.shutdown()
    vm = vsys.atlas.current
    out["vi_ba"] = {"ms": timed(lambda: vsys.mapper._local_ba_vi(vm), reps=3),
                    "imu_initialized": bool(vm.imu_initialized), "drive_calls": len(vsys.mapper.vi_ba_ms)}
    print(json.dumps({"ba_times": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
