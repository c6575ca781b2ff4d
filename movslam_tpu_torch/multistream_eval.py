"""Multi-stream evaluation fan-out: N synthetic seeds, their front ends batched.

The port's counterpart of apps/multistream_eval.py:

    python -m movslam_tpu_torch.multistream_eval [n_streams] [n_frames] [--cpu]

First the MV propagation of every stream in one batched call
(parallel/multistream.py; one score_candidates launch for all streams),
timed over 10 calls: one JSON line `sharded_frontend`. Then one windowed
drive per seed, scored by a scale-aligned ATE against the stream's ground
truth: one JSON line per seed (ate_rmse_m, ate_pct_of_span, lost,
keyframes). Runs on the card, or on the CPU with --cpu.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def umeyama_alignment(x, y, with_scale=True):
    """Least-squares Sim3 (or SE3) taking y (N, 3) onto x (N, 3) (Umeyama
    1991): returns (s, R, t) with x ~ s R y + t."""
    mu_x, mu_y = x.mean(0), y.mean(0)
    xc, yc = x - mu_x, y - mu_y
    U, d, Vt = np.linalg.svd(xc.T @ yc / len(x))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float((d * S.diagonal()).sum() / ((yc * yc).sum() / len(x))) if with_scale else 1.0
    return s, R, mu_x - s * R @ mu_y


def scale_aligned_ate(gt, est):
    """RMSE of the camera centres (N, 3) after a Sim3 fit, and the span of gt."""
    gt, est = np.asarray(gt, np.float64), np.asarray(est, np.float64)
    s, R, t = umeyama_alignment(gt, est)
    resid = gt - (s * est @ R.T + t)
    return float(np.sqrt(np.mean(np.sum(resid ** 2, axis=1)))), float(np.linalg.norm(np.ptp(gt, axis=0)))


def frontend_inputs(streams, cap=512, seed=0):
    """Frame 1 of every stream and a random half-full track state (the
    reference app's batch), as numpy."""
    frames = [st.frame(1) for st in streams]
    rng = np.random.default_rng(seed)
    S = len(streams)
    return [
        np.stack([f.im_gray for f in frames]),
        rng.uniform(20, 400, (S, cap, 2)).astype(np.float32),
        np.tile(np.arange(cap) < cap // 2, (S, 1)),
        np.zeros((S, cap), bool),
        np.zeros((S, cap), np.int32),
        np.zeros((S, cap, 8), np.int32),
        np.full((S, cap, 2), 16.0, np.float32),
        np.stack([f.mv_delta for f in frames]),
        np.stack([f.mv_rect for f in frames]),
        np.stack([f.mv_dindx for f in frames]),
        np.stack([np.arange(len(f.mv_dindx)) < f.n_mvs for f in frames]),
    ]


def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    pos = [a for a in argv[1:] if not a.startswith("--")]
    n_streams = int(pos[0]) if pos else 8
    n_frames = int(pos[1]) if len(pos) > 1 else 120
    device = "cpu" if "--cpu" in argv else "cuda"

    from .config.settings import MONOCULAR, Settings
    from .core.camera import Pinhole
    from .core.system import System
    from .core.verbose import Verbose
    from .device import resolve_device
    from .io.synthetic import SyntheticStream
    from .parallel.multistream import make_multistream_propagate

    Verbose.level = Verbose.QUIET
    dev = resolve_device(device)
    streams = [SyntheticStream(n_points=400, seed=100 + s) for s in range(n_streams)]

    # The batched front end: every stream's MV propagation in one call.
    prop = make_multistream_propagate(dev)
    args = [torch.as_tensor(a, device=dev) for a in frontend_inputs(streams)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prop(*args, 25.0)
    sync()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        prop(*args, 25.0)
    sync()
    dt = (time.perf_counter() - t0) / reps
    print(json.dumps({"sharded_frontend": {
        "streams": n_streams, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "propagate_ms_per_batch": 1e3 * dt, "stream_fps_aggregate": n_streams / dt,
    }}), flush=True)

    # One windowed drive per seed, scored against its ground truth.
    for s, stream in enumerate(streams):
        cfg = Settings()
        cfg.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
        cfg.fps = 30.0
        system = System(cfg, MONOCULAR, device=dev)
        items = [(f.timestamp, f) for f in stream.frames(n_frames)]
        t0 = time.perf_counter()
        for k in range(0, len(items), system.window):
            system.track_monocular_batch(items[k:k + system.window], flush=False)
        system.track_monocular_batch([], flush=True)
        sync()
        wall = time.perf_counter() - t0
        est, gt = [], []
        for ts, R, t, _ in system.frame_trajectory():
            est.append(-(R.T @ t))
            R_gt, t_gt = stream.gt_pose(round(ts * 30.0))
            gt.append(-(R_gt.T @ t_gt))
        ate = span = float("nan")
        if len(est) > 10:
            ate, span = scale_aligned_ate(np.array(gt), np.array(est))
        system.shutdown()
        print(json.dumps({
            "seed": 100 + s, "frames": n_frames, "fps": n_frames / wall,
            "lost": system.get_total_lost(), "keyframes": system.atlas.current.n_keyframes(),
            "ate_rmse_m": ate, "ate_pct_of_span": 100 * ate / span if span else None,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
