"""Visual-inertial plumbing: IMU sample routing, per-keyframe-interval
preintegration, and the gravity/scale initialization.

Port of movslam_tpu/core/inertial.py. Raw samples buffer on the host per
frame; at the initialization every keyframe-to-keyframe window is
preintegrated in one batched loop (ops/imu.preintegrate) on the device, and
gravity direction + metric scale + velocities + shared biases are solved by
ops/imu.inertial_gs_optimize with the poses fixed (EdgeInertialGS semantics,
Optimizer.cc:843-950). The similarity is applied to the map like ORB-SLAM3's
ApplyScaledRotation:

    R_cw <- R_cw @ Rwg,   t_cw <- s * t_cw,   X <- s * Rwg^T X

after which gravity is -z in the world frame and the map is metric.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.imu import inertial_gs_optimize, preintegrate
from .verbose import Verbose

MAX_SAMPLES_PER_WINDOW = 512  # padding cap for one KF-to-KF interval
MAX_WINDOWS = 31              # KF chain length used by the init solve


class ImuBuffer:
    """Per-frame IMU sample store (host). Samples arrive with
    System.track_monocular(ts, smv, imu=...) as (N, 7) rows
    [dt, gx, gy, gz, ax, ay, az] covering the interval since the previous
    frame."""

    def __init__(self):
        self.by_frame = {}  # frame id -> (N, 7) float32

    def add(self, frame_id, samples):
        if samples is None or len(samples) == 0:
            return
        self.by_frame[int(frame_id)] = np.asarray(samples, np.float32)

    def window(self, fid_lo, fid_hi):
        """Concatenated samples for frames in (fid_lo, fid_hi]."""
        parts = [self.by_frame[f] for f in range(int(fid_lo) + 1, int(fid_hi) + 1) if f in self.by_frame]
        if not parts:
            return np.zeros((0, 7), np.float32)
        return np.concatenate(parts)

    def clear_before(self, fid):
        for f in [f for f in self.by_frame if f <= fid]:
            del self.by_frame[f]


def _stack_windows(kfs, buf, cap=MAX_SAMPLES_PER_WINDOW):
    """Preintegration inputs for the K-1 consecutive-KF windows, padded:
    gyro (K-1, cap, 3), acc (K-1, cap, 3), dts (K-1, cap), valid (K-1, cap),
    w_ok (K-1,)."""
    K = len(kfs)
    gyro = np.zeros((K - 1, cap, 3), np.float32)
    acc = np.zeros((K - 1, cap, 3), np.float32)
    dts = np.zeros((K - 1, cap), np.float32)
    valid = np.zeros((K - 1, cap), bool)
    w_ok = np.zeros(K - 1, bool)
    for k in range(K - 1):
        s = buf.window(kfs[k].frame_id, kfs[k + 1].frame_id)
        n = min(len(s), cap)
        if n == 0:
            continue
        dts[k, :n] = s[:n, 0]
        gyro[k, :n] = s[:n, 1:4]
        acc[k, :n] = s[:n, 4:7]
        valid[k, :n] = True
        w_ok[k] = True
    return gyro, acc, dts, valid, w_ok


def preintegrate_windows(gyro, acc, dts, valid, bias_g, bias_a, device, **noise):
    """preintegrate on `device` over host arrays from _stack_windows. The loop
    stops after the last sample of the longest window: every later step is
    padding in every window. Returns (pres, steps run)."""
    used = np.flatnonzero(valid.any(0))
    steps = int(used[-1]) + 1 if len(used) else 0
    dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    pres = preintegrate(dev(gyro), dev(acc), dev(dts), dev(valid), dev(bias_g), dev(bias_a),
                        steps=steps, **noise)
    return pres, steps


def visual_inertial_init(m, kfs, buf, *, device, noise_gyro=1.7e-4, noise_acc=2e-3, map_lock=None,
                         min_windows=5):
    """Gravity + scale initialization over the keyframe chain. Returns the
    solve (a dict of numpy arrays, with the preintegration steps run), or
    None when there is not enough IMU evidence, after applying the similarity
    to the map and stamping per-KF velocities and shared biases."""
    kfs = sorted((kf for kf in kfs if not kf.bad), key=lambda k: k.id)
    kfs = kfs[-MAX_WINDOWS - 1:]
    if len(kfs) < min_windows + 1:
        return None
    gyro, acc, dts, valid, w_ok = _stack_windows(kfs, buf)
    if int(w_ok.sum()) < min_windows:
        return None

    zero = np.zeros(3, np.float32)
    pres, steps = preintegrate_windows(gyro, acc, dts, valid, zero, zero, device,
                                       sigma_g=noise_gyro, sigma_a=noise_acc)
    # World-from-body states (camera == body: extrinsics, if any, fold into
    # the sample stream upstream).
    Rs = np.stack([kf.R.T for kf in kfs])  # world-from-camera
    ps = np.stack([kf.center() for kf in kfs])
    # Velocity guesses from finite differences of the (unscaled) positions.
    dts_w = np.maximum(np.array([kfs[k + 1].timestamp - kfs[k].timestamp for k in range(len(kfs) - 1)]),
                       1e-3)
    v0 = np.zeros((len(kfs), 3), np.float32)
    v0[:-1] = (ps[1:] - ps[:-1]) / dts_w[:, None]
    v0[-1] = v0[-2]

    dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    res = inertial_gs_optimize(pres, dev(Rs.astype(np.float32)), dev(ps.astype(np.float32)), dev(v0),
                               dev(zero), dev(zero), dev(w_ok))
    res = {k: v.cpu().numpy() for k, v in res.items()}
    res["preintegrate_steps"] = steps
    s = float(res["scale"])
    Rwg = np.asarray(res["Rwg"], np.float64)
    if not np.isfinite(s) or s <= 1e-3 or s > 1e3:
        Verbose.log(f"VI init rejected: scale={s}")
        return None

    apply_scaled_rotation(m, s, Rwg, map_lock=map_lock)
    vel = np.asarray(res["vel"], np.float64) @ Rwg  # v_new = Rwg^T v, row-wise
    for k, kf in enumerate(kfs):
        kf2 = m.keyframes.get(kf.id)
        if kf2 is not None:
            kf2.velocity = vel[k] * 1.0
            kf2.bias_g = np.asarray(res["bg"], np.float64)
            kf2.bias_a = np.asarray(res["ba"], np.float64)
    m.imu_initialized = True
    m.imu_scale = s
    Verbose.log(f"VI init: scale={s:.4f}, gravity dir applied")
    return res


def apply_scaled_rotation(m, s, Rwg, map_lock=None):
    """Map::ApplyScaledRotation (ORB-SLAM3): re-express the map in a
    gravity-aligned metric world (see the module docstring for the algebra)."""
    if map_lock is not None:
        map_lock.acquire()
    try:
        for kf in m.keyframes.values():
            kf.set_pose(kf.R @ Rwg, kf.t * s)
        for mp in m.mappoints.values():
            mp.pos = s * (Rwg.T @ mp.pos)
            mp.normal = Rwg.T @ mp.normal
            mp.min_dist *= s
            mp.max_dist *= s
        m.bump_change()
    finally:
        if map_lock is not None:
            map_lock.release()
