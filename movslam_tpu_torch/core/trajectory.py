"""Trajectory writers: TUM / EuRoC / KITTI formats + PLY point cloud.

The port's own copy of movslam_tpu/core/trajectory.py (numpy only), with the
same byte formats as the C++ reference's savers (System.cc:363-893), so the
vendored evaluation harness reads the port's outputs unchanged:
  - KITTI keyframe rows: `frame_id r00 r01 r02 tx r10 ... tz` of T_wc
    relative to the first keyframe of each map (System.cc:722-776).
  - EuRoC rows: `1e9*ts tx ty tz qx qy qz qw` (System.cc:547).
  - TUM rows: `ts tx ty tz qx qy qz qw` (System.cc:419).
"""
from __future__ import annotations

import numpy as np


def _quat_wc(R_cw, t_cw):
    """T_wc translation + quaternion (x, y, z, w) from camera-from-world."""
    R_wc = R_cw.T
    t_wc = -R_cw.T @ t_cw
    q = _rot_to_quat(R_wc)
    return t_wc, q


def _rot_to_quat(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def _sorted_kfs(m):
    return sorted((kf for kf in m.keyframes.values() if not kf.bad), key=lambda k: k.id)


def save_keyframe_trajectory_kitti(atlas, filename):
    """System::saveKeyFrameTrajectoryKITTI (System.cc:722-776). Emits a row
    for every keyframe including culled ones, whose poses are recovered
    through the parent chain (Trw = Tcp * ... * T_parent, System.cc:760-766)."""
    with open(filename, "w") as f:
        for m in atlas.all_maps():
            kfs = _sorted_kfs(m)
            if not kfs:
                continue
            R0, t0 = kfs[0].pose()
            # T_ow = inv(T_cw first): transform so first KF is origin.
            R_ow, t_ow = R0.T, -(R0.T @ t0)
            all_kfs = sorted(
                list(m.keyframes.values()) + list(m.culled_keyframes.values()),
                key=lambda k: k.id,
            )
            for kf in all_kfs:
                # Recover culled poses via the Tcp parent chain: accumulate
                # T_acc = Tcp_kf * Tcp_parent * ... until a live ancestor.
                R_acc, t_acc = np.eye(3), np.zeros(3)
                node = kf
                while node.bad and node.Tcp is not None and node.parent is not None:
                    R_cp, t_cp = node.Tcp
                    R_acc, t_acc = R_acc @ R_cp, R_acc @ t_cp + t_acc
                    node = node.parent
                if node.bad:
                    continue  # unrecoverable (no live ancestor)
                R_kw = R_acc @ node.R
                t_kw = R_acc @ node.t + t_acc
                R_rw = R_kw @ R_ow
                t_rw = R_kw @ t_ow + t_kw
                R_wc = R_rw.T
                t_wc = -(R_rw.T @ t_rw)
                r = R_wc
                f.write(
                    f"{kf.frame_id:.9f} "
                    f"{r[0,0]:.9f} {r[0,1]:.9f} {r[0,2]:.9f} {t_wc[0]:.9f} "
                    f"{r[1,0]:.9f} {r[1,1]:.9f} {r[1,2]:.9f} {t_wc[1]:.9f} "
                    f"{r[2,0]:.9f} {r[2,1]:.9f} {r[2,2]:.9f} {t_wc[2]:.9f}\n"
                )


def save_keyframe_trajectory_euroc(atlas, filename):
    """System::SaveKeyFrameTrajectoryEuRoC (System.cc:700-718)."""
    with open(filename, "w") as f:
        for m in atlas.all_maps():
            for kf in _sorted_kfs(m):
                t_wc, q = _quat_wc(kf.R, kf.t)
                f.write(
                    f"{1e9 * kf.timestamp:.6f} {t_wc[0]:.9f} {t_wc[1]:.9f} "
                    f"{t_wc[2]:.9f} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
                )


def save_keyframe_trajectory_tum(atlas, filename):
    """System::SaveKeyFrameTrajectoryTUM (System.cc:427-456)."""
    with open(filename, "w") as f:
        for m in atlas.all_maps():
            for kf in _sorted_kfs(m):
                t_wc, q = _quat_wc(kf.R, kf.t)
                f.write(
                    f"{kf.timestamp:.6f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )


def frame_trajectory(tracking):
    """Per-frame poses reconstructed from the relative-pose logs against the
    CURRENT (bundle-adjusted) reference-keyframe poses — the reference's saver
    semantics (System::SaveTrajectoryEuRoC, System.cc:458-720): T_cw(frame) =
    T_rel * T_cw(refKF). BA corrections to keyframes thus retroactively
    correct the whole trajectory, which is why the saved trajectory is far
    more accurate than the live per-frame estimates (pre-BA early-map gauge
    error never reaches it). Yields (ts, R_cw, t_cw, lost)."""
    for (R_rel, t_rel), ref_kf, ts, lost in zip(
        tracking.rel_poses, tracking.rel_refs, tracking.rel_times, tracking.rel_lost
    ):
        if ref_kf is None:
            continue
        # A culled reference keyframe's pose is frozen at cull time (BA no
        # longer updates it): accumulate its Tcp records up the parent chain
        # to a live ancestor, exactly like the KITTI saver / System.cc:760.
        R_acc = R_rel
        t_acc = t_rel
        node = ref_kf
        while node.bad and node.Tcp is not None and node.parent is not None:
            R_cp, t_cp = node.Tcp
            t_acc = R_acc @ t_cp + t_acc
            R_acc = R_acc @ R_cp
            node = node.parent
        R_cw = R_acc @ node.R
        t_cw = R_acc @ node.t + t_acc
        yield ts, R_cw, t_cw, lost


def save_frame_trajectory(tracking, filename, scale_ts=1.0):
    """Per-frame trajectory from relative-pose logs (System::SaveTrajectoryTUM
    / EuRoC): T_cw(frame) = T_rel * T_cw(refKF); rows are T_wc."""
    with open(filename, "w") as f:
        for ts, R_cw, t_cw, lost in frame_trajectory(tracking):
            t_wc, q = _quat_wc(R_cw, t_cw)
            f.write(
                f"{scale_ts * ts:.6f} {t_wc[0]:.9f} {t_wc[1]:.9f} {t_wc[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def save_point_cloud(atlas, filename):
    """PLY export of all map points (System::SavePointCloud,
    System.cc:840-893)."""
    pts = []
    for m in atlas.all_maps():
        for mp in m.mappoints.values():
            if not mp.bad:
                pts.append(mp.pos)
    with open(filename, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
