"""The benchmark's frozen copy of the port's visual-inertial stream.

A copy of movslam_tpu_torch/io/synthetic_vi.py (numpy only, no import of the
port) over traffic/synthetic.Scene, so that later changes to the port's
generator cannot move the yardstick; slambench/tests/test_slambench_traffic.py
holds the two equal. Each frame's IMU samples come from the ground-truth
pose path by central differences: `n_sub` rows over the interval (frame k-1,
frame k], [dt, gx, gy, gz, ax, ay, az] in the body frame with gravity
(0, 0, -9.81) in the world, the layout of the port's core/inertial.ImuBuffer.
"""
from __future__ import annotations

import numpy as np

G_W = np.array([0.0, 0.0, -9.81])


def imu_window(scene, k, n_sub):
    """The IMU rows (n_sub, 7) float32 of frame k of `scene`: gyro = body
    angular velocity, accel = specific force (world acceleration minus
    gravity, in the body frame). None for k == 0."""
    if k <= 0:
        return None
    fps = scene.fps
    dt = 1.0 / (fps * n_sub)
    rows = np.zeros((n_sub, 7), np.float32)

    def center(tf):
        R, t = scene.gt_pose(tf)
        return -(R.T @ t)

    def R_wc(tf):
        R, _ = scene.gt_pose(tf)
        return R.T

    for i in range(n_sub):
        tf = (k - 1) + (i + 0.5) / n_sub
        h = 0.05
        a_w = (center(tf + h) - 2 * center(tf) + center(tf - h)) / (h * h) * fps * fps
        Rw = R_wc(tf)
        dR = (R_wc(tf + h) - R_wc(tf - h)) / (2 * h) * fps
        Om = Rw.T @ dR
        rows[i, 0] = dt
        rows[i, 1:4] = (Om[2, 1], Om[0, 2], Om[1, 0])
        rows[i, 4:7] = Rw.T @ (a_w - G_W)
    return rows
