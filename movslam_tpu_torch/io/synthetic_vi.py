"""Synthetic visual-inertial stream: MV frames + analytic IMU windows.

The port's own copy of movslam_tpu/io/synthetic_vi.py (numpy only), over the
port's io/synthetic.py: per-frame IMU sample windows derived from the
ground-truth pose path by central differences.

Sample rows are [dt, gx, gy, gz, ax, ay, az] in the body frame with gravity
(0, 0, -9.81) in the world, the layout core/inertial.ImuBuffer reads.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .synthetic import SyntheticStream

G_W = np.array([0.0, 0.0, -9.81])


@dataclasses.dataclass
class SyntheticVIStream:
    n_points: int = 400
    seed: int = 0
    fps: float = 30.0
    keyint: int = 1000
    n_sub: int = 8  # IMU samples per frame interval (240 Hz at 30 fps)

    def __post_init__(self):
        self.stream = SyntheticStream(n_points=self.n_points, seed=self.seed, fps=self.fps,
                                      keyint=self.keyint)

    def gt_pose(self, k):
        return self.stream.gt_pose(k)

    def frame(self, k):
        return self.stream.frame(k)

    def imu_window(self, k):
        """IMU samples over the interval (frame k-1, frame k]: gyro = body
        angular velocity, accel = specific force (world acceleration minus
        gravity, in the body frame). None for k == 0."""
        if k <= 0:
            return None
        fps = self.stream.fps
        n_sub = self.n_sub
        dt = 1.0 / (fps * n_sub)
        rows = np.zeros((n_sub, 7), np.float32)

        def center(tf):
            R, t = self.stream.gt_pose(tf)
            return -(R.T @ t)

        def R_wc(tf):
            R, _ = self.stream.gt_pose(tf)
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

    def items(self, n, start=0):
        """(timestamp, smv, imu) triples: the track_monocular_batch layout of
        an IMU_MONOCULAR system."""
        for k in range(start, start + n):
            smv = self.frame(k)
            yield smv.timestamp, smv, self.imu_window(k)
