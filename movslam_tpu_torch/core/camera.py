"""Pinhole camera model (numpy).

Port of movslam_tpu/core/camera.py without its JAX branches: the port's
device code takes intrinsics as tensors, so the host model is numpy only.
Distortion is handled by undistorting keypoints (Frame.cc:682-713).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Pinhole:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480
    dist: tuple = ()  # (k1, k2, p1, p2[, k3]); empty means rectified

    def K(self):
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32)

    def undistort_points(self, uv):
        """Iteratively undistort pixel coords; a no-op without distortion."""
        if not self.dist or not any(self.dist):
            return uv
        k1, k2, p1, p2, k3 = (list(self.dist) + [0.0] * 5)[:5]
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        x0, y0 = x.copy(), y.copy()
        for _ in range(8):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x = (x0 - dx) / radial
            y = (y0 - dy) / radial
        return np.stack([x * self.fx + self.cx, y * self.fy + self.cy], axis=-1).astype(np.float32)

    def undistorted_bounds(self):
        """(minx, maxx, miny, maxy) of the undistorted image
        (Frame::ComputeImageBounds)."""
        if not self.dist or not any(self.dist):
            return (0.0, float(self.width), 0.0, float(self.height))
        corners = np.array(
            [[0.0, 0.0], [self.width, 0.0], [0.0, self.height], [self.width, self.height]],
            np.float32,
        )
        cu = self.undistort_points(corners)
        return (
            float(min(cu[0, 0], cu[2, 0])), float(max(cu[1, 0], cu[3, 0])),
            float(min(cu[0, 1], cu[1, 1])), float(max(cu[2, 1], cu[3, 1])),
        )

    def in_image(self, uv, margin=0):
        return (
            (uv[..., 0] >= margin) & (uv[..., 0] < self.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < self.height - margin)
        )
