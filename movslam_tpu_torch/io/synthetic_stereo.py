"""Synthetic stereo MV stream: left frames with MVs + rendered right views.

The port's own copy of movslam_tpu/io/synthetic_stereo.py (numpy only), over
the port's io/synthetic.py.

Emulates the reference's frame-packed stereo input
(Examples/Stereo/stereo_video_tartan.cc:74-99): the left
frame carries motion vectors; the right frame is image-only (MV extraction
skipped) and offset by a horizontal baseline.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .mvimage import FrameType, MotionVectorImage
from .synthetic import SyntheticStream


@dataclasses.dataclass
class SyntheticStereoStream:
    n_points: int = 400
    seed: int = 0
    fps: float = 30.0
    baseline: float = 0.25  # meters (Stereo.b in the reference YAML)
    keyint: int = 1000

    def __post_init__(self):
        self.left = SyntheticStream(
            n_points=self.n_points, seed=self.seed, fps=self.fps, keyint=self.keyint
        )
        b = self.baseline

        base_pose = self.left.pose_fn

        def right_pose(t):
            R, tt = base_pose(t)
            # Right camera center is +b along the camera x-axis:
            # pc_right = pc_left - [b, 0, 0].
            return R, tt - np.array([b, 0, 0], np.float32)

        self.right = SyntheticStream(
            n_points=self.n_points, seed=self.seed, fps=self.fps,
            keyint=self.keyint, pose_fn=right_pose,
        )
        # Identical world: share points/patches/texture.
        self.right.points = self.left.points
        self.right.patches = self.left.patches
        self.right.bg_tex = self.left.bg_tex

    def gt_pose(self, k):
        return self.left.gt_pose(k)

    def pair(self, k):
        left = self.left.frame(k)
        right = MotionVectorImage.empty(self.right.width, self.right.height)
        right.frame_no = k
        right.timestamp = k / self.fps
        right.ft = left.ft
        img, _, _ = self.right.render(k)
        right.im_gray = img
        return left, right

    def pairs(self, n, start=0):
        for k in range(start, start + n):
            yield self.pair(k)
