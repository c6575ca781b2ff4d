"""The benchmark's frozen copy of the port's stereo stream: the right camera.

A copy of movslam_tpu_torch/io/synthetic_stereo.py (numpy only, no import of
the port) over traffic/synthetic.Scene; slambench/tests/test_slambench_traffic.py
holds the two equal. The right camera sees the left one's world (points,
patches and texture shared) and renders an image only, as the reference's
frame-packed stereo input does (Examples/Stereo/stereo_video_tartan.cc): the
left frame carries the motion vectors.

A rectified rig (the port's construction) moves the left camera `baseline` m
along its x axis. A raw rig, which the port rectifies from Stereo.T_c1_c2,
puts the right camera at T_c1_c2 (cam2 in cam1's frame) with its own
pinhole; the port's generator has no raw rig, so this one has no copy to be
held equal to.
"""
from __future__ import annotations

import copy

import numpy as np


def right_scene(scene, baseline):
    """The right camera of a rectified rig over `scene`."""
    right = copy.copy(scene)
    base_pose = scene.pose_fn

    def right_pose(t):
        R, tt = base_pose(t)
        # Right camera center is +b along the camera x-axis:
        # pc_right = pc_left - [b, 0, 0].
        return R, tt - np.array([baseline, 0, 0], np.float32)

    right.pose_fn = right_pose
    return right


def raw_right_scene(scene, camera2, T_c1_c2):
    """The right camera of a raw rig over `scene`: pinhole `camera2`
    (synthetic.Camera) at T_c1_c2 (4, 4), which maps cam2 points to cam1."""
    T21 = np.linalg.inv(np.asarray(T_c1_c2, np.float64))
    R21, t21 = T21[:3, :3], T21[:3, 3]
    right = copy.copy(scene)
    right.camera, right.width, right.height = camera2, camera2.width, camera2.height
    base_pose = scene.pose_fn

    def right_pose(t):
        R, tt = base_pose(t)
        return (R21 @ R).astype(np.float32), (R21 @ tt + t21).astype(np.float32)

    right.pose_fn = right_pose
    return right

