"""Stereo depth from batched left->right LK matching (the per-frame path).

Port of movslam_tpu/core/stereo.py, which replaces
Frame::ComputeStereoMatches (Frame.cc:281-354): one batched LK call from the
left features into the right image, a y-epipolar gate, disparity bounds and a
median-distance outlier trim. The windowed path computes the same inside the
frame program (ops/frame_step stage 1c), where the median is the lower middle
of a sort; here it is `np.median`, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.lk import lk_track

EPIPOLAR_Y = 2.0  # max |dy| of a rectified match
MIN_DISPARITY = 0.1
CAP = 2048  # LK batch size (the track capacity)


def compute_stereo_depth(frame, img_left, img_right, settings, device):
    """Fill frame.depth_right / frame.uright (-1 = none) from a rectified
    pair. The images are (H, W) arrays or tensors; LK runs on `device`."""
    n = frame.n
    frame.depth_right = np.full(n, -1.0, np.float64)
    frame.uright = np.full(n, -1.0, np.float64)
    if n == 0 or settings.bf <= 0:
        return
    pts = np.zeros((CAP, 2), np.float32)
    valid = np.zeros(CAP, bool)
    k = min(n, CAP)
    src = frame.pts_raw if len(frame.pts_raw) else frame.pts
    pts[:k] = src[:k]
    valid[:k] = True

    out_pts, status = lk_track(
        torch.as_tensor(img_left, device=device).to(torch.float32),
        torch.as_tensor(img_right, device=device).to(torch.float32),
        torch.as_tensor(pts, device=device), torch.as_tensor(valid, device=device),
    )
    out = out_pts.cpu().numpy()[:k]
    ok = status.cpu().numpy()[:k]

    dy = np.abs(out[:, 1] - pts[:k, 1])
    disp = pts[:k, 0] - out[:, 0]
    good = ok & (dy < EPIPOLAR_Y) & (disp > MIN_DISPARITY) & (disp < settings.bf)
    depth = np.where(good, settings.bf / np.maximum(disp, MIN_DISPARITY), -1.0)
    # Median-distance outlier trim (Frame.cc:334-352).
    if good.sum() > 10:
        good &= depth < 6.0 * np.median(depth[good])
        depth = np.where(good, depth, -1.0)
    frame.depth_right[:k] = depth
    frame.uright[:k] = np.where(good, out[:, 0], -1.0)
