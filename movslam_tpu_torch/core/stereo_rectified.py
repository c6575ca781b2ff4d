"""Apply stereo rectification to decoded frames + their MV side data.

The port's own copy of movslam_tpu/core/stereo_rectified.py (numpy only; the
dense remap stays on the host as in the reference).

The reference computes rectification maps for raw PinHole rigs but never
consumes them (Settings.cc:430-465 builds M1l_/M2l_; the M1l() getter has no
call site) — its stereo examples run on pre-rectified streams. This module
completes the path: decoded frames are remapped into the rectified geometry
and the codec's motion-vector side data — which lives in RAW pixel
coordinates — is coordinate-transformed to match (a sparse transform of
rect corners and flow endpoints; remapping dense MV fields would be
meaningless since the codec's block grid doesn't survive the warp).
"""
from __future__ import annotations

import numpy as np

from ..config.rectify import rectify_points, remap_bilinear


def _transform_rects(rects_x0y0x1y1, n, K, dist, R, P):
    """Axis-aligned bounding box of each rect's 4 rectified corners."""
    r = rects_x0y0x1y1[:n]
    corners = np.stack(
        [
            r[:, [0, 1]], r[:, [2, 1]], r[:, [0, 3]], r[:, [2, 3]],
        ],
        axis=1,
    ).reshape(-1, 2)
    rc = rectify_points(corners, K, dist, R, P).reshape(-1, 4, 2)
    out = np.empty_like(r)
    out[:, 0] = rc[:, :, 0].min(axis=1)
    out[:, 1] = rc[:, :, 1].min(axis=1)
    out[:, 2] = rc[:, :, 0].max(axis=1)
    out[:, 3] = rc[:, :, 1].max(axis=1)
    return out


def rectify_pair(smv_left, smv_right, settings):
    """Rectify a decoded stereo pair IN PLACE (gray images + left MV data;
    the port's MotionVectorImage carries no colour image).

    Left images sample through camera1's map, right through camera2's; the
    left frame's MV deltas/rects/kps transform through camera1's forward
    point map: delta' = F(p) - F(p - delta) evaluated at the destination
    block center (flow is locally rigid at macroblock scale, so endpoint
    transformation preserves the chain-propagation semantics,
    VideoDecoder.cc:220-224)."""
    if not settings.need_rectify or getattr(smv_left, "_rectified", False):
        return smv_left, smv_right
    smv_left._rectified = True
    maps = settings.rectify_maps()
    r = settings.rectification
    K1, d1, R1, P1 = r["K1"], r["dist1"], r["R1"], r["P1"]

    smv_left.im_gray = remap_bilinear(smv_left.im_gray, *maps["left"])
    if smv_right is not None and smv_right.im_gray is not None:
        smv_right.im_gray = remap_bilinear(smv_right.im_gray, *maps["right"])

    n = smv_left.n_mvs
    if n:
        rects = smv_left.mv_rect
        centers = np.stack(
            [
                0.5 * (rects[:n, 0] + rects[:n, 2]),
                0.5 * (rects[:n, 1] + rects[:n, 3]),
            ],
            axis=1,
        )
        dst = centers + smv_left.mv_delta[:n]
        c_rect = rectify_points(centers, K1, d1, R1, P1)
        d_rect = rectify_points(dst, K1, d1, R1, P1)
        smv_left.mv_delta[:n] = (d_rect - c_rect).astype(np.float32)
        smv_left.mv_rect[:n] = _transform_rects(rects, n, K1, d1, R1, P1)
    k = smv_left.n_kps
    if k:
        kr = smv_left.kps_rect[:k]
        as_bounds = np.stack(
            [kr[:, 0], kr[:, 1], kr[:, 0] + kr[:, 2], kr[:, 1] + kr[:, 3]],
            axis=1,
        )
        tb = _transform_rects(as_bounds, k, K1, d1, R1, P1)
        smv_left.kps_rect[:k] = np.stack(
            [tb[:, 0], tb[:, 1], tb[:, 2] - tb[:, 0], tb[:, 3] - tb[:, 1]],
            axis=1,
        )
    return smv_left, smv_right
