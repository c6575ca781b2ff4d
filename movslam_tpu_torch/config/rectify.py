"""Stereo rectification from raw (unrectified) calibrated pairs.

The port's own copy of movslam_tpu/config/rectify.py (numpy only, host).

The reference precomputes rectification maps and updated calibration for
PinHole stereo rigs from `Stereo.T_c1_c2`
(src/Settings.cc:430-465: cv::stereoRectify +
cv::initUndistortRectifyMap, CALIB_ZERO_DISPARITY; updated fx/fy/cx/cy and
bf at Settings.cc:459-465) — this module is a clean-room NumPy
implementation of the same Bouguet construction: rotate each camera half-way
toward the other, then align both with the baseline so epipolar lines become
image rows. Beyond the reference (whose maps have no consumer — `M1l()` is
never called), the maps here are actually APPLIED by the stereo path
(core/stereo_rectified.py): dense image remap plus a sparse coordinate
transform for the codec's MV data, which lives in unrectified pixel space.

No OpenCV: the constants below reproduce cv::stereoRectify's geometry
(half-rotation split, baseline alignment, ZERO_DISPARITY shared principal
point, new focal from the y-focals shrunk by negative radial distortion).
"""
from __future__ import annotations

import numpy as np


def rodrigues_vec_to_mat(w):
    """Rotation vector -> matrix (Rodrigues)."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64
    )
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def rodrigues_mat_to_vec(R):
    """Rotation matrix -> vector (log map)."""
    R = np.asarray(R, np.float64)
    c = (np.trace(R) - 1.0) / 2.0
    c = np.clip(c, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    if th > np.pi - 1e-6:
        # Near-pi: extract axis from R + I.
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # Fix signs from off-diagonals.
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], A[1, 2])
        return th * axis / max(np.linalg.norm(axis), 1e-12)
    v = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], np.float64
    )
    return v * (th / (2.0 * np.sin(th)))


def _distort(x, y, dist):
    """Apply Brown-Conrady distortion to normalized coords.
    dist = (k1, k2, p1, p2[, k3])."""
    d = list(dist) + [0.0] * (5 - len(dist))
    k1, k2, p1, p2, k3 = d[:5]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def _undistort(xd, yd, dist, iters=24):
    """Iterative inverse of _distort (cv::undistortPoints-style fixed
    point)."""
    d = list(dist) + [0.0] * (5 - len(dist))
    k1, k2, p1, p2, k3 = d[:5]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def stereo_rectify(K1, dist1, K2, dist2, size, R, t):
    """Bouguet stereo rectification (cv::stereoRectify semantics,
    CALIB_ZERO_DISPARITY, alpha=-1 default scaling ignored: the new focal
    follows the reference's operating regime of same-sensor rigs).

    K1, K2 : (3,3) intrinsics; dist1, dist2 : Brown-Conrady tuples;
    size   : (width, height); R, t : cam1 -> cam2 transform (x2 = R x1 + t).
    Returns dict(R1, R2, P1, P2): per-camera rectifying rotations and new
    projection matrices (P2[0,3] carries -fx * baseline).
    """
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64).reshape(3)
    nx, ny = size

    # Split the inter-camera rotation evenly (each camera turns half-way).
    om = rodrigues_mat_to_vec(R)
    r_half = rodrigues_vec_to_mat(-0.5 * om)
    t_r = r_half @ t

    # Align the dominant baseline axis with the image x (or y) axis.
    idx = 0 if abs(t_r[0]) > abs(t_r[1]) else 1
    c = t_r[idx]
    nt = np.linalg.norm(t_r)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t_r, uu)
    nw = np.linalg.norm(ww)
    if nw > 1e-12:
        ww *= np.arccos(min(abs(c) / max(nt, 1e-12), 1.0)) / nw
    wR = rodrigues_vec_to_mat(ww)
    R1 = wR @ r_half.T
    R2 = wR @ r_half

    # New focal: y-focals shrunk by negative leading radial distortion
    # (barrel lenses lose effective focal toward the border).
    fc_new = np.inf
    for K, dist in ((K1, dist1), (K2, dist2)):
        fc = K[1, 1]
        k1 = dist[0] if len(dist) else 0.0
        if k1 < 0:
            fc *= 1.0 + k1 * (nx * nx + ny * ny) / (4.0 * fc * fc)
        fc_new = min(fc_new, fc)

    # New principal point: center the undistorted-rotated corner cloud of
    # each image; ZERO_DISPARITY shares one principal point for both.
    cc = np.zeros((2, 2))
    for k, (K, dist, Rk) in enumerate(
        ((K1, dist1, R1), (K2, dist2, R2))
    ):
        corners = np.array(
            [[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], np.float64
        )
        xn = (corners[:, 0] - K[0, 2]) / K[0, 0]
        yn = (corners[:, 1] - K[1, 2]) / K[1, 1]
        xu, yu = _undistort(xn, yn, dist)
        pts = np.stack([xu, yu, np.ones_like(xu)], axis=1) @ Rk.T
        u = fc_new * pts[:, 0] / pts[:, 2]
        v = fc_new * pts[:, 1] / pts[:, 2]
        cc[k, 0] = (nx - 1) / 2.0 - u.mean()
        cc[k, 1] = (ny - 1) / 2.0 - v.mean()
    cc[:] = cc.mean(axis=0)  # CALIB_ZERO_DISPARITY

    P1 = np.array(
        [
            [fc_new, 0, cc[0, 0], 0],
            [0, fc_new, cc[0, 1], 0],
            [0, 0, 1, 0],
        ],
        np.float64,
    )
    P2 = P1.copy()
    P2[idx, 3] = t_r[idx] * fc_new  # baseline term (cam2 offset)
    return {"R1": R1, "R2": R2, "P1": P1, "P2": P2, "fc_new": fc_new}


def init_rectify_map(K, dist, Rk, P, size):
    """Inverse rectification map (cv::initUndistortRectifyMap): for each
    RECTIFIED pixel, the source (raw) pixel to sample. Returns (map_x,
    map_y) float32 arrays of shape (height, width)."""
    nx, ny = size
    u, v = np.meshgrid(
        np.arange(nx, dtype=np.float64), np.arange(ny, dtype=np.float64)
    )
    fx_p, fy_p = P[0, 0], P[1, 1]
    cx_p, cy_p = P[0, 2], P[1, 2]
    x = (u - cx_p) / fx_p
    y = (v - cy_p) / fy_p
    pts = np.stack([x, y, np.ones_like(x)], axis=-1) @ Rk  # R^-1 = R.T rows
    xr = pts[..., 0] / pts[..., 2]
    yr = pts[..., 1] / pts[..., 2]
    xd, yd = _distort(xr, yr, dist)
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def rectify_points(pts, K, dist, Rk, P):
    """Forward transform: raw pixels -> rectified pixels (sparse analogue of
    the dense remap; used for the codec's MV coordinates, which live in the
    unrectified image). pts: (N, 2)."""
    pts = np.asarray(pts, np.float64)
    xn = (pts[:, 0] - K[0, 2]) / K[0, 0]
    yn = (pts[:, 1] - K[1, 2]) / K[1, 1]
    xu, yu = _undistort(xn, yn, dist)
    p = np.stack([xu, yu, np.ones_like(xu)], axis=1) @ Rk.T
    u = P[0, 0] * p[:, 0] / p[:, 2] + P[0, 2]
    v = P[1, 1] * p[:, 1] / p[:, 2] + P[1, 2]
    return np.stack([u, v], axis=1)


def remap_bilinear(img, map_x, map_y):
    """Dense bilinear remap (cv::remap equivalent): out[i,j] =
    img(map_y[i,j], map_x[i,j]), zero outside."""
    H, W = img.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    ax = (map_x - x0).astype(np.float32)
    ay = (map_y - y0).astype(np.float32)
    valid = (x0 >= 0) & (x0 < W - 1) & (y0 >= 0) & (y0 < H - 1)
    x0c = np.clip(x0, 0, W - 2)
    y0c = np.clip(y0, 0, H - 2)
    f = img.astype(np.float32)
    v00 = f[y0c, x0c]
    v01 = f[y0c, x0c + 1]
    v10 = f[y0c + 1, x0c]
    v11 = f[y0c + 1, x0c + 1]
    out = (
        v00 * (1 - ax) * (1 - ay)
        + v01 * ax * (1 - ay)
        + v10 * (1 - ax) * ay
        + v11 * ax * ay
    )
    out = np.where(valid, out, 0.0)
    if img.dtype == np.uint8:
        return np.clip(out + 0.5, 0, 255).astype(np.uint8)
    return out.astype(img.dtype)
