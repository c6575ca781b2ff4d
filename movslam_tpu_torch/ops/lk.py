"""Batched pyramidal Lucas-Kanade optical flow.

Port of movslam_tpu/ops/lk.py (cv::calcOpticalFlowPyrLK replacement):
31x31 window, 3 levels, 20 iterations with masked convergence, min-eigen
gate 1e-4. Each level extracts ONE LOCAL x LOCAL window per point from each
image and iterates inside it; flow beyond the window's slack clamps — that
LOCAL = 64 clamp is behaviour of the reference and is kept.
"""
from __future__ import annotations

import torch

from .image import bilinear_grid, build_pyramid, sample_patches

WIN_HALF = 15  # 31x31 window
LEVELS = 3
ITERS = 20
EPS = 0.01
MIN_EIG = 1e-4
LOCAL = 64  # per-point local window side extracted once per level


def _edge_diff(P, dim):
    """Central difference with edge padding along `dim` (1 = rows, 2 = cols)."""
    n = P.shape[dim]
    fwd = torch.cat([P.narrow(dim, 1, n - 1), P.narrow(dim, n - 1, 1)], dim=dim)
    bwd = torch.cat([P.narrow(dim, 0, 1), P.narrow(dim, 0, n - 1)], dim=dim)
    return 0.5 * (fwd - bwd)


def _lk_level(prev_img, cur_img, pts_prev, guess, valid, half, iters):
    """One pyramid level; returns (flow (N, 2), min_eig (N,))."""
    Lh = LOCAL // 2
    Pwin = sample_patches(prev_img, pts_prev, Lh - 1)  # (N, L, L)
    L = Pwin.shape[1]
    K = 2 * half + 1
    c0 = (L - 1) // 2 - half
    T = Pwin[:, c0 : c0 + K, c0 : c0 + K]
    Gx = _edge_diff(Pwin, 2)[:, c0 : c0 + K, c0 : c0 + K]
    Gy = _edge_diff(Pwin, 1)[:, c0 : c0 + K, c0 : c0 + K]
    Jwin = sample_patches(cur_img, pts_prev + guess, Lh - 1)  # (N, L, L)
    slack = (L - K) // 2 - 1

    gxx = (Gx * Gx).sum(dim=(1, 2))
    gxy = (Gx * Gy).sum(dim=(1, 2))
    gyy = (Gy * Gy).sum(dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    inv_scale = 1.0 / det.clamp(min=1e-12)
    tr = gxx + gyy
    disc = torch.sqrt(((gxx - gyy) ** 2 + 4 * gxy * gxy).clamp(min=0.0))
    min_eig = 0.5 * (tr - disc) / (K * K)

    dev = Pwin.device
    d = torch.arange(K, dtype=torch.float32, device=dev) - half
    top = torch.tensor(L - 1.000001, dtype=torch.float32, device=dev)
    lo, hi = guess - slack, guess + slack
    flow = guess
    active = valid & (det > 1e-12)
    for _ in range(iters):
        local = (flow - guess + (L - 1) / 2.0).clamp(half, L - 1 - half)
        ys = torch.minimum((local[:, 1, None] + d).clamp(min=0.0), top)
        xs = torch.minimum((local[:, 0, None] + d).clamp(min=0.0), top)
        J = bilinear_grid(Jwin, ys, xs)
        diff = T - J
        bx = (diff * Gx).sum(dim=(1, 2))
        by = (diff * Gy).sum(dim=(1, 2))
        step = torch.stack(
            [(gyy * bx - gxy * by) * inv_scale, (gxx * by - gxy * bx) * inv_scale], dim=-1
        )
        step = torch.where(active[:, None], step, torch.zeros_like(step))
        flow = torch.minimum(torch.maximum(flow + step, lo), hi)
        active = active & ((step * step).sum(-1) >= EPS * EPS)
    return flow, min_eig


def lk_track(prev_img, cur_img, pts, valid):
    """Track pts (N, 2) from prev_img to cur_img (both (H, W) u8 or f32).

    Returns (new_pts (N, 2) f32, status (N,) bool): inside the image and
    min-eigenvalue > 1e-4 at the finest level (MOVExtractor.cc:98)."""
    H, W = cur_img.shape
    prev_pyr = build_pyramid(prev_img, LEVELS)
    cur_pyr = build_pyramid(cur_img, LEVELS)
    flow = torch.zeros_like(pts)
    min_eig = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
    for lvl in range(LEVELS - 1, -1, -1):
        flow, min_eig = _lk_level(
            prev_pyr[lvl], cur_pyr[lvl], pts / 2.0**lvl, flow, valid, WIN_HALF, ITERS
        )
        if lvl > 0:
            flow = flow * 2.0
    new_pts = pts + flow
    inb = (new_pts[:, 0] >= 0) & (new_pts[:, 1] >= 0) & (new_pts[:, 0] < W) & (new_pts[:, 1] < H)
    return new_pts, valid & inb & (min_eig > MIN_EIG)
