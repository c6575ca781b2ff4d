"""Batched two-view DLT triangulation.

Port of movslam_tpu/ops/triangulate.py: one batched 4x4 null-space solve
(shifted inverse iteration, ops/linalg.smallest_nullvec) over all matches.
Degenerate points come back huge; callers gate them by depth and
reprojection like the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .linalg import smallest_nullvec

MAX_PAIRS = 8192  # largest triangulation batch of the reference (_PAIR_BUCKETS)


def _solve_dlt(A):
    """Dehomogenized least-squares solution of A X = 0 for A (..., 4, 4)."""
    X = smallest_nullvec(A.transpose(-1, -2) @ A, iters=4)
    w = X[..., 3]
    safe_w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / safe_w[..., None]


def triangulate(P1, P2, x1, x2):
    """DLT triangulation: P1, P2 (3, 4); x1, x2 (N, 2) -> (N, 3)."""
    rows = [
        x1[:, 0:1] * P1[2:3] - P1[0:1],
        x1[:, 1:2] * P1[2:3] - P1[1:2],
        x2[:, 0:1] * P2[2:3] - P2[0:1],
        x2[:, 1:2] * P2[2:3] - P2[1:2],
    ]
    return _solve_dlt(torch.stack(rows, dim=1))


def triangulate_pairs(P1, P2s, x1, x2):
    """Triangulation with a per-pair second camera: P2s (N, 3, 4)."""
    rows = [
        x1[:, 0:1, None] * P1[None, 2:3] - P1[None, 0:1],
        x1[:, 1:2, None] * P1[None, 2:3] - P1[None, 1:2],
        x2[:, 0:1, None] * P2s[:, 2:3] - P2s[:, 0:1],
        x2[:, 1:2, None] * P2s[:, 2:3] - P2s[:, 1:2],
    ]
    return _solve_dlt(torch.cat(rows, dim=1))


def triangulate_pairs_np(P1, P2s, x1, x2, device):
    """Host helper (counterpart of the reference's triangulate_pairs_padded):
    numpy in, f32 numpy out, at most MAX_PAIRS pairs. Eager PyTorch needs
    no shape buckets, so nothing is padded."""
    n = min(x1.shape[0], MAX_PAIRS)
    if n == 0:
        return np.zeros((0, 3), np.float32)
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    X = triangulate_pairs(f32(P1), f32(P2s[:n]), f32(x1[:n]), f32(x2[:n]))
    return X.cpu().numpy()


def triangulate_rays(R21, t21, r1, r2):
    """Triangulate normalized rays with camera 1 at identity; points in the
    camera-1 frame (N, 3)."""
    eye = torch.eye(3, dtype=R21.dtype, device=R21.device)
    P1 = torch.cat([eye, torch.zeros_like(eye[:, :1])], dim=1)
    P2 = torch.cat([R21, t21.reshape(3, 1)], dim=1)
    return triangulate(P1, P2, r1, r2)
