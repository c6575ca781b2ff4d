"""Batched small-matrix linear algebra.

Port of movslam_tpu/ops/linalg.py. The reference unrolls its Cholesky to
keep LAPACK custom calls off the TPU's scalar core; here the column loop is
vectorised over rows, and — as in the reference — it never fails: pivots
are floored at 1e-20 and non-finite inverse-iteration lanes are reset, so
degenerate RANSAC samples lose the vote instead of raising.
"""
from __future__ import annotations

import torch


def det3x3(A):
    """Batched 3x3 determinant (closed form)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3x3(A, eps=0.0):
    """Batched 3x3 inverse via the adjugate; eps > 0 floors |det| (the
    result for a singular block is finite garbage the caller masks)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    if eps:
        floor = torch.where(det < 0, torch.full_like(det, -eps), torch.full_like(det, eps))
        det = torch.where(det.abs() < eps, floor, det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return adj * (1.0 / det)[..., None, None]


def cholesky_unrolled(S):
    """Batched lower Cholesky factor of small SPD matrices (..., n, n).
    Pivots are floored at 1e-20 (never raises, like the reference)."""
    n = S.shape[-1]
    L = torch.zeros_like(S)
    for j in range(n):
        s = S[..., j, j] - (L[..., j, :j] * L[..., j, :j]).sum(-1)
        d = torch.sqrt(s.clamp(min=1e-20))
        L[..., j, j] = d
        if j + 1 < n:
            col = S[..., j + 1 :, j] - (L[..., j + 1 :, :j] * L[..., j, None, :j]).sum(-1)
            L[..., j + 1 :, j] = col / d[..., None]
    return L


def chol_substitute(L, b):
    """Solve L L^T x = b with a factor from cholesky_unrolled; b (..., n)."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        y[..., i] = (b[..., i] - (L[..., i, :i] * y[..., :i]).sum(-1)) / L[..., i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[..., i] = (y[..., i] - (L[..., i + 1 :, i] * x[..., i + 1 :]).sum(-1)) / L[..., i, i]
    return x


def chol_solve_small(S, b):
    """Batched SPD solve for small n."""
    return chol_substitute(cholesky_unrolled(S), b)


def solve_psd(S, b):
    """SPD solve of one (n, n) system via Cholesky. A system that is not
    positive definite yields NaNs (as the reference's XLA Cholesky does),
    which the caller rejects."""
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def smallest_nullvec(AtA, iters=4, ridge=1e-5):
    """Batched smallest eigenvector of small SPD Gram matrices by shifted
    inverse iteration on the Cholesky factor. Returns unit (..., n) vectors;
    non-finite lanes are reset to a harmless direction."""
    n = AtA.shape[-1]
    tr = AtA.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(n, dtype=AtA.dtype, device=AtA.device)
    L = cholesky_unrolled(AtA + (ridge * tr / n + 1e-20) * eye)
    v = (torch.arange(1, n + 1, dtype=AtA.dtype, device=AtA.device) / n).expand(AtA.shape[:-1])
    for _ in range(iters):
        v = chol_substitute(L, v)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)
        v = torch.where(torch.isfinite(v), v, torch.full_like(v, 1.0 / n))
    return v
