"""Batched two-view reconstruction: essential-matrix RANSAC + pose recovery.

Port of movslam_tpu/ops/twoview.py (the monocular initializer,
TwoViewReconstruction.cc:38-245): 8-point hypotheses on RANSAC lanes,
Sampson MSAC scoring, two weighted refits, the 4-way (R, t) decomposition
and CheckRT's gates. The draw is injectable like ops/pnp.py:
`sampler(n_hyp, 8, n_valid)`.
"""
from __future__ import annotations

import torch

from .linalg import smallest_nullvec
from .triangulate import triangulate_rays

N_HYP = 384
SIGMA = 1.0  # inlier threshold in pixels (findEssentialMat's 1 px)
MIN_TRIANGULATED = 50
MIN_PARALLAX_DEG = 1.0
COS_HIGH_PARALLAX = 0.99998  # reference's "infinite point" guard


def _kron_rows(x1, x2):
    """Rows kron(x2, x1) of the epipolar constraint: (..., N, 3) -> (..., N, 9)."""
    return (x2[..., :, None] * x1[..., None, :]).flatten(-2)


def _sampson_err2(E, x1, x2):
    """Squared Sampson distances; E (B, 3, 3), x1/x2 (N, 3) -> (B, N)."""
    Ex1 = torch.einsum("bij,nj->bni", E, x1)
    Etx2 = torch.einsum("bji,nj->bni", E, x2)
    num = (x2 * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / den.clamp(min=1e-12)


def _decompose_E(E):
    """Four candidate (R, t) with ||t|| = 1 (Hartley-Zisserman)."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[:, 2]
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def _check_rt(R, t, r1, r2, mask, sigma2, fx, fy):
    """CheckRT (TwoViewReconstruction.cc:120-245) for one candidate.
    Returns (n_good, parallax_deg at the 50th-smallest, strong (N,), X (N,3))."""
    X = triangulate_rays(R, t, r1, r2)
    finite = torch.isfinite(X).all(-1) & (X.abs() < 1e6).all(-1)
    O2 = -R.T @ t
    n2 = X - O2[None]
    d1 = torch.linalg.vector_norm(X, dim=-1)
    d2 = torch.linalg.vector_norm(n2, dim=-1)
    cos_par = (X * n2).sum(-1) / (d1 * d2).clamp(min=1e-12)
    z1 = X[:, 2]
    Xc2 = X @ R.T + t
    z2 = Xc2[:, 2]
    far = cos_par >= COS_HIGH_PARALLAX
    front = ((z1 > 0) | far) & ((z2 > 0) | far)
    e1 = (r1[:, 0] - X[:, 0] / z1.clamp(min=1e-9)) ** 2 * fx * fx + (
        r1[:, 1] - X[:, 1] / z1.clamp(min=1e-9)) ** 2 * fy * fy
    e2 = (r2[:, 0] - Xc2[:, 0] / z2.clamp(min=1e-9)) ** 2 * fx * fx + (
        r2[:, 1] - Xc2[:, 1] / z2.clamp(min=1e-9)) ** 2 * fy * fy
    th2 = 4.0 * sigma2
    good = mask & finite & front & (e1 <= th2) & (e2 <= th2) & (z1 > 0) & (z2 > 0)
    strong = good & (cos_par < COS_HIGH_PARALLAX)
    n_good = good.to(torch.int32).sum()
    cp_sorted = torch.sort(torch.where(good, cos_par, torch.full_like(cos_par, 2.0))).values
    idx = torch.clamp(n_good - 1, min=0).clamp(max=MIN_TRIANGULATED)
    cp50 = cp_sorted[idx].clamp(-1.0, 1.0)
    parallax = torch.rad2deg(torch.arccos(cp50))
    parallax = torch.where(n_good > 0, parallax, torch.zeros_like(parallax))
    return n_good, parallax, strong, X


def reconstruct_two_views(uv1, uv2, valid, fx, fy, cx, cy, sampler):
    """Monocular initialization from matched pixels uv1 -> uv2 (N, 2).

    Returns dict(ok, R21, t21, points (N,3) in frame 1, triangulated (N,),
    n_inliers, n_good, parallax_deg)."""
    r1 = torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], dim=-1)
    r2 = torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], dim=-1)
    ones = torch.ones_like(r1[:, :1])
    x1 = torch.cat([r1, ones], dim=1)
    x2 = torch.cat([r2, ones], dim=1)

    n_valid = valid.to(torch.int32).sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    samp = order[sampler(N_HYP, 8, n_valid)]  # (H, 8)
    A = _kron_rows(x1[samp], x2[samp])  # (H, 8, 9)
    # Minimal samples solve the constraints exactly: no per-lane rank-2
    # projection (the winner is projected in the refit below).
    E = smallest_nullvec(A.transpose(1, 2) @ A, iters=4).reshape(-1, 3, 3)
    Es = E / torch.linalg.matrix_norm(E)[:, None, None].clamp(min=1e-12)

    f = 0.5 * (fx + fy)
    thr2 = (SIGMA / f) ** 2
    vf = valid.to(x1.dtype)
    err2 = _sampson_err2(Es, x1, x2)
    msac = (err2.clamp(max=thr2) * vf).sum(-1)
    best = torch.argmin(msac)
    mask = (err2[best] < thr2) & valid
    E_best = Es[best]

    A_all = _kron_rows(x1, x2)  # (N, 9)
    diag = torch.tensor([1.0, 1.0, 0.0], dtype=x1.dtype, device=x1.device)
    for _ in range(2):  # least-squares refit on the inliers, then rescore
        w = mask.to(x1.dtype)
        Er = smallest_nullvec((A_all * w[:, None]).T @ A_all, iters=4).reshape(3, 3)
        U, _, Vh = torch.linalg.svd(Er)
        E_best = U @ torch.diag(diag) @ Vh
        mask = (_sampson_err2(E_best[None], x1, x2)[0] < thr2) & valid
    n_inl = mask.to(torch.int32).sum()

    res = [_check_rt(R, t, r1, r2, mask, SIGMA * SIGMA, fx, fy) for R, t in _decompose_E(E_best)]
    n_goods = torch.stack([r[0] for r in res])
    pick = int(torch.argmax(n_goods))
    n_best = n_goods[pick]
    second = torch.sort(n_goods).values[-2]
    dominant = n_best > torch.clamp((9 * second) // 10, min=1)
    min_good = torch.clamp((3 * n_inl) // 4, min=MIN_TRIANGULATED)
    parallax = res[pick][1]
    ok = (n_inl > 0) & dominant & (n_best >= min_good) & (parallax > MIN_PARALLAX_DEG)
    R, t = _decompose_E(E_best)[pick]
    return {
        "ok": ok, "R21": R, "t21": t, "points": res[pick][3],
        "triangulated": res[pick][2] & ok, "n_inliers": n_inl,
        "n_good": n_best, "parallax_deg": parallax,
    }
