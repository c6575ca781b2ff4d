"""Batched RANSAC PnP + Huber Gauss-Newton polish (mono and stereo rows).

Port of movslam_tpu/ops/pnp.py (cv::solvePnPRansac replacement,
Optimizer.cc:397-459): a fixed block of 6-point DLT hypotheses plus the
prior pose, MSAC scoring of all of them at once, and Gauss-Newton on the
top two. The random draw is injectable: `sampler(n_hyp, sample, n_valid)`
returns (n_hyp, sample) int positions below n_valid. `make_sampler` draws
from a torch.Generator; tests pass one that replays the reference's
`jax.random.randint` draws.
"""
from __future__ import annotations

import math

import torch

from .lie import hat, project_to_so3, se3_compose, se3_exp
from .linalg import chol_solve_small, chol_substitute, cholesky_unrolled, det3x3

N_HYP = 256  # RANSAC hypothesis lanes
SAMPLE = 6  # DLT sample size
GN_ITERS = 10


def make_sampler(generator):
    """Uniform positions below n_valid (a tensor) drawn from `generator`,
    without a host sync."""
    def sampler(n_hyp, sample, n_valid):
        hi = n_valid.clamp(min=1).to(torch.float32)
        u = torch.rand((n_hyp, sample), generator=generator, device=generator.device)
        return torch.minimum((u * hi).to(torch.int64), (hi - 1).to(torch.int64))
    return sampler


def _dlt_pose(pw, rays):
    """Batched DLT for [R|t]: pw (B, S, 3) world points, rays (B, S, 2)
    normalized coords. Hartley-normalized; the null vector of A^T A comes
    from 6 steps of shifted inverse iteration. Returns (R (B,3,3), t (B,3))."""
    B, S, _ = pw.shape
    c = pw.mean(dim=1, keepdim=True)
    sc = (torch.linalg.vector_norm(pw - c, dim=-1).mean(dim=1) / math.sqrt(3.0)).clamp(min=1e-6)
    pwn = (pw - c) / sc[:, None, None]
    X = torch.cat([pwn, torch.ones_like(pwn[..., :1])], dim=-1)  # (B, S, 4)
    zero = torch.zeros_like(X)
    u, v = rays[..., 0:1], rays[..., 1:2]
    A = torch.cat(
        [torch.cat([X, zero, -u * X], dim=-1), torch.cat([zero, X, -v * X], dim=-1)], dim=1
    )  # (B, 2S, 12)
    AtA = A.transpose(1, 2) @ A
    tscale = AtA.diagonal(dim1=-2, dim2=-1).sum(-1) / 12.0
    eye = torch.eye(12, dtype=pw.dtype, device=pw.device)
    L = cholesky_unrolled(AtA + (1e-7 * tscale + 1e-12)[:, None, None] * eye)
    p = torch.ones((B, 12), dtype=pw.dtype, device=pw.device)
    for _ in range(6):
        p = chol_substitute(L, p)
        p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp(min=1e-20)
        # Degenerate samples give non-finite solves: reset those lanes.
        p = torch.where(torch.isfinite(p), p, torch.ones_like(p))
    Pn_ = p.reshape(B, 3, 4)
    M_ = Pn_[:, :, :3] / sc[:, None, None]
    t_ = Pn_[:, :, 3] - (Pn_[:, :, :3] @ c[:, 0, :, None])[..., 0] / sc[:, None]
    P = torch.cat([M_, t_[..., None]], dim=-1)
    M = P[:, :, :3]
    scale = torch.pow(det3x3(M).abs() + 1e-12, 1.0 / 3.0)
    sign = torch.sign(((pw @ M[:, 2, :, None])[..., 0] + P[:, 2, 3:4]).sum(-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    Pn = P * (sign / scale)[:, None, None]
    return project_to_so3(Pn[:, :, :3]), Pn[:, :, 3]


def _reproj_err2(R, t, pw, uv, fx, fy, cx, cy, ur=None, bf=0.0):
    """Squared pixel reprojection errors: R (B,3,3), t (B,3) -> (B, N).
    With ur (N,), stereo rows (ur >= 0) add the right-image column residual
    (u - bf/z - ur)^2. Non-finite errors and points behind the camera score
    1e12 so a NaN lane never wins the MSAC argmin."""
    pc = torch.einsum("bij,nj->bni", R, pw) + t[:, None, :]
    z = pc[..., 2].clamp(min=1e-6)
    u = fx * pc[..., 0] / z + cx
    du = u - uv[:, 0]
    dv = fy * pc[..., 1] / z + cy - uv[:, 1]
    err2 = du * du + dv * dv
    if ur is not None:
        dr = (u - bf / z - ur) * (ur >= 0).to(err2.dtype)
        err2 = err2 + dr * dr
    big = torch.full_like(err2, 1e12)
    err2 = torch.where(torch.isfinite(err2), err2, big)
    return torch.where(pc[..., 2] <= 0, big, err2)


def _gn_refine(R, t, pw, uv, weight, fx, fy, cx, cy, huber_delta, iters=GN_ITERS,
               ur=None, bf=0.0):
    """Huber-weighted Gauss-Newton pose polish, batched over lanes:
    R (B,3,3), t (B,3), weight (B, N). With ur (N,), stereo rows (ur >= 0)
    add the right-column residual as a third row."""
    if ur is not None:
        stereo = (ur >= 0).to(pw.dtype)
        ur_safe = ur.clamp(min=0.0)
    eye6 = torch.eye(6, dtype=pw.dtype, device=pw.device)
    eye3 = torch.eye(3, dtype=pw.dtype, device=pw.device)
    for _ in range(iters):
        pc = torch.einsum("bij,nj->bni", R, pw) + t[:, None, :]
        iz = 1.0 / pc[..., 2].clamp(min=1e-6)
        x, y = pc[..., 0], pc[..., 1]
        u = fx * x * iz + cx
        rows = [u - uv[:, 0], fy * y * iz + cy - uv[:, 1]]
        if ur is not None:
            rows.append((u - bf * iz - ur_safe) * stereo)
        r = torch.stack(rows, dim=-1)  # (B, N, 2|3)
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = weight * torch.clamp(huber_delta / rn.clamp(min=1e-9), max=1.0)
        zero = torch.zeros_like(iz)
        jrows = [
            torch.stack([fx * iz, zero, -fx * x * iz * iz], -1),
            torch.stack([zero, fy * iz, -fy * y * iz * iz], -1),
        ]
        if ur is not None:
            jrows.append(
                torch.stack(
                    [fx * iz * stereo, zero, (-fx * x * iz * iz + bf * iz * iz) * stereo], -1
                )
            )
        J_pc = torch.stack(jrows, dim=-2)  # (B, N, 2|3, 3)
        J_xi = torch.cat([eye3.expand(pc.shape[:-1] + (3, 3)), -hat(pc)], dim=-1)
        J = J_pc @ J_xi  # (B, N, 2|3, 6)
        Jw = J * w[..., None, None]
        H = torch.einsum("bnij,bnik->bjk", Jw, J) + 1e-6 * eye6
        g = torch.einsum("bnij,bni->bj", Jw, r)
        dR, dt = se3_exp(-chol_solve_small(H, g))
        R, t = se3_compose(dR, dt, R, t)
    return R, t


def pnp_ransac(pw, uv, valid, fx, fy, cx, cy, reproj_err, R_init, t_init, sampler,
               ur=None, bf=0.0):
    """Robust PnP.

    pw (N, 3) world points; uv (N, 2) pixels; valid (N,) bool; R_init/t_init:
    the prior pose, scored as one extra hypothesis lane. ur (N,) is the
    right-image column of stereo rows (< 0 = mono row) and bf the rig's
    baseline * fx; both enter the scoring and the polish.
    Returns dict(R, t, inliers (N,) bool, n_inliers i32, ok bool)."""
    n_valid = valid.to(torch.int32).sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid first
    samp_idx = order[sampler(N_HYP, SAMPLE, n_valid)]  # (N_HYP, SAMPLE)

    rays = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=-1)
    Rh, th = _dlt_pose(pw[samp_idx], rays[samp_idx])
    Rh = torch.cat([Rh, R_init[None]], dim=0)
    th = torch.cat([th, t_init[None]], dim=0)

    # MSAC: truncated squared error (continuous, stable under float noise).
    thr2 = reproj_err * reproj_err
    err2 = _reproj_err2(Rh, th, pw, uv, fx, fy, cx, cy, ur, bf)  # (N_HYP + 1, N)
    vf = valid.to(err2.dtype)
    inl = (err2 < thr2) & valid[None, :]
    msac = (err2.clamp(max=thr2) * vf).sum(-1)
    best = torch.argmin(msac)

    # LO-RANSAC on the top two, reselected on the polished scores.
    top2 = torch.argsort(msac, stable=True)[:2]
    R2, t2 = _gn_refine(
        Rh[top2], th[top2], pw, uv, inl[top2].to(pw.dtype), fx, fy, cx, cy,
        huber_delta=math.sqrt(thr2), ur=ur, bf=bf,
    )
    err2_r = _reproj_err2(R2, t2, pw, uv, fx, fy, cx, cy, ur, bf)
    inl_r = (err2_r < thr2) & valid[None, :]
    msac_r = (err2_r.clamp(max=thr2) * vf).sum(-1)

    # Polished lanes first: argmin's first-wins tie-break prefers them.
    cand_msac = torch.cat([msac_r, msac[best][None]])
    cand_R = torch.cat([R2, Rh[best][None]])
    cand_t = torch.cat([t2, th[best][None]])
    cand_inl = torch.cat([inl_r, inl[best][None]])
    pick = torch.argmin(cand_msac)
    inl_out = cand_inl[pick]
    n_out = inl_out.to(torch.int32).sum()
    ok = (n_valid >= 4) & (n_out >= 4)
    return {
        "R": cand_R[pick], "t": cand_t[pick], "inliers": inl_out & ok,
        "n_inliers": torch.where(ok, n_out, torch.zeros_like(n_out)), "ok": ok,
    }


def pnp_ransac_fused(data, prior, intr, reproj_err, sampler, bf=0.0, stereo=False):
    """Packed-input PnP: data (N, 6|7) [pw(3) uv(2) valid (ur)], prior (4, 3)
    [R; t], intr (4,) [fx fy cx cy] (counterpart of the reference's
    single-upload form). With stereo=True column 6 carries the right-image
    u (< 0 = mono row)."""
    fx, fy, cx, cy = (float(v) for v in intr)
    return pnp_ransac(
        data[:, 0:3], data[:, 3:5], data[:, 5] > 0, fx, fy, cx, cy, reproj_err,
        prior[:3], prior[3], sampler, ur=data[:, 6] if stereo else None, bf=bf,
    )
