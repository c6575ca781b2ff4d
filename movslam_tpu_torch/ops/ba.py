"""Levenberg-Marquardt bundle adjustment with an explicit Schur complement.

Port of the mono path of movslam_tpu/ops/ba.py (g2o LM + BlockSolver_6_3
replacement, Optimizer.cc:461-841): Huber (delta^2 = 5 px^2), 10 LM
iterations with branchless accept/reject, landmark blocks marginalized with
batched 3x3 inverses and a dense 6K x 6K reduced camera system solved by
Cholesky. Segment sums are `index_add_`; the Schur coupling scatters the
per-point (a, b) blocks directly instead of the reference's one-hot einsum.
"""
from __future__ import annotations

import numpy as np
import torch

from .lie import hat, se3_compose, se3_exp
from .linalg import inv3x3, solve_psd

HUBER2 = 5.0  # chi2 kernel threshold (g2o delta^2)
LM_ITERS = 10


def _segment_sum(x, idx, n):
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def _residual_jacobians(kf_R, kf_t, mp_pos, obs_kf, obs_mp, obs_uv, obs_w, fx, fy, cx, cy):
    """Per-observation mono residuals r (O, 2), pose Jacobians (O, 2, 6),
    point Jacobians (O, 2, 3), robust weights w (O,), chi2 (O,), depth (O,)."""
    R = kf_R[obs_kf]
    X = mp_pos[obs_mp]
    pc = (R @ X[:, :, None])[..., 0] + kf_t[obs_kf]
    z = pc[:, 2]
    iz = 1.0 / z.clamp(min=1e-6)
    x, y = pc[:, 0], pc[:, 1]
    r = torch.stack([fx * x * iz + cx - obs_uv[:, 0], fy * y * iz + cy - obs_uv[:, 1]], dim=-1)
    chi2 = (r * r).sum(-1)
    hub = torch.where(chi2 <= HUBER2, torch.ones_like(chi2),
                      torch.sqrt(HUBER2 / chi2.clamp(min=1e-12)))
    w = obs_w * hub * (z > 0)
    zero = torch.zeros_like(iz)
    iz2 = iz * iz
    J_pc = torch.stack(
        [torch.stack([fx * iz, zero, -fx * x * iz2], -1),
         torch.stack([zero, fy * iz, -fy * y * iz2], -1)],
        dim=1,
    )  # (O, 2, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    Jp = J_pc @ torch.cat([eye, -hat(pc)], dim=-1)  # (O, 2, 6)
    Jl = J_pc @ R  # d(pc)/dX = R
    return r, Jp, Jl, w, chi2, z


def _total_cost(chi2, w_valid):
    """Huber-robustified total cost (what LM must decrease)."""
    rho = torch.where(chi2 <= HUBER2, chi2, 2.0 * torch.sqrt(HUBER2 * chi2.clamp(min=0.0)) - HUBER2)
    return (rho * w_valid).sum()


def schur_reduce(W, g_p, g_l, Hpp, Hll, obs_kf, obs_mp, obs_by_point, lam, K, P, O):
    """Marginalize the landmark blocks. Returns (S (6K, 6K) including
    Hpp + lam I, rhs (K, 6), Hll_inv (P, 3, 3)). Only the observations listed
    in obs_by_point (at most MOPP per point) couple keyframe pairs, exactly
    as in the reference."""
    eye3 = torch.eye(3, dtype=W.dtype, device=W.device)
    eye6 = torch.eye(6, dtype=W.dtype, device=W.device)
    Hll_inv = inv3x3(Hll + lam * eye3 + 1e-8 * eye3, eps=1e-30)
    Hinv_gl = (Hll_inv @ g_l[:, :, None])[..., 0]
    rhs = g_p - _segment_sum((W @ Hinv_gl[obs_mp][:, :, None])[..., 0], obs_kf, K)

    # Pair blocks W_a Hinv_p W_b^T of every point's listed observations,
    # scattered into the (a, b) block of S; index O is the padding slot.
    pad = obs_by_point < O
    ob = obs_by_point.clamp(max=O - 1).to(torch.int64)
    Wp = W[ob] * pad[..., None, None]  # (P, M, 6, 3)
    kfp = obs_kf[ob]  # (P, M)
    Yp = Wp @ Hll_inv[:, None]  # (P, M, 6, 3)
    blocks = torch.einsum("pmik,pnjk->pmnij", Yp, Wp)  # (P, M, M, 6, 6)
    ab = (kfp[:, :, None] * K + kfp[:, None, :]).reshape(-1)
    S = -_segment_sum(blocks.reshape(-1, 6, 6), ab, K * K)
    diag = torch.arange(K, device=W.device) * (K + 1)
    S[diag] += Hpp + lam * eye6
    S = S.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    return S, rhs, Hll_inv


def ba_solve(kf_R, kf_t, kf_fixed, kf_valid, mp_pos, mp_valid, obs_kf, obs_mp, obs_uv,
             obs_valid, obs_by_point, fx, fy, cx, cy, iters=LM_ITERS):
    """Mono LM bundle adjustment. kf_* (K, ...); mp_pos (P, 3); obs_* (O,);
    obs_by_point (P, MOPP) observation indices padded with O. Fixed
    keyframes contribute residuals but are not updated (g2o setFixed).

    Returns dict(kf_R, kf_t, mp_pos, chi2 (O,), depth (O,), cost)."""
    K, P, O = kf_R.shape[0], mp_pos.shape[0], obs_kf.shape[0]
    obs_kf = obs_kf.to(torch.int64)
    obs_mp = obs_mp.to(torch.int64)
    free = kf_valid & ~kf_fixed
    obs_w = obs_valid.to(mp_pos.dtype) * mp_valid[obs_mp] * kf_valid[obs_kf]
    free_obs = free[obs_kf].to(mp_pos.dtype)[:, None, None]
    m = free.to(mp_pos.dtype).repeat_interleave(6)
    eye = torch.eye(K * 6, dtype=mp_pos.dtype, device=mp_pos.device)

    def linearize(R, t, X):
        r, Jp, Jl, w, chi2, z = _residual_jacobians(R, t, X, obs_kf, obs_mp, obs_uv, obs_w, fx, fy, cx, cy)
        Jp = Jp * free_obs
        Jpw = Jp * w[:, None, None]
        Jlw = Jl * w[:, None, None]
        g_p = -_segment_sum((Jpw.transpose(1, 2) @ r[:, :, None])[..., 0], obs_kf, K)
        g_l = -_segment_sum((Jlw.transpose(1, 2) @ r[:, :, None])[..., 0], obs_mp, P)
        Hpp = _segment_sum(Jpw.transpose(1, 2) @ Jp, obs_kf, K)
        Hll = _segment_sum(Jlw.transpose(1, 2) @ Jl, obs_mp, P)
        W = Jpw.transpose(1, 2) @ Jl  # (O, 6, 3)
        return {"W": W, "g_p": g_p, "g_l": g_l, "Hpp": Hpp, "Hll": Hll,
                "cost": _total_cost(chi2, obs_w), "chi2": chi2, "z": z}

    R, t, X = kf_R, kf_t, mp_pos
    lam = torch.tensor(1e-4, dtype=mp_pos.dtype, device=mp_pos.device)
    lin = linearize(R, t, X)
    for _ in range(iters):
        S, rhs, Hll_inv = schur_reduce(
            lin["W"], lin["g_p"], lin["g_l"], lin["Hpp"], lin["Hll"],
            obs_kf, obs_mp, obs_by_point, lam, K, P, O,
        )
        S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        dxi = solve_psd(S + 1e-6 * eye, rhs.reshape(-1) * m).reshape(K, 6)
        dxi = torch.where(torch.isfinite(dxi), dxi, torch.zeros_like(dxi))
        Wt_dxi = _segment_sum((lin["W"].transpose(1, 2) @ dxi[obs_kf][:, :, None])[..., 0], obs_mp, P)
        dX = (Hll_inv @ (lin["g_l"] - Wt_dxi)[:, :, None])[..., 0]
        dX = torch.where(torch.isfinite(dX), dX, torch.zeros_like(dX)) * mp_valid[:, None]
        dR, dt = se3_exp(dxi)
        R_new, t_new = se3_compose(dR, dt, R, t)
        R_new = torch.where(free[:, None, None], R_new, R)
        t_new = torch.where(free[:, None], t_new, t)
        X_new = X + dX
        lin_new = linearize(R_new, t_new, X_new)
        accept = (lin_new["cost"] < lin["cost"]) & torch.isfinite(lin_new["cost"])
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        X = torch.where(accept, X_new, X)
        lin = {k: torch.where(accept, lin_new[k], lin[k]) for k in lin}
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-8, 1e6)
    return {"kf_R": R, "kf_t": t, "mp_pos": X, "chi2": lin["chi2"], "depth": lin["z"],
            "cost": lin["cost"]}


def ba_solve_packed(kf_pack, mp_pack, obs_pack, obs_by_point, intr, bf, iters=LM_ITERS):
    """Packed-array BA (the reference's ba_solve_packed):

    kf_pack : (K, 14) f32 — R(9) t(3) fixed valid
    mp_pack : (P, 4) f32 — pos(3) valid
    obs_pack: (O, 6) f32 — kf mp u v ur valid  (indices exact below 2^24)
    intr    : fx fy cx cy, as host floats or a (4,) tensor on the same device

    Returns (out_kf (K, 12) [R t], out_mp (P, 3), out_obs (O, 2) [chi2
    depth]). Mono only: stereo rows (ur >= 0) and bf != 0 are ROADMAP
    Queue 1 "stereo" work and raise."""
    if bf:
        raise NotImplementedError("stereo BA (bf != 0): ROADMAP Queue 1, stereo slice")
    K = kf_pack.shape[0]
    res = ba_solve(
        kf_pack[:, 0:9].reshape(K, 3, 3), kf_pack[:, 9:12], kf_pack[:, 12] > 0, kf_pack[:, 13] > 0,
        mp_pack[:, 0:3], mp_pack[:, 3] > 0, obs_pack[:, 0].to(torch.int64),
        obs_pack[:, 1].to(torch.int64), obs_pack[:, 2:4], obs_pack[:, 5] > 0,
        obs_by_point.to(torch.int64), intr[0], intr[1], intr[2], intr[3], iters=iters,
    )
    out_kf = torch.cat([res["kf_R"].reshape(K, 9), res["kf_t"]], dim=1)
    return out_kf, res["mp_pos"], torch.stack([res["chi2"], res["depth"]], dim=1)


def ba_solve_wire(wire, intr, bf, *, K, P, O, MOPP, iters=LM_ITERS):
    """Flat-wire BA, the reference's ba_solve_wire layout.

    wire in : f32 [kf_pack K*14 (R t fixed valid) | mp_pack P*4 (pos valid) |
              obs_pack O*6 (kf mp u v ur valid) | obs_by_point P*MOPP].
    wire out: f32 [out_kf K*12 (R t) | out_mp P*3 | out_obs O*2 (chi2 depth)]."""
    o0 = K * 14
    o1 = o0 + P * 4
    o2 = o1 + O * 6
    out_kf, out_mp, out_obs = ba_solve_packed(
        wire[:o0].reshape(K, 14), wire[o0:o1].reshape(P, 4), wire[o1:o2].reshape(O, 6),
        wire[o2:].reshape(P, MOPP), [float(v) for v in intr], bf, iters=iters,
    )
    return torch.cat([out_kf.reshape(-1), out_mp.reshape(-1), out_obs.reshape(-1)])


def build_obs_by_point(obs_mp, n_points, mopp, n_obs):
    """Host helper: (P, MOPP) observation indices per point, padded with
    n_obs (first `mopp` observations of each point in index order)."""
    obs_mp = np.asarray(obs_mp)
    out = np.full((n_points, mopp), n_obs, np.int32)
    idx = np.flatnonzero((obs_mp >= 0) & (obs_mp < n_points))
    if len(idx) == 0:
        return out
    p = obs_mp[idx].astype(np.int64)
    order = np.argsort(p, kind="stable")
    p_sorted, o_sorted = p[order], idx[order]
    first = np.concatenate([[True], p_sorted[1:] != p_sorted[:-1]])
    group_start = np.maximum.accumulate(np.where(first, np.arange(len(p_sorted)), 0))
    within = np.arange(len(p_sorted)) - group_start
    keep = within < mopp
    out[p_sorted[keep], within[keep]] = o_sorted[keep].astype(np.int32)
    return out
