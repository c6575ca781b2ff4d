"""Levenberg-Marquardt bundle adjustment with an explicit Schur complement.

Port of movslam_tpu/ops/ba.py (g2o LM + BlockSolver_6_3
replacement, Optimizer.cc:461-841): Huber (delta^2 = 5 px^2), 10 LM
iterations with branchless accept/reject, landmark blocks marginalized with
batched 3x3 inverses and a dense 6K x 6K reduced camera system solved by
Cholesky. The Schur coupling scatters the per-point (a, b) blocks directly
instead of the reference's one-hot einsum.

Segment sums: `index_add_` on the CPU; on the card the ordered
kernels.segment_sum, whose order is the CPU's, so a solve gives the same
bits on every run (`index_add_` there is float atomics). The plans that fix
that order depend only on the problem's indices: ba_solve builds them once
(segment_plans) and every LM iteration reuses them.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels import segment_plan, segment_sum
from .lie import hat, se3_compose, se3_exp
from .linalg import inv3x3, solve_psd

HUBER2 = 5.0  # chi2 kernel threshold (g2o delta^2)
LM_ITERS = 10


def _ordered(x):
    """Whether x's sums go through the ordered segment sum and its plans
    (on the card) rather than `index_add_` (on the CPU)."""
    return x.device.type != "cpu"


def _segment_sum(x, idx, n, plan=None):
    """Sum the rows of x into n segments by idx: `index_add_` on the CPU;
    on the card the ordered kernel over `plan` (segment_plan(idx, n) when
    None)."""
    if not _ordered(x):
        out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
        return out.index_add_(0, idx, x)
    return segment_sum(x, plan if plan is not None else segment_plan(idx, n))


def _listed_obs(obs_by_point, O):
    """Each point's listed observations, clamped to a valid row, and which
    of them are real (index O pads)."""
    return obs_by_point.clamp(max=O - 1).to(torch.int64), obs_by_point < O


def _pair_index(obs_kf, ob, K):
    """Block (a, b) of S for every pair of each point's listed observations."""
    kfp = obs_kf[ob]  # (P, M)
    return (kfp[:, :, None] * K + kfp[:, None, :]).reshape(-1)


def segment_plans(obs_kf, obs_mp, obs_valid, obs_by_point, K, P, O):
    """The card's summation plans of one BA problem, fixed across LM
    iterations: by keyframe ("kf"), by point ("mp") and the Schur pair
    scatter ("pair"). Rows that carry zero blocks are left out: invalid
    (padding) observations, and pairs with a padding slot, which would
    otherwise make one long serial run in one segment. None on the CPU,
    where the sums are `index_add_`."""
    if not _ordered(obs_kf):
        return None
    ob, pad = _listed_obs(obs_by_point, O)
    keep = obs_valid.to(torch.bool)
    return {"kf": segment_plan(obs_kf, K, keep), "mp": segment_plan(obs_mp, P, keep),
            "pair": segment_plan(_pair_index(obs_kf, ob, K), K * K,
                                 (pad[:, :, None] & pad[:, None, :]).reshape(-1))}


def _residual_jacobians(kf_R, kf_t, mp_pos, obs_kf, obs_mp, obs_uv, obs_w, fx, fy, cx, cy,
                        obs_ur=None, bf=0.0):
    """Per-observation residuals r (O, 2|3), pose Jacobians (O, 2|3, 6),
    point Jacobians (O, 2|3, 3), robust weights w (O,), chi2 (O,), depth (O,).

    Mono observations have the rows (u, v). With obs_ur (O,), stereo
    observations (obs_ur >= 0) add the right-image column u_r = u - bf/z as a
    third row (EdgeStereoSE3ProjectXYZ, Optimizer.cc:673-705), which is zero
    for the mono rows among them."""
    R = kf_R[obs_kf]
    X = mp_pos[obs_mp]
    pc = (R @ X[:, :, None])[..., 0] + kf_t[obs_kf]
    z = pc[:, 2]
    iz = 1.0 / z.clamp(min=1e-6)
    x, y = pc[:, 0], pc[:, 1]
    u = fx * x * iz + cx
    rows = [u - obs_uv[:, 0], fy * y * iz + cy - obs_uv[:, 1]]
    if obs_ur is not None:
        stereo = (obs_ur >= 0).to(pc.dtype)
        rows.append((u - bf * iz - obs_ur) * stereo)
    r = torch.stack(rows, dim=-1)
    chi2 = (r * r).sum(-1)
    hub = torch.where(chi2 <= HUBER2, torch.ones_like(chi2),
                      torch.sqrt(HUBER2 / chi2.clamp(min=1e-12)))
    w = obs_w * hub * (z > 0)
    zero = torch.zeros_like(iz)
    iz2 = iz * iz
    jrows = [torch.stack([fx * iz, zero, -fx * x * iz2], -1),
             torch.stack([zero, fy * iz, -fy * y * iz2], -1)]
    if obs_ur is not None:
        jrows.append(
            torch.stack([fx * iz * stereo, zero, (-fx * x * iz2 + bf * iz2) * stereo], -1)
        )
    J_pc = torch.stack(jrows, dim=1)  # (O, 2|3, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    Jp = J_pc @ torch.cat([eye, -hat(pc)], dim=-1)  # (O, 2|3, 6)
    Jl = J_pc @ R  # d(pc)/dX = R
    return r, Jp, Jl, w, chi2, z


def _total_cost(chi2, w_valid):
    """Huber-robustified total cost (what LM must decrease)."""
    rho = torch.where(chi2 <= HUBER2, chi2, 2.0 * torch.sqrt(HUBER2 * chi2.clamp(min=0.0)) - HUBER2)
    return (rho * w_valid).sum()


def schur_reduce(W, g_p, g_l, Hpp, Hll, obs_kf, obs_mp, obs_by_point, lam, K, P, O, lam_pose=None,
                 plans=None):
    """Marginalize the landmark blocks. Returns (S (6K, 6K) including
    Hpp + lam_pose I, rhs (K, 6), Hll_inv (P, 3, 3)); lam_pose defaults to
    lam (the point-sharded BA passes 0 and damps the summed system once).
    Only the observations listed in obs_by_point (at most MOPP per point)
    couple keyframe pairs, exactly as in the reference. plans:
    segment_plans of the problem, or None."""
    plans = plans or {}
    eye3 = torch.eye(3, dtype=W.dtype, device=W.device)
    eye6 = torch.eye(6, dtype=W.dtype, device=W.device)
    Hll_inv = inv3x3(Hll + lam * eye3 + 1e-8 * eye3, eps=1e-30)
    Hinv_gl = (Hll_inv @ g_l[:, :, None])[..., 0]
    rhs = g_p - _segment_sum((W @ Hinv_gl[obs_mp][:, :, None])[..., 0], obs_kf, K, plans.get("kf"))

    # Pair blocks W_a Hinv_p W_b^T of every point's listed observations,
    # scattered into the (a, b) block of S; index O is the padding slot.
    ob, pad = _listed_obs(obs_by_point, O)
    Wp = W[ob] * pad[..., None, None]  # (P, M, 6, 3)
    Yp = Wp @ Hll_inv[:, None]  # (P, M, 6, 3)
    blocks = torch.einsum("pmik,pnjk->pmnij", Yp, Wp).reshape(-1, 6, 6)  # (P*M*M, 6, 6)
    pair = plans.get("pair")
    S = -(segment_sum(blocks, pair) if pair is not None else
          _segment_sum(blocks, _pair_index(obs_kf, ob, K), K * K))
    diag = torch.arange(K, device=W.device) * (K + 1)
    S[diag] += Hpp + (lam if lam_pose is None else lam_pose) * eye6
    S = S.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    return S, rhs, Hll_inv


def visual_linearize(R, t, X, obs_kf, obs_mp, obs_uv, obs_w, free_obs, fx, fy, cx, cy, obs_ur, bf,
                     K, P, plans=None):
    """The reprojection edges' normal-equation blocks at (R, t, X): W (O, 6, 3),
    gradients g_p (K, 6) and g_l (P, 3), Hpp (K, 6, 6), Hll (P, 3, 3), the
    robust cost, chi2 and depth. free_obs (O, 1, 1) zeroes the pose Jacobian
    of observations in fixed keyframes. plans: segment_plans, or None."""
    plans = plans or {}
    r, Jp, Jl, w, chi2, z = _residual_jacobians(R, t, X, obs_kf, obs_mp, obs_uv, obs_w, fx, fy, cx, cy, obs_ur, bf)
    Jp = Jp * free_obs
    Jpw = Jp * w[:, None, None]
    Jlw = Jl * w[:, None, None]
    pk, pm = plans.get("kf"), plans.get("mp")
    g_p = -_segment_sum((Jpw.transpose(1, 2) @ r[:, :, None])[..., 0], obs_kf, K, pk)
    g_l = -_segment_sum((Jlw.transpose(1, 2) @ r[:, :, None])[..., 0], obs_mp, P, pm)
    Hpp = _segment_sum(Jpw.transpose(1, 2) @ Jp, obs_kf, K, pk)
    Hll = _segment_sum(Jlw.transpose(1, 2) @ Jl, obs_mp, P, pm)
    W = Jpw.transpose(1, 2) @ Jl  # (O, 6, 3)
    return {"W": W, "g_p": g_p, "g_l": g_l, "Hpp": Hpp, "Hll": Hll,
            "cost": _total_cost(chi2, obs_w), "chi2": chi2, "z": z}


def backsub_landmarks(dxi, W, Hll_inv, g_l, obs_kf, obs_mp, P, mp_valid, plans=None):
    """Back-substitute the landmark updates: dX = Hll_inv (g_l - sum W^T dxi)."""
    Wt_dxi = _segment_sum((W.transpose(1, 2) @ dxi[obs_kf][:, :, None])[..., 0], obs_mp, P,
                          (plans or {}).get("mp"))
    dX = (Hll_inv @ (g_l - Wt_dxi)[:, :, None])[..., 0]
    return torch.where(torch.isfinite(dX), dX, torch.zeros_like(dX)) * mp_valid[:, None]


def ba_solve(kf_R, kf_t, kf_fixed, kf_valid, mp_pos, mp_valid, obs_kf, obs_mp, obs_uv,
             obs_valid, obs_by_point, fx, fy, cx, cy, obs_ur=None, bf=0.0, iters=LM_ITERS):
    """LM bundle adjustment. kf_* (K, ...); mp_pos (P, 3); obs_* (O,);
    obs_by_point (P, MOPP) observation indices padded with O. Fixed
    keyframes contribute residuals but are not updated (g2o setFixed).
    obs_ur (O,) is the right-image column of stereo observations (< 0 =
    mono) and bf the rig's baseline * fx.

    Returns dict(kf_R, kf_t, mp_pos, chi2 (O,), depth (O,), cost)."""
    K, P, O = kf_R.shape[0], mp_pos.shape[0], obs_kf.shape[0]
    obs_kf = obs_kf.to(torch.int64)
    obs_mp = obs_mp.to(torch.int64)
    free = kf_valid & ~kf_fixed
    obs_w = obs_valid.to(mp_pos.dtype) * mp_valid[obs_mp] * kf_valid[obs_kf]
    free_obs = free[obs_kf].to(mp_pos.dtype)[:, None, None]
    m = free.to(mp_pos.dtype).repeat_interleave(6)
    eye = torch.eye(K * 6, dtype=mp_pos.dtype, device=mp_pos.device)
    plans = segment_plans(obs_kf, obs_mp, obs_valid, obs_by_point, K, P, O)

    def linearize(R, t, X):
        return visual_linearize(R, t, X, obs_kf, obs_mp, obs_uv, obs_w, free_obs, fx, fy, cx, cy,
                                obs_ur, bf, K, P, plans)

    R, t, X = kf_R, kf_t, mp_pos
    lam = torch.tensor(1e-4, dtype=mp_pos.dtype, device=mp_pos.device)
    lin = linearize(R, t, X)
    for _ in range(iters):
        S, rhs, Hll_inv = schur_reduce(
            lin["W"], lin["g_p"], lin["g_l"], lin["Hpp"], lin["Hll"],
            obs_kf, obs_mp, obs_by_point, lam, K, P, O, plans=plans,
        )
        S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        dxi = solve_psd(S + 1e-6 * eye, rhs.reshape(-1) * m).reshape(K, 6)
        dxi = torch.where(torch.isfinite(dxi), dxi, torch.zeros_like(dxi))
        dX = backsub_landmarks(dxi, lin["W"], Hll_inv, lin["g_l"], obs_kf, obs_mp, P, mp_valid, plans)
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
    depth]). bf is a host float or a 0-d tensor; with a host 0 (a monocular
    rig, whose rows all carry ur = -1) the third residual row is left out."""
    mono = isinstance(bf, (int, float)) and bf == 0
    K = kf_pack.shape[0]
    res = ba_solve(
        kf_pack[:, 0:9].reshape(K, 3, 3), kf_pack[:, 9:12], kf_pack[:, 12] > 0, kf_pack[:, 13] > 0,
        mp_pack[:, 0:3], mp_pack[:, 3] > 0, obs_pack[:, 0].to(torch.int64),
        obs_pack[:, 1].to(torch.int64), obs_pack[:, 2:4], obs_pack[:, 5] > 0,
        obs_by_point.to(torch.int64), intr[0], intr[1], intr[2], intr[3],
        obs_ur=None if mono else obs_pack[:, 4], bf=bf, iters=iters,
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
