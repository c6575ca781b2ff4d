"""Point-sharded bundle adjustment over a process group.

Port of movslam_tpu/parallel/sharded_ba.py. Map points, with all their
observations (point-contiguous), are split over the ranks of a
torch.distributed group; keyframes are replicated. Each rank linearizes
its shard and builds its part of the reduced camera system with the
single-device solver's own pieces (ops/ba.py: visual_linearize,
schur_reduce's index scatter, backsub_landmarks); one all_reduce sums the
6K x 6K system and its right-hand side (the reference's psum over ICI),
and every rank solves the camera system itself, so all take the same
accept decision from the same all-reduced costs. Landmark
back-substitution stays local. The LM schedule, the isfinite guards and
the lambda clip are the reference's.
"""
from __future__ import annotations

import torch

from ..ops.ba import backsub_landmarks, schur_reduce, segment_plans, visual_linearize
from ..ops.lie import se3_compose, se3_exp
from ..ops.linalg import solve_psd
from .mesh import all_reduce_sum, group_or_world

LM_ITERS = 10


def make_sharded_ba(group=None, iters=LM_ITERS):
    """Build the sharded LM step for `group` (default: the world group; with
    no initialized group this raises).

    step(kf_R (K,3,3), kf_t (K,3), kf_fixed (K,), kf_valid (K,), mp_pos (P,3),
    mp_valid (P,), obs_kf (O,), obs_mp (O,), obs_uv (O,2), obs_valid (O,),
    obs_by_point (P, MOPP), fx, fy, cx, cy) takes this rank's shard of the
    point and observation arrays (obs_mp and obs_by_point index the LOCAL
    points and observations, padding = O) and the whole keyframe arrays.
    Returns (kf_R, kf_t, the local mp_pos, costs (iters,)), costs being each
    iteration's trial cost summed over the group."""
    g = group_or_world(group)

    def step(kf_R, kf_t, kf_fixed, kf_valid, mp_pos, mp_valid, obs_kf, obs_mp, obs_uv, obs_valid,
             obs_by_point, fx, fy, cx, cy):
        K, P, O = kf_R.shape[0], mp_pos.shape[0], obs_kf.shape[0]
        dt = mp_pos.dtype
        obs_kf = obs_kf.to(torch.int64)
        obs_mp = obs_mp.to(torch.int64)
        obs_by_point = obs_by_point.to(torch.int64)
        free = kf_valid & ~kf_fixed
        obs_w = obs_valid.to(dt) * mp_valid[obs_mp] * kf_valid[obs_kf]
        free_obs = free[obs_kf].to(dt)[:, None, None]
        m = free.to(dt).repeat_interleave(6)
        eye = torch.eye(K * 6, dtype=dt, device=mp_pos.device)
        plans = segment_plans(obs_kf, obs_mp, obs_valid, obs_by_point, K, P, O)

        def linearize(R, t, X):
            return visual_linearize(R, t, X, obs_kf, obs_mp, obs_uv, obs_w, free_obs, fx, fy, cx, cy,
                                    None, 0.0, K, P, plans)

        R, t, X = kf_R, kf_t, mp_pos
        lam = torch.tensor(1e-4, dtype=dt, device=mp_pos.device)
        lin = linearize(R, t, X)
        cost0 = all_reduce_sum(lin["cost"].reshape(1).clone(), g)[0]
        costs = []
        for _ in range(iters):
            S, rhs, Hll_inv = schur_reduce(lin["W"], lin["g_p"], lin["g_l"], lin["Hpp"], lin["Hll"],
                                           obs_kf, obs_mp, obs_by_point, lam, K, P, O, lam_pose=0.0,
                                           plans=plans)
            # One collective for the reduced camera system and its rhs.
            sys_ = all_reduce_sum(torch.cat([S.reshape(-1), rhs.reshape(-1)]), g)
            S, rhs = sys_[:36 * K * K].reshape(6 * K, 6 * K), sys_[36 * K * K:]
            S = (S + lam * eye) * m[:, None] * m[None, :] + torch.diag(1.0 - m)
            dxi = solve_psd(S + 1e-6 * eye, rhs * m).reshape(K, 6)
            dxi = torch.where(torch.isfinite(dxi), dxi, torch.zeros_like(dxi))
            dX = backsub_landmarks(dxi, lin["W"], Hll_inv, lin["g_l"], obs_kf, obs_mp, P, mp_valid, plans)
            dR, dtr = se3_exp(dxi)
            R_new, t_new = se3_compose(dR, dtr, R, t)
            R_new = torch.where(free[:, None, None], R_new, R)
            t_new = torch.where(free[:, None], t_new, t)
            X_new = X + dX
            lin_new = linearize(R_new, t_new, X_new)
            cost1 = all_reduce_sum(lin_new["cost"].reshape(1).clone(), g)[0]
            accept = (cost1 < cost0) & torch.isfinite(cost1)
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            X = torch.where(accept, X_new, X)
            lin = {k: torch.where(accept, lin_new[k], lin[k]) for k in lin}
            cost0 = torch.where(accept, cost1, cost0)
            lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-8, 1e6)
            costs.append(cost1)
        return R, t, X, torch.stack(costs) if costs else torch.zeros(0, dtype=dt)

    return step
