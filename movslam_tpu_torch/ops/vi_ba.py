"""Visual-inertial local bundle adjustment (joint LM).

Port of movslam_tpu/ops/vi_ba.py: EdgeInertial + EdgeGyroRW/EdgeAccRW
between consecutive keyframe states (G2oTypes.h:522-666, ImuTypes.h:139-249)
solved jointly with the visual reprojection edges, ORB-SLAM3's
LocalInertialBA shape:

  - per keyframe: camera-from-world pose (6), world velocity (3), gyro bias
    (3), accelerometer bias (3): 15-dim blocks;
  - landmarks are marginalized as in ops/ba.ba_solve (the shared
    schur_reduce); the reduced camera system fills the pose slices of the
    (15K, 15K) full system;
  - each consecutive-keyframe window adds a 9-dim inertial residual and a
    6-dim bias random-walk residual, whitened by its preintegration
    covariance; their Jacobians are torch.func.vmap(torch.func.jacfwd(f)) at
    the zero perturbation, as the reference's jax.vmap(jax.jacfwd(f));
  - branchless LM (accept/reject with torch.where), fixed iteration count:
    no host sync inside the solve.

Pose perturbations are left-multiplicative on T_cw, as in ba_solve, so the
visual Schur blocks and the inertial blocks share one tangent space.

`jacobians="analytic"` takes the inertial Jacobians in closed form
(_edge_linearize: ORB-SLAM3's EdgeInertial::linearizeOplus, G2oTypes.cc,
carried over to this tangent space) instead of by torch.func; the windowed
drive's mapper solves so, since forward-mode AD issues ~700 small kernels
per linearization where the closed form issues ~100.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from .ba import LM_ITERS, backsub_landmarks, schur_reduce, segment_plans, visual_linearize
from .imu import _right_jacobian, bias_corrected_deltas, gravity_like, inertial_residual
from .lie import hat, se3_compose, se3_exp, so3_log
from .linalg import solve_psd

# Per-edge cap on the whitening scale (see edge_whitening).
SQRT_INFO_CAP = 1e3


def _sqrt_info(cov, ridge):
    """Upper sqrt-information L^T of a covariance block, scaled down so that
    no entry exceeds SQRT_INFO_CAP. A block that is not positive definite
    gives NaNs (as XLA's Cholesky does), which the solve's acceptance test
    rejects; the same for a singular one."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    info = torch.linalg.inv_ex(cov + ridge * eye)[0]
    L, err = torch.linalg.cholesky_ex(0.5 * (info + info.transpose(-1, -2)))
    L = torch.where((err == 0)[..., None, None], L, float("nan"))
    c = torch.clamp(SQRT_INFO_CAP / torch.clamp(L.abs().amax((-1, -2)), min=1e-12), max=1.0)
    return c[..., None, None] * L.transpose(-1, -2)


def edge_whitening(cov):
    """Whitening of the K-1 edges from their preintegration covariance (..., 15,
    15): (W9 (..., 9, 9), Wg (..., 3, 3), Wa (..., 3, 3)).

    The raw sqrt-information reaches ~1e4-1e5 for short quiet windows; the g2o
    reference absorbs that in double precision, but an f32 normal-equation
    solve loses the visual blocks (~1e3) next to 1e10 inertial diagonals. Each
    edge's whitening is capped by a scalar (direction and correlation kept) to
    keep the joint system f32-conditioned. It depends on the covariance only,
    never on the perturbation, so it is computed once per solve."""
    return (_sqrt_info(cov[..., 0:9, 0:9], 1e-9), _sqrt_info(cov[..., 9:12, 9:12], 1e-12),
            _sqrt_info(cov[..., 12:15, 12:15], 1e-12))


def _edge_residual(dx, pre, pose_i, pose_j, bg0, ba0, gravity, whiten):
    """Whitened 15-dim inertial + bias random-walk residual of one keyframe
    pair as a function of the 30-dim (dx_i, dx_j) perturbation.

    pose_* = (R_cw, t_cw, v, bg, ba); bg0/ba0 = the bias the window was
    integrated at; whiten = edge_whitening of this window's covariance."""
    def perturb(d, pose):
        R_cw, t_cw, v, bg, ba = pose
        dR, dt = se3_exp(d[:6])
        R_c, t_c = se3_compose(dR, dt, R_cw, t_cw)
        return R_c, t_c, v + d[6:9], bg + d[9:12], ba + d[12:15]

    R_ci, t_ci, v_i, bg_i, ba_i = perturb(dx[:15], pose_i)
    R_cj, t_cj, v_j, bg_j, ba_j = perturb(dx[15:], pose_j)
    # world-from-body states (camera == body, see core/inertial.py)
    Rwb_i, Rwb_j = R_ci.transpose(-1, -2), R_cj.transpose(-1, -2)
    p_i, p_j = -(Rwb_i @ t_ci), -(Rwb_j @ t_cj)

    r9 = inertial_residual(pre, Rwb_i, p_i, v_i, Rwb_j, p_j, v_j, bg_i, ba_i, bg0, ba0, gravity)
    W9, Wg, Wa = whiten
    return torch.cat([W9 @ r9, Wg @ (bg_j - bg_i), Wa @ (ba_j - ba_i)])


def _inv_right_jacobian(phi):
    """Inverse SO(3) right Jacobian (ImuTypes.cc InverseRightJacobianSO3),
    batched over leading dims."""
    theta2 = (phi * phi).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-12)
    K = hat(phi)
    c = torch.where(theta2 > 1e-8, 1.0 / theta2 - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta)),
                    1.0 / 12.0)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + 0.5 * K + c * (K @ K)


def _edge_linearize(pre, R_ci, t_ci, v_i, bg_i, ba_i, R_cj, t_cj, v_j, bg_j, ba_j, bg0, ba0, whiten, gravity):
    """_edge_residual and its Jacobian at the zero perturbation in closed
    form, batched over the E edges: r (E, 15), J (E, 15, 30).

    EdgeInertial::linearizeOplus perturbs world-from-body poses on the
    right, R_wb Exp(dtheta) and p + R_wb dp. A left perturbation
    (se3_exp([rho, phi]) o T_cw) gives R_wb Exp(-phi) and, to first order,
    p - R_wb rho, so the pose columns here are the reference's negated and
    ordered [rho, phi]."""
    mv = lambda M, x: (M @ x[..., None])[..., 0]  # noqa: E731
    Rwb_i, Rwb_j = R_ci.transpose(-1, -2), R_cj.transpose(-1, -2)
    p_i, p_j = -mv(Rwb_i, t_ci), -mv(Rwb_j, t_cj)
    dbg = bg_i - bg0
    dR, dv, dp = bias_corrected_deltas(pre, dbg, ba_i - ba0)
    dt = pre["dt"][:, None]
    eR = dR.transpose(-1, -2) @ R_ci @ Rwb_j
    er = so3_log(eR)
    inv_jr = _inv_right_jacobian(er)
    vrel = mv(R_ci, v_j - v_i - gravity * dt)
    prel = mv(R_ci, p_j - p_i - v_i * dt - 0.5 * gravity * dt * dt)
    r9 = torch.cat([er, vrel - dv, prel - dp], -1)
    E, f, dev = r9.shape[0], r9.dtype, r9.device
    eye = torch.eye(3, dtype=f, device=dev)
    J9 = torch.zeros((E, 9, 30), dtype=f, device=dev)
    # keyframe i: pose [rho, phi], velocity, gyro and accelerometer bias
    J9[:, 0:3, 3:6] = inv_jr @ R_cj @ Rwb_i
    J9[:, 3:6, 3:6] = -hat(vrel)
    J9[:, 6:9, 3:6] = -hat(prel)
    J9[:, 6:9, 0:3] = eye
    J9[:, 3:6, 6:9] = -R_ci
    J9[:, 6:9, 6:9] = -R_ci * dt[..., None]
    J9[:, 0:3, 9:12] = -inv_jr @ eR.transpose(-1, -2) @ _right_jacobian(mv(pre["JRg"], dbg)) @ pre["JRg"]
    J9[:, 3:6, 9:12] = -pre["Jvg"]
    J9[:, 6:9, 9:12] = -pre["Jpg"]
    J9[:, 3:6, 12:15] = -pre["Jva"]
    J9[:, 6:9, 12:15] = -pre["Jpa"]
    # keyframe j: pose and velocity
    J9[:, 0:3, 18:21] = -inv_jr
    J9[:, 6:9, 15:18] = -(R_ci @ Rwb_j)
    J9[:, 3:6, 21:24] = R_ci
    W9, Wg, Wa = whiten
    J = torch.zeros((E, 15, 30), dtype=f, device=dev)
    J[:, 0:9] = W9 @ J9
    J[:, 9:12, 9:12], J[:, 9:12, 24:27] = -Wg, Wg
    J[:, 12:15, 12:15], J[:, 12:15, 27:30] = -Wa, Wa
    r = torch.cat([mv(W9, r9), mv(Wg, bg_j - bg_i), mv(Wa, ba_j - ba_i)], -1)
    return r, J


def vi_ba_solve(kf_R, kf_t, kf_fixed, kf_valid, kf_v, kf_bg, kf_ba, mp_pos, mp_valid, obs_kf,
                obs_mp, obs_uv, obs_valid, obs_by_point, pres, pre_valid, pre_bg0, pre_ba0,
                fx, fy, cx, cy, obs_ur=None, bf=0.0, gravity=None, kf_vb_fixed=None,
                iters=LM_ITERS, jacobians="autodiff"):
    """Joint visual-inertial LM bundle adjustment.

    Visual inputs are ba_solve's. Inertial inputs: kf_v/kf_bg/kf_ba (K, 3)
    per-keyframe world velocity and biases; pres, the preintegration of the
    K-1 consecutive-keyframe windows (ops/imu.preintegrate); pre_valid (K-1,)
    window mask; pre_bg0/pre_ba0 (K-1, 3), the bias each window was
    integrated at. kf_vb_fixed masks velocity/bias updates apart from the
    poses (default kf_fixed): the gauge keyframe keeps its pose pinned while
    its velocity and biases stay free. jacobians: "autodiff" (the
    reference's torch.func Jacobians) or "analytic" (_edge_linearize).

    Returns dict(kf_R, kf_t, kf_v, kf_bg, kf_ba, mp_pos, chi2, depth, cost,
    costs)."""
    K, P, O = kf_R.shape[0], mp_pos.shape[0], obs_kf.shape[0]
    f, dev = mp_pos.dtype, mp_pos.device
    obs_kf = obs_kf.to(torch.int64)
    obs_mp = obs_mp.to(torch.int64)
    g = gravity_like(mp_pos) if gravity is None else gravity
    free = kf_valid & ~kf_fixed  # pose dims
    free_vb = kf_valid & ~(kf_fixed if kf_vb_fixed is None else kf_vb_fixed)  # velocity/bias dims
    obs_w = obs_valid.to(f) * mp_valid[obs_mp] * kf_valid[obs_kf]
    free_obs = free[obs_kf].to(f)[:, None, None]
    any_free = free | free_vb
    edge_w = (pre_valid & kf_valid[:-1] & kf_valid[1:] & (any_free[:-1] | any_free[1:])).to(f)
    whiten = edge_whitening(pres["cov"])
    vb_mask = torch.cat([torch.zeros(6, dtype=f, device=dev), torch.ones(9, dtype=f, device=dev)]).repeat(K)
    m = torch.cat([free[:, None].expand(K, 6), free_vb[:, None].expand(K, 9)], 1).reshape(-1).to(f)
    eye = torch.eye(K * 15, dtype=f, device=dev)
    plans = segment_plans(obs_kf, obs_mp, obs_valid, obs_by_point, K, P, O)

    def edge(d, pre, Ri, ti, vi, bgi, bai, Rj, tj, vj, bgj, baj, bg0, ba0, wh):
        r = _edge_residual(d, pre, (Ri, ti, vi, bgi, bai), (Rj, tj, vj, bgj, baj), bg0, ba0, g, wh)
        return r, r

    def edge_args(R, t, v, bg, ba):
        return (pres, R[:-1], t[:-1], v[:-1], bg[:-1], ba[:-1], R[1:], t[1:], v[1:], bg[1:], ba[1:],
                pre_bg0, pre_ba0, whiten)

    zero = torch.zeros((K - 1, 30), dtype=f, device=dev)

    def inertial_linearize(R, t, v, bg, ba):
        """Residuals r (E, 15) and Jacobians J (E, 15, 30) of all K-1 edges at
        the zero perturbation."""
        if jacobians == "analytic":
            return _edge_linearize(*edge_args(R, t, v, bg, ba), g)
        J, r = vmap(jacfwd(edge, has_aux=True))(zero, *edge_args(R, t, v, bg, ba))
        return r, J.to(f)  # torch.func may carry the tangents in f64

    def visual(R, t, X):
        return visual_linearize(R, t, X, obs_kf, obs_mp, obs_uv, obs_w, free_obs, fx, fy, cx, cy,
                                obs_ur, bf, K, P, plans)

    def inertial_cost(r_in):
        return ((r_in * r_in).sum(-1) * edge_w).sum()

    def solve(state, lin, r_in, J_in, lam):
        R, t, X, v, bg, ba = state
        S6, rhs6, Hll_inv = schur_reduce(lin["W"], lin["g_p"], lin["g_l"], lin["Hpp"], lin["Hll"],
                                         obs_kf, obs_mp, obs_by_point, lam, K, P, O, plans=plans)
        Jw = J_in * edge_w[:, None, None]
        J_i, J_j = Jw[:, :, :15], Jw[:, :, 15:]
        JiT, JjT = J_i.transpose(1, 2), J_j.transpose(1, 2)
        H_ij = JiT @ J_j
        D = torch.zeros((K, 15, 15), dtype=f, device=dev)
        D[:-1] += JiT @ J_i
        D[1:] += JjT @ J_j
        Hb = torch.zeros((K, K, 15, 15), dtype=f, device=dev)
        ar = torch.arange(K, device=dev)
        Hb[ar, ar] = D
        Hb[ar[:-1], ar[1:]] = H_ij
        Hb[ar[1:], ar[:-1]] = H_ij.transpose(1, 2)
        b = torch.zeros((K, 15), dtype=f, device=dev)
        b[:-1] -= (JiT @ r_in[:, :, None])[..., 0]
        b[1:] -= (JjT @ r_in[:, :, None])[..., 0]
        # the visual reduced system in the pose slices
        Hb[:, :, :6, :6] += S6.reshape(K, 6, K, 6).permute(0, 2, 1, 3)
        b[:, :6] += rhs6
        H = Hb.permute(0, 2, 1, 3).reshape(K * 15, K * 15)
        # damping on the non-pose dims (the pose dims carry lam via schur_reduce)
        H = H + torch.diag(vb_mask * lam + 1e-8)
        # fixed/invalid keyframes: identity rows/cols, zero rhs
        H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        dx = solve_psd(H + 1e-6 * eye, b.reshape(-1) * m).reshape(K, 15)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        dxi = dx[:, :6]
        dX = backsub_landmarks(dxi, lin["W"], Hll_inv, lin["g_l"], obs_kf, obs_mp, P, mp_valid, plans)
        dR, dt_ = se3_exp(dxi)
        R_new, t_new = se3_compose(dR, dt_, R, t)
        fvb = free_vb[:, None]
        return (torch.where(free[:, None, None], R_new, R), torch.where(free[:, None], t_new, t), X + dX,
                torch.where(fvb, v + dx[:, 6:9], v), torch.where(fvb, bg + dx[:, 9:12], bg),
                torch.where(fvb, ba + dx[:, 12:15], ba))

    state = (kf_R, kf_t, mp_pos, kf_v, kf_bg, kf_ba)
    lin = visual(kf_R, kf_t, mp_pos)
    r_in, J_in = inertial_linearize(kf_R, kf_t, kf_v, kf_bg, kf_ba)
    lam = torch.tensor(1e-4, dtype=f, device=dev)
    costs = []
    for _ in range(iters):
        new = solve(state, lin, r_in, J_in, lam)
        R, t, X, v, bg, ba = new
        lin_new = visual(R, t, X)
        r_new, J_new = inertial_linearize(R, t, v, bg, ba)
        cost0 = lin["cost"] + inertial_cost(r_in)
        cost1 = lin_new["cost"] + inertial_cost(r_new)
        accept = (cost1 < cost0) & torch.isfinite(cost1)
        state = tuple(torch.where(accept, n, o) for n, o in zip(new, state))
        lin = {k: torch.where(accept, lin_new[k], lin[k]) for k in lin}
        r_in = torch.where(accept, r_new, r_in)
        J_in = torch.where(accept, J_new, J_in)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-8, 1e6)
        costs.append(cost1)
    R, t, X, v, bg, ba = state
    return {"kf_R": R, "kf_t": t, "kf_v": v, "kf_bg": bg, "kf_ba": ba, "mp_pos": X,
            "chi2": lin["chi2"], "depth": lin["z"], "cost": lin["cost"], "costs": torch.stack(costs)}
