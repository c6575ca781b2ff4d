"""IMU preintegration (Forster et al.) and the gravity/scale solve.

Port of movslam_tpu/ops/imu.py. The reference's `lax.scan` over the samples
of one window, vmapped over windows, is a Python loop over sample steps here,
batched over windows. A padded step (`valid` false) leaves the carry as it
was, so the loop stops after the last step any window marks valid (`steps`,
which the caller knows from its host arrays) with the same result as the full
scan. The gravity/scale LM takes its Jacobian with torch.func.jacfwd of the
stacked residual, vmapped over windows, like the reference's jax.jacfwd.

`preintegrate_scan` computes what `preintegrate` does in O(log N) batched
steps instead of N (the windowed drive's interval cache, core/local_mapping):
the rotation chain and the covariance's transition matrices are products,
taken by a parallel prefix scan, and every other quantity is a prefix sum
of terms those products give.

State per window: dR (3, 3), dv (3,), dp (3,), dt, the bias Jacobians
(JRg, Jvg, Jva, Jpg, Jpa) and the 15x15 covariance (order: rot, vel, pos,
gyro bias, acc bias, as in ImuTypes).
"""
from __future__ import annotations

import math

import torch
from torch.func import jacfwd, vmap

from .lie import hat, so3_exp, so3_log

GRAVITY = (0.0, 0.0, -9.81)  # world gravity (m/s^2); gravity_like makes the tensor


def gravity_like(x, g=GRAVITY):
    """The gravity vector as a tensor on x's device and dtype."""
    return torch.tensor(g, dtype=x.dtype, device=x.device)


def _right_jacobian(phi):
    """SO(3) right Jacobian (ImuTypes.h:252-258), batched over leading dims."""
    theta2 = (phi * phi).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-12)
    K = hat(phi)
    a = torch.where(theta2 > 1e-8, (1.0 - torch.cos(theta)) / theta2, 0.5)
    b = torch.where(theta2 > 1e-8, (theta - torch.sin(theta)) / (theta2 * theta), 1.0 / 6.0)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - a * K + b * (K @ K)


def preintegrate(gyro, acc, dts, valid, bias_g, bias_a, sigma_g=1.7e-4, sigma_a=2e-3,
                 sigma_bg=1e-5, sigma_ba=1e-4, steps=None):
    """Preintegrate E windows of IMU samples at once.

    gyro/acc: (E, N, 3); dts: (E, N); valid: (E, N) bool padding mask;
    bias_g/bias_a: (3,) or (E, 3), the bias each window is integrated at.
    steps: how many leading sample steps to run (default N); every step at or
    past `steps` must be invalid in every window.

    Returns dict(dR, dv, dp, dt, JRg, Jvg, Jva, Jpg, Jpa, cov (E, 15, 15)),
    Preintegrated::IntegrateNewMeasurement semantics: position and velocity
    integrated with the pre-update rotation, the covariance propagated with
    the discrete A/B model."""
    E, N = dts.shape
    steps = N if steps is None else int(steps)
    f, dev = dts.dtype, dts.device
    eye3 = torch.eye(3, dtype=f, device=dev)
    bias_g = bias_g.expand(E, 3)
    bias_a = bias_a.expand(E, 3)
    nq = torch.tensor([sigma_g ** 2] * 3 + [sigma_a ** 2] * 3, dtype=f, device=dev)
    q_walk = torch.tensor([0.0] * 9 + [sigma_bg ** 2] * 3 + [sigma_ba ** 2] * 3, dtype=f, device=dev)
    A = torch.eye(15, dtype=f, device=dev).repeat(E, 1, 1)
    B = torch.zeros((E, 15, 6), dtype=f, device=dev)

    dR = eye3.repeat(E, 1, 1)
    dv = torch.zeros((E, 3), dtype=f, device=dev)
    dp = torch.zeros((E, 3), dtype=f, device=dev)
    dt_acc = torch.zeros(E, dtype=f, device=dev)
    JRg, Jvg, Jva, Jpg, Jpa = (torch.zeros((E, 3, 3), dtype=f, device=dev) for _ in range(5))
    cov = torch.zeros((E, 15, 15), dtype=f, device=dev)
    for n in range(steps):
        ok = valid[:, n]
        dt = torch.where(ok, dts[:, n], 0.0)
        dt1, dt2 = dt[:, None], dt[:, None, None]
        okv, okm = ok[:, None], ok[:, None, None]
        acc_c = acc[:, n] - bias_a
        w_c = gyro[:, n] - bias_g

        # position/velocity with the pre-update rotation
        dR_acc = (dR @ acc_c[:, :, None])[..., 0]
        dp_new = dp + dv * dt1 + 0.5 * dR_acc * dt1 * dt1
        dv_new = dv + dR_acc * dt1

        # bias Jacobians (ImuTypes.cc IntegrateNewMeasurement order)
        acc_hat = hat(acc_c)
        dR_ahat = dR @ acc_hat
        Jpa_new = Jpa + Jva * dt2 - 0.5 * dR * dt2 * dt2
        Jpg_new = Jpg + Jvg * dt2 - (0.5 * dR_ahat) @ JRg * dt2 * dt2
        Jva_new = Jva - dR * dt2
        Jvg_new = Jvg - dR_ahat @ JRg * dt2

        phi = w_c * dt1
        dRi = so3_exp(phi)
        Jr = _right_jacobian(phi)
        dR_new = dR @ dRi
        JRg_new = dRi.transpose(1, 2) @ JRg - Jr * dt2

        # covariance propagation (rot, vel, pos, bg, ba)
        A[:, 0:3, 0:3] = dRi.transpose(1, 2)
        A[:, 3:6, 0:3] = -dR_ahat * dt2
        A[:, 6:9, 0:3] = (-0.5 * dR) @ acc_hat * dt2 * dt2
        A[:, 6:9, 3:6] = eye3 * dt2
        B[:, 0:3, 0:3] = Jr * dt2
        B[:, 3:6, 3:6] = dR * dt2
        B[:, 6:9, 3:6] = 0.5 * dR * dt2 * dt2
        cov_new = A @ cov @ A.transpose(1, 2) + (B * nq) @ B.transpose(1, 2)
        cov_new = cov_new + torch.diag_embed(q_walk * dt1)

        dR = torch.where(okm, dR_new, dR)
        dv = torch.where(okv, dv_new, dv)
        dp = torch.where(okv, dp_new, dp)
        dt_acc = dt_acc + dt
        JRg = torch.where(okm, JRg_new, JRg)
        Jvg = torch.where(okm, Jvg_new, Jvg)
        Jva = torch.where(okm, Jva_new, Jva)
        Jpg = torch.where(okm, Jpg_new, Jpg)
        Jpa = torch.where(okm, Jpa_new, Jpa)
        cov = torch.where(okm, cov_new, cov)
    return {"dR": dR, "dv": dv, "dp": dp, "dt": dt_acc, "JRg": JRg, "Jvg": Jvg, "Jva": Jva,
            "Jpg": Jpg, "Jpa": Jpa, "cov": cov}


def _prefix_products(M):
    """Inclusive products along axis 1, earlier factors on the left:
    out[:, n] = M[:, 0] @ ... @ M[:, n], in ceil(log2 N) batched matmuls
    (Hillis-Steele)."""
    s = 1
    while s < M.shape[1]:
        M = torch.cat([M[:, :s], M[:, :-s] @ M[:, s:]], 1)
        s *= 2
    return M


def _exclusive(c):
    """An inclusive prefix along axis 1 shifted to the exclusive one."""
    return torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], 1)


def preintegrate_scan(gyro, acc, dts, valid, bias_g, bias_a, sigma_g=1.7e-4, sigma_a=2e-3,
                      sigma_bg=1e-5, sigma_ba=1e-4, steps=None):
    """preintegrate's result, arguments and semantics in O(log N) batched
    steps. With D_n the rotation before sample n (the exclusive prefix
    product of the sample rotations) every recursion of preintegrate is a
    sum: dv = sum D a dt, dp and Jva, Jpa alike; D_n JRg_n = -sum_{i<n}
    D_{i+1} Jr_i dt_i, from which Jvg and Jpg are sums too; and the
    covariance is sum_n Phi_n M_n Phi_n^T, Phi_n the product of the
    transition matrices after sample n (a suffix scan). The bias blocks of
    the covariance only gather the walk: their transition is the identity.
    A padded sample has dt = 0, which makes every factor the identity and
    every term zero."""
    E, N = dts.shape
    S = max(1, N if steps is None else int(steps))  # an interval with no sample: one padded step
    f, dev = dts.dtype, dts.device
    dt = torch.where(valid[:, :S], dts[:, :S], 0.0)[..., None, None]  # (E, S, 1, 1)
    a = (acc[:, :S] - bias_a.expand(E, 3)[:, None])[..., None]  # (E, S, 3, 1)
    phi = (gyro[:, :S] - bias_g.expand(E, 3)[:, None]) * dt[..., 0]
    dRi, Jr = so3_exp(phi), _right_jacobian(phi)
    eye3 = torch.eye(3, dtype=f, device=dev)
    P = _prefix_products(dRi)  # P[:, n] = D_{n+1}
    D = torch.cat([eye3.expand(E, 1, 3, 3), P[:, :-1]], 1)
    Da = D @ a
    dv_step = Da * dt
    dv_c = torch.cumsum(dv_step, 1)
    dp = (_exclusive(dv_c) * dt + 0.5 * dv_step * dt).sum(1)[..., 0]
    Jva_step = -D * dt
    Jva_c = torch.cumsum(Jva_step, 1)
    Jpa = (_exclusive(Jva_c) * dt + 0.5 * Jva_step * dt).sum(1)
    G_c = torch.cumsum(-(P @ Jr) * dt, 1)  # D_{n+1} JRg_{n+1}
    Dahat = D @ hat(a[..., 0])
    U = -(Dahat @ (D.transpose(-1, -2) @ _exclusive(G_c))) * dt  # the Jvg steps
    Jvg_c = torch.cumsum(U, 1)
    Jpg = (_exclusive(Jvg_c) * dt + 0.5 * U * dt).sum(1)

    # covariance of (rot, vel, pos): transition A_n and noise M_n of sample n
    A = torch.zeros((E, S, 9, 9), dtype=f, device=dev)
    A[..., 0:3, 0:3] = dRi.transpose(-1, -2)
    A[..., 3:6, 0:3] = -Dahat * dt
    A[..., 6:9, 0:3] = -0.5 * Dahat * dt * dt
    A[..., 6:9, 3:6] = eye3 * dt
    A[..., 3:9, 3:9] += torch.eye(6, dtype=f, device=dev)
    B = torch.zeros((E, S, 9, 6), dtype=f, device=dev)
    B[..., 0:3, 0:3] = Jr * dt
    B[..., 3:6, 3:6] = D * dt
    B[..., 6:9, 3:6] = 0.5 * D * dt * dt
    nq = torch.tensor([sigma_g ** 2] * 3 + [sigma_a ** 2] * 3, dtype=f, device=dev)
    M = (B * nq) @ B.transpose(-1, -2)
    suffix = _prefix_products(A.flip(1)).flip(1)  # A_{S-1} ... A_n
    Phi = torch.cat([suffix[:, 1:], torch.eye(9, dtype=f, device=dev).expand(E, 1, 9, 9)], 1)
    dt_acc = dt[:, :, 0, 0].sum(1)
    cov = torch.zeros((E, 15, 15), dtype=f, device=dev)
    cov[:, :9, :9] = (Phi @ M @ Phi.transpose(-1, -2)).sum(1)
    walk = torch.tensor([sigma_bg ** 2] * 3 + [sigma_ba ** 2] * 3, dtype=f, device=dev)
    cov[:, 9:, 9:] = torch.diag_embed(walk * dt_acc[:, None])
    return {"dR": P[:, -1], "dv": dv_c[:, -1, :, 0], "dp": dp, "dt": dt_acc, "JRg":
            P[:, -1].transpose(-1, -2) @ G_c[:, -1], "Jvg": Jvg_c[:, -1], "Jva": Jva_c[:, -1], "Jpg": Jpg,
            "Jpa": Jpa, "cov": cov}


def bias_corrected_deltas(pre, dbg, dba):
    """First-order bias update of the preintegrated deltas
    (Preintegrated::GetDeltaRotation/Velocity/Position(bias)); batched over
    leading dims."""
    mv = lambda M, x: (M @ x[..., None])[..., 0]  # noqa: E731
    dR = pre["dR"] @ so3_exp(mv(pre["JRg"], dbg))
    dv = pre["dv"] + mv(pre["Jvg"], dbg) + mv(pre["Jva"], dba)
    dp = pre["dp"] + mv(pre["Jpg"], dbg) + mv(pre["Jpa"], dba)
    return dR, dv, dp


def inertial_residual(pre, R_i, p_i, v_i, R_j, p_j, v_j, bias_g, bias_a, bias_g0, bias_a0,
                      gravity=None):
    """9-dim inertial residual between two world-from-body states (EdgeInertial,
    G2oTypes.h:522-566); one window (no leading batch dim on pre). The
    gravity/scale solve and the VI BA's edges (ops/vi_ba.py) both use it."""
    g = gravity_like(R_i) if gravity is None else gravity
    dt = pre["dt"]
    dR, dv, dp = bias_corrected_deltas(pre, bias_g - bias_g0, bias_a - bias_a0)
    RiT = R_i.transpose(-1, -2)
    er = so3_log(dR.transpose(-1, -2) @ (RiT @ R_j))
    ev = RiT @ (v_j - v_i - g * dt) - dv
    ep = RiT @ (p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dp
    return torch.cat([er, ev, ep])


def _exp_xy(theta):
    """Gravity-direction rotation from a 2-DoF tangent (VertexGDir: roll and
    pitch only, yaw is unobservable)."""
    return so3_exp(torch.cat([theta, torch.zeros_like(theta[:1])]))


def inertial_gs_optimize(pres, Rs, ps, v0, bg0, ba0, valid, iters=30, gravity_mag=9.81,
                         prior_bias=1e2, theta0=None, log_s0=None):
    """Gravity direction + scale (+ velocities, shared biases) with every
    keyframe pose fixed: Optimizer::InertialOptimization (Optimizer.cc:843-950,
    EdgeInertialGS semantics).

    pres: preintegration of the K-1 windows (each field stacked over windows);
    Rs (K, 3, 3) world-from-body rotations; ps (K, 3) keyframe positions in
    the unscaled map frame; v0 (K, 3) velocity guesses; valid (K-1,) window
    mask. Optimizes x = [theta_g (2), log_s, v (3K), bg (3), ba (3)] by LM on
    the stacked 9-dim residuals with g = Exp([theta_g, 0]) [0, 0, -gravity_mag]
    and a gentle bias prior (Optimizer.cc:901-917). The LM starts at
    theta0 (2,) and log_s0 () where given, else at zero, as the reference
    does: gravity along the map's -z and scale 1 (gravity_scale_start gives
    ORB-SLAM3's start). Returns dict(Rwg, scale, vel, bg, ba, costs)."""
    K = Rs.shape[0]
    f, dev = ps.dtype, ps.device
    g0 = torch.tensor([0.0, 0.0, -gravity_mag], dtype=f, device=dev)
    n = 9 + 3 * K

    def unpack(x):
        return x[0:2], x[2], x[3:3 + 3 * K].reshape(K, 3), x[3 + 3 * K:6 + 3 * K], x[6 + 3 * K:9 + 3 * K]

    def window(pre, R_i, p_i, v_i, R_j, p_j, v_j, w_valid, g, s, bg, ba):
        r = inertial_residual(pre, R_i, s * p_i, v_i, R_j, s * p_j, v_j, bg, ba, bg0, ba0, g)
        return torch.where(w_valid, r, 0.0)

    in_dims = (0,) * 8 + (None,) * 4

    def residuals(x):
        theta, log_s, v, bg, ba = unpack(x)
        g = _exp_xy(theta) @ g0
        s = torch.exp(log_s)
        r = vmap(window, in_dims=in_dims)(
            pres, Rs[:-1], ps[:-1], v[:-1], Rs[1:], ps[1:], v[1:], valid, g, s, bg, ba
        ).reshape(-1)
        r_prior = torch.cat([bg - bg0, ba - ba0]) * (1.0 / prior_bias) ** 0.5
        return torch.cat([r, r_prior])

    def residuals_aux(x):
        r = residuals(x)
        return r, r

    start = torch.zeros(3, dtype=f, device=dev)
    if theta0 is not None:
        start[0:2] = theta0
    if log_s0 is not None:
        start[2] = log_s0
    x = torch.cat([start, v0.reshape(-1), bg0, ba0])
    lam = torch.tensor(1e-3, dtype=f, device=dev)
    eye = torch.eye(n, dtype=f, device=dev)
    costs = []
    for _ in range(iters):
        J, r = jacfwd(residuals_aux, has_aux=True)(x)
        H = J.T @ J
        # LM damping: pure GN overshoots (the scale enters as exp(log_s)).
        Hd = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8)) + 1e-9 * eye
        dx = torch.linalg.solve_ex(Hd, -(J.T @ r))[0]
        x_new = x + dx
        c0 = (r * r).sum()
        c1 = (residuals(x_new) ** 2).sum()
        ok = torch.isfinite(c1) & (c1 < c0)
        x = torch.where(ok, x_new, x)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-9, 1e8)
        costs.append(torch.where(ok, c1, c0))
    theta, log_s, v, bg, ba = unpack(x)
    return {"Rwg": _exp_xy(theta), "scale": torch.exp(log_s), "vel": v, "bg": bg, "ba": ba,
            "costs": torch.stack(costs)}


def gravity_scale_start(pres, Rs, ps, valid, gravity_mag=9.81):
    """ORB-SLAM3's start of the gravity/scale solve (LocalMapping::
    InitializeIMU): the gravity direction dirG = -sum R_wb,i dV_i over the
    windows, normalised, and the roll/pitch tangent theta of _exp_xy that
    turns the map's -z onto it; then, with that gravity held, the scale and
    the velocities of the linear least squares of the windows' velocity and
    position residuals (zero bias). Arguments as inertial_gs_optimize's.
    Returns (theta (2,), log_s (), v (K, 3)); log_s is None where the linear
    scale is not positive, and the caller starts the scale at 1."""
    f, dev = ps.dtype, ps.device
    w = valid.to(f)[:, None]
    dirG = -((Rs[:-1] @ pres["dv"][..., None])[..., 0] * w).sum(0)
    dirG = dirG / dirG.norm().clamp(min=1e-12)
    axis = torch.stack([dirG[1], -dirG[0]])  # (0, 0, -1) x dirG, whose z is 0
    angle = torch.arccos(torch.clamp(-dirG[2], -1.0, 1.0))
    theta = axis * (angle / axis.norm().clamp(min=1e-12))
    g = _exp_xy(theta) @ torch.tensor([0.0, 0.0, -gravity_mag], dtype=f, device=dev)
    # Unknowns [s, v_0 .. v_{K-1}] of, per window i -> j = i + 1:
    #   v_j - v_i = R_i dV_i + g dt,   s (p_j - p_i) - v_i dt = R_i dP_i + g dt^2 / 2.
    K, E = Rs.shape[0], Rs.shape[0] - 1
    dt = pres["dt"][:, None]
    sel = torch.eye(K, dtype=f, device=dev)
    first, second = sel[:-1], sel[1:]  # window i's v_i and v_j, one-hot over keyframes
    eye3 = torch.eye(3, dtype=f, device=dev)
    blocks = lambda c: (c[:, None, :, None] * eye3[:, None, :]).reshape(E, 3, 3 * K)  # noqa: E731
    zero = torch.zeros((E, 3, 1), dtype=f, device=dev)
    A = torch.cat([torch.cat([zero, blocks(second - first)], 2),
                   torch.cat([(ps[1:] - ps[:-1])[..., None], blocks(-first * dt)], 2)], 1)
    b = torch.cat([(Rs[:-1] @ pres["dv"][..., None])[..., 0] + g * dt,
                   (Rs[:-1] @ pres["dp"][..., None])[..., 0] + 0.5 * g * dt * dt], 1)
    A = (A * w[:, :, None]).reshape(-1, 1 + 3 * K)
    b = (b * w).reshape(-1)
    H = A.T @ A + 1e-9 * torch.eye(1 + 3 * K, dtype=f, device=dev)
    x = torch.linalg.solve(H, A.T @ b)
    s = float(x[0])
    log_s = torch.log(x[0]) if s > 0 and math.isfinite(s) else None
    return theta, log_s, x[1:].reshape(K, 3)
