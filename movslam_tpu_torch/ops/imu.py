"""IMU preintegration (Forster et al.) and the gravity/scale solve.

Port of movslam_tpu/ops/imu.py. The reference's `lax.scan` over the samples
of one window, vmapped over windows, is a Python loop over sample steps here,
batched over windows. A padded step (`valid` false) leaves the carry as it
was, so the loop stops after the last step any window marks valid (`steps`,
which the caller knows from its host arrays) with the same result as the full
scan. The gravity/scale LM takes its Jacobian with torch.func.jacfwd of the
stacked residual, vmapped over windows, like the reference's jax.jacfwd.

State per window: dR (3, 3), dv (3,), dp (3,), dt, the bias Jacobians
(JRg, Jvg, Jva, Jpg, Jpa) and the 15x15 covariance (order: rot, vel, pos,
gyro bias, acc bias, as in ImuTypes).
"""
from __future__ import annotations

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
                         prior_bias=1e2):
    """Gravity direction + scale (+ velocities, shared biases) with every
    keyframe pose fixed: Optimizer::InertialOptimization (Optimizer.cc:843-950,
    EdgeInertialGS semantics).

    pres: preintegration of the K-1 windows (each field stacked over windows);
    Rs (K, 3, 3) world-from-body rotations; ps (K, 3) keyframe positions in
    the unscaled map frame; v0 (K, 3) velocity guesses; valid (K-1,) window
    mask. Optimizes x = [theta_g (2), log_s, v (3K), bg (3), ba (3)] by LM on
    the stacked 9-dim residuals with g = Exp([theta_g, 0]) [0, 0, -gravity_mag]
    and a gentle bias prior (Optimizer.cc:901-917). Returns dict(Rwg, scale,
    vel, bg, ba, costs)."""
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

    x = torch.cat([torch.zeros(3, dtype=f, device=dev), v0.reshape(-1), bg0, ba0])
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
