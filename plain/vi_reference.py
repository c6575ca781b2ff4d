"""A plain float64 reference of the port's visual-inertial arithmetic.

Written from the papers, in plain PyTorch, independent of both packages: it
imports neither `movslam_tpu` nor `movslam_tpu_torch` nor JAX, and holds
every quantity in float64 with TF32 off. The tests hold the port's float32
results against it (tests/test_plain_vi.py; on the card,
tests/test_torch_cuda.py).

  preintegrate       on-manifold preintegration of one interval, sample by
                     sample: Forster et al., "On-Manifold Preintegration for
                     Real-Time Visual-Inertial Odometry", TRO 2017, eqs.
                     33-35 (deltas), appendix B (bias Jacobians), eq. 62
                     (covariance)
  corrected_deltas   the deltas corrected to first order for a bias change
                     (Forster eq. 44)
  inertial_residual  the 9-dim residual of two states (Forster eq. 45)
  gs_start, gs_solve the gravity/scale/velocity/bias init (ORB-SLAM3,
                     Campos et al., TRO 2021, sec. V-B; LocalMapping::
                     InitializeIMU): the dirG start, then dense Gauss-Newton
  vi_ba_cost         the VI local BA's cost: Huber reprojection terms,
                     whitened inertial and bias random-walk terms

Departures from the papers, each the port's (and its reference's) choice:

  - The covariance's measurement noise enters per sample as sigma^2 with
    B scaled by dt (B diag(sigma^2) B^T), not as the discretised sigma^2 /
    dt of eq. 62; the bias blocks gather a fixed random walk, sigma_bw^2 dt
    per sample (sigma_bg 1e-5, sigma_ba 1e-4), whatever the rig's
    configuration says.
  - The init's gravity has two degrees of freedom (roll and pitch of the
    map's -z, yaw unobservable) and the scale enters as exp(log_s); the
    shared biases carry a prior of weight 1 / prior_bias (100). The solve
    is Gauss-Newton with step halving, where ORB-SLAM3 runs g2o's
    Levenberg-Marquardt.
  - The inertial edges are whitened by the upper Cholesky factor of the
    inverse covariance (plus a ridge: 1e-9 on the 9-dim block, 1e-12 on the
    walks), scaled down so that no entry exceeds SQRT_INFO_CAP: the port
    solves in float32, where the raw information of a short interval would
    swamp the visual blocks. The reprojection terms carry no octave
    information and the Huber threshold 5 on chi2.
  - Pose perturbations are left-multiplicative on camera-from-world, and
    the camera is the body (no camera-IMU extrinsics).
"""
from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
GRAVITY_MAG = 9.81
SIGMA_BG, SIGMA_BA = 1e-5, 1e-4  # the fixed walks
SQRT_INFO_CAP = 1e3
HUBER2 = 5.0
PRIOR_BIAS = 1e2


def _t(x):
    """x as a float64 CPU tensor (a tensor keeps its autograd graph)."""
    return x.to("cpu", F64) if torch.is_tensor(x) else torch.as_tensor(x, dtype=F64)


def hat(w):
    z = torch.zeros((), dtype=w.dtype)
    return torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def exp_so3(phi):
    """Rodrigues' formula; its Taylor series below 1e-6 rad."""
    theta = torch.linalg.norm(phi)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype)
    if theta < 1e-6:
        return eye + K + 0.5 * K @ K
    return eye + torch.sin(theta) / theta * K + (1 - torch.cos(theta)) / theta ** 2 * K @ K


def log_so3(R):
    c = torch.clamp((torch.trace(R) - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(c)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-6:
        return 0.5 * w
    return theta / (2 * torch.sin(theta)) * w


def right_jacobian(phi):
    theta = torch.linalg.norm(phi)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype)
    if theta < 1e-6:
        return eye - 0.5 * K + K @ K / 6
    return eye - (1 - torch.cos(theta)) / theta ** 2 * K + (theta - torch.sin(theta)) / theta ** 3 * K @ K


# --- preintegration -----------------------------------------------------------
def preintegrate(gyro, acc, dts, bias_g, bias_a, sigma_g, sigma_a):
    """One interval's samples (N, 3), (N, 3), (N,) at the biases (3,), one
    sample at a time. Returns dR, dv, dp, dt, the bias Jacobians JRg, Jvg,
    Jva, Jpg, Jpa and the 15x15 covariance (rot, vel, pos, gyro bias, acc
    bias)."""
    gyro, acc, dts, bg, ba = (_t(x) for x in (gyro, acc, dts, bias_g, bias_a))
    eye = torch.eye(3, dtype=F64)
    dR, dv, dp, T = eye.clone(), torch.zeros(3, dtype=F64), torch.zeros(3, dtype=F64), 0.0
    JRg, Jvg, Jva, Jpg, Jpa = (torch.zeros((3, 3), dtype=F64) for _ in range(5))
    cov = torch.zeros((15, 15), dtype=F64)
    noise = torch.diag(torch.tensor([sigma_g ** 2] * 3 + [sigma_a ** 2] * 3, dtype=F64))
    walk = torch.tensor([SIGMA_BG ** 2] * 3 + [SIGMA_BA ** 2] * 3, dtype=F64)
    for w, a, dt in zip(gyro, acc, dts):
        a, phi = a - ba, (w - bg) * dt
        dRi, Jr = exp_so3(phi), right_jacobian(phi)
        ahat = hat(a)
        A = torch.eye(9, dtype=F64)
        A[0:3, 0:3] = dRi.T
        A[3:6, 0:3] = -dR @ ahat * dt
        A[6:9, 0:3] = -0.5 * dR @ ahat * dt * dt
        A[6:9, 3:6] = eye * dt
        B = torch.zeros((9, 6), dtype=F64)
        B[0:3, 0:3] = Jr * dt
        B[3:6, 3:6] = dR * dt
        B[6:9, 3:6] = 0.5 * dR * dt * dt
        cov[:9, :9] = A @ cov[:9, :9] @ A.T + B @ noise @ B.T
        cov[9:, 9:] += torch.diag(walk * dt)
        # bias Jacobians (appendix B), each from the pre-update state
        Jpa = Jpa + Jva * dt - 0.5 * dR * dt * dt
        Jpg = Jpg + Jvg * dt - 0.5 * dR @ ahat @ JRg * dt * dt
        Jva = Jva - dR * dt
        Jvg = Jvg - dR @ ahat @ JRg * dt
        JRg = dRi.T @ JRg - Jr * dt
        # eqs. 33-35: position and velocity with the pre-update rotation
        dp = dp + dv * dt + 0.5 * dR @ a * dt * dt
        dv = dv + dR @ a * dt
        dR = dR @ dRi
        T += float(dt)
    return {"dR": dR, "dv": dv, "dp": dp, "dt": torch.tensor(T, dtype=F64), "JRg": JRg, "Jvg": Jvg,
            "Jva": Jva, "Jpg": Jpg, "Jpa": Jpa, "cov": cov}


def corrected_deltas(pre, dbg, dba):
    """The deltas at bias + (dbg, dba) to first order (Forster eq. 44)."""
    dbg, dba = _t(dbg), _t(dba)
    dR = pre["dR"] @ exp_so3(pre["JRg"] @ dbg)
    return dR, pre["dv"] + pre["Jvg"] @ dbg + pre["Jva"] @ dba, pre["dp"] + pre["Jpg"] @ dbg + pre["Jpa"] @ dba


def inertial_residual(pre, R_i, p_i, v_i, R_j, p_j, v_j, bg, ba, bg0, ba0, g):
    """[r_R, r_v, r_p] between world-from-body states i and j (Forster eq.
    45), the deltas corrected from the integration bias (bg0, ba0) to
    (bg, ba)."""
    dR, dv, dp = corrected_deltas(pre, _t(bg) - _t(bg0), _t(ba) - _t(ba0))
    dt = pre["dt"]
    RiT = R_i.T
    return torch.cat([log_so3(dR.T @ RiT @ R_j), RiT @ (v_j - v_i - g * dt) - dv,
                      RiT @ (p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dp])


# --- the gravity/scale init ---------------------------------------------------
def _gravity(theta):
    return exp_so3(torch.cat([theta, torch.zeros(1, dtype=F64)])) @ torch.tensor([0.0, 0.0, -GRAVITY_MAG],
                                                                                    dtype=F64)


def gs_start(pres, Rs, ps):
    """ORB-SLAM3's start: dirG = -sum_i R_i dV_i (normalised), the roll/pitch
    tangent that turns -z onto it, then the scale and velocities of the
    linear least squares of every interval's velocity and position rows with
    that gravity and zero bias. Rs (K, 3, 3) world-from-body, ps (K, 3)
    unscaled positions, pres the K - 1 intervals. Returns (theta, s, v)."""
    Rs, ps = _t(Rs), _t(ps)
    K = len(Rs)
    dirG = -sum(Rs[i] @ pres[i]["dv"] for i in range(K - 1))
    dirG = dirG / torch.linalg.norm(dirG)
    axis = torch.stack([dirG[1], -dirG[0]])
    angle = torch.arccos(torch.clamp(-dirG[2], -1.0, 1.0))
    theta = axis / torch.linalg.norm(axis) * angle
    g = _gravity(theta)
    A = torch.zeros((6 * (K - 1), 1 + 3 * K), dtype=F64)
    b = torch.zeros(6 * (K - 1), dtype=F64)
    eye = torch.eye(3, dtype=F64)
    for i, pre in enumerate(pres):
        dt = pre["dt"]
        r = 6 * i
        A[r:r + 3, 1 + 3 * (i + 1):4 + 3 * (i + 1)] = eye
        A[r:r + 3, 1 + 3 * i:4 + 3 * i] = -eye
        b[r:r + 3] = Rs[i] @ pre["dv"] + g * dt
        A[r + 3:r + 6, 0] = ps[i + 1] - ps[i]
        A[r + 3:r + 6, 1 + 3 * i:4 + 3 * i] = -eye * dt
        b[r + 3:r + 6] = Rs[i] @ pre["dp"] + 0.5 * g * dt * dt
    x = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    return theta, x[0], x[1:].reshape(K, 3)


def gs_residuals(x, pres, Rs, ps):
    """The init's stacked residuals at x = [theta (2), log_s, v (3K), bg,
    ba]: each interval's 9-dim residual with the positions scaled, gravity
    g(theta) and shared biases (integrated at zero), and the biases' prior."""
    K = len(Rs)
    theta, s, v = x[0:2], torch.exp(x[2]), x[3:3 + 3 * K].reshape(K, 3)
    bg, ba = x[3 + 3 * K:6 + 3 * K], x[6 + 3 * K:9 + 3 * K]
    g, zero = _gravity(theta), torch.zeros(3, dtype=F64)
    rows = [inertial_residual(pre, Rs[i], s * ps[i], v[i], Rs[i + 1], s * ps[i + 1], v[i + 1], bg, ba,
                              zero, zero, g) for i, pre in enumerate(pres)]
    return torch.cat(rows + [torch.cat([bg, ba]) / math.sqrt(PRIOR_BIAS)])


def gs_solve(pres, Rs, ps, iters=50):
    """Dense Gauss-Newton on gs_residuals from gs_start's point, halving a
    step until the cost falls. Returns dict(theta, Rwg, scale, vel, bg, ba,
    cost)."""
    Rs, ps = _t(Rs), _t(ps)
    K = len(Rs)
    theta, s, v = gs_start(pres, Rs, ps)
    x = torch.cat([theta, torch.log(s.clamp(min=1e-6))[None], v.reshape(-1), torch.zeros(6, dtype=F64)])

    def fn(y):
        return gs_residuals(y, pres, Rs, ps)

    cost = float((fn(x) ** 2).sum())
    for _ in range(iters):
        J = torch.autograd.functional.jacobian(fn, x)
        r = fn(x)
        dx = torch.linalg.lstsq(J, -r[:, None]).solution[:, 0]
        step = 1.0
        while step > 1e-6:
            c = float((fn(x + step * dx) ** 2).sum())
            if c < cost:
                break
            step *= 0.5
        else:
            break
        x, done, cost = x + step * dx, c > cost * (1 - 1e-10), c
        if done:
            break
    theta = x[0:2]
    return {"theta": theta, "Rwg": exp_so3(torch.cat([theta, torch.zeros(1, dtype=F64)])), "scale": torch.exp(x[2]),
            "vel": x[3:3 + 3 * K].reshape(K, 3), "bg": x[3 + 3 * K:6 + 3 * K], "ba": x[6 + 3 * K:], "cost": cost}


# --- the VI local BA's cost -----------------------------------------------------
def _sqrt_info(cov, ridge):
    n = cov.shape[-1]
    info = torch.linalg.inv(cov + ridge * torch.eye(n, dtype=F64))
    L = torch.linalg.cholesky(0.5 * (info + info.T))
    return min(1.0, SQRT_INFO_CAP / float(L.abs().max())) * L.T


def whitening(cov):
    """(W9, Wg, Wa) of one interval's covariance (module docstring)."""
    cov = _t(cov)
    return _sqrt_info(cov[0:9, 0:9], 1e-9), _sqrt_info(cov[9:12, 9:12], 1e-12), _sqrt_info(cov[12:15, 12:15], 1e-12)


def huber(chi2):
    return torch.where(chi2 <= HUBER2, chi2, 2.0 * torch.sqrt(HUBER2 * chi2) - HUBER2)


def vi_ba_cost(kf_R, kf_t, kf_v, kf_bg, kf_ba, mp_pos, obs, pres, pre_bg0, pre_ba0, cam, gravity=None):
    """The cost the VI local BA lowers: sum over observations (kf, point, u,
    v) of Huber(chi2) of the pinhole reprojection error, plus per interval i
    -> i + 1 (pres[i], None where it has no edge) the squared whitened
    inertial residual and bias walks. kf_R, kf_t camera-from-world; cam =
    (fx, fy, cx, cy). Returns (visual, inertial)."""
    kf_R, kf_t, kf_v, kf_bg, kf_ba, X = (_t(a) for a in (kf_R, kf_t, kf_v, kf_bg, kf_ba, mp_pos))
    fx, fy, cx, cy = cam
    g = torch.tensor([0.0, 0.0, -GRAVITY_MAG], dtype=F64) if gravity is None else _t(gravity)
    visual = torch.zeros((), dtype=F64)
    for k, p, u, v in obs:
        pc = kf_R[int(k)] @ X[int(p)] + kf_t[int(k)]
        r = torch.stack([fx * pc[0] / pc[2] + cx - u, fy * pc[1] / pc[2] + cy - v])
        visual = visual + huber((r * r).sum())
    inertial = torch.zeros((), dtype=F64)
    for i, pre in enumerate(pres):
        if pre is None:
            continue
        Rwb_i, Rwb_j = kf_R[i].T, kf_R[i + 1].T
        p_i, p_j = -Rwb_i @ kf_t[i], -Rwb_j @ kf_t[i + 1]
        r9 = inertial_residual(pre, Rwb_i, p_i, kf_v[i], Rwb_j, p_j, kf_v[i + 1], kf_bg[i], kf_ba[i],
                               pre_bg0[i], pre_ba0[i], g)
        W9, Wg, Wa = whitening(pre["cov"])
        r = torch.cat([W9 @ r9, Wg @ (kf_bg[i + 1] - kf_bg[i]), Wa @ (kf_ba[i + 1] - kf_ba[i])])
        inertial = inertial + (r * r).sum()
    return visual, inertial
