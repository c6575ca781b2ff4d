"""The port's visual-inertial arithmetic against the plain float64 reference
(plain/vi_reference.py), on the CPU, on a seeded IMU stream along a smooth
path and on keyframe chains cut from it; and two departures of the port from
its JAX reference (port only).

Tolerances, each with its reason:
  - preintegration (80 samples at 200 Hz, float32): each field within 1e-4
    of its largest entry, as tests/test_torch_imu.py holds it to the JAX
    reference (float32 sums over 80 samples, and the port's SO(3)
    exponential, whose angle guard leaves each step's rotation orthonormal
    to ~1e-7 only, compound to ~1e-5 in the gyro Jacobians); the
    interval cache's path (ops/imu.preintegrate_scan at the bias of the
    interval's start, corrected to first order to the current bias) within
    the same bounds as the loop at the current bias, for a gyro bias change
    just under the cache's reintegration threshold
    (local_mapping.REINTEGRATE_GYRO_BIAS): the correction's second-order
    error, ~(0.4 s x 0.01 rad/s)^2, is under float32's accumulation there;
  - the inertial residual within 1e-4 absolute (float32 residuals of
    positions of a few metres);
  - the closed-form inertial residual and Jacobians (ops/vi_ba.
    _edge_linearize, run in float64) within 1e-6 of the largest entry of the
    reference's residual and autograd Jacobian: both are exact, and the
    port's SO(3) maps, whose 1e-12 angle guard moves their results by ~1e-8,
    leave the rest;
  - the gravity/scale solve from ORB-SLAM3's start: the scale within 1e-3
    relative, gravity within 1e-3 rad, velocities within 1e-3 m/s (the port's
    float32 Levenberg-Marquardt and the reference's float64 Gauss-Newton
    stop a few float32 digits apart);
  - the VI local BA: the reference's cost at the port's solution within
    1e-4 relative of the cost the port reports for it, and the closed-form
    solve's cost within 1e-3 relative of the forward-mode solve's.
"""
import math

import numpy as np
import pytest
import torch

from movslam_tpu_torch.ops import imu, vi_ba
from movslam_tpu_torch.ops.ba import build_obs_by_point
from movslam_tpu_torch.core.local_mapping import REINTEGRATE_GYRO_BIAS
from plain import vi_reference as plain

HZ = 200.0
G_W = np.array([0.0, 0.0, -9.81])
WB = np.array([0.05, -0.3, 0.1])  # body rate, rad/s
# World-from-camera at t = 0: the optical axis (+z) along the world's +x,
# so gravity lies 90 degrees from the camera's -z.
R0_LEVEL = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)
SIGMA_G, SIGMA_A = 1.7e-4, 2e-3


def _exp(w):
    return plain.exp_so3(torch.as_tensor(w, dtype=torch.float64)).numpy()


def _state(t, R0=R0_LEVEL):
    """World-from-body rotation, position, acceleration of the smooth path."""
    p = np.array([0.6 * np.sin(1.3 * t), 0.4 * np.cos(0.9 * t) - 0.4, 0.15 * np.sin(2.1 * t)])
    a = np.array([-0.6 * 1.69 * np.sin(1.3 * t), -0.4 * 0.81 * np.cos(0.9 * t), -0.15 * 4.41 * np.sin(2.1 * t)])
    return R0 @ _exp(WB * t), p, a


def _velocity(t):
    return np.array([0.6 * 1.3 * np.cos(1.3 * t), -0.4 * 0.9 * np.sin(0.9 * t), 0.15 * 2.1 * np.cos(2.1 * t)])


def _samples(t0, n, bg=np.zeros(3), ba=np.zeros(3), R0=R0_LEVEL):
    """n IMU samples from t0 (midpoint values), the biases added."""
    dt = 1.0 / HZ
    gyro, acc = np.zeros((n, 3)), np.zeros((n, 3))
    for i in range(n):
        R, _, a = _state(t0 + (i + 0.5) * dt, R0)
        gyro[i] = WB + bg
        acc[i] = R.T @ (a - G_W) + ba
    return gyro, acc, np.full(n, dt)


def _padded(windows):
    n = max(len(w[2]) for w in windows)
    E = len(windows)
    out = [np.zeros((E, n, 3), np.float32), np.zeros((E, n, 3), np.float32), np.zeros((E, n), np.float32)]
    valid = np.zeros((E, n), bool)
    for e, (g, a, d) in enumerate(windows):
        out[0][e, :len(d)], out[1][e, :len(d)], out[2][e, :len(d)], valid[e, :len(d)] = g, a, d, True
    return [torch.as_tensor(x) for x in out] + [torch.as_tensor(valid)]


def _close(got, want, tol, what):
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.numpy() if torch.is_tensor(want) else np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max error {err:.3e} > {tol:.3e}"


LENGTHS = (80, 61, 17)
PRE_KEYS = ("dR", "dv", "dp", "dt", "JRg", "Jvg", "Jva", "Jpg", "Jpa", "cov")


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(7)
    starts = (0.0, 0.9, 2.3)
    bias_now = [rng.normal(0, 0.02, 3) for _ in LENGTHS], [rng.normal(0, 0.1, 3) for _ in LENGTHS]
    windows = [_samples(s, n, bg=np.array([0.01, -0.02, 0.015]), ba=np.array([0.05, 0.0, -0.08]))
               for s, n in zip(starts, LENGTHS)]
    for g, a, _ in windows:  # sensor noise on top of the path
        g += rng.normal(0, 1e-3, g.shape)
        a += rng.normal(0, 1e-2, a.shape)
    return windows, bias_now


def _bound(want, key):
    return 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("path", ["uncached", "cached"])
def test_preintegrate_matches_plain(stream, path):
    """uncached: ops/imu.preintegrate at the current bias, as the per-frame
    drive's VI BA integrates; cached: ops/imu.preintegrate_scan at the bias
    the interval closed at, then the first-order correction the VI BA
    applies (imu.bias_corrected_deltas)."""
    windows, (bg_now, ba_now) = stream
    bg_now, ba_now = np.stack(bg_now), np.stack(ba_now)
    # The cache integrated each interval at a bias just under the threshold away.
    step = np.array([1.0, -1.0, 1.0]) / math.sqrt(3) * 0.95 * REINTEGRATE_GYRO_BIAS
    bg_at = bg_now - step if path == "cached" else bg_now
    ba_at = ba_now - 0.05 if path == "cached" else ba_now
    args = _padded(windows)
    t32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    fn = imu.preintegrate_scan if path == "cached" else imu.preintegrate
    pres = fn(*args, t32(bg_at), t32(ba_at), sigma_g=SIGMA_G, sigma_a=SIGMA_A)
    dR, dv, dp = imu.bias_corrected_deltas(pres, t32(bg_now - bg_at), t32(ba_now - ba_at))
    for e, (g, a, d) in enumerate(windows):
        want = plain.preintegrate(g, a, d, bg_now[e], ba_now[e], SIGMA_G, SIGMA_A)
        for key, got in (("dR", dR[e]), ("dv", dv[e]), ("dp", dp[e])):
            _close(got, want[key], _bound(want[key], key), f"{path} {key}[{e}]")
        # The Jacobians and the covariance are those of the integration bias.
        at = plain.preintegrate(g, a, d, bg_at[e], ba_at[e], SIGMA_G, SIGMA_A)
        for key in PRE_KEYS:
            _close(pres[key][e], at[key], _bound(at[key], key), f"{path} {key}[{e}] at its bias")


def test_inertial_residual_matches_plain(stream):
    windows, _ = stream
    rng = np.random.default_rng(11)
    g, a, d = windows[0]
    bg0, ba0 = rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)
    pre_plain = plain.preintegrate(g, a, d, bg0, ba0, SIGMA_G, SIGMA_A)
    pre_port = {k: v[0] for k, v in imu.preintegrate(*_padded([windows[0]]), torch.as_tensor(bg0, dtype=torch.float32),
                                                      torch.as_tensor(ba0, dtype=torch.float32)).items()}
    for trial in range(4):
        Ri, pi, _ = _state(0.0)
        Rj, pj, _ = _state(0.4)
        Rj = Rj @ _exp(rng.normal(0, 0.01, 3))
        pi, pj = pi + rng.normal(0, 0.05, 3), pj + rng.normal(0, 0.05, 3)
        vi, vj = _velocity(0.0) + rng.normal(0, 0.1, 3), _velocity(0.4) + rng.normal(0, 0.1, 3)
        bg, ba = bg0 + rng.normal(0, 0.005, 3), ba0 + rng.normal(0, 0.02, 3)
        f64 = [torch.as_tensor(x, dtype=torch.float64) for x in (Ri, pi, vi, Rj, pj, vj, bg, ba, bg0, ba0, G_W)]
        want = plain.inertial_residual(pre_plain, *f64)
        got = imu.inertial_residual(pre_port, *[x.float() for x in f64])
        _close(got, want, 1e-4, f"residual, trial {trial}")


def test_closed_form_inertial_jacobians_match_plain_autograd(stream):
    """ops/vi_ba._edge_linearize (the windowed mapper's Jacobians), run in
    float64, against the reference's whitened edge residual differentiated
    by autograd under the same left perturbation of camera-from-world."""
    windows, _ = stream
    rng = np.random.default_rng(5)
    g, a, d = windows[0]
    pre = plain.preintegrate(g, a, d, np.zeros(3), np.zeros(3), SIGMA_G, SIGMA_A)
    W9, Wg, Wa = plain.whitening(pre["cov"])
    states = []
    for tt in (0.0, 0.4):
        R, p, _ = _state(tt)
        R = R @ _exp(rng.normal(0, 0.02, 3))
        Rc = R.T
        states.append([Rc, -Rc @ (p + rng.normal(0, 0.03, 3)), _velocity(tt) + rng.normal(0, 0.05, 3),
                       rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)])
    states = [[torch.as_tensor(x, dtype=torch.float64) for x in s] for s in states]
    bg0 = ba0 = torch.zeros(3, dtype=torch.float64)
    g_w = torch.as_tensor(G_W)

    def residual(dx):
        out = []
        for k, (R, t, v, bg, ba) in enumerate(states):
            d = dx[15 * k:15 * (k + 1)]
            dR = plain.exp_so3(d[3:6])
            out.append((dR @ R, dR @ t + d[0:3], v + d[6:9], bg + d[9:12], ba + d[12:15]))
        (Ri, ti, vi, bgi, bai), (Rj, tj, vj, bgj, baj) = out
        r9 = plain.inertial_residual(pre, Ri.T, -Ri.T @ ti, vi, Rj.T, -Rj.T @ tj, vj, bgi, bai, bg0, ba0, g_w)
        return torch.cat([W9 @ r9, Wg @ (bgj - bgi), Wa @ (baj - bai)])

    want_J = torch.autograd.functional.jacobian(residual, torch.zeros(30, dtype=torch.float64))
    b = lambda x: x[None]  # noqa: E731
    pre_b = {k: b(v) for k, v in pre.items()}
    (Ri, ti, vi, bgi, bai), (Rj, tj, vj, bgj, baj) = states
    got_r, got_J = vi_ba._edge_linearize(pre_b, b(Ri), b(ti), b(vi), b(bgi), b(bai), b(Rj), b(tj), b(vj), b(bgj),
                                         b(baj), b(bg0), b(ba0), (b(W9), b(Wg), b(Wa)), g_w)
    want_r = residual(torch.zeros(30, dtype=torch.float64))
    _close(got_r[0], want_r, 1e-6 * float(want_r.abs().max()), "residual")
    _close(got_J[0], want_J, 1e-6 * float(want_J.abs().max()), "closed-form Jacobian")


def _chain(K, per, s_true, R0=R0_LEVEL):
    """K keyframes `per` samples apart along the path, in the first
    camera's frame at 1 / s_true of the metric scale, as a monocular map
    holds them: (windows, Rs world-from-body, ps, gravity in that frame)."""
    Rc0w, p0 = _state(0.0, R0)[0].T, _state(0.0, R0)[1]
    Rs, ps, windows = [], [], []
    for k in range(K):
        t0 = k * per / HZ
        R, p, _ = _state(t0, R0)
        Rs.append(Rc0w @ R)
        ps.append(Rc0w @ (p - p0) / s_true)
        if k < K - 1:
            windows.append(_samples(t0, per, R0=R0))
    return windows, np.stack(Rs), np.stack(ps), Rc0w @ G_W


def _port_init(windows, Rs, ps, start):
    """ops/imu's gravity/scale solve over the chain, from ORB-SLAM3's start
    (gravity_scale_start, as visual_inertial_init's windowed form) or from
    the reference's zero start. Returns (Rwg, scale, vel)."""
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    z = torch.zeros(3)
    pres = imu.preintegrate(*_padded(windows), z, z, sigma_g=SIGMA_G, sigma_a=SIGMA_A)
    K = len(Rs)
    ok = torch.ones(K - 1, dtype=torch.bool)
    v0 = np.zeros((K, 3))
    v0[:-1] = (ps[1:] - ps[:-1]) / np.array([w[2].sum() for w in windows])[:, None]
    v0[-1] = v0[-2]
    v0, kw = f32(v0), {}
    if start == "orb_slam3":
        theta0, log_s0, v_lin = imu.gravity_scale_start(pres, f32(Rs), f32(ps), ok)
        kw = {"theta0": theta0, "log_s0": log_s0}
        v0 = v_lin if log_s0 is not None else v0
    res = imu.inertial_gs_optimize(pres, f32(Rs), f32(ps), v0, z, z, ok, **kw)
    return res["Rwg"].double().numpy(), float(res["scale"]), res["vel"].double().numpy()


def _tilt(Rwg, g_map):
    g = Rwg @ np.array([0.0, 0.0, -9.81])
    return math.acos(np.clip(g @ g_map / 9.81 ** 2, -1.0, 1.0))


def test_gravity_scale_solve_from_the_new_start_matches_plain():
    windows, Rs, ps, g_map = _chain(K=8, per=40, s_true=4.0)
    Rwg, s, vel = _port_init(windows, Rs, ps, "orb_slam3")
    pres = [plain.preintegrate(g, a, d, np.zeros(3), np.zeros(3), SIGMA_G, SIGMA_A) for g, a, d in windows]
    want = plain.gs_solve(pres, Rs, ps)
    assert abs(s / float(want["scale"]) - 1.0) < 1e-3, (s, float(want["scale"]))
    _close(Rwg, want["Rwg"], 1e-3, "Rwg")
    _close(vel, want["vel"], 1e-3, "velocities")
    # and the reference lands the truth: gravity and the metric scale
    assert _tilt(want["Rwg"].numpy(), g_map) < 0.01 and abs(float(want["scale"]) / 4.0 - 1) < 0.01


def _looking(angle_deg):
    """World-from-camera at t = 0 with gravity `angle_deg` from the camera's
    -z: 90 looks level, 180 straight down (a drone's downward camera)."""
    a = math.radians(90.0 - angle_deg)
    Rx = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    return R0_LEVEL @ Rx


@pytest.mark.parametrize("angle", [90, 170])
@pytest.mark.parametrize("s_true", [0.25, 40.0])
def test_new_start_recovers_gravity_and_scale(angle, s_true):
    """Departure (port only): the windowed drive's init starts where
    ORB-SLAM3 does. On a six-keyframe chain whose gravity lies 90 or 170
    degrees from the first camera's -z it lands gravity within 0.05 rad and
    the scale within 5%."""
    windows, Rs, ps, g_map = _chain(K=6, per=40, s_true=s_true, R0=_looking(angle))
    assert abs(_tilt(np.eye(3), g_map) - math.radians(angle)) < 0.01
    Rwg, s, _ = _port_init(windows, Rs, ps, "orb_slam3")
    assert _tilt(Rwg, g_map) < 0.05 and abs(s / s_true - 1) < 0.05, (_tilt(Rwg, g_map), s)


def test_zero_start_misses_gravity_far_from_the_cameras_minus_z():
    """The JAX reference's start (gravity along the map's -z, scale 1),
    which inertial_gs_optimize keeps by default, lands a level camera's
    chain (90 degrees, as test_new_start_recovers_gravity_and_scale's) but
    not a camera looking down (170 degrees): the departure's reason."""
    for angle, lands in ((90, True), (170, False)):
        windows, Rs, ps, g_map = _chain(K=6, per=40, s_true=4.0, R0=_looking(angle))
        Rwg, s, _ = _port_init(windows, Rs, ps, "zero")
        assert (_tilt(Rwg, g_map) < 0.05 and abs(s / 4.0 - 1) < 0.05) is lands, (angle, _tilt(Rwg, g_map), s)


def _ba_problem(K=6, P=60, per=80):
    """A VI local BA problem along the path: K keyframes `per` samples apart
    with their intervals, P points seen by every keyframe (0.5 px noise), the
    states perturbed; camera == body, camera-from-world poses."""
    rng = np.random.default_rng(17)
    fx = fy = 300.0
    cx, cy = 320.0, 240.0
    Rs, ts, vs = [], [], []
    for k in range(K):
        R, p, _ = _state(k * per / HZ)
        Rs.append(R.T)
        ts.append(-R.T @ p)
        vs.append(_velocity(k * per / HZ))
    Rc, pc = Rs[K // 2], -Rs[K // 2].T @ ts[K // 2]
    X = pc + (Rc.T @ np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 9, P)], 1).T).T
    obs = []
    for k in range(K):
        pcam = X @ Rs[k].T + ts[k]
        u = fx * pcam[:, 0] / pcam[:, 2] + cx + rng.normal(0, 0.5, P)
        v = fy * pcam[:, 1] / pcam[:, 2] + cy + rng.normal(0, 0.5, P)
        obs += [(k, p, u[p], v[p]) for p in range(P) if pcam[p, 2] > 0.1]
    windows = [_samples(k * per / HZ, per) for k in range(K - 1)]
    start = {
        "kf_R": np.stack([R @ _exp(rng.normal(0, 0.003, 3)) if k else R for k, R in enumerate(Rs)]),
        "kf_t": np.stack([t + (rng.normal(0, 0.02, 3) if k else 0) for k, t in enumerate(ts)]),
        "kf_v": np.stack(vs) + rng.normal(0, 0.05, (K, 3)), "mp_pos": X + rng.normal(0, 0.05, X.shape),
    }
    return start, np.array(obs), windows, (fx, fy, cx, cy)


@pytest.fixture(scope="module")
def vi_ba_solves():
    """The problem and the port's solve of it, with each form of the
    inertial Jacobians."""
    start, obs, windows, cam = _ba_problem()
    K, P, O = len(start["kf_R"]), len(start["mp_pos"]), len(obs)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    z = torch.zeros(K - 1, 3)
    pres = imu.preintegrate(*_padded(windows), z, z, sigma_g=SIGMA_G, sigma_a=SIGMA_A)
    obs_mp = obs[:, 1].astype(np.int64)
    solves = {j: vi_ba.vi_ba_solve(
        f32(start["kf_R"]), f32(start["kf_t"]), torch.as_tensor(np.arange(K) == 0), torch.ones(K, dtype=torch.bool),
        f32(start["kf_v"]), torch.zeros(K, 3), torch.zeros(K, 3), f32(start["mp_pos"]), torch.ones(P, dtype=torch.bool),
        torch.as_tensor(obs[:, 0].astype(np.int64)), torch.as_tensor(obs_mp), f32(obs[:, 2:4]),
        torch.ones(O, dtype=torch.bool), torch.as_tensor(build_obs_by_point(obs_mp, P, 16, O)).long(), pres,
        torch.ones(K - 1, dtype=torch.bool), z, z, *cam, kf_vb_fixed=torch.zeros(K, dtype=torch.bool),
        iters=10, jacobians=j) for j in ("analytic", "autodiff")}
    plain_pres = [plain.preintegrate(g, a, d, np.zeros(3), np.zeros(3), SIGMA_G, SIGMA_A) for g, a, d in windows]
    return start, torch.as_tensor(obs), plain_pres, cam, solves


def _plain_cost(problem, state):
    start, obs, plain_pres, cam, _ = problem
    K = len(start["kf_R"])
    zero = np.zeros((K - 1, 3))
    return plain.vi_ba_cost(state["kf_R"], state["kf_t"], state["kf_v"], state.get("kf_bg", np.zeros((K, 3))),
                            state.get("kf_ba", np.zeros((K, 3))), state["mp_pos"], obs, plain_pres, zero, zero, cam)


@pytest.mark.parametrize("jacobians", ["analytic", "autodiff"])
def test_vi_ba_cost_at_its_solution_matches_plain(vi_ba_solves, jacobians):
    res = vi_ba_solves[-1][jacobians]
    visual, inertial = _plain_cost(vi_ba_solves, res)
    total = float(res["costs"].min())  # the accepted steps' costs fall; a rejected step's is higher
    assert float(visual) == pytest.approx(float(res["cost"]), rel=1e-4)
    assert float(visual + inertial) == pytest.approx(total, rel=1e-4)
    assert total < 0.5 * float(sum(_plain_cost(vi_ba_solves, vi_ba_solves[0])))  # the solve did work


def test_closed_form_and_forward_mode_solves_reach_one_cost(vi_ba_solves):
    costs = [float(vi_ba_solves[-1][j]["costs"].min()) for j in ("analytic", "autodiff")]
    assert costs[0] == pytest.approx(costs[1], rel=1e-3)
