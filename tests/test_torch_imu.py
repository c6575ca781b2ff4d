"""Port parity: ops/lie.so3_log and ops/imu (preintegration, the inertial
residual, the gravity/scale LM) against the JAX reference.

Tolerances: so3_log and its forward-mode Jacobian within 1e-5 (the Jacobian
within 1e-3 at angles near pi, where the f32 derivative of arccos amplifies
the last bit of the trace by ~1e3 on either side); the
preintegrated deltas, bias Jacobians and covariance within rtol 1e-4 (atol
1e-4 of each field's largest entry); the loop that stops after the longest
window bit-exact with the full 512-step one; the bias-corrected deltas and
the residual within 1e-5; the gravity/scale solve's scale within rtol 1e-5,
gravity rotation and velocities within 1e-5, biases within 1e-5 absolute
(they sit at ~1e-5, where f32 solves differ in the last digits)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.ops import imu as jimu
from movslam_tpu.ops import lie as jlie
from movslam_tpu_torch.ops import imu, lie
from tests._torch_parity import assert_close, assert_exact, t, to_np

PRE_KEYS = ("dR", "dv", "dp", "dt", "JRg", "Jvg", "Jva", "Jpg", "Jpa", "cov")


# d/dphi Log(Exp(phi) R) at phi = 0, one compiled program for every R
_jax_log_jac = jax.jit(jax.jacfwd(lambda p, R: jlie.so3_log(jlie.so3_exp(p) @ R)))


def _rotations(rng, n, scale):
    return np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, scale, (n, 3)).astype(np.float32))))


@pytest.mark.parametrize("case", ["identity", "random", "small", "near_pi"])
def test_so3_log_and_its_jacfwd_match_reference(rng, case):
    R0 = {
        "identity": np.tile(np.eye(3, dtype=np.float32), (1, 1, 1)),
        "random": _rotations(rng, 8, 0.8),
        "small": _rotations(rng, 8, 1e-4),
        "near_pi": _rotations(rng, 4, 1.0) @ np.asarray(jlie.so3_exp(jnp.asarray([2.9, 0.0, 0.0]))),
    }[case].astype(np.float32)
    assert_close(lie.so3_log(t(R0)), np.asarray(jax.jit(jlie.so3_log)(jnp.asarray(R0))), 1e-5, what="so3_log")
    for R in R0:
        # d/dphi Log(Exp(phi) R) at phi = 0: where jacfwd takes the inertial
        # Jacobians (at the identity in the case of that name).
        got = torch.func.jacfwd(lambda p: lie.so3_log(lie.so3_exp(p) @ t(R)))(torch.zeros(3))
        want = _jax_log_jac(jnp.zeros(3), jnp.asarray(R))
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert_close(got, np.asarray(want), 1e-3 if case == "near_pi" else 1e-5, what="jacfwd so3_log")
    # so3_exp and the left Jacobian keep finite forward-mode derivatives at 0
    for fn, jfn in ((lie.so3_exp, jlie.so3_exp), (lie._so3_left_jacobian, jlie._so3_left_jacobian)):
        got = torch.func.jacfwd(fn)(torch.zeros(3))
        assert torch.isfinite(got).all()
        assert_close(got, np.asarray(jax.jit(jax.jacfwd(jfn))(jnp.zeros(3))), 1e-5)


def _imu_case(rng, lengths, cap=512):
    """Padded windows of random IMU samples (a gravity-like accelerometer
    offset, gyro rates up to ~1 rad/s) and nonzero per-window biases."""
    E = len(lengths)
    gyro = rng.normal(0, 0.5, (E, cap, 3)).astype(np.float32)
    acc = (rng.normal(0, 2.0, (E, cap, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    dts = rng.uniform(0.003, 0.006, (E, cap)).astype(np.float32)
    valid = np.zeros((E, cap), bool)
    for e, n in enumerate(lengths):
        valid[e, :n] = True
    bg = rng.normal(0, 0.01, (E, 3)).astype(np.float32)
    ba = rng.normal(0, 0.05, (E, 3)).astype(np.float32)
    return gyro, acc, dts, valid, bg, ba


def _jax_pre(gyro, acc, dts, valid, bg, ba):
    return jax.device_get(jax.vmap(jimu.preintegrate)(*(jnp.asarray(x) for x in (gyro, acc, dts, valid, bg, ba))))


def test_preintegrate_matches_reference(rng):
    case = _imu_case(rng, [64, 17, 0, 40, 5], cap=64)
    got = imu.preintegrate(*(t(x) for x in case))
    want = _jax_pre(*case)
    for k in PRE_KEYS:
        w = np.asarray(want[k])
        assert_close(got[k], w, atol=1e-4 * max(np.abs(w).max(), 1e-30), rtol=1e-4, what=k)
    assert_exact(got["dR"][2], np.eye(3, dtype=np.float32), "an empty window stays the identity")


def test_preintegrate_stops_after_the_longest_window():
    """Padded steps leave the carry as it was: the loop that stops after the
    last valid step equals the full 512-step loop bit for bit."""
    case = _imu_case(np.random.default_rng(7), [24, 9, 0, 48], cap=512)
    args = [t(x) for x in case]
    full = imu.preintegrate(*args)
    short = imu.preintegrate(*args, steps=48)
    for k in PRE_KEYS:
        assert_exact(short[k], full[k], k)


def _one_window(rng, n=80):
    gyro, acc, dts, valid, _, _ = _imu_case(rng, [n], cap=n)
    g, a, d, v = gyro[0], acc[0], dts[0], valid[0]
    zero = np.zeros(3, np.float32)
    jpre = jax.device_get(jimu.preintegrate(*(jnp.asarray(x) for x in (g, a, d, v, zero, zero))))
    tpre = {k: x[0] for k, x in imu.preintegrate(*(t(x[None]) for x in (g, a, d, v)), t(zero), t(zero)).items()}
    return jpre, tpre


def test_bias_corrected_deltas_and_inertial_residual_match_reference(rng):
    jpre, tpre = _one_window(rng)
    dbg = rng.normal(0, 0.01, 3).astype(np.float32)
    dba = rng.normal(0, 0.05, 3).astype(np.float32)
    for got, want in zip(imu.bias_corrected_deltas(tpre, t(dbg), t(dba)),
                         jimu.bias_corrected_deltas(jpre, jnp.asarray(dbg), jnp.asarray(dba))):
        assert_close(got, np.asarray(want), 1e-5, 1e-5)
    Ri, Rj = _rotations(rng, 2, 0.5)
    p_i, v_i, p_j, v_j, bg, ba, bg0, ba0 = (rng.normal(0, 0.3, 3).astype(np.float32) for _ in range(8))
    args = (Ri, p_i, v_i, Rj, p_j, v_j, bg, ba, bg0, ba0)
    got = imu.inertial_residual(tpre, *(t(x) for x in args))
    want = jimu.inertial_residual(jpre, *(jnp.asarray(x) for x in args))
    assert_close(got, np.asarray(want), 1e-5, 1e-5)


def _gs_scene():
    """tests/test_posegraph_imu.py::test_inertial_gs_optimize_recovers_scale_and_gravity's
    scene: a circle at constant speed, identity attitude, a map shrunk by 2.5
    and gravity tilted by (0.06, -0.04, 0)."""
    s_true = 2.5
    tilt = np.asarray(jlie.so3_exp(jnp.asarray([0.06, -0.04, 0.0], jnp.float32)))
    g_w = tilt @ np.asarray(jimu.GRAVITY)
    r_c, omega = 2.0, 0.6
    imu_dt, per_win, K = 0.005, 100, 9

    def state(tt):
        p = np.array([r_c * np.cos(omega * tt), r_c * np.sin(omega * tt), 0.0])
        v = r_c * omega * np.array([-np.sin(omega * tt), np.cos(omega * tt), 0.0])
        a = -r_c * omega ** 2 * np.array([np.cos(omega * tt), np.sin(omega * tt), 0.0])
        return p, v, a

    Rs, ps, vs, accs = [], [], [], []
    for k in range(K):
        t0 = k * per_win * imu_dt
        p, v, _ = state(t0)
        Rs.append(np.eye(3, dtype=np.float32))
        ps.append((p / s_true).astype(np.float32))
        vs.append(v.astype(np.float32))
        if k < K - 1:
            accs.append([state(t0 + i * imu_dt)[2] - g_w for i in range(per_win)])
    acc = np.asarray(accs, np.float32)
    E = K - 1
    win = (np.zeros_like(acc), acc, np.full((E, per_win), imu_dt, np.float32), np.ones((E, per_win), bool))
    return win, np.stack(Rs), np.stack(ps), np.stack(vs)


def test_inertial_gs_optimize_matches_reference():
    (gyro, acc, dts, valid), Rs, ps, vs = _gs_scene()
    E = len(dts)
    zero = np.zeros(3, np.float32)
    jpres = jax.vmap(lambda g, a, d, v: jimu.preintegrate(g, a, d, v, jnp.zeros(3), jnp.zeros(3)))(
        *(jnp.asarray(x) for x in (gyro, acc, dts, valid)))
    want = jax.device_get(jimu.inertial_gs_optimize(
        jpres, jnp.asarray(Rs), jnp.asarray(ps), jnp.asarray(vs), jnp.zeros(3), jnp.zeros(3),
        jnp.ones(E, bool), iters=12))
    tpres = imu.preintegrate(t(gyro), t(acc), t(dts), t(valid), t(zero), t(zero))
    got = imu.inertial_gs_optimize(tpres, t(Rs), t(ps), t(vs), t(zero), t(zero), torch.ones(E, dtype=torch.bool),
                                   iters=12)
    assert abs(float(got["scale"]) - 2.5) / 2.5 < 0.02  # the reference test's bound, on the port
    assert_close(got["scale"], want["scale"], 0.0, 1e-5, what="scale")
    assert_close(got["Rwg"], want["Rwg"], 1e-5, what="Rwg")
    assert_close(got["vel"], want["vel"], 1e-5, what="velocities")
    assert_close(got["bg"], want["bg"], 1e-5, what="bg")
    assert_close(got["ba"], want["ba"], 1e-5, what="ba")
    costs = to_np(got["costs"])
    assert costs[-1] < costs[0] * 1e-3
    assert imu.gravity_like(t(ps)).tolist() == pytest.approx([0.0, 0.0, -9.81])
