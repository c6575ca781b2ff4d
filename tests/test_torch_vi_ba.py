"""Port parity: ops/vi_ba (the joint visual-inertial LM) against the JAX
reference, and the reference's three behaviour tests (tests/test_vi_ba.py)
on the port.

Tolerances: the whitened edge residual and its 15x30 forward-mode Jacobian
within rtol 1e-4 (atol 1e-4 of the largest entry: the whitening scales
entries up to ~1e3); vi_ba_solve on tests/test_vi_ba.py's scene, padded to
K = 48 keyframes as LocalMapping._local_ba_vi pads it: poses and velocities
within 1e-4, biases within 1e-5, points within 1e-4 (of a 8 m scene), the
visual cost within 1e-6 absolute and the LM costs within rtol 1e-2 (they fall
to ~1e-7, where f32 rounding decides the last digits)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.ops import imu as jimu
from movslam_tpu.ops import vi_ba as jvi
from movslam_tpu_torch.ops import imu, vi_ba
from tests import test_vi_ba as ref
from tests._torch_parity import assert_close, t, to_np


_jax_edge = jax.jit(jvi._edge_residual)
_jax_edge_jac = jax.jit(jax.jacfwd(jvi._edge_residual))


def _windows(times, hz=200.0, gyro_bias=None):
    """The raw samples of tests/test_vi_ba.py::_imu_windows, padded: (gyro,
    acc, dts, valid) as numpy."""
    g = np.asarray(jimu.GRAVITY)
    winds = []
    for k in range(len(times) - 1):
        n = int(round((times[k + 1] - times[k]) * hz))
        dt = (times[k + 1] - times[k]) / n
        t_mid = times[k] + (np.arange(n) + 0.5) * dt
        gyro = np.zeros((n, 3), np.float32) + (gyro_bias if gyro_bias is not None else 0.0)
        acc = np.stack([ref._acc(tt) - g for tt in t_mid]).astype(np.float32)
        winds.append((gyro, acc, np.full(n, dt, np.float32)))
    cap, E = max(len(w[2]) for w in winds), len(winds)
    G, A = np.zeros((E, cap, 3), np.float32), np.zeros((E, cap, 3), np.float32)
    D, V = np.zeros((E, cap), np.float32), np.zeros((E, cap), bool)
    for e, (gy, ac, dts) in enumerate(winds):
        n = len(dts)
        G[e, :n], A[e, :n], D[e, :n], V[e, :n] = gy, ac, dts, True
    return G, A, D, V


def _port_pres(win, bg0=None, ba0=None):
    E = win[0].shape[0]
    z = torch.zeros(E, 3)
    return imu.preintegrate(*(t(x) for x in win), z if bg0 is None else t(bg0), z if ba0 is None else t(ba0))


def _port_solve(sc, pres, kf_R, kf_t, v, X, iters=12):
    """tests/test_vi_ba.py::_solve on the port: the first keyframe's pose
    fixed (gauge), its velocity and biases free."""
    K, P = sc["K"], sc["P"]
    E = K - 1
    z3 = torch.zeros(K, 3)
    res = vi_ba.vi_ba_solve(
        t(kf_R), t(kf_t), t(np.arange(K) == 0), torch.ones(K, dtype=torch.bool), t(v), z3, z3, t(X),
        torch.ones(P, dtype=torch.bool), t(sc["obs_kf"]).long(), t(sc["obs_mp"]).long(), t(sc["obs_uv"]),
        t(sc["obs_valid"]), t(sc["obp"]).long(), pres, torch.ones(E, dtype=torch.bool), torch.zeros(E, 3),
        torch.zeros(E, 3), ref.FX, ref.FY, ref.CX, ref.CY, kf_vb_fixed=torch.zeros(K, dtype=torch.bool),
        iters=iters,
    )
    return {k: to_np(x) for k, x in res.items()}


def _edge_case(rng):
    sc = ref._scene()
    win = _windows(sc["times"])
    jpre = {k: np.asarray(x)[1] for k, x in sc["pres"].items()}
    tpre = {k: x[1] for k, x in _port_pres(win).items()}
    Ri, Rj = (sc["kf_R"][k] for k in (1, 2))
    ti, tj = (sc["kf_t"][k] + rng.normal(0, 0.02, 3).astype(np.float32) for k in (1, 2))
    vi, vj = (sc["v"][k] + rng.normal(0, 0.05, 3).astype(np.float32) for k in (1, 2))
    bgi, bai, bgj, baj, bg0, ba0 = (rng.normal(0, 0.01, 3).astype(np.float32) for _ in range(6))
    d = rng.normal(0, 1e-3, 30).astype(np.float32)
    return jpre, tpre, ((Ri, ti, vi, bgi, bai), (Rj, tj, vj, bgj, baj)), bg0, ba0, d


@pytest.mark.parametrize("at", ["zero", "perturbed"])
def test_edge_residual_and_jacobian_match_reference(rng, at):
    jpre, tpre, (pose_i, pose_j), bg0, ba0, d = _edge_case(rng)
    d = d if at == "perturbed" else np.zeros(30, np.float32)
    jargs = (jpre, tuple(map(jnp.asarray, pose_i)), tuple(map(jnp.asarray, pose_j)), jnp.asarray(bg0),
             jnp.asarray(ba0), jnp.asarray(jimu.GRAVITY))

    whiten = vi_ba.edge_whitening(tpre["cov"])

    def tf(x):
        return vi_ba._edge_residual(x, tpre, tuple(map(t, pose_i)), tuple(map(t, pose_j)), t(bg0), t(ba0),
                                    imu.gravity_like(x), whiten)

    want_r = np.asarray(_jax_edge(jnp.asarray(d), *jargs))
    want_J = np.asarray(_jax_edge_jac(jnp.asarray(d), *jargs))
    got_r, got_J = tf(t(d)), torch.func.jacfwd(tf)(t(d))
    assert got_J.shape == (15, 30) and torch.isfinite(got_J).all()
    assert_close(got_r, want_r, 1e-4 * np.abs(want_r).max(), 1e-4, what="residual")
    assert_close(got_J, want_J, 1e-4 * np.abs(want_J).max(), 1e-4, what="Jacobian")


def test_edge_whitening_gives_nan_for_a_block_that_is_not_positive_definite():
    cov = torch.zeros(2, 15, 15)
    cov[0] = torch.eye(15) * 1e-8  # sqrt-information 1e4, capped to 1e3
    cov[1, :9, :9] = -torch.eye(9)  # not PD: XLA's Cholesky gives NaNs, and so does the port's
    W9, Wg, Wa = vi_ba.edge_whitening(cov)
    assert torch.isfinite(W9[0]).all() and torch.isnan(W9[1]).all()
    assert torch.isfinite(Wg).all() and torch.isfinite(Wa).all()
    assert float(W9[0].abs().max()) == pytest.approx(vi_ba.SQRT_INFO_CAP, rel=1e-6)  # capped


def _padded_problem(sc, kf_t, v, X, K=48):
    """The scene padded to K keyframe rows the way _local_ba_vi pads its chain
    (rows past the scene invalid and fixed, their edges invalid, preintegrated
    over no samples) and to 64 points (padding rows invalid)."""
    k, P, Pp = sc["K"], sc["P"], 64
    E = K - 1

    def pad(x, n, fill=0):
        return np.concatenate([x, np.full((n - len(x),) + x.shape[1:], fill, x.dtype)])

    kf_R = pad(sc["kf_R"], K)
    kf_R[k:] = np.eye(3, dtype=np.float32)
    obs_mp = sc["obs_mp"]
    obp = np.full((Pp, sc["obp"].shape[1]), len(obs_mp), np.int32)
    obp[:P] = sc["obp"]
    win = tuple(pad(w, E) for w in _windows(sc["times"]))
    inputs = dict(
        kf_R=kf_R, kf_t=pad(kf_t, K), kf_fixed=pad(np.arange(k) == 0, K, True), kf_valid=pad(np.ones(k, bool), K),
        kf_v=pad(v, K), kf_bg=np.zeros((K, 3), np.float32), kf_ba=np.zeros((K, 3), np.float32),
        mp_pos=pad(X, Pp), mp_valid=pad(np.ones(P, bool), Pp), obs_kf=sc["obs_kf"], obs_mp=obs_mp,
        obs_uv=sc["obs_uv"], obs_valid=sc["obs_valid"], obs_by_point=obp,
        pre_valid=pad(np.ones(k - 1, bool), E), pre_bg0=np.zeros((E, 3), np.float32),
        pre_ba0=np.zeros((E, 3), np.float32), kf_vb_fixed=np.arange(K) >= k,
    )
    return inputs, win


def test_vi_ba_solve_padded_to_48_keyframes_matches_reference():
    sc = ref._scene()
    rng = np.random.default_rng(3)
    K = sc["K"]
    kf_t = sc["kf_t"].copy()
    kf_t[1:] += rng.normal(0, 0.05, (K - 1, 3)).astype(np.float32)
    v = sc["v"] + rng.normal(0, 0.1, (K, 3)).astype(np.float32)
    X = sc["X"] + rng.normal(0, 0.05, sc["X"].shape).astype(np.float32)
    inputs, win = _padded_problem(sc, kf_t, v, X)
    order = ("kf_R", "kf_t", "kf_fixed", "kf_valid", "kf_v", "kf_bg", "kf_ba", "mp_pos", "mp_valid", "obs_kf",
             "obs_mp", "obs_uv", "obs_valid", "obs_by_point")
    jpres = jax.vmap(lambda g, a, d, vv: jimu.preintegrate(g, a, d, vv, jnp.zeros(3), jnp.zeros(3)))(
        *(jnp.asarray(x) for x in win))
    want = jax.device_get(jvi.vi_ba_solve(
        *(jnp.asarray(inputs[k]) for k in order), jpres, jnp.asarray(inputs["pre_valid"]),
        jnp.asarray(inputs["pre_bg0"]), jnp.asarray(inputs["pre_ba0"]), ref.FX, ref.FY, ref.CX, ref.CY,
        kf_vb_fixed=jnp.asarray(inputs["kf_vb_fixed"])))
    as_t = {k: t(x).long() if k in ("obs_kf", "obs_mp", "obs_by_point") else t(x) for k, x in inputs.items()}
    got = vi_ba.vi_ba_solve(
        *(as_t[k] for k in order), _port_pres(win), as_t["pre_valid"], as_t["pre_bg0"], as_t["pre_ba0"],
        ref.FX, ref.FY, ref.CX, ref.CY, kf_vb_fixed=as_t["kf_vb_fixed"])
    for k, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("kf_v", 1e-4), ("kf_bg", 1e-5), ("kf_ba", 1e-5),
                   ("mp_pos", 1e-4), ("depth", 1e-4)):
        assert_close(got[k], want[k], tol, what=k)
    assert_close(got["cost"], want["cost"], 1e-6, what="visual cost")
    assert_close(got["costs"], want["costs"], 1e-6, 1e-2, what="LM costs")
    assert np.abs(to_np(got["kf_t"])[:K] - sc["kf_t"]).max() < 5e-3  # converged, as the reference test asks


def test_vi_ba_converges_from_perturbation():
    sc = ref._scene()
    rng = np.random.default_rng(3)
    K = sc["K"]
    kf_t = sc["kf_t"].copy()
    kf_t[1:] += rng.normal(0, 0.05, (K - 1, 3)).astype(np.float32)
    v = sc["v"] + rng.normal(0, 0.1, (K, 3)).astype(np.float32)
    X = sc["X"] + rng.normal(0, 0.05, sc["X"].shape).astype(np.float32)
    res = _port_solve(sc, _port_pres(_windows(sc["times"])), sc["kf_R"], kf_t, v, X)
    assert np.all(np.isfinite(res["kf_t"]))
    assert np.linalg.norm(res["kf_t"] - sc["kf_t"], axis=1).max() < 5e-3
    assert np.linalg.norm(res["kf_v"] - sc["v"], axis=1)[:-1].max() < 0.05
    assert np.abs(res["kf_bg"]).max() < 1e-2
    assert res["cost"] < 1e-1


def test_vi_ba_recovers_metric_scale():
    sc = ref._scene()
    s = 1.25
    res = _port_solve(sc, _port_pres(_windows(sc["times"])), sc["kf_R"], sc["kf_t"] * s, sc["v"] * s,
                      sc["X"] * s, iters=16)

    def centers(kf_R, kf_t):
        return np.stack([-(kf_R[k].T @ kf_t[k]) for k in range(sc["K"])])

    d_gt = np.linalg.norm(np.diff(centers(sc["kf_R"], sc["kf_t"]), axis=0), axis=1)
    d_est = np.linalg.norm(np.diff(centers(res["kf_R"], res["kf_t"]), axis=0), axis=1)
    assert np.abs(d_est / d_gt - 1.0).max() < 0.05


def test_vi_ba_estimates_gyro_bias():
    sc = ref._scene()
    bias_true = np.array([0.02, -0.015, 0.01], np.float32)
    pres = _port_pres(_windows(sc["times"], gyro_bias=bias_true))
    res = _port_solve(sc, pres, sc["kf_R"], sc["kf_t"], sc["v"], sc["X"], iters=16)
    assert np.abs(res["kf_bg"][1:] - bias_true).max() < 5e-3
