"""Port parity: ops/linalg, ops/triangulate, ops/pnp, ops/twoview, ops/ba.

Tolerances: PnP and two-view poses within 1e-4 (the two-view baseline
direction 1e-3, see there) under the reference's own RANSAC draws (replayed through the injectable sampler); BA outputs within
1e-3 relative on the cases of tests/test_ba.py; small linear algebra within
f32 rounding of a differently ordered sum."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.ops import ba as jba
from movslam_tpu.ops import lie as jlie
from movslam_tpu.ops import linalg as jlin
from movslam_tpu.ops import pnp as jpnp
from movslam_tpu.ops import triangulate as jtri
from movslam_tpu.ops import twoview as jtv
from movslam_tpu_torch.ops import ba, linalg, pnp, triangulate, twoview
from tests._torch_parity import assert_close, assert_exact, replay_jax_draws, t, to_np
from tests.test_ba import _make_problem, _pad
from tests.test_geometry import CX, CY, FX, FY, _pose, _project, _scene

pytestmark = pytest.mark.smoke


def _spd(rng, shape, n):
    A = rng.normal(size=shape + (n, n)).astype(np.float32)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n, dtype=np.float32)


def test_small_linalg_close(rng):
    S = _spd(rng, (64,), 6)
    b = rng.normal(size=(64, 6)).astype(np.float32)
    assert_close(linalg.chol_solve_small(t(S), t(b)),
                 np.asarray(jlin.chol_solve_small(jnp.asarray(S), jnp.asarray(b))), 1e-5, 1e-4)
    A = rng.normal(size=(32, 3, 3)).astype(np.float32)
    assert_close(linalg.inv3x3(t(A), eps=1e-30), np.asarray(jlin.inv3x3(jnp.asarray(A), eps=1e-30)), 1e-4, 1e-4)
    G = rng.normal(size=(16, 9, 8)).astype(np.float32)
    G = G @ np.swapaxes(G, -1, -2)  # rank 8: a clean null direction
    v, jv = linalg.smallest_nullvec(t(G)), np.asarray(jlin.smallest_nullvec(jnp.asarray(G)))
    v = to_np(v) * np.sign((to_np(v) * jv).sum(-1, keepdims=True))
    assert_close(v, jv, 1e-4)
    S12 = _spd(rng, (), 12)
    assert_close(linalg.solve_psd(t(S12), t(b[0].repeat(2))),
                 np.asarray(jlin.solve_psd(jnp.asarray(S12), jnp.asarray(b[0].repeat(2)))), 1e-5, 1e-4)


def test_triangulate_close(rng):
    pts = _scene(rng, 64)
    R, tt = _pose(rng)
    r1 = pts[:, :2] / pts[:, 2:]
    pc2 = pts @ R.T + tt
    r2 = pc2[:, :2] / pc2[:, 2:]
    got = triangulate.triangulate_rays(t(R), t(tt), t(r1), t(r2))
    want = np.asarray(jtri.triangulate_rays(jnp.asarray(R), jnp.asarray(tt), jnp.asarray(r1), jnp.asarray(r2)))
    assert_close(got, want, 1e-3, 1e-4)
    P2s = np.concatenate([np.broadcast_to(R, (64, 3, 3)), np.broadcast_to(tt[:, None], (64, 3, 1))], -1)
    P1 = np.eye(3, 4, dtype=np.float32)
    got = triangulate.triangulate_pairs_np(P1, P2s, r1, r2, "cpu")
    want = jtri.triangulate_pairs_padded(P1, P2s, r1, r2)
    assert_close(got, want, 1e-3, 1e-4)


@pytest.mark.parametrize("case", ["outliers", "prior_lane"])
def test_pnp_ransac_close_under_replayed_draws(rng, case):
    n = 300 if case == "outliers" else 8
    pts = _scene(rng, n)
    R, tt = _pose(rng)
    uv, _ = _project(R, tt, pts)
    if case == "outliers":
        uv = uv + rng.normal(0, 0.5, uv.shape)
        out = rng.uniform(size=n) < 0.3
        uv[out] += rng.uniform(30, 200, (out.sum(), 2))
        R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    else:
        R0, t0 = R, tt
    uv = uv.astype(np.float32)
    valid = np.ones(n, bool)
    valid[::17] = False
    key = jax.random.PRNGKey(3)
    want = jpnp.pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), FX, FY, CX, CY,
                           key, 3.0, jnp.asarray(R0), jnp.asarray(t0))
    got = pnp.pnp_ransac(t(pts), t(uv), t(valid), FX, FY, CX, CY, 3.0, t(R0), t(t0),
                         replay_jax_draws([key]))
    assert bool(want["ok"]) and bool(got["ok"])
    assert_close(got["R"], np.asarray(want["R"]), 1e-4)
    assert_close(got["t"], np.asarray(want["t"]), 1e-4)
    assert_exact(got["inliers"], np.asarray(want["inliers"]))
    assert int(got["n_inliers"]) == int(want["n_inliers"])


def test_pnp_default_sampler_solves(rng):
    pts = _scene(rng, 200)
    R, tt = _pose(rng)
    uv, _ = _project(R, tt, pts)
    gen = torch.Generator("cpu").manual_seed(7)
    res = pnp.pnp_ransac(t(pts), t(uv), torch.ones(200, dtype=torch.bool), FX, FY, CX, CY, 3.0,
                         torch.eye(3), torch.zeros(3), pnp.make_sampler(gen))
    assert bool(res["ok"]) and int(res["n_inliers"]) == 200
    assert_close(res["R"], R, 1e-3)


def test_two_view_close_under_replayed_draws(rng):
    pts = _scene(rng, 300)
    R, _ = _pose(rng, rot_scale=0.05, t_scale=0.0)
    tt = np.array([0.8, 0.1, 0.05], np.float32)
    uv1, z1 = _project(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), pts)
    uv2, z2 = _project(R, tt, pts)
    uv1 = (uv1 + rng.normal(0, 0.3, uv1.shape)).astype(np.float32)
    uv2 = (uv2 + rng.normal(0, 0.3, uv2.shape)).astype(np.float32)
    out = rng.uniform(size=len(pts)) < 0.2
    uv2[out] += rng.uniform(20, 100, (out.sum(), 2)).astype(np.float32)
    valid = (z1 > 0) & (z2 > 0)
    key = jax.random.PRNGKey(2)
    want = jtv.reconstruct_two_views(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                                     FX, FY, CX, CY, key)
    got = twoview.reconstruct_two_views(t(uv1), t(uv2), t(valid), FX, FY, CX, CY,
                                        replay_jax_draws([key], split=False))
    assert bool(want["ok"]) and bool(got["ok"])
    assert_close(got["R21"], np.asarray(want["R21"]), 1e-4)
    # t21 is the null direction of a ~200-row 8-point refit in f32: on this
    # scene the reference itself sits 4.5e-4 from a float64 solve, so the
    # direction is compared at 1e-3 (the rotation holds 1e-4).
    assert_close(got["t21"], np.asarray(want["t21"]), 1e-3)
    assert int(got["n_inliers"]) == int(want["n_inliers"])
    assert_exact(got["triangulated"], np.asarray(want["triangulated"]))
    tri = np.asarray(want["triangulated"])
    assert_close(to_np(got["points"])[tri], np.asarray(want["points"])[tri], 1e-3, 1e-3)


def _ba_inputs(rng, outliers):
    n_kf, n_pts, O = (4, 80, 1024) if outliers else (6, 150, 2048)
    pts, Rs, ts, obs_kf, obs_mp, obs_uv = _make_problem(rng, n_kf=n_kf, n_pts=n_pts)
    K, P, n_obs = len(Rs), len(pts), len(obs_kf)
    if outliers:
        idx = rng.choice(n_obs, size=n_obs // 10, replace=False)
        obs_uv[idx] += rng.uniform(15, 60, (len(idx), 2)).astype(np.float32)
    else:
        for k in range(1, K):
            dw = jnp.asarray(rng.normal(0, 0.01, 3).astype(np.float32))
            Rs[k] = np.asarray(jlie.so3_exp(dw)) @ Rs[k]
            ts[k] = ts[k] + rng.normal(0, 0.05, 3).astype(np.float32)
        pts = pts + rng.normal(0, 0.10, pts.shape).astype(np.float32)
    obs_valid = np.arange(O) < n_obs
    obp = jba.build_obs_by_point(_pad(obs_mp, O, P), P, 16, O)
    assert_exact(ba.build_obs_by_point(_pad(obs_mp, O, P), P, 16, O), obp)
    # Two fixed keyframes: one fixed camera leaves mono BA a free scale, and
    # a flat cost direction is no place to compare two solvers.
    return [Rs, ts, np.arange(K) < 2, np.ones(K, bool), pts, np.ones(P, bool),
            _pad(obs_kf, O), _pad(obs_mp, O), _pad(obs_uv, O), obs_valid, obp], n_obs


@pytest.mark.parametrize("outliers", [False, True])
def test_ba_solve_close(rng, outliers):
    args, n_obs = _ba_inputs(rng, outliers)
    want = jba.ba_solve(*[jnp.asarray(a) for a in args], FX, FY, CX, CY)
    got = ba.ba_solve(*[t(a) for a in args], FX, FY, CX, CY)
    for k in ("kf_R", "kf_t", "mp_pos"):
        w = np.asarray(want[k])
        assert_close(got[k], w, 1e-3 * np.abs(w).max(), 1e-3, what=k)
    w = np.asarray(want["chi2"])[:n_obs]
    assert_close(to_np(got["chi2"])[:n_obs], w, 1e-3 * w.max(), 1e-3, what="chi2")
    assert_close(got["depth"], np.asarray(want["depth"]), 1e-3 * 16, 1e-3, what="depth")


def test_ba_solve_wire_matches_ba_solve(rng):
    args, _ = _ba_inputs(rng, False)
    Rs, ts, fixed, kval, pts, pval, okf, omp, ouv, oval, obp = args
    K, P, O = len(Rs), len(pts), len(okf)
    kf = np.concatenate([Rs.reshape(K, 9), ts, fixed[:, None], kval[:, None]], 1)
    mp = np.concatenate([pts, pval[:, None]], 1)
    obs = np.stack([okf, omp, ouv[:, 0], ouv[:, 1], -np.ones(O), oval], 1)
    wire = np.concatenate([kf.ravel(), mp.ravel(), obs.ravel(), obp.ravel()]).astype(np.float32)
    out = ba.ba_solve_wire(t(wire), [FX, FY, CX, CY], 0.0, K=K, P=P, O=O, MOPP=16)
    res = ba.ba_solve(*[t(a) for a in args], FX, FY, CX, CY)
    assert_close(out[: K * 12].reshape(K, 12)[:, 9:12], res["kf_t"], 0.0)
    assert_close(out[K * 12 : K * 12 + P * 3].reshape(P, 3), res["mp_pos"], 0.0)
    # bf != 0 adds the stereo row; with every ur = -1 it is zero everywhere
    # and the solve goes the same way.
    out_s = ba.ba_solve_wire(t(wire), [FX, FY, CX, CY], 40.0, K=K, P=P, O=O, MOPP=16)
    assert_close(out_s, out, 1e-5, what="bf != 0 without stereo rows")
