"""Port parity: what the stereo slice adds below the window program.

The same numpy inputs go through the JAX function and its counterpart:
  - stage 1c of the per-frame program (left->right LK depth inside
    ops/frame_step): gate masks and -1.0 sentinels equal, ur within 1e-3 px,
    depth within 1e-3 relative, every other word as in the mono parity test;
  - core/stereo.compute_stereo_depth at 640x480 on a synthetic pair: the
    same masks and tolerances;
  - ops/pnp.pnp_ransac with ur/bf rows under replayed draws: pose within
    1e-4, inliers equal;
  - ops/ba.ba_solve_packed with obs_ur and bf, two fixed keyframes: poses and
    points within 1e-5 of the scene's size, chi2 within 1e-3;
  - Frame.from_packed(stereo=True): every field bit-exact.
The per-frame stereo drive is in tests/test_torch_stereo_per_frame.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.core import stereo as jstereo
from movslam_tpu.core.frame import Frame as JFrame
from movslam_tpu.core.trackstate import TrackState as JTrackState
from movslam_tpu.io.synthetic_stereo import SyntheticStereoStream as JStereoStream
from movslam_tpu.ops import ba as jba
from movslam_tpu.ops import frame_step as jfs
from movslam_tpu.ops import pnp as jpnp
from movslam_tpu_torch.core import stereo
from movslam_tpu_torch.core.extractor import MOVExtractor
from movslam_tpu_torch.core.frame import Frame
from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream
from movslam_tpu_torch.ops import ba, frame_step, pnp
from tests._torch_parity import (
    assert_close, assert_exact, assert_stereo_words, port_window_inputs, replay_jax_draws,
    stereo_settings, stereo_window_case, stereo_words, t, to_np,
)
from tests.test_ba import _make_problem, _pad
from tests.test_geometry import CX, CY, FX, FY, _pose, _project, _scene

pytestmark = pytest.mark.smoke

N, P = 512, 1024
INTR = np.array([320.0, 320.0, 160.0, 120.0], np.float32)
KW = dict(reproj_err=5.0, threshold=25.0, coverage_threshold=0.2, capacity=N, max_cov=512)


def test_stereo_stream_renders_reference_pairs():
    ours, ref = SyntheticStereoStream(n_points=120, seed=4), JStereoStream(n_points=120, seed=4)
    for k in (0, 2):
        (la, ra), (lb, rb) = ours.pair(k), ref.pair(k)
        assert_exact(la.im_gray, lb.im_gray, "left image")
        assert_exact(ra.im_gray, rb.im_gray, "right image")
        assert ra.n_mvs == rb.n_mvs == 0 and ra.ft == rb.ft and ra.timestamp == rb.timestamp
        assert_exact(la.mv_delta, lb.mv_delta, "left MVs")
    assert_exact(ours.gt_pose(3)[1], ref.gt_pose(3)[1])


@pytest.mark.parametrize("seed", [3, 5])
def test_stage_1c_depth_matches_reference(seed):
    """One frame of the per-frame program with has_stereo, JAX against the
    port, on the first frame of the stereo window case."""
    sc = stereo_window_case(seed, 4, N, P)
    a = {f.name: getattr(sc["st0"], f.name).numpy() for f in dataclasses.fields(sc["st0"])}
    a["desc"] = a["desc"].view(np.uint32)
    jst0 = JTrackState(**{k: jnp.asarray(v) for k, v in a.items()})
    n_mvs = sc["n_mvs"]
    mvk = sc["mvk"][0].astype(np.float32)
    mvk[:n_mvs, 0:2] *= np.float32(1.0 / 64.0)
    aux = np.zeros(13, np.float32)
    aux[0:12] = sc["pose_pack"][0:12]
    aux[12] = np.float32(sc["mvk"][0, -1, 0]) * np.float32(1.0 / 16384.0)
    key = jax.random.PRNGKey(seed)
    want = jfs.tracked_frame_step(
        jnp.asarray(sc["imgs"][0]), jnp.asarray(sc["prev_img"]), jst0, jnp.asarray(mvk[:-1]),
        jnp.asarray(aux), jnp.asarray(sc["snap"]), jnp.asarray(INTR), key, jnp.asarray(sc["dist_pack"]),
        jnp.asarray(sc["imgs_right"][0]), n_mvs=n_mvs, has_stereo=True, **KW)
    st, snap, _, _, _ = port_window_inputs(jst0, sc["snap"], sc["pose_pack"])
    trailer = np.zeros(16, np.float32)
    trailer[0:13] = aux
    k1, k2 = jax.random.split(jax.random.split(key)[1])
    got = frame_step.tracked_frame_step(
        t(sc["imgs"][0]), t(sc["prev_img"]), st, torch.cat([t(mvk[:-1]), t(trailer).reshape(2, 8)]), snap,
        t(INTR), replay_jax_draws([k1, k2]), t(sc["dist_pack"]), t(sc["imgs_right"][0]),
        n_mvs=n_mvs, has_stereo=True, **KW)
    gp, wp = to_np(got["packed"]), np.asarray(want["packed"])
    assert gp.shape == wp.shape == (N, frame_step.packed_cols(False, True)) and gp.dtype == np.int32
    assert_exact(gp[:, 1], wp[:, 1], "track id words")
    assert_exact(gp[:, 2], wp[:, 2], "meta words")
    have = assert_stereo_words(gp, wp, "stage 1c")
    valid = ((wp[:, 2] >> 25) & 4) != 0
    assert have.sum() > 0.5 * valid.sum() and valid.sum() > 50, (have.sum(), valid.sum())  # a real comparison
    assert not have[~valid].any()
    depth, ur = stereo_words(gp)
    assert (depth[have] > 0).all() and (ur[have] >= 0).all()
    gs, ws = to_np(got["scalars"]), np.asarray(want["scalars"])
    assert_exact(gs[12:], ws[12:], "n_ref, n_inliers, ok, next_id")
    assert ws[14] == 1 and ws[12] >= 10
    assert_close(gs[:12].copy().view(np.float32), ws[:12].copy().view(np.float32), 1e-4, what="pose")
    assert_exact(got["wire"][N * gp.shape[1] + 16:], np.asarray(want["wire"])[N * gp.shape[1] + 16:], "visibility")


def test_stage_1c_without_a_match_writes_sentinels():
    """n_good == 0: the masked median reads inf and every slot keeps -1.0."""
    sc = stereo_window_case(3, 4, N, P)
    st = sc["st0"]
    mvk = sc["mvk"][0].astype(np.float32)
    mvk[: sc["n_mvs"], 0:2] *= np.float32(1.0 / 64.0)
    trailer = np.zeros(16, np.float32)
    trailer[0:12] = sc["pose_pack"][0:12]
    gen = pnp.make_sampler(torch.Generator("cpu").manual_seed(0))
    out = frame_step.tracked_frame_step(
        t(sc["imgs"][0]), t(sc["prev_img"]), st, torch.cat([t(mvk[:-1]), t(trailer).reshape(2, 8)]),
        t(sc["snap"]), t(INTR), gen, t(sc["dist_pack"]), t(sc["imgs"][0]),  # right = left: disparity 0
        n_mvs=sc["n_mvs"], has_stereo=True, **KW)
    depth, ur = stereo_words(out["packed"])
    assert (depth == -1.0).all() and (ur == -1.0).all()
    assert int(np.float32(-1.0).view(np.int32)) == -1082130432  # the sentinel's bit pattern, not -1
    assert (to_np(out["packed"])[:, 3] == -1082130432).all()


def test_compute_stereo_depth_matches_reference():
    stream = SyntheticStereoStream(n_points=200, seed=4)
    left, right = stream.pair(0)  # the cold start: a dense grid of tracks
    state = MOVExtractor(threshold=25, device="cpu").extract(left, None, None)
    s = stereo_settings()
    pf = Frame(state, timestamp=0.0, image=left.im_gray, fid=0, camera=s.camera1)
    jf = JFrame(None)
    jf.pts, jf.pts_raw, jf.track_ids = pf.pts.copy(), pf.pts_raw.copy(), pf.track_ids.copy()
    jstereo.compute_stereo_depth(jf, left.im_gray, right.im_gray, s)
    stereo.compute_stereo_depth(pf, left.im_gray, right.im_gray, s, "cpu")
    assert pf.n == jf.n >= 300
    assert_exact(pf.depth_right == -1.0, jf.depth_right == -1.0, "depth gate mask")
    assert_exact(pf.uright == -1.0, jf.uright == -1.0, "ur gate mask")
    have = jf.depth_right > 0
    assert have.sum() > 0.5 * pf.n
    assert_close(pf.uright[have], jf.uright[have], 1e-3, what="ur (px)")
    assert_close(pf.depth_right[have], jf.depth_right[have], 0.0, rtol=1e-3, what="depth")
    # the background plane and the points lie 2-40 m away
    assert 2.0 < np.median(pf.depth_right[have]) < 40.0
    s.bf = 0.0  # a monocular rig: nothing to compute
    stereo.compute_stereo_depth(pf, left.im_gray, right.im_gray, s, "cpu")
    assert (pf.depth_right == -1.0).all() and (pf.uright == -1.0).all()


@pytest.mark.parametrize("case", ["outliers", "prior_lane", "mono_rows"])
def test_stereo_pnp_ransac_close_under_replayed_draws(rng, case):
    n = 8 if case == "prior_lane" else 300
    pts = _scene(rng, n)
    R, tt = _pose(rng)
    uv, z = _project(R, tt, pts)
    bf = 40.0
    ur = uv[:, 0] - bf / z + rng.normal(0, 0.3, n)
    if case == "prior_lane":
        R0, t0 = R, tt
    else:
        uv = uv + rng.normal(0, 0.5, uv.shape)
        out = rng.uniform(size=n) < 0.3
        uv[out] += rng.uniform(30, 200, (out.sum(), 2))
        ur[out[::-1]] += 25.0  # wrong right-image columns on other rows
        R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    if case == "mono_rows":
        ur[::2] = -1.0
    uv, ur = uv.astype(np.float32), ur.astype(np.float32)
    valid = np.ones(n, bool)
    valid[::17] = False
    key = jax.random.PRNGKey(5)
    want = jpnp.pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), FX, FY, CX, CY,
                           key, 3.0, jnp.asarray(R0), jnp.asarray(t0), ur=jnp.asarray(ur), bf=bf)
    got = pnp.pnp_ransac(t(pts), t(uv), t(valid), FX, FY, CX, CY, 3.0, t(R0), t(t0),
                         replay_jax_draws([key]), ur=t(ur), bf=bf)
    assert bool(want["ok"]) and bool(got["ok"])
    assert_close(got["R"], np.asarray(want["R"]), 1e-4)
    assert_close(got["t"], np.asarray(want["t"]), 1e-4)
    assert_exact(got["inliers"], np.asarray(want["inliers"]))
    assert int(got["n_inliers"]) == int(want["n_inliers"]) >= 4
    # the packed form, 7 columns
    data = np.concatenate([pts, uv, valid[:, None], ur[:, None]], 1).astype(np.float32)
    prior = np.concatenate([R0, t0[None]], 0).astype(np.float32)
    got7 = pnp.pnp_ransac_fused(t(data), t(prior), [FX, FY, CX, CY], 3.0, replay_jax_draws([key]),
                                bf=bf, stereo=True)
    assert_exact(got7["inliers"], got["inliers"])
    assert_close(got7["t"], got["t"], 0.0)
    mono = pnp.pnp_ransac_fused(t(data), t(prior), [FX, FY, CX, CY], 3.0, replay_jax_draws([key]))
    if case == "outliers":  # the wrong ur rows cost inliers only when they are read
        assert int(mono["n_inliers"]) > int(got["n_inliers"])


def _stereo_ba_packs(rng, bf):
    pts, Rs, ts, obs_kf, obs_mp, obs_uv = _make_problem(rng, n_kf=6, n_pts=150)
    K, P, O, n_obs = len(Rs), len(pts), 2048, len(obs_kf)
    pc = np.einsum("oij,oj->oi", Rs[obs_kf], pts[obs_mp]) + ts[obs_kf]
    ur = obs_uv[:, 0] - bf / pc[:, 2] + rng.normal(0, 0.3, n_obs)
    ur[::3] = -1.0  # a third of the observations are mono
    for k in range(2, K):
        ts[k] = ts[k] + rng.normal(0, 0.05, 3).astype(np.float32)
    pts = pts + rng.normal(0, 0.10, pts.shape).astype(np.float32)
    kf = np.concatenate([Rs.reshape(K, 9), ts, (np.arange(K) < 2)[:, None], np.ones((K, 1))], 1)
    mp = np.concatenate([pts, np.ones((P, 1))], 1)
    obs = np.zeros((O, 6), np.float32)
    obs[:, 4] = -1.0
    obs[:n_obs] = np.stack([obs_kf, obs_mp, obs_uv[:, 0], obs_uv[:, 1], ur, np.ones(n_obs)], 1)
    obp = ba.build_obs_by_point(_pad(obs_mp, O, P), P, 16, O)
    return kf.astype(np.float32), mp.astype(np.float32), obs, obp, n_obs


def test_stereo_ba_solve_packed_close(rng):
    bf = 40.0
    kf, mp, obs, obp, n_obs = _stereo_ba_packs(rng, bf)
    intr = np.array([FX, FY, CX, CY], np.float32)
    want = jba.ba_solve_packed(jnp.asarray(kf), jnp.asarray(mp), jnp.asarray(obs), jnp.asarray(obp),
                               jnp.asarray(intr), bf)
    got = ba.ba_solve_packed(t(kf), t(mp), t(obs), t(obp), [FX, FY, CX, CY], bf)
    scale = 16.0  # the scene's depth in metres
    assert_close(got[0], np.asarray(want[0]), 1e-5 * scale, what="poses")
    assert_close(got[1], np.asarray(want[1]), 1e-5 * scale, what="points")
    w = np.asarray(want[2])
    assert_close(to_np(got[2])[:n_obs, 0], w[:n_obs, 0], 1e-3 * w[:n_obs, 0].max(), 1e-3, what="chi2")
    assert_close(got[2][:, 1], w[:, 1], 1e-5 * scale, what="depth")
    assert np.abs(to_np(got[1]) - mp[:, 0:3]).max() > 0.05  # the solve moved the points
    # a tensor bf (the window program's dist_pack[9]) goes the same way
    got_t = ba.ba_solve_packed(t(kf), t(mp), t(obs), t(obp), [FX, FY, CX, CY], torch.tensor(bf))
    assert_close(got_t[1], got[1], 0.0)
    # and the stereo rows matter: without bf the solution differs
    mono = ba.ba_solve_packed(t(kf), t(mp), t(obs), t(obp), [FX, FY, CX, CY], 0.0)
    assert np.abs(to_np(mono[1]) - to_np(got[1])).max() > 1e-3


@pytest.mark.parametrize("has_dist", [False, True])
def test_frame_from_packed_stereo_bit_exact(rng, has_dist):
    n = 96
    C = frame_step.packed_cols(has_dist, True)
    pt = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    flags = rng.integers(0, 16, n)
    meta = (rng.integers(0, 4096, n) | (rng.integers(0, 4097, n) << 12) | (flags << 25)).astype(np.int32)
    cols = [to_np(frame_step.pack_pt_i32(t(pt))), rng.integers(0, 2**31 - 1, n).astype(np.int32), meta]
    if has_dist:
        cols.append(to_np(frame_step.pack_pt_i32(t(pt + 0.7))))
    depth = np.where(rng.uniform(size=n) < 0.6, rng.uniform(1, 40, n), -1.0).astype(np.float32)
    ur = np.where(depth > 0, pt[:, 0] - 80.0 / np.maximum(depth, 1.0), -1.0).astype(np.float32)
    cols += [depth.view(np.int32), ur.view(np.int32)]
    packed = np.stack(cols, 1)
    assert packed.shape == (n, C)
    want = JFrame.from_packed(packed, timestamp=1.5, fid=7, has_dist=has_dist, stereo=True)
    got = Frame.from_packed(packed, timestamp=1.5, fid=7, has_dist=has_dist, stereo=True)
    for name in ("pts", "pts_raw", "track_ids", "ages", "cap_rows", "depth_right", "uright",
                 "_fused_matched", "_fused_inlier", "_fused_midx"):
        assert_exact(getattr(got, name), getattr(want, name), name)
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    rows = got.cap_rows
    assert_exact(got.depth_right, depth[rows].astype(np.float64), "depth read back through a view")
    assert (got.depth_right[depth[rows] < 0] == -1.0).all()
    mono = Frame.from_packed(packed, timestamp=1.5, fid=7, has_dist=has_dist)
    assert mono.depth_right is None and mono.uright is None
