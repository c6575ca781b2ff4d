"""Port parity: one stereo window (ops/window_step with has_stereo).

W=4 at 240x320 on a synthetic stereo pair stream whose map comes from frame
0's own stereo depths, under the reference's replayed RANSAC draws
(tests/_torch_parity.window_keys), with and without a staged mapper job (its
BA then runs with bf = dist_pack[9]): track id and meta words, counters and
visibility words equal to the JAX tracked_window_step(has_stereo=True); the
depth and ur words' -1.0 sentinels (the gate masks) equal, ur within 1e-3 px,
depth within 1e-3 relative; pt words within 1 LSB on LK rows; poses and
pose_carry within 1e-4. And the port against itself: a stereo window equals W
calls of the per-frame program with has_stereo, word for word.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.core.trackstate import TrackState as JTrackState
from movslam_tpu.ops import window_step as jws
from movslam_tpu_torch.ops import frame_step, window_step
from movslam_tpu_torch.ops.mapper_step import C_PATCH, MAPPER_SMALL, P_PATCH, split_mapper_wire
from movslam_tpu_torch.ops.pnp import make_sampler
from tests._torch_parity import (
    assert_close, assert_exact, assert_stereo_words, port_window_inputs, replay_jax_draws,
    stereo_window_case, stereo_words, t, to_np, window_keys,
)

pytestmark = pytest.mark.smoke

W, N, P = 4, 512, 1024
INTR = np.array([320.0, 320.0, 160.0, 120.0], np.float32)
KW = dict(reproj_err=5.0, threshold=25.0, coverage_threshold=0.2, capacity=N, max_cov=512, has_stereo=True)
C = frame_step.packed_cols(False, True)


@pytest.fixture(scope="module", params=[3, 5])
def scenario(request):
    sc = stereo_window_case(request.param, W, N, P)
    a = {f.name: getattr(sc["st0"], f.name).numpy() for f in dataclasses.fields(sc["st0"])}
    a["desc"] = a["desc"].view(np.uint32)
    sc["jst0"] = JTrackState(**{k: jnp.asarray(v) for k, v in a.items()})
    return request.param, sc


def _run_both(seed, sc, staged):
    key = jax.random.PRNGKey(seed)
    kw = dict(KW, n_mvs=sc["n_mvs"])
    jargs = [jnp.asarray(sc[k]) for k in ("imgs", "prev_img")] + [sc["jst0"]] + [
        jnp.asarray(sc[k]) for k in ("mvk", "pose_pack", "snap")] + [
        jnp.asarray(sc["intr"]), key, jnp.asarray(sc["dist_pack"]), jnp.asarray(sc["imgs_right"])]
    st, snap, pose_pack, _, mba = port_window_inputs(
        sc["jst0"], sc["snap"], sc["pose_pack"], None, sc["job"]["ba_wire"] if staged else None)
    pargs = [t(sc["imgs"]), t(sc["prev_img"]), st, t(sc["mvk"]), pose_pack, snap, t(INTR),
             replay_jax_draws(window_keys(key, W)), t(sc["dist_pack"]), t(sc["imgs_right"])]
    if not staged:
        return jws.tracked_window_step(*jargs, **kw), window_step.tracked_window_step(*pargs, **kw)
    tri = sc["job"]["tri_wire"].copy()
    tri[0, 30] = 1.0  # the reference's in-program flag, as LocalMapping sets it
    want = jws.tracked_window_step(
        *jargs, patch_tri=jnp.zeros((C_PATCH, 10), jnp.float32), patch_mp=jnp.zeros((P_PATCH, 3), jnp.float32),
        patch_meta=jnp.asarray(sc["meta"]), mtri=jnp.asarray(tri), mba=jnp.asarray(sc["job"]["ba_wire"]), **kw)
    got = window_step.tracked_window_step(*pargs, patch_meta=t(sc["meta"]), mtri=t(tri), mba=mba, **kw)
    return want, got


@pytest.mark.parametrize("staged", [False, True], ids=["no_job", "staged_job"])
def test_stereo_window_wire(scenario, staged):
    seed, sc = scenario
    want, got = _run_both(seed, sc, staged)
    w_wire, g_wire = np.asarray(want["wire"]), to_np(got["wire"])
    assert g_wire.dtype == np.int32
    o1 = W * N * C  # cut as System._replay_window cuts it
    o2 = o1 + W * frame_step.N_SCALARS
    o3 = o2 + W * (P // 32)
    sz = MAPPER_SMALL
    mlen = sz["C"] * 3 + sz["K"] * 12 + sz["P"] * 3 + sz["O"] * 2
    assert len(g_wire) == o3 + (mlen if staged else 0)
    if staged:
        assert len(w_wire) == len(g_wire)
    wp, gp = w_wire[:o1].reshape(W, N, C), g_wire[:o1].reshape(W, N, C)
    assert_exact(to_np(got["packed_w"]), gp, "packed_w side channel = the wire's packed section")
    assert_exact(gp[:, :, 1], wp[:, :, 1], "track id words")
    assert_exact(gp[:, :, 2], wp[:, :, 2], "meta words")
    lk = ((wp[:, :, 2] >> 25) & 8) != 0
    assert_exact(gp[~lk][:, 0], wp[~lk][:, 0], "pt words")
    for half in (0, 1):
        q = lambda w: ((w << (16 * (1 - half))) >> 16)  # noqa: E731
        assert np.abs(q(gp[lk][:, 0]) - q(wp[lk][:, 0])).max(initial=0) <= 1
    have = assert_stereo_words(gp, wp, "window")
    valid = ((wp[:, :, 2] >> 25) & 4) != 0
    assert (have.sum(1) > 0.5 * valid.sum(1)).all() and not have[~valid].any()
    ws, gs = w_wire[o1:o2].reshape(W, 16), g_wire[o1:o2].reshape(W, 16)
    assert (ws[:, 14] == 1).all() and (ws[:, 12] >= 10).all()  # every frame solved: a real comparison
    assert_exact(gs[:, 12:], ws[:, 12:], "n_ref, n_inliers, ok, next_id")
    assert_close(gs[:, :12].copy().view(np.float32), ws[:, :12].copy().view(np.float32), 1e-4, what="poses")
    assert_exact(g_wire[o2:o3], w_wire[o2:o3], "visibility words")
    assert_close(got["pose_carry"], np.asarray(want["pose_carry"]), 1e-4, what="pose_carry")
    assert_exact(to_np(got["desc_w"]).view(np.uint32), np.asarray(want["desc_w"]), "desc_w")
    assert_exact(got["state"].track_id, np.asarray(want["state"].track_id), "carried state ids")
    # Stereo rows reached the solve: matched slots with a depth are inliers.
    inl = ((gp[:, :, 2] >> 25) & 2) != 0
    assert (inl & have).sum() > 0.5 * inl.sum()
    if staged:
        midx = ((gp[:, :, 2] >> 12) & 0x1FFF) - 1
        assert (midx >= sc["n_base"]).sum() >= 5  # the job's triangulations were matched
        Xg, kf_g, mp_g, _ = split_mapper_wire(g_wire[-mlen:].copy().view(np.float32), **sz)
        Xw, kf_w, mp_w, _ = split_mapper_wire(w_wire[-mlen:].copy().view(np.float32), **sz)
        ok = ~sc["job"]["bad"]
        assert_close(Xg[: len(ok)][ok], Xw[: len(ok)][ok], 1e-3, what="mapper X")
        assert_exact(kf_g, kf_w, "mapper BA poses (all fixed: unchanged)")
        assert_close(mp_g, mp_w, 1e-4, what="mapper BA points (bf = 80)")


def test_stereo_window_equals_sequential_frame_steps(scenario):
    seed, sc = scenario
    kw = dict(KW, n_mvs=sc["n_mvs"])
    st, snap, pose_pack, _, _ = port_window_inputs(sc["jst0"], sc["snap"], sc["pose_pack"])
    gen = lambda: make_sampler(torch.Generator("cpu").manual_seed(seed))  # noqa: E731
    dist_pack = t(sc["dist_pack"])
    win = window_step.tracked_window_step(t(sc["imgs"]), t(sc["prev_img"]), st, t(sc["mvk"]), pose_pack,
                                          snap, t(INTR), gen(), dist_pack, t(sc["imgs_right"]), **kw)
    wire = to_np(win["wire"])
    o1 = W * N * C
    o2 = o1 + W * 16
    sampler = gen()
    state, prev_img = st, t(sc["prev_img"])
    l_R, l_t = pose_pack[0:9].reshape(3, 3), pose_pack[9:12]
    v_R = v_t = None
    for k in range(W):
        mvk = sc["mvk"][k].astype(np.float32)
        mvk[: sc["n_mvs"], 0:2] *= np.float32(1.0 / 64.0)
        prior_R = v_R @ l_R if v_R is not None else l_R
        prior_t = v_R @ l_t + v_t if v_R is not None else l_t
        trailer = torch.zeros(16)
        trailer[0:9], trailer[9:12] = prior_R.reshape(-1), prior_t
        trailer[12] = t(sc["mvk"][k, -1, 0].astype(np.float32)) * (1.0 / 16384.0)
        out = frame_step.tracked_frame_step(
            t(sc["imgs"][k]), prev_img, state, torch.cat([t(mvk[:-1]), trailer.reshape(2, 8)]), snap,
            t(INTR), sampler, dist_pack, t(sc["imgs_right"][k]), **kw)
        assert_exact(out["packed"], wire[:o1].reshape(W, N, C)[k], f"frame {k} packed, stereo words included")
        assert_exact(out["scalars"], wire[o1:o2].reshape(W, 16)[k], f"frame {k} scalars")
        assert_exact(frame_step.pack_bits_i32(out["snap_visible"]), wire[o2:].reshape(W, P // 32)[k],
                     f"frame {k} visibility")
        depth, _ = stereo_words(out["packed"])
        assert (depth > 0).sum() > 40
        pose = out["scalars"][0:12].view(torch.float32)
        R_cur, t_cur = pose[0:9].reshape(3, 3), pose[9:12]
        v_R = R_cur @ l_R.T
        v_t = t_cur - v_R @ l_t
        l_R, l_t, state, prev_img = R_cur, t_cur, out["state"], t(sc["imgs"][k])
