"""Port parity: ops/window_step (W frames per call) and what it stands on.

Bit-exact against the reference: MotionVectorImage.packed_joint_i16,
TrackState.rebuild, _apply_patch (dropped rows and id bit patterns
included), System._ba_patch_meta. The window program itself, W=4 at 240x320
on a synthetic stream under the reference's replayed RANSAC draws, with and
without a staged mapper job: packed id and meta words, counters and
visibility words equal; pt words equal (within 1 LSB = 1/32 px on LK-tracked
rows); the wire cut as System._replay_window cuts it; poses and pose_carry
within 1e-4; the trailing mapper section's BA points within 1e-4 and its
triangulations within 1e-3 m in a scene 30 m deep. (The staged job's BA
holds all its keyframes fixed: with free cameras over this planar scene the
two f32 solvers part by up to 7e-4 m in the weakest direction, which is the
problem's conditioning and not the window program's; ops/mapper_step's own
test solves free cameras in an 8 m scene to 1e-4.) And
the port against itself: a window equals W calls of the per-frame program on
the same de-quantised inputs, word for word."""
import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.core.system import System as JSystem
from movslam_tpu.core.trackstate import TrackState as JTrackState
from movslam_tpu.io.synthetic import SyntheticStream as JStream
from movslam_tpu.ops import window_step as jws
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.trackstate import TrackState
from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.ops import frame_step, window_step
from movslam_tpu_torch.ops.mapper_step import C_PATCH, MAPPER_SMALL, P_PATCH, split_mapper_wire
from movslam_tpu_torch.ops.pnp import make_sampler
from tests._torch_parity import (
    ID_BIT_CASES, assert_close, assert_exact, port_window_inputs, replay_jax_draws,
    t, to_np, window_case, window_keys,
)

pytestmark = pytest.mark.smoke

W, N, P = 4, 512, 1024
INTR = np.array([320.0, 320.0, 160.0, 120.0], np.float32)
KW = dict(reproj_err=5.0, threshold=25.0, coverage_threshold=0.2, capacity=N, max_cov=512)


def _bits(x):
    return np.ascontiguousarray(to_np(x)).view(np.int32)


def test_packed_joint_i16_matches_reference():
    ours = SyntheticStream(n_points=120, seed=4, width=320, height=240, max_mvs=1024, max_kps=512)
    ref = JStream(n_points=120, seed=4, width=320, height=240, max_mvs=1024, max_kps=512)
    for k in (1, 2):
        got, m = ours.frame(k).packed_joint_i16()
        want, mw = ref.frame(k).packed_joint_i16()
        assert m == mw and got.dtype == np.int16
        assert_exact(got, want, "packed_joint_i16")
        assert got[-1, 0] == round(ours.frame(k).coverage_area * 16384.0)


def test_trackstate_rebuild_matches_reference(rng):
    n = 64
    pt = rng.uniform(-20, 700, (n, 2)).astype(np.float32)
    flags = rng.integers(0, 16, n)
    meta = (rng.integers(0, 4096, n) | (rng.integers(0, 4097, n) << 12) | (flags << 25)).astype(np.int32)
    packed = np.stack([to_np(frame_step.pack_pt_i32(t(pt))), rng.integers(0, 2**31 - 1, n).astype(np.int32),
                       meta], 1)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    want = JTrackState.rebuild(jnp.asarray(packed), jnp.asarray(desc), 777)
    got = TrackState.rebuild(t(packed), t(desc.view(np.int32)), 777)
    for name in ("pt", "track_id", "age", "mb_wh", "coverage", "valid", "next_id"):
        assert_exact(getattr(got, name), np.asarray(getattr(want, name)), name)
    assert_exact(to_np(got.desc).view(np.uint32), np.asarray(want.desc), "desc")
    assert_close(got.pt, np.round(pt * 32) / 32, 0.0, what="pt carries the 1/32-px quantisation")
    assert got.track_id.dtype == torch.int32 and got.next_id.dtype == torch.int32
    assert_exact(frame_step.unpack_pt_dev(t(packed[:, 0])), frame_step.unpack_pt_np(packed[:, 0]).astype(np.float32))


def test_apply_patch_bit_exact_with_drops_and_id_bits(rng):
    Ps, C = 256, 64
    snap = rng.normal(size=(Ps, 12)).astype(np.float32)
    snap[:, 10] = rng.integers(0, 2**31 - 1, Ps).astype(np.int32).view(np.float32)
    patch_tri = rng.normal(size=(C, 10)).astype(np.float32)
    ids = (9000 + np.arange(C)).astype(np.int32)
    ids[: len(ID_BIT_CASES)] = ID_BIT_CASES
    patch_tri[:, 3] = ids.view(np.float32)
    patch_tri[:, 4] = (np.arange(C) % 3 != 1).astype(np.float32)  # a third fail the gates
    patch_tri[: len(ID_BIT_CASES), 4] = 1.0
    n_base = 200  # rows 200..263: the last 8 fall off the end of the snapshot
    patch_mp = rng.normal(size=(40, 3)).astype(np.float32)
    rows = rng.permutation(n_base)[:40].astype(np.float32)
    rows[::5] = Ps  # "drop"
    rows[3] = Ps + 50  # any row past the end drops
    meta = np.concatenate([[n_base], rows]).astype(np.float32)
    want = np.asarray(jws._apply_patch(jnp.asarray(snap), jnp.asarray(patch_tri), jnp.asarray(patch_mp),
                                       jnp.asarray(meta)))
    got = to_np(window_step._apply_patch(t(snap), t(patch_tri), t(patch_mp), t(meta)))
    assert got.shape == (Ps, 12)
    assert_exact(_bits(got), _bits(want), "patched snapshot, every word")
    written = _bits(got[n_base : n_base + len(ID_BIT_CASES), 10])
    assert_exact(written, ID_BIT_CASES, "id bits (denormal, large, NaN patterns) in col 10")
    assert_exact(_bits(got[n_base + 7]), _bits(snap[n_base + 7]), "a gated-out row stays")
    assert np.abs(got[:n_base, 0:3] - snap[:n_base, 0:3]).max() > 0  # BA rows really moved
    assert_exact(_bits(t(snap)), _bits(snap), "the input snapshot is not written")


def test_ba_patch_meta_matches_reference(rng):
    tids = rng.permutation(5000)[:300].astype(np.int64)
    tids[17] = tids[3]  # a duplicate id in the snapshot: the first row wins
    mps = [types.SimpleNamespace(track_id=int(x)) for x in tids]

    def fake_snap():
        order = np.argsort(tids, kind="stable")
        return types.SimpleNamespace(mps=mps, tid_order=lambda: (order, tids[order]))

    ba_ids = np.concatenate([tids[rng.permutation(300)[:120]], 6000 + np.arange(30)])
    ba = {"mps": [types.SimpleNamespace(track_id=int(x)) for x in ba_ids if x != tids[3]]}
    want = JSystem._ba_patch_meta(fake_snap(), ba)
    got = System._ba_patch_meta(fake_snap(), ba)
    assert got.shape == (P_PATCH + 1,) and got.dtype == np.float32
    assert_exact(got, want, "patch meta")
    kept = got[1:][got[1:] < frame_step.SNAP_CAP]
    assert len(kept) == len(np.unique(kept)) > 50  # no snapshot row is written twice
    assert_exact(System._ba_patch_meta(fake_snap(), None)[1:], np.full(P_PATCH, frame_step.SNAP_CAP, np.float32))


# --- the window program ---------------------------------------------------------------

def _scenario(seed):
    """tests/_torch_parity.window_case, with the entering state also as a
    JAX TrackState (the port's cold start equals the reference's:
    tests/test_torch_extractor.py)."""
    sc = window_case(seed, W, N, P)
    a = {f.name: getattr(sc["st0"], f.name).numpy() for f in dataclasses.fields(sc["st0"])}
    a["desc"] = a["desc"].view(np.uint32)
    sc["jst0"] = JTrackState(**{k: jnp.asarray(v) for k, v in a.items()})
    return sc


@pytest.fixture(scope="module", params=[3, 5])
def scenario(request):
    return request.param, _scenario(request.param)


def _run_both(seed, sc, staged):
    key = jax.random.PRNGKey(seed)
    kw = dict(KW, n_mvs=sc["n_mvs"])
    jargs = [jnp.asarray(sc[k]) for k in ("imgs", "prev_img")] + [sc["jst0"]] + [
        jnp.asarray(sc[k]) for k in ("mvk", "pose_pack", "snap")] + [jnp.asarray(sc["intr"]), key]
    st, snap, pose_pack, mtri, mba = port_window_inputs(
        sc["jst0"], sc["snap"], sc["pose_pack"],
        *((sc["job"]["tri_wire"], sc["job"]["ba_wire"]) if staged else (None, None)))
    pargs = [t(sc["imgs"]), t(sc["prev_img"]), st, t(sc["mvk"]), pose_pack, snap, t(INTR),
             replay_jax_draws(window_keys(key, W))]
    if staged:
        tri = sc["job"]["tri_wire"].copy()
        tri[0, 30] = 1.0  # the reference's in-program flag, as LocalMapping sets it
        want = jws.tracked_window_step(
            *jargs, patch_tri=jnp.zeros((C_PATCH, 10), jnp.float32), patch_mp=jnp.zeros((P_PATCH, 3), jnp.float32),
            patch_meta=jnp.asarray(sc["meta"]), mtri=jnp.asarray(tri), mba=jnp.asarray(sc["job"]["ba_wire"]), **kw)
        got = window_step.tracked_window_step(*pargs, patch_meta=t(sc["meta"]), mtri=t(tri), mba=mba, **kw)
    else:
        want = jws.tracked_window_step(*jargs, **kw)
        got = window_step.tracked_window_step(*pargs, **kw)
    return want, got


@pytest.mark.parametrize("staged", [False, True], ids=["no_job", "staged_job"])
def test_tracked_window_step_wire(scenario, staged):
    seed, sc = scenario
    want, got = _run_both(seed, sc, staged)
    C = frame_step.packed_cols()
    w_wire, g_wire = np.asarray(want["wire"]), to_np(got["wire"])
    assert g_wire.dtype == np.int32
    # Cut as System._replay_window cuts it.
    o1 = W * N * C
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
    ws, gs = w_wire[o1:o2].reshape(W, 16), g_wire[o1:o2].reshape(W, 16)
    assert (ws[:, 14] == 1).all() and (ws[:, 12] >= 10).all()  # every frame solved: a real comparison
    assert_exact(gs[:, 12:], ws[:, 12:], "n_ref, n_inliers, ok, next_id")
    pose_tol = 1e-4
    assert_close(gs[:, :12].copy().view(np.float32), ws[:, :12].copy().view(np.float32), pose_tol, what="poses")
    assert_exact(g_wire[o2:o3], w_wire[o2:o3], "visibility words")
    assert_close(got["pose_carry"], np.asarray(want["pose_carry"]), pose_tol, what="pose_carry")
    assert to_np(got["pose_carry"])[24] == 1.0
    assert_exact(to_np(got["desc_w"]).view(np.uint32), np.asarray(want["desc_w"]), "desc_w")
    assert_exact(got["state"].track_id, np.asarray(want["state"].track_id), "carried state ids")
    midx = ((gp[:, :, 2] >> 12) & 0x1FFF) - 1
    if staged:
        # Patched rows (>= n_base) are matched: the job's triangulations
        # reached the window's snapshot.
        assert (midx >= sc["n_base"]).sum() >= 5
        Xg, kf_g, mp_g, obs_g = split_mapper_wire(g_wire[-mlen:].copy().view(np.float32), **sz)
        Xw, kf_w, mp_w, obs_w = split_mapper_wire(w_wire[-mlen:].copy().view(np.float32), **sz)
        ok = ~sc["job"]["bad"]
        assert_close(Xg[: len(ok)][ok], Xw[: len(ok)][ok], 1e-3, what="mapper X (30 m scene)")
        assert_exact(kf_g, kf_w, "mapper BA poses (all fixed: unchanged)")
        assert_close(mp_g, mp_w, 1e-4, what="mapper BA points")
        n_ba = int((sc["meta"][1:] < frame_step.SNAP_CAP).sum())
        assert np.abs(mp_g[:n_ba] - sc["snap"][:n_ba, 0:3]).max() > 1e-3  # the BA moved them
    else:
        assert (midx < sc["n_base"]).all()


def test_window_equals_sequential_frame_steps(scenario):
    """The port's window against W calls of the port's per-frame program on
    the same de-quantised i16 inputs, same draws: every word equal."""
    seed, sc = scenario
    kw = dict(KW, n_mvs=sc["n_mvs"])
    st, snap, pose_pack, _, _ = port_window_inputs(sc["jst0"], sc["snap"], sc["pose_pack"])
    gen = lambda: make_sampler(torch.Generator("cpu").manual_seed(seed))  # noqa: E731
    win = window_step.tracked_window_step(t(sc["imgs"]), t(sc["prev_img"]), st, t(sc["mvk"]), pose_pack,
                                          snap, t(INTR), gen(), **kw)
    C = frame_step.packed_cols()
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
            t(INTR), sampler, **kw)
        assert_exact(out["packed"], wire[:o1].reshape(W, N, C)[k], f"frame {k} packed")
        assert_exact(out["scalars"], wire[o1:o2].reshape(W, 16)[k], f"frame {k} scalars")
        assert_exact(frame_step.pack_bits_i32(out["snap_visible"]), wire[o2:].reshape(W, P // 32)[k],
                     f"frame {k} visibility")
        pose = out["scalars"][0:12].view(torch.float32)
        assert int(out["scalars"][14]) == 1 and int(out["scalars"][12]) >= 10
        R_cur, t_cur = pose[0:9].reshape(3, 3), pose[9:12]
        v_R = R_cur @ l_R.T
        v_t = t_cur - v_R @ l_t
        l_R, l_t, state, prev_img = R_cur, t_cur, out["state"], t(sc["imgs"][k])
    assert_exact(win["pose_carry"], torch.cat([l_R.reshape(-1), l_t, v_R.reshape(-1), v_t, torch.ones(1)]))


def test_stereo_window_names_its_slice(scenario):
    _, sc = scenario
    st, snap, pose_pack, _, _ = port_window_inputs(sc["jst0"], sc["snap"], sc["pose_pack"])
    with pytest.raises(NotImplementedError, match="stereo slice"):
        window_step.tracked_window_step(t(sc["imgs"]), t(sc["prev_img"]), st, t(sc["mvk"]), pose_pack, snap,
                                        t(INTR), None, imgs_right=t(sc["imgs"]), n_mvs=sc["n_mvs"], **KW)
