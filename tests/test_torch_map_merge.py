"""The port's multi-map merge (core/map_merge.py over ops/posegraph.py) and
the mapper's welding block, against the JAX package where both run.

The maps come from one port drive over SyntheticStream(n_points=300,
seed=22): its first 16 frames are checkpointed (core/checkpoint.py), and a
copy of that map, re-keyed and moved by a known Sim3 (s = 1.7), plays the
new map, as tests/test_map_merge.py::_build_map_pair does. The same file
loads into both packages, so the parity case starts from identical maps:
the same surviving point ids, keyframe poses and points within 1e-4.

The drive then goes on as tracking loss leaves it when the map has more
than 10 keyframes (Tracking._create_map_in_atlas, what the state machine
calls then): a new map initializes from the persistent tracks, and at its
fifth keyframe LocalMapping.process_one welds it into the old one. The
weld's accuracy is the reference's: a least-squares Umeyama fit over the
~47 points the two maps share (ROADMAP Queue 3), so the test holds the
structure of the welded map, not its trajectory error."""
import numpy as np
import pytest
import torch

from movslam_tpu.core import checkpoint as jckpt
from movslam_tpu.core import map_merge as jmerge
from movslam_tpu_torch.core import checkpoint, map_merge
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.tracking import State
from movslam_tpu_torch.io.mvimage import MotionVectorImage
from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.ops import lie
from tests._torch_parity import assert_close
from tests.test_torch_system import MONOCULAR, port_settings

N_FIRST, N_SECOND = 16, 7


def _run(system, stream, start, n):
    for k in range(start, start + n):
        smv = stream.frame(k)
        system.track_monocular(smv.timestamp, smv)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    stream = SyntheticStream(n_points=300, seed=22)
    system = System(port_settings(), MONOCULAR, device="cpu")
    _run(system, stream, 0, N_FIRST)
    assert system.tracking.state == State.OK
    path = str(tmp_path_factory.mktemp("merge") / "first.atlas")
    system.save_atlas(path)
    old_kfs = set(system.atlas.current.keyframes)
    system.tracking._create_map_in_atlas()
    maps_after_loss = len(system.atlas.maps)
    _run(system, stream, N_FIRST, N_SECOND)
    system.shutdown()
    return {"system": system, "path": path, "old_kfs": old_kfs,
            "maps_after_loss": maps_after_loss}


SIM3 = (1.7, lie.so3_exp(torch.tensor([0.05, -0.3, 0.1], dtype=torch.float64)).numpy(), np.array([2.0, -1.0, 0.5]))


def map_pair(ckpt, path):
    """Two maps of one scene: the checkpoint loaded twice; the copy moved by
    SIM3 (x_new = R^T (x_old - t) / s) and re-keyed so that its ids do not
    collide with the original's (tests/test_map_merge.py::_build_map_pair)."""
    atlas = ckpt.load_atlas(path)
    m_old = atlas.current
    m_new = ckpt.load_atlas(path).current
    s, R, t = SIM3
    for kf in m_new.keyframes.values():
        kf.set_pose(kf.R @ R, (kf.t + kf.R @ t) / s)
    for mp in m_new.mappoints.values():
        mp.pos = R.T @ (mp.pos - t) / s
    off_kf, off_mp = max(m_old.keyframes) + 1000, max(m_old.mappoints) + 100000
    m_new.keyframes = {k + off_kf: v for k, v in m_new.keyframes.items()}
    for k, kf in m_new.keyframes.items():
        kf.id = k
        kf.covis = {c + off_kf: w for c, w in kf.covis.items()}
        kf.mp_ids = np.where(kf.mp_ids >= 0, kf.mp_ids + off_mp, -1)
    m_new.mappoints = {k + off_mp: v for k, v in m_new.mappoints.items()}
    for k, mp in m_new.mappoints.items():
        mp.id = k
        mp.obs = {kf_id + off_kf: slot for kf_id, slot in mp.obs.items()}
        mp.first_kf_id += off_kf
    m_new.init_kf_id += off_kf
    atlas.maps.append(m_new)
    atlas.current = m_new
    return atlas, m_old, m_new


def test_umeyama_sim3_exact(rng):
    x = rng.normal(0, 2, (50, 3))
    s, R, t = 1.3, lie.so3_exp(torch.tensor([0.1, 0.2, -0.1], dtype=torch.float64)).numpy(), np.array([1, 2, 3.0])
    s2, R2, t2 = map_merge.umeyama_sim3(x, x @ (s * R).T + t)
    assert abs(s2 - s) < 1e-6
    np.testing.assert_allclose(R2, R, atol=1e-6)
    np.testing.assert_allclose(t2, t, atol=1e-6)
    sj, Rj, tj = jmerge.umeyama_sim3(x, x @ (s * R).T + t)
    assert s2 == sj and np.array_equal(R2, Rj) and np.array_equal(t2, tj)


def test_merge_maps_welds_and_aligns(drive):
    atlas, m_old, m_new = map_pair(checkpoint, drive["path"])
    n_old, n_new = m_old.n_keyframes(), m_new.n_keyframes()
    old_pos = {mp.track_id: mp.pos.copy() for mp in m_old.mappoints.values() if not mp.bad}
    assert map_merge.try_merge(atlas, device="cpu")
    assert atlas.current is m_old and len(atlas.maps) == 1
    assert m_old.n_keyframes() == n_old + n_new
    tids = [mp.track_id for mp in m_old.mappoints.values() if not mp.bad]
    assert len(tids) == len(set(tids))  # one point per track id
    errs = [np.linalg.norm(mp.pos - old_pos[mp.track_id]) for mp in m_old.mappoints.values()
            if not mp.bad and mp.track_id in old_pos]
    assert np.median(errs) < 0.05, np.median(errs)


def test_merge_rejects_unrelated_maps(drive):
    atlas, _, m_new = map_pair(checkpoint, drive["path"])
    for mp in m_new.mappoints.values():
        mp.track_id += 10_000_000  # no shared tracks
    assert not map_merge.try_merge(atlas, device="cpu")
    assert len(atlas.maps) == 2 and atlas.current is m_new


def test_merge_matches_jax(drive):
    """One file, both packages, the same Sim3: the same welded map."""
    out = {}
    for name, ckpt, merge in (("port", checkpoint, map_merge.try_merge), ("jax", jckpt, jmerge.try_merge)):
        atlas, m_old, _ = map_pair(ckpt, drive["path"])
        assert (merge(atlas, device="cpu") if name == "port" else merge(atlas))
        kfs = sorted(m_old.keyframes)
        mps = sorted(k for k, mp in m_old.mappoints.items() if not mp.bad)
        out[name] = (kfs, mps, np.stack([m_old.keyframes[k].R for k in kfs]),
                     np.stack([m_old.keyframes[k].t for k in kfs]), np.stack([m_old.mappoints[k].pos for k in mps]),
                     {k: dict(m_old.keyframes[k].covis) for k in kfs},
                     {k: dict(m_old.mappoints[k].obs) for k in mps},
                     np.stack([m_old.mappoints[k].normal for k in mps]))
    (kp, mp, Rp, tp, Xp, cp, op, Np), (kj, mj, Rj, tj, Xj, cj, oj, Nj) = out["port"], out["jax"]
    # MapPoint.replace, KeyFrame.update_connections and update_normals_batch
    # left the same graph behind
    assert kp == kj and mp == mj and cp == cj and op == oj
    assert_close(Rp, Rj, 1e-4, what="R")
    assert_close(tp, tj, 1e-4, what="t")
    assert_close(Xp, Xj, 1e-4, what="points")
    assert_close(Np, Nj, 1e-4, what="normals")


def test_merge_keeps_the_references_free_scale_and_velocities(drive):
    """ROADMAP Queue 3, kept on purpose: the Sim3 has a free scale for every
    sensor (here a map marked metric by the VI init still gets s = 1.7), and
    KeyFrame.velocity is not rotated into the old map's frame. Both packages."""
    for ckpt, merge, kw in ((checkpoint, map_merge, {"device": "cpu"}), (jckpt, jmerge, {})):
        atlas, m_old, m_new = map_pair(ckpt, drive["path"])
        for m in (m_old, m_new):
            m.imu_initialized, m.imu_scale = True, 1.0
        vel = {kf.id: np.array([0.3, -0.1, 0.2]) * (i + 1) for i, kf in enumerate(m_new.keyframes.values())}
        for kf in m_new.keyframes.values():
            kf.velocity = vel[kf.id].copy()
        pairs = merge.shared_track_correspondences(m_old, m_new)
        s_fit, _, _ = merge.umeyama_sim3(np.stack([b.pos for _, b in pairs]), np.stack([a.pos for a, _ in pairs]))
        assert merge.try_merge(atlas, **kw)
        assert abs(s_fit - SIM3[0]) < 1e-3, s_fit
        for kf_id, v in vel.items():
            np.testing.assert_array_equal(m_old.keyframes[kf_id].velocity, v)


def test_second_map_is_welded_by_the_mapper(drive):
    """The loss path's second map, merged at its fifth keyframe inside
    LocalMapping.process_one (the welding block, not a direct try_merge)."""
    system = drive["system"]
    assert drive["maps_after_loss"] == 2
    assert len(system.atlas.maps) == 1
    m = system.atlas.current
    assert drive["old_kfs"] <= set(m.keyframes) | set(m.culled_keyframes)
    new = [kf for kf in m.keyframes.values() if kf.frame_id >= N_FIRST]
    assert len(new) >= 3 and all(kf.map_id == m.id for kf in new)
    assert system.tracking.state == State.OK and system.get_total_lost() == 0
    tids = [mp.track_id for mp in m.mappoints.values() if not mp.bad]
    assert len(tids) == len(set(tids))
    assert all(np.isfinite(kf.t).all() for kf in m.keyframes.values())
    assert all(np.isfinite(mp.pos).all() for mp in m.mappoints.values())


def test_tracking_loss_recovery_creates_map_or_recovers():
    """tests/test_system_features.py::test_tracking_loss_recovery_creates_map_or_recovers
    on the port: 8 featureless frames mid-stream must not crash; tracking
    recovers on the old map, resets it or starts a new one."""
    stream = SyntheticStream(n_points=300, seed=22)
    system = System(port_settings(), MONOCULAR, device="cpu")
    _run(system, stream, 0, 16)
    assert system.tracking.state == State.OK
    n_maps_before = len(system.atlas.maps)
    rng = np.random.default_rng(0)
    for k in range(16, 24):
        smv = MotionVectorImage.empty(640, 480)
        smv.timestamp = k / 30.0
        smv.im_gray = rng.integers(100, 110, (480, 640)).astype(np.uint8)
        system.track_monocular(smv.timestamp, smv)
    assert system.tracking.state in (State.RECENTLY_LOST, State.LOST, State.NO_IMAGES_YET,
                                     State.NOT_INITIALIZED)
    _run(system, stream, 24, 15)
    assert system.tracking.state in (State.OK, State.NOT_INITIALIZED, State.RECENTLY_LOST)
    assert len(system.atlas.maps) >= n_maps_before
    system.shutdown()
