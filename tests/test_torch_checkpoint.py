"""The port's atlas checkpoint (core/checkpoint.py) and the System surface
around it (save_atlas / load_atlas, Settings.load_atlas / save_atlas,
global_bundle_adjustment, get_timings).

One port drive makes the map: SyntheticStream(n_points=300, seed=21) (the
stream of tests/test_system_features.py::test_atlas_checkpoint_roundtrip),
8 frames per frame and 8 through the windowed drive, so that the map holds
keyframes with eager and with lazily archived descriptors. A file written by
either package loads in the other: counts equal and every array bit-equal
(the codec copies bytes; no tolerance)."""
import os

import numpy as np
import pytest

from movslam_tpu.core import checkpoint as jckpt
from movslam_tpu.core import map as jmap
from movslam_tpu_torch.core import checkpoint, map as pmap
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.io.synthetic import SyntheticStream
from tests._torch_parity import gba_map
from tests.test_torch_system import MONOCULAR, port_settings

N_PER_FRAME, N_WINDOWED = 8, 8


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    stream = SyntheticStream(n_points=300, seed=21)
    system = System(port_settings(), MONOCULAR, device="cpu")
    for k in range(N_PER_FRAME):
        smv = stream.frame(k)
        system.track_monocular(smv.timestamp, smv)
    items = [(f.timestamp, f) for f in (stream.frame(k) for k in range(N_PER_FRAME, N_PER_FRAME + N_WINDOWED))]
    system.track_monocular_batch(items)
    system.shutdown()
    lazy = [kf.id for kf in system.atlas.current.keyframes.values() if kf._desc_thunk is not None]
    path = str(tmp_path_factory.mktemp("atlas") / "session.atlas")
    system.save_atlas(path)
    return system, path, lazy


def _kf_arrays(kf):
    return {"R": kf.R, "t": kf.t, "track_ids": kf.track_ids, "pts": kf.pts, "desc": kf.desc,
            "mp_ids": kf.mp_ids, "image": kf.image}


def _mp_arrays(mp):
    return {"pos": mp.pos, "normal": mp.normal}


def _kf_fields(kf):
    link = lambda k: -1 if k is None else k.id  # noqa: E731
    return (kf.id, kf.frame_id, kf.timestamp, kf.covis, sorted(kf.children), kf.map_id,
            link(kf.parent), link(kf.prev_kf), link(kf.next_kf))


def _mp_fields(mp):
    return (mp.id, mp.track_id, mp.first_kf_id, mp.map_id, mp.obs, mp.min_dist, mp.max_dist,
            mp.n_visible, mp.n_found)


def _assert_same(a, b, fields, arrays):
    assert fields(a) == fields(b)
    for name, x in arrays(a).items():
        y = arrays(b)[name]
        if y is None:
            assert x is None, name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def assert_same_atlas(got, want):
    """Same maps, ids, links and scalars; every array bit-equal (dtype too)."""
    assert [m.id for m in got.maps] == [m.id for m in want.maps]
    assert got.current.id == want.current.id
    for mg, mw in zip(got.maps, want.maps):
        assert mg.init_kf_id == mw.init_kf_id
        assert sorted(mg.keyframes) == sorted(mw.keyframes)
        assert sorted(mg.mappoints) == sorted(mw.mappoints)
        for i, kf in mw.keyframes.items():
            _assert_same(mg.keyframes[i], kf, _kf_fields, _kf_arrays)
        for i, mp in mw.mappoints.items():
            _assert_same(mg.mappoints[i], mp, _mp_fields, _mp_arrays)


def test_atlas_checkpoint_roundtrip(drive):
    """tests/test_system_features.py::test_atlas_checkpoint_roundtrip on the port."""
    system, path, _ = drive
    m = system.atlas.current
    assert m.n_keyframes() > 3 and m.n_mappoints() > 100
    atlas2 = checkpoint.load_atlas(path)
    m2 = atlas2.current
    assert m2.n_keyframes() == m.n_keyframes() and m2.n_mappoints() == m.n_mappoints()
    for mp in m2.mappoints.values():  # graph links restored
        for kf_id, slot in mp.obs.items():
            assert m2.keyframes[kf_id].mp_ids[slot] == mp.id
    assert_same_atlas(atlas2, system.atlas)
    kf = next(iter(m2.keyframes.values()))
    assert kf._desc_thunk is None and kf.Tcp is None  # every slot the port reads is set
    # the id counters run on past the loaded ids
    assert next(pmap.KeyFrame._next_id) > max(m2.keyframes)
    assert next(pmap.MapPoint._next_id) > max(m2.mappoints)
    assert pmap.Map().id > m2.id


def test_windowed_keyframe_descriptors_are_saved_as_uint32(drive):
    """A keyframe made by the windowed drive keeps its descriptors behind a
    thunk; saving pulls them and writes uint32 (n, 8) words."""
    system, path, lazy = drive
    assert lazy, "no keyframe of the windowed drive archived its descriptors lazily"
    loaded = checkpoint.load_atlas(path).current
    for kf_id in lazy:
        desc = loaded.keyframes[kf_id].desc
        assert isinstance(desc, np.ndarray) and desc.dtype == np.uint32
        assert desc.shape == (len(loaded.keyframes[kf_id].track_ids), 8) and desc.any()
        np.testing.assert_array_equal(desc, system.atlas.current.keyframes[kf_id].desc)
    with np.load(path, allow_pickle=False) as z:
        assert all(z[k].dtype != object for k in z.files)


def test_port_file_loads_in_jax(drive, tmp_path):
    """Port -> JAX: the reference's load_atlas reads the port's file; saved
    again by the reference, it loads back in the port unchanged."""
    system, path, _ = drive
    atlas_j = jckpt.load_atlas(path)
    assert_same_atlas(atlas_j, system.atlas)
    again = str(tmp_path / "again.atlas")
    jckpt.save_atlas(atlas_j, again)
    assert_same_atlas(checkpoint.load_atlas(again), system.atlas)


def test_jax_file_loads_in_port(tmp_path):
    """JAX -> port: a map made by the reference's own classes (keyframes
    with descriptors, images and covisibility, two maps) loads in the port."""
    from movslam_tpu.core import camera as jcamera

    rng = np.random.default_rng(0)
    atlas = jmap.Atlas()
    first = atlas.current
    m, _, kfs = gba_map(jmap, jcamera, n_kf=6, n_mp=80, seed=1)
    atlas.maps.append(m)
    atlas.current = m
    for kf in kfs:
        kf.desc = rng.integers(0, 2**32, (len(kf.track_ids), 8), dtype=np.uint32)
        kf.image = rng.integers(0, 256, (24, 32), dtype=np.uint8)
        kf.update_connections(m)
    for a, b in zip(kfs, kfs[1:]):
        a.next_kf, b.prev_kf = b, a
    path = str(tmp_path / "jax.atlas")
    jckpt.save_atlas(atlas, path)
    got = checkpoint.load_atlas(path)
    assert [mm.id for mm in got.maps] == [first.id, m.id] and got.current.id == m.id
    assert got.current.n_keyframes() == 6 and got.current.n_mappoints() == 80
    assert_same_atlas(got, atlas)
    assert got.current.keyframes[kfs[1].id].prev_kf is got.current.keyframes[kfs[0].id]


def test_stereo_and_vi_state_is_dropped(drive, tmp_path):
    """The reference's checkpoint carries no stereo or visual-inertial state
    (ROADMAP Queue 3); the port keeps that, in both directions."""
    _, path, _ = drive
    atlas = checkpoint.load_atlas(path)
    m = atlas.current
    for kf in m.keyframes.values():
        n = len(kf.track_ids)
        kf.depth_right, kf.uright = np.full(n, 2.0), np.full(n, 100.0)
        kf.velocity, kf.bias_g, kf.bias_a = np.ones(3), np.ones(3), np.ones(3)
    m.imu_initialized, m.imu_scale, m.imu_init_count = True, 3.0, 2
    stereo_vi = str(tmp_path / "stereo_vi.atlas")
    checkpoint.save_atlas(atlas, stereo_vi)
    for loaded in (checkpoint.load_atlas(stereo_vi), jckpt.load_atlas(stereo_vi)):
        for kf in loaded.current.keyframes.values():
            assert kf.depth_right is None and kf.uright is None
        assert loaded.current.imu_initialized is False and loaded.current.imu_scale == 1.0
    for kf in checkpoint.load_atlas(stereo_vi).current.keyframes.values():
        assert kf.velocity is None and kf.bias_g is None and kf.bias_a is None


def test_object_arrays_are_refused(tmp_path):
    """The file is data only: an archive holding a pickled object array is
    refused, not unpickled."""
    path = str(tmp_path / "evil.atlas")
    with open(path, "wb") as f:
        np.savez(f, structure=np.frombuffer(b'{"maps": [{"__nd__": 0}]}', np.uint8),
                 a0=np.array([{"x": 1}], dtype=object))
    with pytest.raises(ValueError, match="allow_pickle"):
        checkpoint.load_atlas(path)


def test_system_loads_and_saves_from_settings(drive, tmp_path):
    """System.LoadAtlasFromFile / SaveAtlasToFile: loaded in __init__ (the
    mapper and the tracker see the loaded atlas), saved at shutdown; a
    missing file is logged, not raised."""
    system, path, _ = drive
    s = port_settings()
    s.load_atlas, s.save_atlas = path, str(tmp_path / "out.atlas")
    resumed = System(s, MONOCULAR, device="cpu")
    assert resumed.mapper.atlas is resumed.atlas and resumed.tracking.atlas is resumed.atlas
    assert resumed.atlas.current.n_keyframes() == system.atlas.current.n_keyframes()
    resumed.shutdown()
    assert_same_atlas(checkpoint.load_atlas(s.save_atlas), system.atlas)
    s.load_atlas, s.save_atlas = str(tmp_path / "missing.atlas"), None
    assert System(s, MONOCULAR, device="cpu").atlas.current.n_keyframes() == 0
    assert not os.path.exists(s.load_atlas)


def _mean_reprojection(m, cam):
    err, n = 0.0, 0
    for kf in m.keyframes.values():
        for slot in np.flatnonzero(kf.mp_ids >= 0):
            mp = m.mappoints.get(int(kf.mp_ids[slot]))
            if mp is None or mp.bad:
                continue
            pc = kf.R @ mp.pos + kf.t
            if pc[2] <= 1e-6:
                continue
            u, v = cam.fx * pc[0] / pc[2] + cam.cx, cam.fy * pc[1] / pc[2] + cam.cy
            err += float((u - kf.pts[slot][0]) ** 2 + (v - kf.pts[slot][1]) ** 2)
            n += 1
    return err / max(n, 1)


def test_global_bundle_adjustment(drive, monkeypatch):
    """tests/test_system_features.py::test_global_bundle_adjustment on a
    system resumed from the drive's checkpoint: full-map BA (one solve over
    every keyframe) keeps the map finite and does not raise the mean
    reprojection error past 1.5x."""
    from movslam_tpu_torch.core import local_mapping

    _, path, _ = drive
    system = System(port_settings(), MONOCULAR, device="cpu")
    system.load_atlas(path)
    m = system.atlas.current
    solves = []
    solve = local_mapping.ba_solve_wire
    monkeypatch.setattr(local_mapping, "ba_solve_wire",
                        lambda *a, **k: solves.append((k["K"], k["iters"])) or solve(*a, **k))
    before = _mean_reprojection(m, system.mapper.camera)
    system.global_bundle_adjustment(iters=10)
    after = _mean_reprojection(m, system.mapper.camera)
    for kf in m.keyframes.values():
        assert np.isfinite(kf.t).all()
    for mp in m.mappoints.values():
        assert np.isfinite(mp.pos).all()
    assert after <= before * 1.5 + 1e-6, (before, after)
    assert solves == [(48, 10)]
    system.shutdown()


def test_timings_populated(drive):
    """tests/test_system_features.py::test_timings_populated on the drive."""
    t = drive[0].get_timings()
    assert t["frame_total"]["n"] == N_PER_FRAME + N_WINDOWED
    assert t["track_local_map"]["n"] >= 3
    assert t["local_ba"]["n"] >= 1
    assert t["frame_total"]["mean"] > 0
    assert set(t["frame_total"]) == {"n", "mean", "p50", "p95"}
