"""Port parity: core/inertial (IMU routing, window stacking, the gravity/scale
init applied to a map) and the visual-inertial Settings, against the JAX
reference.

Tolerances: ImuBuffer and _stack_windows bit-exact; the init's scale within
rtol 1e-5 and the rescaled keyframe poses, map points, normals, distances,
velocities and biases within 1e-5 (poses and points in metres, on a
~2 m sequence); the EuRoC VI settings equal, and both
packages integrate with the same fixed noise and bias random walks."""
import inspect
import os

import numpy as np
import pytest
import torch

from movslam_tpu.config import settings as jsettings
from movslam_tpu.core import inertial as jinertial
from movslam_tpu.core import map as jmap
from movslam_tpu.ops import imu as jimu
from movslam_tpu_torch.config.settings import IMU_MONOCULAR, Settings
from movslam_tpu_torch.core import inertial, map as tmap
from movslam_tpu_torch.ops import imu
from tests._torch_parity import assert_close, assert_exact
from tests.test_inertial import _FakeFrame, _make_vi_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_copy(jm, jkfs, jbuf, n_points=0, seed=0):
    """The port's map, keyframes and buffer with the reference's contents,
    plus n_points map points put into both maps."""
    m = tmap.Map()
    kfs = []
    for jkf in jkfs:
        kf = tmap.KeyFrame(_FakeFrame(jkf.frame_id, jkf.timestamp, jkf.R.copy(), jkf.t.copy()), m.id)
        m.add_keyframe(kf)
        kfs.append(kf)
    buf = inertial.ImuBuffer()
    for fid, rows in jbuf.by_frame.items():
        buf.add(fid, rows)
    rng = np.random.default_rng(seed)
    for i in range(n_points):
        pos = rng.uniform(-1, 1, 3) + [0.0, 0.0, 3.0]
        normal = rng.normal(size=3)
        normal /= np.linalg.norm(normal)
        d = rng.uniform(0.5, 2.0)
        for mmap, MP in ((jm, jmap.MapPoint), (m, tmap.MapPoint)):
            mp = MP(pos.copy(), 0, i, mmap.id)
            mp.normal, mp.min_dist, mp.max_dist = normal.copy(), d, 2.0 * d
            mmap.add_mappoint(mp)
    return m, kfs, buf


def test_imu_buffer_and_stack_windows_match_reference(rng):
    jbuf, buf = jinertial.ImuBuffer(), inertial.ImuBuffer()
    for fid in (1, 2, 3, 5, 8, 9, 13):
        rows = rng.normal(size=(int(rng.integers(3, 12)), 7)).astype(np.float32)
        jbuf.add(fid, rows)
        buf.add(fid, rows)
    jbuf.add(4, None)
    buf.add(4, np.zeros((0, 7)))
    assert sorted(buf.by_frame) == sorted(jbuf.by_frame) == [1, 2, 3, 5, 8, 9, 13]
    for lo, hi in ((0, 3), (3, 9), (9, 10), (13, 20)):
        assert_exact(buf.window(lo, hi), jbuf.window(lo, hi), f"window({lo}, {hi})")
    jm, jkfs, _, _ = _make_vi_sequence(n_kf=6)
    for kf, fid in zip(jkfs, (0, 3, 5, 9, 10, 13)):
        kf.frame_id = fid  # windows of 2, 1, 2, 0 and 1 frames
    _, kfs, _ = _port_copy(jm, jkfs, jbuf)
    for got, want in zip(inertial._stack_windows(kfs, buf, cap=24), jinertial._stack_windows(jkfs, jbuf, cap=24)):
        assert_exact(got, want)
    buf.clear_before(5)
    jbuf.clear_before(5)
    assert sorted(buf.by_frame) == sorted(jbuf.by_frame) == [8, 9, 13]


def test_visual_inertial_init_matches_reference():
    """tests/test_inertial.py's sequence (a map at 0.25 of metric scale) with
    40 map points: the solve, and the map it rescaled, equal the reference's."""
    jm, jkfs, jbuf, scale = _make_vi_sequence(scale=0.25)
    m, kfs, buf = _port_copy(jm, jkfs, jbuf, n_points=40)
    want = jinertial.visual_inertial_init(jm, jkfs, jbuf, min_windows=5)
    got = inertial.visual_inertial_init(m, kfs, buf, device="cpu", min_windows=5)
    assert got is not None and want is not None
    assert abs(float(got["scale"]) * scale - 1.0) < 0.05  # the reference test's bound, on the port
    assert_close(got["scale"], want["scale"], 0.0, 1e-5, what="scale")
    assert_close(got["Rwg"], want["Rwg"], 1e-5, what="Rwg")
    assert got["preintegrate_steps"] == max(len(r) for r in buf.by_frame.values())  # one KF per window here
    assert m.imu_initialized and jm.imu_initialized and m.imu_scale == pytest.approx(jm.imu_scale, rel=1e-5)
    for kf, jkf in zip(kfs, jkfs):
        assert_close(kf.R, jkf.R, 1e-5, what="R")
        assert_close(kf.t, jkf.t, 1e-5, what="t")
        assert_close(kf.velocity, jkf.velocity, 1e-5, what="velocity")
        assert_close(kf.bias_g, jkf.bias_g, 1e-5, what="bias_g")
        assert_close(kf.bias_a, jkf.bias_a, 1e-5, what="bias_a")
    for mp, jmp in zip(m.mappoints.values(), jm.mappoints.values()):
        assert_close(mp.pos, jmp.pos, 1e-5, what="point")
        assert_close(mp.normal, jmp.normal, 1e-5, what="normal")
        assert mp.min_dist == pytest.approx(jmp.min_dist, rel=1e-5)
        assert mp.max_dist == pytest.approx(jmp.max_dist, rel=1e-5)
    assert m.change_index == jm.change_index == 1


def test_visual_inertial_init_rejects_without_samples():
    jm, jkfs, jbuf, _ = _make_vi_sequence()
    m, kfs, _ = _port_copy(jm, jkfs, jbuf)
    assert inertial.visual_inertial_init(m, kfs, inertial.ImuBuffer(), device="cpu", min_windows=5) is None
    assert not m.imu_initialized and m.change_index == 0
    # too few keyframes with samples: the reference rejects too
    few = inertial.ImuBuffer()
    for fid in sorted(jbuf.by_frame)[:3]:
        few.add(fid, jbuf.by_frame[fid])
    assert inertial.visual_inertial_init(m, kfs, few, device="cpu", min_windows=5) is None
    assert not m.imu_initialized


def test_euroc_vi_settings_match_reference():
    path = os.path.join(REPO, "configs", "EuRoC_VI.yaml")
    got = Settings.from_yaml(path, IMU_MONOCULAR)
    want = jsettings.Settings.from_yaml(path, jsettings.IMU_MONOCULAR)
    assert got.sensor == want.sensor == IMU_MONOCULAR
    for key in ("imu_noise_gyro", "imu_noise_acc", "fps", "threshold", "coverage_threshold",
                "relocalization_distance", "reprojection_error", "reprojection_error_lost", "th_far_points"):
        assert getattr(got, key) == getattr(want, key), key
    assert vars(got.camera1) == vars(want.camera1)
    defaults = Settings()  # the reference's defaults when the IMU.* keys are absent
    ref_defaults = jsettings.Settings()
    assert [defaults.imu_noise_gyro, defaults.imu_noise_acc] == [ref_defaults.imu_noise_gyro,
                                                                 ref_defaults.imu_noise_acc]
    # The reference parses IMU.GyroWalk/AccWalk/Frequency but integrates with
    # fixed bias random walks; the port reads none of the three keys and
    # integrates with the same fixed walks.
    walks = lambda f: {k: v.default for k, v in inspect.signature(f).parameters.items()  # noqa: E731
                       if k in ("sigma_g", "sigma_a", "sigma_bg", "sigma_ba")}
    assert walks(imu.preintegrate) == walks(jimu.preintegrate) == {
        "sigma_g": 1.7e-4, "sigma_a": 2e-3, "sigma_bg": 1e-5, "sigma_ba": 1e-4}
    with pytest.raises(ValueError, match="sensor"):
        Settings.from_yaml(path, 2)
    assert torch.get_default_dtype() == torch.float32
