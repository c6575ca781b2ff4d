"""Port parity: raw-rig stereo rectification (host, numpy only).

The port's config/rectify.py, core/stereo_rectified.py and the stereo part of
config/settings.py against the reference's, on the cases of
tests/test_rectify.py: every output equal to 1e-12 (the port's modules are
copies of the reference's arithmetic; images and maps are equal exactly).
"""
import os

import numpy as np
import pytest

from movslam_tpu.config import rectify as jrect
from movslam_tpu.config.settings import STEREO as JSTEREO
from movslam_tpu.config.settings import Settings as JSettings
from movslam_tpu.core.camera import Pinhole as JPinhole
from movslam_tpu.core.stereo_rectified import rectify_pair as jrectify_pair
from movslam_tpu.io.synthetic_stereo import SyntheticStereoStream as JStereoStream
from movslam_tpu_torch.config import rectify
from movslam_tpu_torch.config.settings import STEREO, Settings, SettingsError
from movslam_tpu_torch.core.camera import Pinhole
from movslam_tpu_torch.core.stereo_rectified import rectify_pair
from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream
from tests import _torch_parity  # noqa: F401  (caps torch's threads for the xdist workers)
from tests.test_rectify import _euroc_rig

pytestmark = pytest.mark.smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=0, err_msg=what)


def _rects():
    K1, d1, K2, d2, T, size = _euroc_rig()
    Trl = np.linalg.inv(T)
    args = (K1, d1, K2, d2, size, Trl[:3, :3], Trl[:3, 3])
    return args, rectify.stereo_rectify(*args), jrect.stereo_rectify(*args)


def test_rodrigues_matches_reference(rng):
    for k in range(20):
        w = rng.normal(0, 1, 3) * (1e-14 if k == 0 else 1.0)
        R = rectify.rodrigues_vec_to_mat(w)
        close(R, jrect.rodrigues_vec_to_mat(w))
        close(rectify.rodrigues_mat_to_vec(R), jrect.rodrigues_mat_to_vec(R))
        close(R @ R.T, np.eye(3))
    axis = np.array([0.6, 0.0, 0.8])
    near_pi = rectify.rodrigues_vec_to_mat(axis * (np.pi - 1e-8))  # the near-pi branch
    close(rectify.rodrigues_mat_to_vec(near_pi), jrect.rodrigues_mat_to_vec(near_pi))


def test_stereo_rectify_euroc_matches_reference():
    _, got, want = _rects()
    assert set(got) == set(want) == {"R1", "R2", "P1", "P2", "fc_new"}
    for k in want:
        close(got[k], want[k], k)
    assert got["P2"][0, 3] != 0 and got["P1"][0, 3] == 0  # the baseline term sits in P2


def test_epipolar_alignment_euroc():
    """tests/test_rectify.py's epipolar case on the port: after rectification
    a world point's two image rows agree and disparity = fx' * b / z."""
    (K1, d1, K2, d2, size, R, t), rect, _ = _rects()
    b = np.linalg.norm(t)
    rng = np.random.default_rng(3)
    X1 = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200), rng.uniform(3, 12, 200)], 1)
    X2 = X1 @ R.T + t

    def raw_project(X, K, d):
        xd, yd = rectify._distort(X[:, 0] / X[:, 2], X[:, 1] / X[:, 2], d)
        return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], 1)

    r1 = rectify.rectify_points(raw_project(X1, K1, d1), K1, d1, rect["R1"], rect["P1"])
    r2 = rectify.rectify_points(raw_project(X2, K2, d2), K2, d2, rect["R2"], rect["P2"])
    close(r1, jrect.rectify_points(raw_project(X1, K1, d1), K1, d1, rect["R1"], rect["P1"]))
    inb = ((r1[:, 0] > 5) & (r1[:, 0] < size[0] - 5) & (r1[:, 1] > 5) & (r1[:, 1] < size[1] - 5)
           & (r2[:, 0] > 5) & (r2[:, 0] < size[0] - 5))
    assert inb.sum() > 100
    assert np.abs(r1[inb, 1] - r2[inb, 1]).max() < 0.1
    Xr = X1 @ rect["R1"].T
    np.testing.assert_allclose(r1[inb, 0] - r2[inb, 0], rect["fc_new"] * b / Xr[inb, 2], rtol=1e-3, atol=0.05)


def test_rectify_map_and_points_match_reference():
    (K1, d1, _, _, size, _, _), rect, _ = _rects()
    mx, my = rectify.init_rectify_map(K1, d1, rect["R1"], rect["P1"], size)
    jx, jy = jrect.init_rectify_map(K1, d1, rect["R1"], rect["P1"], size)
    assert mx.shape == (size[1], size[0]) and mx.dtype == np.float32
    np.testing.assert_array_equal(mx, jx)
    np.testing.assert_array_equal(my, jy)
    rng = np.random.default_rng(5)
    us, vs = rng.integers(100, size[0] - 100, 50), rng.integers(80, size[1] - 80, 50)
    raw = np.stack([mx[vs, us], my[vs, us]], 1)
    back = rectify.rectify_points(raw, K1, d1, rect["R1"], rect["P1"])
    close(back, jrect.rectify_points(raw, K1, d1, rect["R1"], rect["P1"]))
    np.testing.assert_allclose(back[:, 0], us, atol=1e-3)  # the dense map inverts the point transform
    np.testing.assert_allclose(back[:, 1], vs, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_remap_bilinear_matches_reference(rng, dtype):
    img = rng.integers(0, 256, (60, 80)).astype(dtype)
    mx = rng.uniform(-3, 83, (60, 80)).astype(np.float32)  # some samples fall outside: zero
    my = rng.uniform(-3, 63, (60, 80)).astype(np.float32)
    got, want = rectify.remap_bilinear(img, mx, my), jrect.remap_bilinear(img, mx, my)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert (got[(mx < 0) | (my < 0)] == 0).all()


def test_settings_parses_euroc_stereo_yaml():
    path = os.path.join(REPO, "configs", "EuRoCStereo.yaml")
    got, want = Settings.from_yaml(path, STEREO), JSettings.from_yaml(path, JSTEREO)
    assert got.need_rectify and want.need_rectify
    for name in ("b", "bf", "th_depth", "th_depth_m", "fps", "threshold", "new_width", "new_height"):
        close(getattr(got, name), getattr(want, name), name)
    for cam in ("camera1", "camera2"):
        g, w = getattr(got, cam), getattr(want, cam)
        close([g.fx, g.fy, g.cx, g.cy], [w.fx, w.fy, w.cx, w.cy], cam)
        assert (g.width, g.height, tuple(g.dist)) == (w.width, w.height, tuple(w.dist))
    close(got.T_c1_c2, want.T_c1_c2)
    for k in ("K1", "K2", "R1", "R2", "P1", "P2", "fc_new"):
        close(got.rectification[k], want.rectification[k], k)
    assert got.camera1.fx == got.camera1.fy and not got.camera1.dist
    assert abs(got.bf - got.b * got.camera1.fx) < 1e-6
    gm, wm = got.rectify_maps(), want.rectify_maps()
    for side in ("left", "right"):
        assert gm[side][0].shape == (480, 752)
        np.testing.assert_array_equal(gm[side][0], wm[side][0])
        np.testing.assert_array_equal(gm[side][1], wm[side][1])
    assert got.rectify_maps() is gm  # built once


def test_settings_stereo_yaml_errors(tmp_path):
    text = open(os.path.join(REPO, "configs", "EuRoCStereo.yaml")).read()
    no_thdepth = tmp_path / "a.yaml"
    no_thdepth.write_text(text.replace("Stereo.ThDepth", "Stereo.ThDept"))
    with pytest.raises(SettingsError, match="Stereo.ThDepth"):
        Settings.from_yaml(str(no_thdepth), STEREO)
    no_cam2 = tmp_path / "b.yaml"
    no_cam2.write_text(text.replace("Camera2.fx", "Camera2.fxx"))
    with pytest.raises(SettingsError, match="Camera2"):
        Settings.from_yaml(str(no_cam2), STEREO)
    vi = Settings.from_yaml(os.path.join(REPO, "configs", "EuRoCStereo.yaml"), 3)  # read as visual-inertial
    assert vi.sensor == 3 and not vi.need_rectify and vi.bf == 0.0 and vi.imu_noise_gyro == 1.7e-4
    with pytest.raises(ValueError, match="sensor"):
        Settings.from_yaml(os.path.join(REPO, "configs", "EuRoCStereo.yaml"), 2)
    mono = Settings.from_yaml(os.path.join(REPO, "configs", "EuRoCStereo.yaml"))  # read as monocular
    assert not mono.need_rectify and mono.bf == 0.0 and mono.camera2 is not None


def _raw_rig_settings(cls, pinhole):
    W, H, d, b = 640, 480, (-0.12, 0.02, 0.0, 0.0), 0.25
    Rrel = rectify.rodrigues_vec_to_mat([0.004, -0.006, 0.002])
    T = np.eye(4)
    T[:3, :3] = Rrel.T
    T[:3, 3] = Rrel.T @ np.array([b, 0, 0])
    s = cls()
    s.sensor = 1
    s.width = s.new_width = W
    s.height = s.new_height = H
    s.camera1 = pinhole(320.0, 320.0, 320.0, 240.0, W, H, dist=d)
    s.camera2 = pinhole(320.0, 320.0, 320.0, 240.0, W, H, dist=d)
    s.T_c1_c2 = T
    s.b = float(np.linalg.norm(T[:3, 3]))
    s.th_depth = 60.0
    s._precompute_rectification()
    return s


def test_rectify_pair_matches_reference_and_runs_once():
    """The applied path on a synthetic pair read as a raw rig: images, MV
    deltas, MV rects and keypoint rects equal the reference's; a second call
    (a frame fed again after a rewind) changes nothing."""
    got_s, want_s = _raw_rig_settings(Settings, Pinhole), _raw_rig_settings(JSettings, JPinhole)
    close(got_s.bf, want_s.bf)
    close(got_s.camera1.fx, want_s.camera1.fx)
    assert got_s.need_rectify
    gl, gr = SyntheticStereoStream(n_points=300, seed=9).pair(4)
    wl, wr = JStereoStream(n_points=300, seed=9).pair(4)
    raw_left = gl.im_gray.copy()
    assert gl.n_mvs > 50 and gl.n_kps > 50
    out = rectify_pair(gl, gr, got_s)
    jrectify_pair(wl, wr, want_s)
    assert out[0] is gl and out[1] is gr and gl._rectified
    np.testing.assert_array_equal(gl.im_gray, wl.im_gray)
    np.testing.assert_array_equal(gr.im_gray, wr.im_gray)
    assert (gl.im_gray != raw_left).any()
    for name in ("mv_delta", "mv_rect", "kps_rect"):
        close(getattr(gl, name), getattr(wl, name), name)
    once = (gl.im_gray.copy(), gl.mv_delta.copy(), gl.mv_rect.copy(), gr.im_gray.copy())
    rectify_pair(gl, gr, got_s)
    for a, b in zip(once, (gl.im_gray, gl.mv_delta, gl.mv_rect, gr.im_gray)):
        np.testing.assert_array_equal(a, b)
    plain = Settings()  # a pre-rectified rig: a no-op
    l2, r2 = SyntheticStereoStream(n_points=300, seed=9).pair(4)
    rectify_pair(l2, r2, plain)
    np.testing.assert_array_equal(l2.im_gray, raw_left)
