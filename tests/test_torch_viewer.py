"""The port's headless viewer (movslam_tpu_torch/viz/viewer.py) and EXPRESS
debug dump (ops/express.save_express_file): the ports of
tests/test_viewer.py, and pixel-for-pixel parity with the JAX package's
Viewer and save_express_file on the same frames, maps and image (both draw
with cv2 on this host)."""
import numpy as np
import pytest

from movslam_tpu.io.synthetic import SyntheticStream as JSyntheticStream
from movslam_tpu.ops.express import save_express_file as jsave_express_file
from movslam_tpu.viz.viewer import Viewer as JViewer
from movslam_tpu_torch.core.verbose import Verbose
from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.ops.express import save_express_file
from movslam_tpu_torch.viz.viewer import Viewer
import tests._torch_parity  # noqa: F401  (two CPU threads per test worker)


class _F:
    def __init__(self, tids, pts, mappoints=None, outlier=None):
        self.n = len(tids)
        self.track_ids = np.asarray(tids, np.int32)
        self.pts = np.asarray(pts, np.float32)
        self.mappoints = [None] * self.n if mappoints is None else mappoints
        self.outlier = np.zeros(self.n, bool) if outlier is None else outlier


class _KF:
    def __init__(self, kid, c, parent=None, covis=(), yaw=0.0):
        self.id = kid
        self._c = np.asarray(c, float)
        cy, sy = np.cos(yaw), np.sin(yaw)
        self.R = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
        self.t = -self.R @ self._c
        self.covis = dict(covis)
        self.parent = parent
        self.bad = False

    def center(self):
        return self._c


class _MP:
    def __init__(self, p, bad=False):
        self.pos = np.asarray(p, float)
        self.bad = bad


def _system(keyframes=None, mappoints=None, current=None, state="OK"):
    class _S:
        class atlas:
            class current:
                pass

        class tracking:
            pass

    _S.atlas.current.keyframes = keyframes or {}
    _S.atlas.current.mappoints = mappoints or {}
    _S.tracking.current = current
    _S.tracking.state = type("state", (), {"name": state})
    return _S()


def test_track_history_polylines():
    """Viewer accumulates per-track trails and prunes dead tracks
    (FrameDrawer.cc:129-190 green trail parity)."""
    v = Viewer(_system(), history=3)
    v.every = 10**9  # skip rendering; exercise bookkeeping only
    for k in range(5):
        v.update(_F([1, 2], [[10 + k, 10], [20, 20 + k]]), None)
    assert set(v._tracks) == {1, 2}
    assert len(v._tracks[1]) == 3  # clipped to history
    assert v._tracks[1][-1] == (14.0, 10.0)
    v.update(_F([2], [[20, 30]]), None)
    assert set(v._tracks) == {2}  # track 1 pruned when it disappears


def test_save_express_file(tmp_path):
    """The port's dump paints the descriptor bits of every detected block,
    and equals the JAX package's pixel for pixel (threshold 25)."""
    img, _, _ = SyntheticStream(n_points=30, seed=1).render(0)
    jimg, _, _ = JSyntheticStream(n_points=30, seed=1).render(0)
    assert np.array_equal(img, jimg)
    out = save_express_file(str(tmp_path / "ex.png"), img, 25, device="cpu")
    assert out.shape == img.shape
    assert (out == 0).any() and (out == 255).any()
    want = jsave_express_file(str(tmp_path / "jex.png"), img, 25)
    assert np.array_equal(out, want)
    import cv2

    assert np.array_equal(cv2.imread(str(tmp_path / "ex.png"), cv2.IMREAD_UNCHANGED), out)


def test_draw_map_covis_frusta():
    """Top-down MapDrawer renders covisibility edges, spanning-tree edges,
    keyframe frusta and the current camera (MapDrawer.cc DrawKeyFrames /
    DrawGraph parity) without touching a live device."""
    k0 = _KF(0, [0, 0, 0])
    k1 = _KF(1, [1, 0, 0.2], parent=k0, covis={0: 40})
    k0.covis = {1: 40}

    class _Cur:
        pose_set = True
        R = np.eye(3)
        t = np.array([-0.5, 0.0, -0.1])

    s = _system({0: k0, 1: k1}, {0: _MP([0.2, 0, 1.0]), 1: _MP([0.8, 0, 1.2])}, _Cur())
    img = Viewer(s).draw_map(size=128)
    assert img.shape == (128, 128, 3)
    # Some non-white pixels must have been drawn (points/edges/frusta).
    assert (img < 250).any()
    # Red current-camera dot present (BGR channel order: (0, 0, 255)).
    red = (img[:, :, 2] == 255) & (img[:, :, 0] == 0) & (img[:, :, 1] == 0)
    assert red.any()


@pytest.mark.parametrize("size,covis,frusta", [(640, True, True), (200, False, True), (333, True, False)])
def test_draw_map_matches_the_reference(size, covis, frusta):
    """Twelve keyframes on an arc (covisibility, a spanning tree, turned
    frusta), 300 points, a bad point and a bad keyframe, the current camera:
    the port's render equals the JAX package's pixel for pixel."""
    rng = np.random.default_rng(3)
    kfs = {}
    for i in range(12):
        a = 0.3 * i
        parent = kfs.get(i - 1)
        kfs[i] = _KF(i, [2 * np.sin(a), 0.1 * i, 2 - 2 * np.cos(a)], parent=parent,
                     covis={j: 30 for j in range(max(0, i - 3), i)}, yaw=a)
    for i in range(12):
        for j in kfs[i].covis:
            kfs[j].covis[i] = 30
    kfs[7].bad = True
    mps = {k: _MP(rng.normal(0, 2, 3) + [0, 0, 3], bad=(k == 5)) for k in range(300)}

    class _Cur:
        pose_set = True
        R = kfs[11].R
        t = kfs[11].t + 0.05

    s = _system(kfs, mps, _Cur())
    got = Viewer(s).draw_map(size=size, covis=covis, frusta=frusta)
    want = JViewer(s).draw_map(size=size, covis=covis, frusta=frusta)
    assert got.shape == (size, size, 3) and (got < 250).any()
    assert np.array_equal(got, want)


def test_draw_frame_matches_the_reference(tmp_path):
    """Six frames of tracks (some appearing, some dying, map-point inliers,
    outliers and unmatched slots) through update(): every render, the trails
    and the PNGs equal the JAX package's."""
    rng = np.random.default_rng(5)
    stream = SyntheticStream(n_points=200, seed=2)
    s = _system(state="OK")
    port = Viewer(s, out_dir=str(tmp_path / "port"), history=4)
    ref = JViewer(s, out_dir=str(tmp_path / "ref"), history=4)
    tids = np.arange(60)
    pts = rng.uniform([20, 20], [620, 460], (60, 2))
    for k in range(6):
        smv = stream.frame(k)
        pts = pts + rng.normal(0, 2.0, pts.shape)
        tids = np.where(rng.random(60) < 0.1, tids + 1000, tids)  # some tracks die, new ones start
        mps = [_MP([0, 0, 1]) if rng.random() < 0.6 else None for _ in range(60)]
        f = _F(tids, pts, mps, rng.random(60) < 0.2)
        port.update(f, smv)
        ref.update(f, smv)
        assert port._tracks == ref._tracks
        assert np.array_equal(port.last_frame_render, ref.last_frame_render)
    assert (port.last_frame_render != np.stack([smv.im_gray] * 3, -1)).any()
    import cv2

    for k in range(1, 7):
        a = cv2.imread(str(tmp_path / "port" / f"frame_{k:06d}.png"))
        b = cv2.imread(str(tmp_path / "ref" / f"frame_{k:06d}.png"))
        assert a is not None and np.array_equal(a, b)


def test_viewer_on_a_drive_matches_the_reference():
    """System(use_viewer=True) on a short per-frame and windowed drive: the
    viewer sees every frame, and the reference's Viewer fed the same port
    frames and map draws the same frames and map."""
    from movslam_tpu_torch.config.settings import MONOCULAR, Settings
    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.system import System

    level, Verbose.level = Verbose.level, Verbose.QUIET
    try:
        settings = Settings()
        settings.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
        system = System(settings, MONOCULAR, device="cpu", use_viewer=True)
        ref = JViewer(system)
        stream = SyntheticStream(n_points=400, seed=11)
        seen = []
        update = system.viewer.update

        def both(frame, smv):
            update(frame, smv)
            ref.update(frame, smv)
            seen.append(np.array_equal(system.viewer.last_frame_render, ref.last_frame_render))

        system.viewer.update = both
        for k in range(6):
            smv = stream.frame(k)
            system.track_monocular(smv.timestamp, smv)
        system.track_monocular_batch([(f.timestamp, f) for f in (stream.frame(k) for k in range(6, 12))])
        system.shutdown()
    finally:
        Verbose.level = level
    assert system.image_count == 12 and len(seen) == 12 and all(seen)
    assert system.counts["windows"] >= 1
    got, want = system.viewer.draw_map(), ref.draw_map()
    assert (got < 250).any() and np.array_equal(got, want)


def test_without_cv2_nothing_is_written(tmp_path, monkeypatch, capsys):
    """A host without cv2 renders nothing, writes nothing and
    says so once; the dump falls back to an .npy file as the reference's."""
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    v = Viewer(_system(), out_dir=str(tmp_path / "frames"))
    smv = SyntheticStream(n_points=30, seed=1).frame(0)
    for k in range(3):
        v.update(_F([1, 2], [[10 + k, 10], [20, 20 + k]]), smv)
    assert v.count == 3 and list((tmp_path / "frames").iterdir()) == []
    assert np.array_equal(v.last_frame_render, np.stack([smv.im_gray] * 3, -1))
    assert (v.draw_map() == 255).all()
    assert capsys.readouterr().out.count("cv2 is not installed") == 1
    img = smv.im_gray[200:280, 280:400]
    out = save_express_file(str(tmp_path / "ex.png"), img, 25, device="cpu")
    assert np.array_equal(np.load(str(tmp_path / "ex.png.npy")), out)
