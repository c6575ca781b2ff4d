"""The benchmark's frozen generators render what the port's generators do
(the test imports both; the benchmark's runs import only their own copies),
and the renderer's mono frames and feed are what they were before it
learned the other sensors."""
import dataclasses
import enum
import hashlib

import numpy as np
import pytest

from harness import port, spec
from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream
from movslam_tpu_torch.io.synthetic_vi import SyntheticVIStream
from traffic import render, synthetic, synthetic_stereo, synthetic_vi


def _same(port_frame, frame):
    n = port_frame.n_mvs
    assert np.array_equal(port_frame.im_gray, frame["im_gray"])
    assert n == len(frame["mv_delta"])
    for name in ("mv_delta", "mv_rect", "mv_dindx", "kps_rect"):
        assert np.array_equal(getattr(port_frame, name)[:n], frame[name]), name
    assert port_frame.coverage_area == frame["coverage"]
    assert int(port_frame.ft) == frame["ft"] and port_frame.timestamp == frame["timestamp"]


@pytest.mark.parametrize("seed", [0, 11, 2**40 + 3])
def test_mono_frames_equal_the_ports(seed):
    port = SyntheticStream(n_points=60, seed=seed, width=160, height=128, keyint=4)
    scene = synthetic.Scene(synthetic.Camera(320.0, 320.0, 80.0, 64.0, 160, 128), 30.0, seed,
                            n_points=60, keyint=4)
    for k in (0, 1, 3, 5):
        _same(port.frame(k), scene.frame(k))
        assert all(np.array_equal(a, b) for a, b in zip(port.gt_pose(k), scene.gt_pose(k)))


def test_parallel_render_equals_the_scene():
    """Rendered in three workers: the frames the scene renders alone."""
    config = {"camera": {"fx": 320.0, "fy": 320.0, "cx": 80.0, "cy": 64.0, "width": 160, "height": 128,
                         "fps": 30}}
    mix = {"scene": {"n_points": 40, "keyint": 5}}
    got = render.frames(config, mix, -7, 7, workers=3)
    scene = synthetic.Scene(**render.scene_args(config, mix, render.seed_of(-7)))
    assert len(got) == 7
    for k, frame in enumerate(got):
        want = scene.frame(k)
        assert set(frame) == set(want)
        for name in want:
            assert np.array_equal(np.asarray(frame[name]), np.asarray(want[name])), name


# Digests of the parent's tartanair_mono render and feed (5 frames a seed),
# taken before the renderer learned IMU rows and right images.
MONO_DIGESTS = {31337: "87c7af3cd276faf9add8507059f2dbb7c3462c670e6eafd4938ecb0792b78782",
                2**33 + 5: "361c1d4e54ed9f0b5c59253d753f5ff30552071236ba1a471f77af7c27238414"}


def _update(h, value):
    if isinstance(value, np.ndarray):
        h.update(f"{value.dtype.str}{value.shape}".encode())
        h.update(np.ascontiguousarray(value).tobytes())
    elif isinstance(value, enum.Enum):
        h.update(repr(int(value)).encode())
    else:
        h.update(repr(value).encode())


def _digest(frames, feed):
    h = hashlib.sha256()
    for f in frames:
        for name in sorted(f):
            h.update(name.encode())
            _update(h, f[name])
    for item in feed:
        for part in item:
            if dataclasses.is_dataclass(part):
                for field in dataclasses.fields(part):
                    h.update(field.name.encode())
                    _update(h, getattr(part, field.name))
            else:
                _update(h, part)
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(MONO_DIGESTS))
def test_mono_render_and_feed_are_the_parents(seed):
    cell = spec.load("tartan_mono_window")
    frames = render.frames(cell.config, cell.mix, seed, 5, workers=2)
    assert _digest(frames, port.inputs(frames, cell.config)) == MONO_DIGESTS[seed]


PORT_CAMERA = synthetic.Camera(320.0, 320.0, 320.0, 240.0, 640, 480)  # the port's streams' camera


@pytest.mark.parametrize("seed", [0, 2**40 + 3])
def test_imu_rows_equal_the_ports(seed):
    port_stream = SyntheticVIStream(n_points=40, seed=seed, fps=20.0, n_sub=10)
    scene = synthetic.Scene(PORT_CAMERA, 20.0, seed, n_points=40)
    assert synthetic_vi.imu_window(scene, 0, 10) is None
    for k in (1, 2, 37):
        assert np.array_equal(port_stream.imu_window(k), synthetic_vi.imu_window(scene, k, 10)), k


@pytest.mark.parametrize("seed", [5, 2**40 + 3])
def test_right_images_equal_the_ports(seed):
    port_stream = SyntheticStereoStream(n_points=60, seed=seed, baseline=0.11)
    right = synthetic_stereo.right_scene(synthetic.Scene(PORT_CAMERA, 30.0, seed, n_points=60), 0.11)
    for k in (0, 3):
        left, port_right = port_stream.pair(k)
        assert np.array_equal(port_right.im_gray, right.render(k)), k
        assert all(np.array_equal(a, b) for a, b in zip(port_stream.right.gt_pose(k), right.gt_pose(k)))


def test_raw_rig_of_a_pure_baseline_is_the_rectified_rig():
    """T_c1_c2 that only moves the right camera b along x, with the left
    camera's pinhole, sees what the rectified rig of baseline b sees."""
    scene = synthetic.Scene(synthetic.Camera(160.0, 160.0, 160.0, 120.0, 320, 240), 20.0, 3, n_points=60)
    T = np.eye(4)
    T[0, 3] = 0.11
    raw = synthetic_stereo.raw_right_scene(scene, scene.camera, T.tolist())
    rect = synthetic_stereo.right_scene(scene, 0.11)
    for k in (0, 4):
        assert all(np.allclose(a, b, atol=1e-6) for a, b in zip(raw.gt_pose(k), rect.gt_pose(k)))
        diff = raw.render(k).astype(int) - rect.render(k).astype(int)
        assert np.mean(np.abs(diff) > 1) < 0.001, k


SENSORS = {
    "IMU_MONOCULAR": {"imu": {"noise_gyro": 1.7e-4, "noise_acc": 2e-3, "frequency": 200.0}},
    "STEREO": {"stereo": {"b": 0.11, "th_depth": 60.0}},
    "STEREO_RAW": {"stereo": {"th_depth": 60.0, "T_c1_c2": [[1, 0, 0, 0.11], [0, 1, 0, 0], [0, 0, 1, 0],
                                                             [0, 0, 0, 1]]},
                   "camera2": {"fx": 300.0, "fy": 300.0, "cx": 80.0, "cy": 64.0, "width": 160, "height": 128}},
}


@pytest.mark.parametrize("sensor", sorted(SENSORS))
def test_parallel_render_of_a_sensor_equals_the_scene(sensor):
    """The IMU rows and right images rendered in three workers: those the
    scene and the generator copies give alone, and the port's item for the
    sensor built from them."""
    config = {"sensor": sensor.split("_RAW")[0], "capacity": {"mvs": 256, "keypoints": 128},
              "camera": {"fx": 320.0, "fy": 320.0, "cx": 80.0, "cy": 64.0, "width": 160, "height": 128,
                         "fps": 20}, **SENSORS[sensor]}
    mix = {"scene": {"n_points": 40, "keyint": 5}}
    got = render.frames(config, mix, 9, 6, workers=3)
    scene = synthetic.Scene(**render.scene_args(config, mix, 9))
    stereo = config.get("stereo", {})
    right = (synthetic_stereo.raw_right_scene(scene, render.camera(config["camera2"]), stereo["T_c1_c2"])
             if "T_c1_c2" in stereo else synthetic_stereo.right_scene(scene, stereo.get("b", 0.0)))
    feed = port.inputs(got, config)
    for k, frame in enumerate(got):
        want = scene.frame(k)
        assert all(np.array_equal(np.asarray(frame[n]), np.asarray(want[n])) for n in want)
        if sensor == "IMU_MONOCULAR":
            imu = synthetic_vi.imu_window(scene, k, 10)
            assert (frame["imu"] is None and imu is None) or np.array_equal(frame["imu"], imu)
            assert len(feed[k]) == 3 and feed[k][2] is frame["imu"]
        else:
            assert np.array_equal(frame["im_right"], right.render(k))
            assert np.array_equal(feed[k][2].im_gray, frame["im_right"]) and feed[k][2].frame_no == k
