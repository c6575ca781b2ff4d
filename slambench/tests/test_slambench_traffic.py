"""The benchmark's frozen generator renders what the port's generators do
(the test imports both; the benchmark's runs import only its own copy)."""
import numpy as np
import pytest

from movslam_tpu_torch.io.synthetic import SyntheticStream
from traffic import render, synthetic


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
