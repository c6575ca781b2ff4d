"""The port's stereo drives end to end on the CPU: the counterparts of
tests/test_stereo_window.py and tests/test_stereo.py at 640x480.

SyntheticStereoStream(seed=5), b = 0.25 m, bf = 80, device="cpu": 40 pairs
through track_stereo_batch (W=8, batches of 8, flush=False). The error is
metric: the estimate composed with the ground-truth pose of the init frame,
no fitted scale. Bounds as in chip_smoke.py's stereo phase: median < 0.20 m,
max < 0.8 m, 0 lost. (The 25-pair per-frame drive is in
tests/test_torch_stereo_per_frame.py, so that test workers take the two side
by side.)
"""
import numpy as np
import pytest

from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.tracking import State
from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream
from tests._torch_parity import stereo_metric_errors, stereo_settings

STEREO = System.STEREO

N_WINDOWED = 40


@pytest.fixture(scope="module")
def stream_items():
    stream = SyntheticStereoStream(seed=5)
    return stream, [(left.timestamp, left, right) for left, right in stream.pairs(N_WINDOWED)]


@pytest.fixture(scope="module")
def windowed(stream_items):
    _, items = stream_items
    system = System(stereo_settings(), STEREO, device="cpu")
    poses = []
    for k in range(0, N_WINDOWED, 8):
        poses.extend(system.track_stereo_batch(items[k : k + 8], flush=False))
    poses.extend(system.track_stereo_batch([], flush=True))
    system.shutdown()
    return system, poses


def test_stereo_windowed_tracks_metric(stream_items, windowed):
    system, poses = windowed
    k0, errs = stereo_metric_errors(system, stream_items[0])
    assert system.get_total_lost() == 0 and system.tracking.state == State.OK
    assert len(poses) == system.image_count == N_WINDOWED
    assert all(p is not None for p in poses[k0:])
    assert k0 <= 3  # init needs > 500 features: the first or the fourth frame
    assert np.median(errs) < 0.20, np.median(errs)  # metric: no scale, no fitted alignment
    assert errs.max() < 0.8, errs.max()
    assert system.atlas.current.n_mappoints() > 100


def test_stereo_windows_ran_and_carried_stereo_jobs(windowed):
    system, _ = windowed
    c = system.counts
    assert c["windows"] >= 4 and c["window_frames"] >= N_WINDOWED // 2
    assert c["window_frames"] + c["per_frame_p"] >= N_WINDOWED - 1  # rewinds dispatch frames again
    assert system.mapper.bf == 80.0 and not system.mapper.monocular
    assert system.mapper.n_fused_jobs >= 1  # a window ran a job with bf != 0 and its wire committed it
    assert not system._wfq and not system._pending


def test_stereo_keyframes_keep_depth_and_ur(windowed):
    system, _ = windowed
    kfs = list(system.atlas.current.keyframes.values())
    assert len(kfs) >= 5
    for kf in kfs:
        assert kf.depth_right is not None and kf.depth_right.shape == kf.uright.shape == (len(kf.track_ids),)
        have = kf.depth_right > 0
        assert ((kf.depth_right == -1.0) | have).all()
        assert (kf.uright[have] >= 0).all() and (kf.uright[~have] == -1.0).all()
        # ur = u - bf / z on the rows that have a depth (u rides the wire in 1/32 px)
        np.testing.assert_allclose(kf.pts[have, 0] - kf.uright[have], 80.0 / kf.depth_right[have], atol=0.04)
    assert np.mean([(kf.depth_right > 0).mean() for kf in kfs]) > 0.5
    from_wire = [kf for kf in kfs if kf._desc_thunk is not None or kf._desc is None]
    assert from_wire, "no keyframe was made from a window replay"
