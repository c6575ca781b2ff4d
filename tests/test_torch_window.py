"""The port's windowed drive end to end on the CPU: the counterparts of
tests/test_window.py (window program + deferred mapper + pipelined
track_monocular_batch).

SyntheticStream(n_points=400, seed=42) at 640x480, W=8, device="cpu". The
drives are shared through module fixtures. Mixed drives, a forced rewind and
the mapper thread are in tests/test_torch_window_rewind.py, the comparison
with the JAX windowed drive in tests/test_torch_window_jax.py (separate
files, so that test workers can take them side by side)."""
import numpy as np
import pytest
import torch

from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.io.synthetic import SyntheticStream
from tests import _torch_parity  # noqa: F401  (caps torch's threads for the xdist workers)
from tests.test_torch_system import MONOCULAR, port_settings

N_FRAMES = 48


@pytest.fixture(scope="module")
def stream_items():
    stream = SyntheticStream(n_points=400, seed=42)
    return [(f.timestamp, f) for f in (stream.frame(k) for k in range(N_FRAMES))]


def _batches(system, items, flush):
    poses = []
    for k in range(0, len(items), 8):
        poses.extend(system.track_monocular_batch(items[k : k + 8], flush=flush))
    if not flush:
        poses.extend(system.track_monocular_batch([], flush=True))
    system.shutdown()
    return poses


@pytest.fixture(scope="module")
def windowed(stream_items):
    system = System(port_settings(), MONOCULAR, device="cpu")
    return system, _batches(system, stream_items, flush=True)


@pytest.fixture(scope="module")
def pipelined(stream_items):
    system = System(port_settings(), MONOCULAR, device="cpu")
    return system, _batches(system, stream_items, flush=False)


@pytest.fixture(scope="module")
def per_frame(stream_items):
    system = System(port_settings(), MONOCULAR, device="cpu")
    for ts, f in stream_items:
        system.track_monocular(ts, f)
    system.shutdown()
    return system


def test_windowed_tracks_without_loss(windowed):
    system, poses = windowed
    assert len(poses) == N_FRAMES
    assert system.get_total_lost() == 0
    assert system.atlas.current.n_keyframes() >= 5
    assert system.image_count == N_FRAMES
    assert len(system.tracking.rel_poses) >= N_FRAMES - 3
    assert system.counts["windows"] >= 4 and system.counts["window_frames"] >= N_FRAMES // 2
    assert system.mapper.throttle_mode == "frames" and system.mapper.defer_mapping


def test_windowed_agrees_with_per_frame(windowed, per_frame):
    """Same math, different draws, i16-quantised MV input on one side:
    trajectories agree to a few mm on a ~1.6 m path."""
    assert per_frame.get_total_lost() == 0 and per_frame.counts["windows"] == 0
    tw = np.array([p[1] for p in windowed[0].tracking.rel_poses])
    tp = np.array([p[1] for p in per_frame.tracking.rel_poses])
    n = min(len(tw), len(tp))
    med = np.median(np.abs(tw[:n] - tp[:n]))
    assert med < 0.05, med


def test_pipelined_stream_drive(pipelined):
    """flush=False: window k+1 is dispatched on window k's device carry
    before k is replayed, and the deferred mapper commits each keyframe's
    triangulation + BA one keyframe late. Poses lag and drain on the final
    flush; tracking stays lossless and the map keeps growing."""
    system, poses = pipelined
    assert len(poses) == N_FRAMES
    assert system.get_total_lost() == 0
    assert system.image_count == N_FRAMES
    m = system.atlas.current
    assert m.n_keyframes() >= 5 and m.n_mappoints() > 100
    assert all(p is not None for p in poses[-8:])
    assert system.mapper.n_fused_jobs >= 1  # a window ran a staged job and its wire committed it
    assert not system._wfq and not system._pending


def test_keyframe_descriptors_are_archived_lazily(pipelined, per_frame):
    system, _ = pipelined
    kfs = sorted(system.atlas.current.keyframes.values(), key=lambda kf: kf.id)
    lazy = [kf for kf in kfs if kf._desc_thunk is not None]
    assert lazy, "no keyframe was made from a window replay"
    kf = lazy[-1]
    desc = kf.desc  # pulls desc_w[k] now
    assert kf._desc_thunk is None and desc.dtype == np.uint32 and desc.shape == (len(kf.track_ids), 8)
    assert desc.any()
    eager = [kf for kf in per_frame.atlas.current.keyframes.values() if kf._desc is not None]
    assert eager and eager[0].desc.shape[1] == 8


def test_later_slices_name_their_queue_item():
    system = System(port_settings(), MONOCULAR, device="cpu")
    with pytest.raises(NotImplementedError, match="stereo slice"):
        system.track_stereo_batch([])
    with pytest.raises(NotImplementedError, match="localization"):
        system.activate_localization_mode()
    assert system.tracking.only_tracking is False
    assert system.track_monocular_batch([]) == []
    assert torch.get_num_threads() <= 2
