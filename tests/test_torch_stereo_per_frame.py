"""The port's per-frame stereo drive (System.track_stereo) end to end on the
CPU: the counterpart of tests/test_stereo.py at 640x480. (The windowed drive
is in tests/test_torch_stereo_drive.py, so that test workers take the two
side by side.)"""
import numpy as np
import pytest

from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.tracking import State
from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream
from tests._torch_parity import stereo_metric_errors, stereo_settings

N_PER_FRAME = 25


def test_stereo_per_frame_tracks_metric():
    """25 pairs of SyntheticStereoStream(seed=5) at 640x480 through
    track_stereo on the CPU: state OK, every frame answered from the init
    frame on, metric error median < 0.35 m (chip_smoke.py's bound)."""
    stream = SyntheticStereoStream(seed=5)
    items = [(left.timestamp, left, right) for left, right in stream.pairs(N_PER_FRAME)]
    system = System(stereo_settings(), System.STEREO, device="cpu")
    poses = [system.track_stereo(*it) for it in items]
    system.shutdown()
    k0, errs = stereo_metric_errors(system, stream)
    assert system.tracking.state == State.OK and system.image_count == N_PER_FRAME
    assert all(p is not None for p in poses[k0:])
    assert system.counts["windows"] == 0 and system.counts["per_frame_p"] == N_PER_FRAME - 1
    assert np.median(errs) < 0.35, np.median(errs)
    assert system.atlas.current.n_mappoints() > 100
    with pytest.raises(ValueError, match="Stereo"):
        System(stereo_settings(), System.MONOCULAR, device="cpu").track_stereo(*items[0])
