"""Slow tier: the port's counterparts of tests/test_window.py's golden-ATE
gates, on the CPU and on the card.

test_golden_ate_windowed: the windowed drive (batches of 8, each call
flushing) over 60 frames of SyntheticStream(n_points=400, seed) for seeds
42 and 7: 0 lost, scale-aligned post-hoc ATE (frame_trajectory()) below
2.2% of the trajectory's span per seed, the reference's bound.
test_golden_ate_5seeds_300frames: 300 frames per seed (batches of 8 with
flush=False, one final flush) for seeds 42, 7, 23, 1 and 5: 0 lost and ATE
below 5% of the span per seed (BASELINE.md's accuracy target).

This file imports no jax, so the card's host runs it too:

    python -m pytest --noconftest -m "slow and cuda" tests/test_torch_golden_ate.py -s

The card's sums are ordered (ops/kernels.segment_sum), so a seed reads the
same ATE on every run there. Each test prints its reading (-s)."""
import numpy as np
import pytest
import torch

from movslam_tpu_torch.config.settings import MONOCULAR, Settings
from movslam_tpu_torch.core.camera import Pinhole
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.verbose import Verbose
from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.multistream_eval import scale_aligned_ate
import tests._torch_parity  # noqa: F401  (two CPU threads per test worker)

pytestmark = pytest.mark.slow


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _settings():
    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    s.fps = 30.0
    s.sensor = MONOCULAR
    return s


def _windowed_drive(device, seed, n_frames, flush_each_batch):
    """The windowed drive of tests/test_window.py's golden gates; returns
    (the system, shut down; the stream)."""
    level, Verbose.level = Verbose.level, Verbose.QUIET
    try:
        stream = SyntheticStream(n_points=400, seed=seed)
        items = [(f.timestamp, f) for f in (stream.frame(k) for k in range(n_frames))]
        system = System(_settings(), MONOCULAR, device=device)
        for k in range(0, len(items), 8):
            system.track_monocular_batch(items[k:k + 8], flush=flush_each_batch)
        if not flush_each_batch:
            system.track_monocular_batch([], flush=True)
        system.shutdown()
    finally:
        Verbose.level = level
    return system, stream


def _windowed_ate(device, seed, n_frames, flush_each_batch):
    """(frames lost, scale-aligned post-hoc ATE as a fraction of the span)."""
    system, stream = _windowed_drive(device, seed, n_frames, flush_each_batch)
    traj = system.frame_trajectory()
    gt = [-(stream.gt_pose(round(ts * 30.0))[0].T @ stream.gt_pose(round(ts * 30.0))[1]) for ts, _, _, _ in traj]
    ate, span = scale_aligned_ate(gt, [-(R.T @ t) for _, R, t, _ in traj])
    return system.get_total_lost(), ate / span


@pytest.mark.parametrize("seed", [42, 7])
def test_golden_ate_windowed(device, seed):
    lost, frac = _windowed_ate(device, seed, 60, flush_each_batch=True)
    print(f"golden ATE windowed, seed {seed}, {device}: {100 * frac:.3f}% of span, lost {lost}")
    assert lost == 0
    assert frac < 0.022


@pytest.mark.parametrize("seed", [42, 7, 23, 1, 5])
def test_golden_ate_5seeds_300frames(device, seed):
    lost, frac = _windowed_ate(device, seed, 300, flush_each_batch=False)
    print(f"golden ATE 300 frames, seed {seed}, {device}: {100 * frac:.3f}% of span, lost {lost}")
    assert lost == 0
    assert frac < 0.05


def test_ordered_sums_change_no_bit_of_a_drive_on_the_cpu(monkeypatch):
    """The card's summation path (ops/ba.py's plans, padding rows left out,
    and kernels.segment_sum's plain version) forced on the CPU gives the
    index_add_ path's trajectory bit for bit over the whole 60-frame
    seed-7 drive."""
    from movslam_tpu_torch.ops import ba

    def trajectory():
        system, _ = _windowed_drive("cpu", 7, 60, flush_each_batch=True)
        return np.array([np.concatenate([[ts], np.ravel(R), np.ravel(t)])
                         for ts, R, t, _ in system.frame_trajectory()])

    want = trajectory()
    monkeypatch.setattr(ba, "_ordered", lambda x: True)
    assert np.array_equal(trajectory(), want)
