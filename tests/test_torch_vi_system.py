"""The port's visual-inertial drives end to end on the CPU (port only): the
short counterparts of tests/test_vi_system.py.

SyntheticVIStream(n_points=400, seed=11) at 640x480 (camera 320/320/320/240,
fps 30), device="cpu", vi_min_kfs = 4 so that the gravity/scale init runs
early (its first solve needs 6 keyframes, the second runs at 8). The per-frame
drive stops after the first stage, so the metric bound is held on the
windowed one:
  - per frame: 15 frames through track_monocular(..., imu=);
  - windowed: 48 frames through track_monocular_batch((ts, smv, imu) triples,
    W=8, batches of 8, flush=False, then flush=True). Its init stages land
    between windows; one more runs while a speculative window is in flight.
Bounds: the reference's metric one (median keyframe camera-centre error,
no fitted scale, < 0.15 * max(span, 0.5)), 0 lost; on the windowed drive
also every pose answered from the first init stage on (the windowed
drive's departures, core/local_mapping.py). The 60- and 96-frame
drives of both packages are in tests/test_torch_vi_jax.py (slow tier) and
chip_smoke.py phase 7."""
import numpy as np
import pytest

from movslam_tpu_torch.config.settings import IMU_MONOCULAR, Settings
from movslam_tpu_torch.core import local_mapping
from movslam_tpu_torch.core.camera import Pinhole
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.tracking import State
from movslam_tpu_torch.io.synthetic_vi import SyntheticVIStream
import tests._torch_parity  # noqa: F401  (two torch threads per test worker)

N_PER_FRAME, N_WINDOWED, VI_MIN_KFS = 15, 48, 4


def vi_settings():
    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    s.fps = 30.0
    s.sensor = IMU_MONOCULAR
    return s


def _center(stream, k):
    R, t = stream.gt_pose(k)
    return -(R.T @ t)


def metric_errors(system, stream, n):
    """Keyframe camera-centre errors (no fitted scale) and the bound of
    tests/test_vi_system.py."""
    kfs = system.atlas.current.keyframes.values()
    errs = np.array([np.linalg.norm(kf.center() - _center(stream, kf.frame_id)) for kf in kfs])
    span = float(np.linalg.norm(np.ptp(np.array([_center(stream, k) for k in range(n)]), axis=0)))
    return errs, 0.15 * max(span, 0.5)


@pytest.fixture(scope="module")
def stream_items():
    stream = SyntheticVIStream(n_points=400, seed=11)
    return stream, list(stream.items(N_WINDOWED))


@pytest.fixture(scope="module")
def per_frame(stream_items):
    _, items = stream_items
    system = System(vi_settings(), IMU_MONOCULAR, device="cpu")
    system.mapper.vi_min_kfs = VI_MIN_KFS
    poses = [system.track_monocular(ts, smv, imu=imu) for ts, smv, imu in items[:N_PER_FRAME]]
    system.shutdown()
    return system, poses


@pytest.fixture(scope="module")
def windowed(stream_items):
    """The windowed drive. Its own init stages land between windows, at
    keyframes the per-frame path tracks while the map is young. Once the map
    is mature a flush=False call returns with a speculative window in flight:
    there the mapper runs the init once more, as its thread may at any time
    (LocalMapping._staged_vi_init under map_lock), before that window, tracked
    against the pre-scale snapshot and pose chain, is replayed."""
    stream, items = stream_items
    system = System(vi_settings(), IMU_MONOCULAR, device="cpu")
    system.mapper.vi_min_kfs = VI_MIN_KFS
    stages = []  # (frames replayed, the tracker's last frame and its error) at each stage
    rescale = system.tracking.apply_scaled_rotation

    def recorded(s, Rwg):
        rescale(s, Rwg)
        lf = system.tracking.last_frame
        stages.append((system.image_count, lf.id, np.linalg.norm(lf.center() - _center(stream, lf.id))))
    system.tracking.apply_scaled_rotation = recorded
    poses, crossed = [], None
    for k in range(0, N_WINDOWED, 8):
        poses += system.track_monocular_batch(items[k:k + 8], flush=False)
        m = system.atlas.current
        if crossed is None and system._wfq and m.imu_initialized:
            crossed = {"windows_in_flight": len(system._wfq), "frames_in_flight": sum(len(w["run"]) for w in system._wfq),
                       "change_index": m.change_index, "stage": m.imu_init_count,
                       "snapshot_key": system._snapshot_key, "velocity": system.tracking.velocity[1].copy()}
            system.mapper.vi_min_kfs = 1  # the next stage is due now
            system.mapper._staged_vi_init(m)
            system.mapper.vi_min_kfs = VI_MIN_KFS
            crossed["velocity_after"] = system.tracking.velocity[1].copy()
            crossed["scale"] = system.mapper.vi_inits[-1][2]
    poses += system.track_monocular_batch([], flush=True)
    system.shutdown()
    crossed["stages"] = stages
    return system, poses, crossed


def test_per_frame_vi_drive_initializes_and_runs_vi_ba(stream_items, per_frame):
    _, items = stream_items
    system, poses = per_frame
    m = system.atlas.current
    assert m.imu_initialized and m.imu_init_count >= 1
    assert system.get_total_lost() == 0 and system.tracking.state == State.OK
    init = next(k for k, p in enumerate(poses) if p is not None)
    assert len(poses) == system.image_count == N_PER_FRAME and all(p is not None for p in poses[init:])
    mp = system.mapper
    assert len(mp.vi_ba_ms) >= 1 and len(mp.vi_ba_steps) == len(mp.vi_ba_ms)
    # the preintegration loop ran to the longest window of each call, not 512
    assert all(0 < s < 512 for s in mp.vi_ba_steps)
    done = [i for i in mp.vi_inits if i[2] is not None]
    assert done and done[0][1] >= 6 and all(np.isfinite(i[2]) for i in done)
    last = max(m.keyframes.values(), key=lambda kf: kf.id)
    assert last.velocity is not None and last.bias_g is not None and last.bias_a is not None
    assert np.isfinite(last.velocity).all() and np.abs(last.bias_g).max() < 0.1
    # one sample window per frame after the first, filed under its frame id
    assert sorted(system.imu_buffer.by_frame) == list(range(1, N_PER_FRAME))
    for k in range(1, N_PER_FRAME):
        np.testing.assert_array_equal(system.imu_buffer.by_frame[k], items[k][2])


def test_windowed_vi_drive_crosses_the_init_stage(stream_items, windowed):
    stream, items = stream_items
    system, poses, crossed = windowed
    m = system.atlas.current
    assert m.imu_initialized and system.get_total_lost() == 0 and system.tracking.state == State.OK
    assert len(poses) == system.image_count == N_WINDOWED
    init = next(k for k, p in enumerate(poses) if p is not None)
    assert all(p is not None for p in poses[init:])
    errs, bound = metric_errors(system, stream, N_WINDOWED)
    assert np.median(errs) < bound, (np.median(errs), bound)
    c = system.counts
    assert c["windows"] >= 4 and c["window_frames"] >= N_WINDOWED // 2 and c["spec_windows"] >= 1
    # a speculative window was in flight when an init stage rescaled the map;
    # it replayed onto the rescaled map, and the snapshot key (which holds the
    # map's change index) makes the next dispatch rebuild the snapshot
    assert crossed is not None and crossed["windows_in_flight"] >= 1, crossed
    assert m.imu_init_count == crossed["stage"] + 1 and m.change_index > crossed["change_index"]
    assert not system._wfq and not system._pending
    # The windows in flight went back to be tracked again from the rescaled
    # tracker (scale_rewinds), on a snapshot rebuilt after the stage.
    assert c["scale_rewinds"] >= 1 and crossed["snapshot_key"] != system._snapshot_key
    system._refresh_snapshot()
    assert system._snapshot_key[2] == m.change_index


def test_windowed_vi_drive_answers_at_the_scale_of_each_stage(stream_items, windowed):
    """Each stage re-expresses the tracker with the map (Tracking.
    apply_scaled_rotation): its last frame lands on the truth and the motion
    model's translation takes the stage's scale; every pose answered from
    the first stage on is metric, not only the keyframes; and the local BA
    is the visual-inertial one on the windowed drive."""
    stream, _ = stream_items
    system, poses, crossed = windowed
    stages = crossed["stages"]
    _, bound = metric_errors(system, stream, N_WINDOWED)
    assert len(stages) == system.counts["vi_init_stages"] == system.atlas.current.imu_init_count >= 2
    assert all(err < bound for _, _, err in stages), stages
    np.testing.assert_allclose(crossed["velocity_after"], crossed["velocity"] * crossed["scale"], rtol=1e-6)
    errs = [np.linalg.norm(-(p[0].T @ p[1]) - _center(stream, k)) for k, p in enumerate(poses) if k >= stages[0][0]]
    assert len(errs) >= N_WINDOWED // 2 and max(errs) < bound, (max(errs), bound)
    assert system.counts["vi_ba"] >= 1 and len(system.mapper.vi_ba_ms) == system.counts["vi_ba"]


def test_windowed_drive_files_imu_samples_like_the_per_frame_drive(stream_items, per_frame, windowed):
    """The windowed drive files each frame's samples under the id the frame
    gets, past the buffered and in-flight frames, and a rewind that feeds
    frames again neither adds nor loses any: its buffer holds what a
    per-frame drive of the same items holds."""
    _, items = stream_items
    pf_buf = per_frame[0].imu_buffer.by_frame
    system = windowed[0]
    buf = system.imu_buffer.by_frame
    assert sorted(buf) == list(range(1, N_WINDOWED))  # a per-frame drive files frame k under k
    assert system.counts["rewinds"] >= 1  # frames were fed again
    for k in range(1, N_WINDOWED):
        np.testing.assert_array_equal(buf[k], items[k][2])
        if k in pf_buf:
            np.testing.assert_array_equal(buf[k], pf_buf[k])
