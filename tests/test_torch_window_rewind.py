"""The port's windowed drive on the CPU, the irregular cases: an I-frame
inside a batch, per-frame calls while windows are in flight, a forced
rewind (restage + TrackState.rebuild) and the mapper thread.

SyntheticStream(n_points=400, seed=42) at 640x480, W=8, device="cpu"; see
tests/test_torch_window.py for the regular drives."""
import pytest

from movslam_tpu_torch.core import system as system_mod
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.tracking import State
from movslam_tpu_torch.core.trackstate import TrackState
from movslam_tpu_torch.io.mvimage import FrameType
from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.ops.frame_step import N_SCALARS, packed_cols
from tests.test_torch_system import MONOCULAR, port_settings
from tests.test_torch_window import _batches

N_FRAMES = 48


@pytest.fixture(scope="module")
def stream_items():
    stream = SyntheticStream(n_points=400, seed=42)
    return [(f.timestamp, f) for f in (stream.frame(k) for k in range(80))]


def test_windowed_mixed_batch_with_iframe(stream_items):
    """An I-frame inside a batch breaks the window and takes the LK path."""
    import copy

    items = list(stream_items[:24])
    iframe = copy.copy(items[13][1])
    iframe.ft = FrameType.I_FRAME
    items[13] = (items[13][0], iframe)
    system = System(port_settings(), MONOCULAR, device="cpu")
    _batches(system, items, flush=True)
    assert system.image_count == 24
    assert system.get_total_lost() <= 1
    assert system.counts["windows"] >= 2


def test_pipelined_mixed_with_per_frame(stream_items):
    """A per-frame call while windows are in flight drains the pipeline
    first (System._flush_windows): no frame lost, doubled or out of order."""
    system = System(port_settings(), MONOCULAR, device="cpu")
    system.track_monocular_batch(stream_items[:40], flush=False)
    for ts, f in stream_items[40:44]:
        system.track_monocular(ts, f)
    system.track_monocular_batch(stream_items[44:N_FRAMES], flush=True)
    system.shutdown()
    assert system.image_count == N_FRAMES
    assert system.get_total_lost() == 0
    times = system.tracking.rel_times
    assert all(a < b for a, b in zip(times, times[1:]))


def test_forced_rewind_restages_and_rebuilds(stream_items, monkeypatch):
    """A speculative 8-frame window's wire is edited to report a thin
    local-map margin (25 inliers) at its fourth frame. The replay must break
    there, expire the mapper cooldown, rebuild the track state on the device
    from that frame's packed words, hand the staged mapper job of the
    discarded follower back to the mapper, and feed the rest again."""
    calls = {"rebuild": 0, "restaged_jobs": 0, "edited": 0}
    real_rebuild = TrackState.rebuild
    monkeypatch.setattr(system_mod.TrackState, "rebuild", staticmethod(
        lambda *a: (calls.__setitem__("rebuild", calls["rebuild"] + 1), real_rebuild(*a))[1]))
    system = System(port_settings(), MONOCULAR, device="cpu")
    real_restage = system.mapper.restage

    def restage(st):
        calls["restaged_jobs"] += st is not None
        return real_restage(st)

    monkeypatch.setattr(system.mapper, "restage", restage)
    real_dispatch = system._dispatch_window

    def dispatch(run, carry=None):
        wf = real_dispatch(run, carry=carry)
        if wf is not None and carry is not None and len(run) == 8 and not calls["edited"]:
            o1 = 8 * system.extractor.capacity * packed_cols()
            wf["out"]["wire"][o1 + 3 * N_SCALARS + 13] = 25
            calls["edited"] = wf["run"][3][0]  # that frame's timestamp
        return wf

    monkeypatch.setattr(system, "_dispatch_window", dispatch)
    poses = _batches(system, stream_items, flush=False)
    assert calls["edited"], "no speculative 8-frame window was dispatched"
    assert system.counts["rewinds"] >= 1 and calls["rebuild"] >= 1
    assert calls["restaged_jobs"] >= 1
    assert len(poses) == len(stream_items) == system.image_count
    assert system.get_total_lost() == 0 and system.tracking.state == State.OK
    # The frame after the edited one made a keyframe (the cooldown expired).
    kf_times = [kf.timestamp for kf in system.atlas.current.keyframes.values()]
    later = [ts for ts, _ in stream_items if ts > calls["edited"]]
    assert later[0] in kf_times
    # Re-dispatched frames are counted where they are dispatched.
    assert system.counts["window_frames"] + system.counts["per_frame_p"] > len(stream_items) - 1
    times = system.tracking.rel_times
    assert all(a < b for a, b in zip(times, times[1:]))


def test_mapper_thread_drive(stream_items):
    """System(async_mapping=True): the mapper thread shares the queue and the
    map lock with the tracker; per-frame and windowed frames both track."""
    system = System(port_settings(), MONOCULAR, device="cpu", async_mapping=True)
    assert system.mapper._thread is not None and system.mapper._thread.is_alive()
    for ts, f in stream_items[:16]:
        system.track_monocular(ts, f)
    poses = system.track_monocular_batch(stream_items[16:32], flush=True)
    system.mapper.wait_idle()
    system.shutdown()
    assert system.mapper._thread is None
    assert len(poses) == 16 and all(p is not None for p in poses)
    assert system.get_total_lost() == 0 and system.image_count == 32
    assert system.atlas.current.n_keyframes() >= 4


def test_job_slot_is_taken_once_under_contention():
    """The tracker and the mapper thread both commit jobs: whichever comes
    first takes the job out of its slot, the other finds it empty."""
    import os
    import sys
    import threading

    mapper = System(port_settings(), MONOCULAR, device="cpu").mapper
    n = min(64, 2 * (os.cpu_count() or 8))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for rnd in range(40):
            mapper._deferred = {"round": rnd, "done": None}
            got = []
            barrier = threading.Barrier(n)

            def work():
                barrier.wait(timeout=20)
                job = mapper._take("_deferred", lambda d: d["done"] is None)
                if job is not None:
                    got.append(job)

            threads = [threading.Thread(target=work) for _ in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=20)
            assert not any(th.is_alive() for th in threads)
            assert len(got) == 1 and got[0]["round"] == rnd and mapper._deferred is None
    finally:
        sys.setswitchinterval(old)
    assert mapper._take("_staged") is None
