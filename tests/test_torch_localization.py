"""Localization-only mode on the port (System.activate_localization_mode):
the two cases of tests/test_system_features.py, device="cpu", at shorter
lengths, and the windowed one also with the mapper thread on.

With the mode active, tracking runs against the frozen map: no keyframes, no
new map points, no change of the map's change index or of any keyframe pose,
and poses keep coming; deactivating resumes mapping. Activation lands
everything in flight first (windows, queued keyframes, the staged and the
launched mapper job, the pending BA), also when the mapper thread holds it.
"""
import numpy as np
import pytest

from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.tracking import State
from movslam_tpu_torch.io.synthetic import SyntheticStream
from tests import _torch_parity  # noqa: F401  (caps torch's threads for the xdist workers)
from tests.test_torch_system import MONOCULAR, port_settings


def _frozen(m):
    return (m.n_keyframes(), m.n_mappoints(), m.change_index)


def test_localization_only_mode():
    stream = SyntheticStream(n_points=400, seed=31)
    system = System(port_settings(), MONOCULAR, device="cpu")
    for k in range(30):
        f = stream.frame(k)
        system.track_monocular(f.timestamp, f)
    assert system.tracking.state == State.OK
    assert system.mapper._pending_ba is not None  # a BA is in flight when the mode is asked for
    system.activate_localization_mode()
    assert system.localization_mode_active()
    assert system.mapper._pending_ba is None and system.mapper._deferred is None and not system.mapper.queue
    m = system.atlas.current
    before, n_maps = _frozen(m), len(system.atlas.maps)
    kf_poses = {kid: (kf.R.copy(), kf.t.copy()) for kid, kf in m.keyframes.items()}

    poses = []
    for k in range(30, 60):
        f = stream.frame(k)
        poses.append(system.track_monocular(f.timestamp, f))
    assert _frozen(m) == before, "the map changed in localization mode"
    assert len(system.atlas.maps) == n_maps
    for kid, (R0, t0) in kf_poses.items():
        np.testing.assert_array_equal(m.keyframes[kid].R, R0)
        np.testing.assert_array_equal(m.keyframes[kid].t, t0)
    assert sum(p is not None for p in poses) >= 22, "most frames still localize on the frozen map"

    system.deactivate_localization_mode()
    assert not system.localization_mode_active()
    for k in range(60, 80):
        f = stream.frame(k)
        system.track_monocular(f.timestamp, f)
    system.shutdown()
    assert system.atlas.current.n_keyframes() > before[0] or len(system.atlas.maps) > n_maps


@pytest.mark.parametrize("async_mapping", [False, True], ids=["inline_mapper", "mapper_thread"])
def test_localization_mode_windowed_batch(async_mapping):
    """The windowed drive honours the mode: whole windows go out with no
    predicted keyframe and the map stays frozen."""
    stream = SyntheticStream(n_points=400, seed=32)
    system = System(port_settings(), MONOCULAR, device="cpu", async_mapping=async_mapping)
    items = [(f.timestamp, f) for f in (stream.frame(k) for k in range(72))]
    for k in range(0, 40, 8):
        system.track_monocular_batch(items[k : k + 8], flush=False)
    # No flush: windows are in flight and a mapper job is staged or launched
    # when the mode is asked for.
    system.activate_localization_mode()
    mapper = system.mapper
    assert not system._wfq and not system._pending
    assert mapper._staged is None and mapper._deferred is None and mapper._pending_ba is None
    assert not mapper.queue and system.image_count == 40
    m = system.atlas.current
    before = _frozen(m)
    windows_before = system.counts["windows"]

    got = []
    for k in range(40, 72, 8):
        got.extend(system.track_monocular_batch(items[k : k + 8], flush=False))
    got.extend(system.track_monocular_batch([], flush=True))
    assert _frozen(m) == before
    assert len(got) == 32 and sum(p is not None for p in got) >= 26
    assert system.counts[f"windows_len_{system.window}"] >= 3  # no keyframe cuts a window short
    assert system.counts["windows"] - windows_before <= 6
    assert mapper._staged is None and mapper._deferred is None  # nothing was made to map

    system.deactivate_localization_mode()
    more = [(f.timestamp, f) for f in (stream.frame(k) for k in range(72, 88))]
    system.track_monocular_batch(more)
    system.shutdown()
    assert m.n_keyframes() > before[0] or len(system.atlas.maps) > 1
