"""The port's windowed stereo drive against the JAX windowed stereo drive on
the CPU, over 72 pairs: long enough for the map to mature and for 8-frame
windows to appear (tests/test_stereo_window.py stops at 40 pairs).

SyntheticStereoStream(seed=5), batches of 8 with flush=False and one final
flush on both sides. The RANSAC generators differ, so the comparison is of the
metric error series (camera centre, estimate composed with the ground-truth
pose of the init frame, no fitted scale): no lost frame, medians within 0.03 m
and maxima within 0.10 m of each other, and the same saw-tooth in both: inside
an 8-frame window the error climbs past 0.5 m and falls back below 0.25 m
after the keyframe. Slow tier: about 7 minutes. It prints the numbers that
PERF.md quotes."""
import numpy as np
import pytest

from movslam_tpu.core.system import System as JSystem
from movslam_tpu.core.verbose import Verbose as JVerbose
from movslam_tpu.io.synthetic_stereo import SyntheticStereoStream as JStereoStream
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream
from tests._torch_parity import stereo_metric_errors, stereo_settings
from tests.test_stereo_window import _settings as jax_stereo_settings

N_PAIRS = 72


def _errors(system, stream):
    items = [(left.timestamp, left, right) for left, right in stream.pairs(N_PAIRS)]
    for k in range(0, N_PAIRS, 8):
        system.track_stereo_batch(items[k : k + 8], flush=False)
    system.track_stereo_batch([], flush=True)
    system.shutdown()
    assert system.get_total_lost() == 0 and system.image_count == N_PAIRS
    return stereo_metric_errors(system, stream)


@pytest.mark.slow
def test_port_stereo_drive_follows_the_jax_stereo_drive():
    JVerbose.level = JVerbose.QUIET
    jk0, jerr = _errors(JSystem(jax_stereo_settings(), JSystem.STEREO), JStereoStream(seed=5))
    pk0, perr = _errors(System(stereo_settings(), System.STEREO, device="cpu"), SyntheticStereoStream(seed=5))
    print(f"jax : init {jk0}, median {np.median(jerr):.4f} m, max {jerr.max():.4f} m at frame {jk0 + 1 + jerr.argmax()}")
    print(f"port: init {pk0}, median {np.median(perr):.4f} m, max {perr.max():.4f} m at frame {pk0 + 1 + perr.argmax()}")
    assert jk0 == pk0 and len(jerr) == len(perr)
    assert abs(np.median(jerr) - np.median(perr)) < 0.03
    assert abs(jerr.max() - perr.max()) < 0.10
    for name, e in (("jax", jerr), ("port", perr)):
        assert np.median(e) < 0.20 and e.max() < 0.8, name
        late = e[40:]
        peak = int(late.argmax())
        assert late[peak] > 0.5, name  # the saw-tooth's crest, in a mature map's window
        assert late[peak + 1 : peak + 3].min() < 0.25, name  # and its fall after the keyframe
    assert np.median(np.abs(jerr - perr)) < 0.03  # frame by frame
