"""The port's spans (movslam_tpu_torch/trace.py) on the CPU: a short windowed
drive, its first batch with no profiler on, the rest under torch.profiler.

SyntheticStream(n_points=400, seed=42) at 640x480, W=8: frames 0-7 without a
profiler (record_function made to raise, so a span that were not a no-op
would fail the drive), frames 8-11 and the final flush under
torch.profiler.profile(activities=[CPU]). Every span is checked against the
span that encloses it."""
import collections

import pytest

from movslam_tpu_torch import trace
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.io.synthetic import SyntheticStream
from tests import _torch_parity  # noqa: F401  (caps torch's threads for the xdist workers)
from tests.test_torch_system import MONOCULAR, port_settings

UNPROFILED, PROFILED = 8, 4

# Each span's enclosing port span, as the layers nest (None: no port span).
PARENTS = {
    "drive.dispatch": {None},
    "dispatch.inputs": {"drive.dispatch"},
    "dispatch.snapshot": {"drive.dispatch"},
    "window": {"drive.dispatch"},
    "window.patch": {"window"},
    "frame.front_end": {"window", "drive.per_frame"},
    "frame.pose": {"window", "drive.per_frame"},
    "drive.replay": {None},
    "replay.wait": {"drive.replay"},
    "replay.commit": {"drive.replay"},
    "replay.track": {"drive.replay"},
    "replay.rebuild": {"drive.replay"},
    "drive.per_frame": {None},
    "mapper.keyframe": {"replay.track", "drive.per_frame"},
    "mapper.local_ba": {None, "mapper.keyframe", "mapper.local_ba", "mapper.commit"},
    "mapper.commit": {None, "mapper.keyframe", "mapper.commit", "replay.commit", "dispatch.snapshot"},
}


def _refuse(name):
    raise AssertionError(f"record_function({name!r}) created with no profiler on")


@pytest.fixture(scope="module")
def drive():
    from torch.profiler import ProfilerActivity, profile

    stream = SyntheticStream(n_points=400, seed=42)
    items = [(f.timestamp, f) for f in (stream.frame(k) for k in range(UNPROFILED + PROFILED))]
    system = System(port_settings(), MONOCULAR, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "record_function", _refuse)
        system.track_monocular_batch(items[:UNPROFILED], flush=False)
    unprofiled = collections.Counter(system.counts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        system.track_monocular_batch(items[UNPROFILED:], flush=False)
        system.track_monocular_batch([], flush=True)
    spans = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(trace.PREFIX):])
        for e in prof.profiler.kineto_results.events() if e.name().startswith(trace.PREFIX)
    )
    return system, unprofiled, spans


def _parents(spans):
    """(name, enclosing port span's name or None) for each span."""
    stack, out = [], []
    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= start:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((end, name))
    return out


def test_span_is_a_shared_noop_without_a_profiler(drive):
    system, unprofiled, _ = drive
    assert unprofiled["windows"] >= 1 and unprofiled["per_frame_p"] >= 1
    assert trace.span("window") is trace.span("mapper.keyframe")
    assert not hasattr(system, "_prof")


def test_spans_nest_at_the_layer_boundaries(drive):
    system, _, spans = drive
    assert system.get_total_lost() == 0
    pairs = _parents(spans)
    names = {name for name, _ in pairs}
    missing = set(PARENTS) - names
    assert not missing, missing
    wrong = sorted({(n, p) for n, p in pairs if p not in PARENTS[n]})
    assert not wrong, wrong
    # The window program's front end sits inside the window, inside the dispatch.
    assert ("frame.front_end", "window") in pairs and ("frame.pose", "window") in pairs
    for name in ("drive.dispatch", "drive.replay", "window"):
        assert sum(n == name for n, _ in pairs) >= 2
