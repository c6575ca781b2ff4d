"""The readers of euroc_vi_window's per-layer metrics: each reads its port
span's row per frame answered, and nothing where the traced window saw no
such span (a port that has not got it)."""
import pytest

from harness import spec

READERS = {
    "vi_ba_ms_per_frame": ("movslam.mapper.vi_ba", "host_s", 1e3),
    "vi_ba_launches_per_frame": ("movslam.mapper.vi_ba", "launches", 1.0),
    "preintegrate_launches_per_frame": ("movslam.imu.preintegrate", "launches", 1.0),
}


def _record(spans):
    return {"frames": 48, "window_s": 20.0, "spans": spans}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_vi_metric_reads_its_span_per_frame(metric):
    span, key, scale = READERS[metric]
    rows = {name: {"n": 6, "host_s": 1.75, "self_s": 1.7, "outer_s": 0.0, "launches": 35716, "device_s": 0.086}
            for name in ("movslam.mapper.vi_ba", "movslam.imu.preintegrate")}
    rows[span] = dict(rows[span], **{key: 12.0})
    assert spec.metric_reader(metric)(_record(rows)) == pytest.approx(scale * 12.0 / 48)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_vi_metric_reads_nothing_without_its_span(metric):
    rows = {"movslam.mapper.local_ba": {"n": 1, "host_s": 0.1, "self_s": 0.1, "outer_s": 0.1, "launches": 9,
                                        "device_s": 0.0}}
    assert spec.metric_reader(metric)(_record(rows)) is None
    assert spec.metric_reader(metric)({"frames": 48, "window_s": 20.0}) is None
