"""The benchmark's arithmetic: the output check, the union
of device intervals, the idle gaps' labels and the roofline byte counts."""
import numpy as np
import pytest

from harness import reference, roofline, spec, trace
from traffic.synthetic import _orbit_pose


def _gt(a, b):
    return {k: _orbit_pose(float(k)) for k in range(a, b)}


def _sim3(pose, s, R, t):
    """The same camera in a world moved by x -> s R x + t (the map's frame)."""
    R_cw, t_cw = (np.asarray(x, np.float64) for x in pose)
    return R_cw @ R.T, s * t_cw - R_cw @ R.T @ t


def test_judge_is_blind_to_the_map_frame_and_scale():
    gt = _gt(10, 60)
    c, s_ = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1.0]])
    answers = {k: _sim3(p, 0.37, R, np.array([1.0, -2.0, 0.5])) for k, p in gt.items()}
    out = reference.judge(gt, answers, list(gt))
    assert out["unanswered"] == 0 and out["ate_rms_pct"] < 1e-4  # float32 poses


def test_judge_counts_missing_and_lost_frames_and_the_worst_error():
    gt = _gt(0, 40)
    answers = dict(gt)
    answers[5] = None
    R, t = gt[20]
    answers[20] = (R, np.asarray(t) + np.array([0.0, 0.0, 0.3], np.float32))
    out = reference.judge(gt, answers, list(gt), lost=[7])
    assert out["unanswered"] == 2
    kept = [k for k in gt if k not in (5, 7)]
    span = np.linalg.norm(np.ptp([reference.center(*gt[k]) for k in kept], axis=0))
    # One answer 0.3 m off: the fit spreads it, the RMS is about 0.3 / sqrt(38).
    assert 100 * 0.2 / np.sqrt(38) / span < out["ate_rms_pct"] < 100 * 0.3 / np.sqrt(38) / span
    assert reference.verdict(out, {"unanswered": 2, "ate_rms_pct": 100.0})[0]
    assert not reference.verdict(out, {"unanswered": 1, "ate_rms_pct": 100.0})[0]
    assert not reference.verdict({"unanswered": 0, "ate_rms_pct": float("inf")},
                                 {"unanswered": 0, "ate_rms_pct": 1e9})[0]


def test_union_of_device_intervals():
    merged = trace._union(sorted([(0, 10), (5, 12), (12, 15), (20, 30), (21, 22)]))
    assert merged == [[0, 15], [20, 30]]
    assert sum(e - s for s, e in merged) == 25


class _Event:
    def __init__(self, name, start, end, device, kind, thread=1, annotation=False, corr=0):
        self._v = name, start, end, device, kind, thread, annotation, corr

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def activity_type(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def correlation_id(self):
        return self._v[7]


class _OldEvent:
    """An event of a torch without activity_type and is_user_annotation (the
    card's 2.11 takes _activity's fallback)."""

    def __init__(self, event):
        self._e = event

    def __getattr__(self, name):
        if name in ("activity_type", "is_user_annotation"):
            raise AttributeError(name)
        return getattr(self._e, name)


def _profile(ev):
    class P:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return ev
    return P


def test_reduce_busy_kernels_and_idle_labels():
    ev = [
        _Event("slambench.track_monocular", 0, 1000, False, "user_annotation", annotation=True),
        _Event("aten::mul", 20, 200, False, "cpu_op"),
        _Event("aten::item", 400, 700, False, "cpu_op"),
        _Event("cudaStreamSynchronize", 450, 690, False, "cuda_runtime"),
        _Event("void (anonymous namespace)::segment_sums_kernel(Jobs)", 150, 450, True, "kernel"),
        _Event("Memcpy DtoH (Device -> Pinned)", 690, 700, True, "gpu_memcpy"),
        _Event("ampere_sgemm(float*)", 800, 900, True, "kernel"),
        _Event("slambench.track_monocular", 150, 450, True, "gpu_user_annotation"),
    ]

    out = trace.reduce(_profile(ev))
    assert out["kernels"] == {"segment_sums_kernel": (1, 300e-9), "ampere_sgemm": (1, 100e-9)}
    assert out["launches"] == 2 and out["busy_s"] == pytest.approx(410e-9)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["track_monocular: cudaStreamSynchronize"] == pytest.approx(240e-9)
    assert gaps["track_monocular: python"] == pytest.approx((100 + 100) * 1e-9)
    assert gaps["track_monocular: aten::mul"] == pytest.approx(150e-9)
    assert sum(gaps.values()) == pytest.approx(1000e-9 - out["busy_s"])


def test_roofline_counts_from_shapes():
    nbytes, ops = roofline.score_candidates_work(2048, 4096)
    assert nbytes == 2048 * (8 + 16 + 8 + 32) + 4096 * 8 + 2048 * (4 + 4 + 8 + 32 + 1)
    assert ops == 2048 * 4 * (2 * 256 + 3 * 8)
    nbytes, ops = roofline.segment_sum_work(rows=2600, columns=36, segments=48)
    assert nbytes == 2600 * (36 * 4 + 4) + 49 * 4 + 48 * 36 * 4 and ops == 2600 * 36
    assert roofline.share_pct([(3.35e6, 0)], 2e-6) == pytest.approx(50.0)
    assert roofline.share_pct([], 1.0) is None and roofline.share_pct([(1, 1)], 0.0) is None


def test_metric_readers():
    record = {"frames": 50, "window_s": 10.0, "counts": {"rewinds": 2}, "lba_ms": [3.0, 1.0, 2.0],
              "launches": 400000, "busy_s": 1.5,
              "kernels": {"score_candidates_kernel": (50, 50 * 3.5e-6)},
              "calls": {"score_candidates": [roofline.score_candidates_work(2048, 4096)] * 50,
                        "segment_sums": []}}
    read = {m: spec.metric_reader(m)(record) for m in (
        "rewinds_per_100_frames", "launches_per_frame", "local_ba_ms_p50",
        "score_candidates_roofline", "segment_sums_roofline", "device_idle_share")}
    assert read["rewinds_per_100_frames"] == 4.0 and read["launches_per_frame"] == 8000.0
    assert read["local_ba_ms_p50"] == 2.0
    assert read["device_idle_share"] == pytest.approx(0.85)
    least = roofline.least_seconds(*roofline.score_candidates_work(2048, 4096))
    assert read["score_candidates_roofline"] == pytest.approx(100 * least / 3.5e-6)
    assert read["segment_sums_roofline"] is None


def _window_events(port_spans=True):
    """One benchmark call on thread 1 with the port's spans inside it, kernels
    launched under them (one by a graph launch), and a second thread."""
    def host(name, a, b, kind="cpu_op", thread=1, corr=0):
        return _Event(name, a, b, False, kind, thread=thread, annotation=kind == "user_annotation", corr=corr)

    def span(name, a, b, thread=1):
        rows = [host(name, a, b, "user_annotation", thread)]
        return rows + [_Event(name, a + 1, b - 1, True, "gpu_user_annotation", annotation=True)]

    def kernel(name, a, b, corr):
        return _Event(name, a, b, True, "kernel", corr=corr)

    ev = span("slambench.track_monocular_batch", 0, 1000)
    ev += [host("cudaLaunchKernel", 30, 35, "cuda_runtime", corr=11),
           host("cudaLaunchKernel", 150, 155, "cuda_runtime", corr=12),
           host("cudaGraphLaunch", 200, 210, "cuda_runtime", corr=13),
           host("cudaLaunchKernel", 450, 452, "cuda_runtime", corr=14),
           host("cudaLaunchKernel", 950, 952, "cuda_runtime", corr=15),
           host("cudaLaunchKernel", 120, 125, "cuda_runtime", thread=2, corr=17),
           # A host operator whose id is kernel 12's: an operator's id is not a launch's.
           host("aten::mm", 460, 470, corr=12),
           host("aten::item", 610, 690)]
    ev += [kernel("front_kernel", 40, 60, 11), kernel("pose_kernel", 160, 260, 12),
           kernel("graph_kernel", 300, 320, 13), kernel("graph_kernel", 320, 330, 13),
           kernel("mapper_kernel", 455, 475, 14), kernel("late_kernel", 960, 970, 15),
           kernel("unlaunched_kernel", 980, 990, 99), kernel("thread_kernel", 130, 140, 17),
           _Event("Memcpy DtoH (Device -> Pinned)", 690, 700, True, "gpu_memcpy", corr=16)]
    if port_spans:
        for name, a, b in [("window", 10, 600), ("frame.front_end", 20, 100), ("frame.pose", 100, 400),
                           ("window.mapper", 400, 500), ("drive.replay", 600, 900), ("replay.wait", 610, 700),
                           ("replay.track", 700, 800), ("mapper.keyframe", 720, 780),
                           ("mapper.local_ba", 730, 760), ("mapper.commit", 800, 850)]:
            ev += span("movslam." + name, a, b)
        ev += span("movslam.mapper.keyframe", 100, 200, thread=2)
    return ev


def test_reduce_keeps_its_old_keys_beside_the_port_spans():
    with_spans = trace.reduce(_profile(_window_events()))
    without = trace.reduce(_profile(_window_events(port_spans=False)))
    for key in ("kernels", "launches", "busy_s"):
        assert with_spans[key] == without[key], key
    assert with_spans["launches"] == 8 and "movslam.window" not in with_spans["kernels"]
    assert with_spans["breakdown"]["device_ops"] == without["breakdown"]["device_ops"]
    gaps, gaps0 = (dict(o["breakdown"]["idle_gaps"]) for o in (with_spans, without))
    assert sum(gaps.values()) == pytest.approx(sum(gaps0.values()))
    assert all(k.startswith("track_monocular_batch: ") for k in gaps0)
    assert gaps["movslam.window: python"] == pytest.approx((690 - 475) * 1e-9)  # the gap's middle, 582
    assert gaps["movslam.mapper.commit: python"] == pytest.approx((960 - 700) * 1e-9)
    assert without["spans"] == {"outside": {"launches": 8, "device_s": pytest.approx(200e-9)}}


def test_span_rows_host_times():
    rows = trace.reduce(_profile(_window_events()))["spans"]
    ns = 1e-9
    assert rows["movslam.window"]["host_s"] == pytest.approx(590 * ns)
    assert rows["movslam.window"]["self_s"] == pytest.approx((590 - 80 - 300 - 100) * ns)
    assert rows["movslam.window.mapper"]["outer_s"] == 0.0  # inside movslam.window
    assert rows["movslam.drive.replay"]["self_s"] == pytest.approx((300 - 90 - 100 - 50) * ns)
    assert rows["movslam.replay.track"]["self_s"] == pytest.approx(40 * ns)
    assert rows["movslam.mapper.keyframe"]["n"] == 1  # thread 2's is not the drive's
    assert rows["movslam.mapper.keyframe"]["self_s"] == pytest.approx(30 * ns)
    assert rows["movslam.mapper.local_ba"]["host_s"] == pytest.approx(30 * ns)
    assert rows["movslam.mapper.local_ba"]["outer_s"] == 0.0
    assert rows["movslam.mapper.commit"]["outer_s"] == pytest.approx(50 * ns)


def test_span_rows_match_kernels_by_their_own_correlation_id():
    """Each kernel lands under the spans open at the call that launched it;
    a graph's kernels under the span open at its cudaGraphLaunch; kernels of
    another thread's calls or of no call found land in `outside`."""
    rows = trace.reduce(_profile(_window_events()))["spans"]
    launches = {name: row["launches"] for name, row in rows.items()}
    assert launches == {
        "movslam.window": 5, "movslam.frame.front_end": 1, "movslam.frame.pose": 3, "movslam.window.mapper": 1,
        "movslam.drive.replay": 0, "movslam.replay.wait": 0, "movslam.replay.track": 0,
        "movslam.mapper.keyframe": 0, "movslam.mapper.local_ba": 0, "movslam.mapper.commit": 0, "outside": 3}
    assert rows["movslam.frame.pose"]["device_s"] == pytest.approx(130e-9)
    assert rows["movslam.window"]["device_s"] == pytest.approx(170e-9)
    assert rows["outside"]["device_s"] == pytest.approx(30e-9)


def test_span_rows_count_a_name_nested_in_itself_once():
    rows = trace._span_rows([(0, 100, "movslam.window"), (10, 50, "movslam.window")],
                            [(20, 30, "k", "kernel", 1)], {1: 15})
    assert rows["movslam.window"]["n"] == 2
    assert rows["movslam.window"]["host_s"] == rows["movslam.window"]["self_s"] == pytest.approx(100e-9)
    assert rows["movslam.window"]["launches"] == 1 and rows["outside"]["launches"] == 0


def test_fallback_counts_span_rows_as_annotations_not_kernels():
    """Without activity_type and is_user_annotation a port span's device row
    is no kernel, and a cu* host row is a launch call: the same reduction."""
    new = trace.reduce(_profile(_window_events()))
    old = trace.reduce(_profile([_OldEvent(e) for e in _window_events()]))
    assert old["kernels"] == new["kernels"] and old["launches"] == new["launches"] == 8
    assert old["busy_s"] == new["busy_s"] and old["spans"] == new["spans"]


def test_span_metric_readers():
    record = trace.reduce(_profile(_window_events()))
    record.pop("breakdown")
    record.update(frames=2, window_s=1e-6)
    read = {m: spec.metric_reader(m)(record) for m in SPAN_METRICS}
    assert read["front_end_ms_per_frame"] == pytest.approx(1e3 * 80e-9 / 2)
    assert read["front_end_launches_per_frame"] == 0.5
    assert read["pose_ms_per_frame"] == pytest.approx(1e3 * 300e-9 / 2)
    assert read["pose_launches_per_frame"] == 1.5
    assert read["replay_track_ms_per_frame"] == pytest.approx(1e3 * 40e-9 / 2)
    assert read["mapper_ms_per_frame"] == pytest.approx(1e3 * (60 + 50) * 1e-9 / 2)
    assert read["wire_wait_share"] == pytest.approx(90e-9 / 1e-6)


SPAN_METRICS = ("front_end_ms_per_frame", "front_end_launches_per_frame", "pose_ms_per_frame",
                "pose_launches_per_frame", "replay_track_ms_per_frame", "mapper_ms_per_frame", "wire_wait_share")


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_metric_reads_nothing_without_its_span(metric):
    record = trace.reduce(_profile(_window_events(port_spans=False)))
    record.update(frames=2, window_s=1.0)
    assert spec.metric_reader(metric)(record) is None
