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
    def __init__(self, name, start, end, device, kind, thread=1, annotation=False):
        self._v = name, start, end, device, kind, thread, annotation

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

    class P:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return ev

    out = trace.reduce(P)
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
