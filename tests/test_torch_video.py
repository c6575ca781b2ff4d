"""Port parity: io/video.py and the port's own build of the native decoder
(movslam_tpu_torch/native/decoder/, built into movslam_tpu_torch/_build/)
against the reference's VideoDecoder on the same encoded files, bit for bit;
and the ports of tests/test_decoder.py and tests/test_multiref.py, with
libx264 through encode_gray instead of cv2."""
import ctypes

import numpy as np
import pytest

from movslam_tpu.io import video as jvideo
from movslam_tpu_torch.core.verbose import Verbose
from movslam_tpu_torch.io import video
from movslam_tpu_torch.io.mvimage import FrameType
from movslam_tpu_torch.io.synthetic import SyntheticStream
from tests.test_multiref import CASES, reference_model, run_native

FIELDS = ("ft", "frame_no", "timestamp", "coverage_area", "n_mvs", "n_kps", "mv_delta", "mv_rect",
          "mv_dindx", "kps_rect", "im_gray")


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None and x.dtype == y.dtype and np.array_equal(x, y), f
        else:
            assert x == y and type(x) is type(y) or (f == "ft" and int(x) == int(y)), (f, x, y)


def _decode(mod, path, **kw):
    dec = mod.VideoDecoder(path, **kw)
    dec.init()
    out = list(dec)
    dec.close()
    return out


@pytest.fixture(scope="module")
def codec_file(tmp_path_factory):
    """24 frames of SyntheticStream(n_points=400, seed=42) at the published
    operating point: CAVLC, ref = 4, keyint = 1000."""
    stream = SyntheticStream(n_points=400, seed=42)
    path = str(tmp_path_factory.mktemp("vid") / "e2e.mp4")
    video.encode_gray(path, np.stack([stream.render(k)[0] for k in range(24)]), fps=30.0,
                      keyint=1000, refs=4, cavlc=True)
    return path


def test_decoder_builds_from_the_ports_sources():
    lib = video.build()
    assert video.SRC_DIR.parts[-3:] == ("movslam_tpu_torch", "native", "decoder")
    assert lib._name.startswith(str(video.BUILD_DIR)) and "libmvdecoder_" in lib._name
    assert video.libav_found()


def test_decoder_arrays_equal_the_references(codec_file):
    got = _decode(video, codec_file)
    want = _decode(jvideo, codec_file)
    assert len(got) == len(want) == 24
    assert got[0].ft == FrameType.I_FRAME and all(f.ft == FrameType.P_FRAME for f in got[1:])
    assert min(f.n_mvs for f in got[1:]) > 300
    assert got[0].mv_delta.shape == (8192, 2) and got[0].kps_rect.shape == (4096, 4)
    for g, w in zip(got, want):
        _same(g, w, FIELDS)


def test_decoder_truncates_and_logs_once(codec_file, capsys, monkeypatch):
    monkeypatch.setattr(Verbose, "level", Verbose.NORMAL)
    got = _decode(video, codec_file, max_mvs=64, max_kps=32)
    assert capsys.readouterr().out.count("dropped") == 1
    want = _decode(jvideo, codec_file, max_mvs=64, max_kps=32)
    for g, w in zip(got, want):
        _same(g, w, FIELDS)
    assert max(f.n_mvs for f in got) == 64


def test_rgb_and_bframe_records_equal_the_references(tmp_path):
    """The B-frame branch (VideoDecoder.cc:255-286) and the RGB surface
    (VideoBase.h:60-68) on a bframes = 2 encode."""
    rng = np.random.default_rng(1)
    H, W, N = 120, 160, 30
    base = rng.integers(0, 255, (H * 2, W * 2)).astype(np.uint8)
    path = str(tmp_path / "btest.mp4")
    video.encode_gray(path, np.stack([base[k:k + H, k:k + W] for k in range(N)]), fps=30.0,
                      keyint=1000, refs=2, bframes=2)
    got = _decode(video, path, qlen=6, rgb=True)
    want = _decode(jvideo, path, qlen=6, rgb=True)
    assert len(got) == len(want) == N
    assert sum(f.ft == FrameType.B_FRAME for f in got) > 0 and sum(f.n_bmvs for f in got) > 0
    for g, w in zip(got, want):
        _same(g, w, FIELDS + ("im_rgb", "n_bmvs"))
        assert g.im_rgb.shape == (H, W, 3)
        if g.n_bmvs:
            assert g.ft == FrameType.B_FRAME
            _same(g, w, ("bmv_delta", "bmv_rect"))


@pytest.mark.parametrize("n,decoded", [(12, 12), (13, 12), (16, 15), (17, 17)])
def test_both_decoders_lose_the_last_frame_of_some_files(tmp_path, n, decoded):
    """A fault of the reference's decoder that the port's copy keeps: of
    some files (13 or 16 frames here, n access units by refidx_scan) both
    yield every frame but the last; of others (12, 17) every frame."""
    stream = SyntheticStream(n_points=400, seed=42)
    path = str(tmp_path / f"n{n}.mp4")
    video.encode_gray(path, np.stack([stream.render(k)[0] for k in range(n)]), refs=4, cavlc=True)
    assert len(video.refidx_scan(path)) == n
    got, want = _decode(video, path), _decode(jvideo, path)
    assert [f.frame_no for f in got] == [f.frame_no for f in want] == list(range(1, decoded + 1))
    for g, w in zip(got, want):
        _same(g, w, FIELDS)


def test_decoder_error_on_missing_file():
    dec = video.VideoDecoder("/nonexistent/file.mp4")
    with pytest.raises(RuntimeError, match="failed to open"):
        dec.init()


@pytest.fixture(scope="module")
def flicker_file(tmp_path_factory):
    """tests/test_multiref.py::_flicker_stream: period-2 texture flicker and
    constant horizontal motion, so x264 picks references 2 or 4 frames back."""
    rng = np.random.default_rng(1)
    H, W, n, shift = 480, 640, 40, 2
    texs = []
    for _ in range(2):
        t = rng.integers(0, 255, (H, 2 * W), np.uint8).astype(np.float32)
        t = (t + np.roll(t, 1, 0) + np.roll(t, 1, 1) + np.roll(t, 2, 1)) / 4
        texs.append(t.astype(np.uint8))
    frames = np.stack([np.roll(texs[k % 2], -shift * k, axis=1)[:, :W] for k in range(n)])
    path = str(tmp_path_factory.mktemp("flicker") / "flicker_ref4.mp4")
    video.encode_gray(path, frames, refs=4, cavlc=True)
    return path, shift


def test_refidx_parser_full_coverage_and_multiref(flicker_file):
    path, _ = flicker_file
    s = video.refidx_scan(path)
    assert np.array_equal(s, jvideo.refidx_scan(path))
    assert len(s) == 40
    p_rows = s[1:]  # row 0 is the IDR
    assert (p_rows[:, 0] == 1).all(), "unparsed P access units"
    assert (p_rows[:, 1] == 40 * 30).all(), "incomplete MB coverage"
    assert p_rows[:, 11].sum() == 0, "ref indices out of range"
    hist = p_rows[:, 3:11].sum(0)
    assert hist[1] + hist[3] > 0.8 * hist.sum(), hist


def test_real_multiref_stream_decodes_to_per_hop_deltas(flicker_file):
    """Per-hop deltas of (-shift, 0): only when the recovered reference
    index divides each multi-ref MV over its hops (VideoDecoder.cc:287-348)."""
    path, shift = flicker_file
    per_frame_med, bad_hops, total = [], 0, 0
    for smv in _decode(video, path):
        if smv.ft != FrameType.P_FRAME or smv.n_mvs < 100:
            continue
        d = smv.mv_delta[:smv.n_mvs]
        per_frame_med.append(np.median(d, axis=0))
        bad_hops += int(np.sum(np.abs(d - np.array([-shift, 0.0], np.float32)).max(axis=1) > 1.0))
        total += len(d)
    assert len(per_frame_med) > 30
    np.testing.assert_allclose(np.median(np.stack(per_frame_med), axis=0), [-shift, 0.0], atol=0.5)
    assert bad_hops < 0.05 * total, (bad_hops, total)


@pytest.fixture(scope="module")
def decompose_lib():
    lib = video.build()
    fn = lib.mvdec_test_decompose
    fn.restype = ctypes.c_float
    f32, i32 = np.ctypeslib.ndpointer(np.float32), np.ctypeslib.ndpointer(np.int32)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, f32, f32, f32, i32, i32, ctypes.c_int,
                   f32, i32, f32, i32, ctypes.c_int, ctypes.c_int]
    return lib


@pytest.mark.parametrize("case", range(len(CASES)))
def test_decompose_matches_reference_model(decompose_lib, case):
    """The multi-ref hop decomposition of the port's build against the
    reference's Python model of VideoDecoder.cc:211-348."""
    W, H, n_queue = 640, 480, 4
    out_mv, out_nmv, out_kp, out_nkp, cov = run_native(decompose_lib, W, H, n_queue, CASES[case])
    frames, cov_ref = reference_model(W, H, n_queue, CASES[case])
    assert cov == pytest.approx(cov_ref)
    for f in range(n_queue + 1):
        exp_mv = np.array(frames[f]["mv"], np.float32).reshape(-1, 7)
        exp_kp = np.array(frames[f]["kp"], np.float32).reshape(-1, 4)
        assert out_nmv[f] == len(exp_mv) and out_nkp[f] == len(exp_kp), f
        np.testing.assert_allclose(out_mv[f, :len(exp_mv)], exp_mv, atol=1e-5)
        np.testing.assert_allclose(out_kp[f, :len(exp_kp)], exp_kp, atol=1e-5)
