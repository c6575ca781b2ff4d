"""The port's CLI (movslam_tpu_torch/cli.py) end to end on the CPU: the port
of tests/test_smoke_pipeline.py through mono_main, a real H.264 file,
frame-packed stereo against the reference's open_stereo_stream, and the
device rules (--cpu or the card, never a silent CPU run). The stereo and VI
streams' drives are in the slow tier."""
import os

import numpy as np
import pytest
import torch

from movslam_tpu import cli as jcli
from movslam_tpu_torch import cli
from movslam_tpu_torch.core.verbose import Verbose
from movslam_tpu_torch.io import video
from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream
import tests._torch_parity  # noqa: F401  (two CPU threads per test worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONO_YAML = os.path.join(REPO, "configs", "TartanAir.yaml")
STEREO_YAML = os.path.join(REPO, "configs", "TartanAirStereo.yaml")
IMU_KEYS = """
IMU.NoiseGyro: 1.7e-04
IMU.NoiseAcc: 2.0e-03
"""


@pytest.fixture(autouse=True)
def quiet():
    level, Verbose.level = Verbose.level, Verbose.QUIET
    yield
    Verbose.level = level


def _outputs(frames, min_rows):
    """results.txt (imageCnt,totalLost,avg_ms: every frame counted, 0 lost)
    and both trajectory files in the working directory, with at least
    min_rows frame rows."""
    fields = open("results.txt").read().strip().split(",")
    assert len(fields) == 3 and int(fields[0]) == frames and int(fields[1]) == 0, fields
    assert float(fields[2]) > 0
    kitti = np.loadtxt("TrajectoryKITTIKeyFrame.txt", ndmin=2)
    euroc = np.loadtxt("TrajectoryEUROC.txt", ndmin=2)
    assert kitti.shape[1] == 13 and len(kitti) >= 2
    assert euroc.shape[1] == 8 and len(euroc) >= min_rows


def test_mono_main_synthetic(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.mono_main(["mono", MONO_YAML, "synthetic://n_frames=24,seed=3", "--cpu"]) == 0
    _outputs(24, 12)


def test_mono_main_viewer_writes_frame_pngs(tmp_path, monkeypatch):
    """--viewer DIR streams one annotated PNG per frame through the headless
    viewer (cv2 is installed on this host), as the reference's CLI does."""
    import cv2

    monkeypatch.chdir(tmp_path)
    assert cli.mono_main(["mono", MONO_YAML, "synthetic://n_frames=16", "--viewer", "frames", "--cpu"]) == 0
    _outputs(16, 8)
    pngs = sorted(os.listdir("frames"))
    assert pngs == [f"frame_{k:06d}.png" for k in range(1, 17)]
    img = cv2.imread(os.path.join("frames", pngs[-1]))
    assert img.shape == (480, 640, 3)
    green = (img[:, :, 1] == 255) & (img[:, :, 0] == 0) & (img[:, :, 2] == 0)
    assert green.any()  # map-point inliers boxed


@pytest.mark.slow  # ~35 s: the stereo depth's LK runs at 640x480 on the CPU
def test_stereo_main_synthetic(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["cli", "stereo", STEREO_YAML, "synthetic-stereo://n_frames=6,seed=5", "--cpu"]) == 0
    _outputs(6, 2)  # the stereo map starts at pair 4 on this stream


@pytest.mark.slow
def test_mono_main_visual_inertial(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    settings = tmp_path / "vi.yaml"
    settings.write_text(open(MONO_YAML).read() + IMU_KEYS)
    assert cli.mono_main(["mono", str(settings), "synthetic-vi://n_frames=12,seed=11", "--cpu"]) == 0
    fields = open("results.txt").read().strip().split(",")
    assert int(fields[0]) == 12 and int(fields[1]) == 0


def test_mono_main_real_h264(tmp_path, monkeypatch):
    """16 frames of SyntheticStream(n_points=400, seed=42) encoded at the
    published operating point (CAVLC, ref = 4) and decoded by the port: every
    frame the decoder yields is counted (it yields 15 of this file's 16, as
    the reference's does; tests/test_torch_video.py)."""
    stream = SyntheticStream(n_points=400, seed=42)
    path = str(tmp_path / "clip.mp4")
    video.encode_gray(path, np.stack([stream.render(k)[0] for k in range(16)]), refs=4, cavlc=True)
    n_decoded = sum(1 for _ in cli.open_stream(path)[0])
    monkeypatch.chdir(tmp_path)
    assert cli.mono_main(["mono", MONO_YAML, path, "--cpu"]) == 0
    _outputs(n_decoded, 8)


def test_frame_packed_stereo_pairs_match_the_reference(tmp_path):
    """Left and right frames interleaved in one H.264 file: right frames
    skip the MV copies (stereo_video_tartan.cc:74-99)."""
    pairs = list(SyntheticStereoStream(seed=5).pairs(6))
    path = str(tmp_path / "packed.mp4")
    video.encode_gray(path, np.stack([f.im_gray for pair in pairs for f in pair]), refs=4, cavlc=True)
    got = list(cli.open_stereo_stream(path, 30.0))
    want = list(jcli.open_stereo_stream(path, 30.0))
    assert len(got) == len(want) == 6
    for (gl, gr), (wl, wr) in zip(got, want):
        assert gr.n_mvs == 0 and wr.n_mvs == 0
        assert np.array_equal(gl.im_gray, wl.im_gray) and np.array_equal(gr.im_gray, wr.im_gray)
        assert gl.n_mvs == wl.n_mvs and np.array_equal(gl.mv_delta, wl.mv_delta)
    assert sum(left.n_mvs for left, _ in got[1:]) > 0


def test_entry_points_run_on_the_card_or_raise(tmp_path, monkeypatch):
    """Without --cpu every entry point asks for the card; with no card it
    raises instead of running on the CPU, with --viewer too."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # a host without a card
    with pytest.raises(RuntimeError, match="cuda"):
        cli.mono_main(["mono", MONO_YAML, "synthetic://n_frames=2"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.stereo_main(["stereo", STEREO_YAML, "synthetic-stereo://n_frames=2"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.mono_main(["mono", MONO_YAML, "synthetic://n_frames=2", "--viewer", "out"])
    assert not os.path.exists("results.txt") and not os.path.exists("out")
    assert cli.main(["cli"]) == 1 and cli.mono_main(["mono"]) == 1
