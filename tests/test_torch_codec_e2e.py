"""The port of tests/test_codec_e2e.py: the full windowed SLAM drive of the
port on a real H.264 stream (libx264 at the published operating point:
CAVLC, ref = 4, keyint = 1000), decoded by the port's VideoDecoder, on the
CPU. Gates: every frame counted, 0 lost, >= 10 keyframes, scale-aligned ATE
< 5% of the trajectory's span (the reference's own gate)."""
import numpy as np
import pytest

from movslam_tpu_torch.config.settings import MONOCULAR, Settings
from movslam_tpu_torch.core.camera import Pinhole
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.verbose import Verbose
from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.io.video import VideoDecoder, encode_gray
from movslam_tpu_torch.multistream_eval import scale_aligned_ate
import tests._torch_parity  # noqa: F401  (two CPU threads per test worker)


@pytest.mark.slow
def test_encoded_stream_full_slam_ate(tmp_path):
    Verbose.level = Verbose.QUIET
    N = 320
    stream = SyntheticStream(n_points=400, seed=42)
    path = str(tmp_path / "e2e.mp4")
    encode_gray(path, np.stack([stream.render(k)[0] for k in range(N)]), fps=30.0, keyint=1000,
                refs=4, cavlc=True)
    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    system = System(s, MONOCULAR, device="cpu")
    dec = VideoDecoder(path, qlen=12, max_mvs=4096, max_kps=4096)
    dec.init()
    batch, n = [], 0
    for smv in dec:
        batch.append((smv.timestamp, smv))
        if len(batch) >= system.window:
            system.track_monocular_batch(batch, flush=False)
            n += len(batch)
            batch = []
    system.track_monocular_batch(batch, flush=True)
    n += len(batch)
    system.shutdown()

    assert n == N
    assert system.get_total_lost() == 0
    assert system.atlas.current.n_keyframes() >= 10
    est, gt = [], []
    for ts, R, t, _ in system.frame_trajectory():
        est.append(-(R.T @ t))
        R_gt, t_gt = stream.gt_pose(round(ts * 30.0))
        gt.append(-(R_gt.T @ t_gt))
    ate, span = scale_aligned_ate(np.array(gt), np.array(est))
    print(f"real H.264 drive: {n} frames, ATE {ate:.4f} m = {100 * ate / span:.2f}% of {span:.3f} m")
    assert 100.0 * ate / span < 5.0, (ate, span)
