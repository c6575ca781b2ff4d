"""The port's windowed drive against the JAX windowed drive, on the CPU.

SyntheticStream(n_points=400, seed=42), 48 frames, batches of 8 with
flush=False and one final flush, on both sides. The RANSAC generators differ,
so the comparison is at trajectory level: no lost frame in either drive, and
after a Sim(3) alignment the port's camera centres lie within 0.05 m (median)
of the reference drive's."""
import numpy as np

from movslam_tpu.config.settings import Settings as JSettings
from movslam_tpu.core.camera import Pinhole as JPinhole
from movslam_tpu.core.system import System as JSystem
from movslam_tpu.core.verbose import Verbose as JVerbose
from movslam_tpu.io.synthetic import SyntheticStream as JStream
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.io.synthetic import SyntheticStream
from tests.test_torch_system import MONOCULAR, port_settings

N_FRAMES = 48


def _centres(system, stream):
    est = {}
    items = [(f.timestamp, f) for f in (stream.frame(k) for k in range(N_FRAMES))]
    poses = []
    for k in range(0, N_FRAMES, 8):
        poses.extend(system.track_monocular_batch(items[k : k + 8], flush=False))
    poses.extend(system.track_monocular_batch([], flush=True))
    system.shutdown()
    assert len(poses) == N_FRAMES
    for k, pose in enumerate(poses):
        if pose is not None:
            R, t = pose
            est[k] = -(R.T @ t)
    return est


def test_port_windowed_drive_tracks_the_jax_windowed_drive():
    JVerbose.level = JVerbose.QUIET
    js = JSettings()
    js.camera1 = JPinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    jsys = JSystem(js, MONOCULAR)
    j_est = _centres(jsys, JStream(n_points=400, seed=42))
    psys = System(port_settings(), MONOCULAR, device="cpu")
    p_est = _centres(psys, SyntheticStream(n_points=400, seed=42))
    assert jsys.get_total_lost() == 0 and psys.get_total_lost() == 0
    assert jsys.image_count == psys.image_count == N_FRAMES
    assert psys.counts["windows"] >= 4 and psys.mapper.n_fused_jobs >= 1
    common = sorted(set(j_est) & set(p_est))
    assert len(common) >= N_FRAMES - 8
    J = np.stack([j_est[k] for k in common]).T
    Pp = np.stack([p_est[k] for k in common]).T
    mu_j, mu_p = J.mean(1, keepdims=True), Pp.mean(1, keepdims=True)
    U, d, Vt = np.linalg.svd((J - mu_j) @ (Pp - mu_p).T / len(common))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (d * S.diagonal()).sum() / ((Pp - mu_p) ** 2).sum(0).mean()
    aligned = s * R @ (Pp - mu_p) + mu_j
    med = np.median(np.linalg.norm(aligned - J, axis=0))
    assert med < 0.05, med
