"""The port's monocular per-frame slice end to end on the CPU.

(a) the 40-frame gate of tests/test_pipeline.py against the port;
(b) the port against the JAX drive on the same stream, at trajectory level
    (their RANSAC generators differ, so frame-level poses are not compared);
(d) the port's synthetic stream renders the reference's frames;
(e) the port imports and runs, per frame, one window, global BA, an atlas checkpoint and three
    stereo pairs, with jax, flax, yaml, cv2 and the JAX package blocked — the machine with the
    card has none of the first four, and the port keeps its own copies of what it needs from
    the fifth;
plus the explicit-device rule. ((c), TrackState.from_numpy on a JAX state,
is in tests/test_torch_extractor.py.)"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from movslam_tpu_torch.config.settings import MONOCULAR, Settings
from movslam_tpu_torch.core.camera import Pinhole
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.tracking import State
from movslam_tpu_torch.core.trackstate import TrackState
from movslam_tpu_torch.io.synthetic import SyntheticStream
from tests._torch_parity import assert_exact
from tests.test_pipeline import _umeyama_ate

POSTHOC_ATE_MAX = 0.10  # chip_smoke.py's bound, see there

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_settings():
    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    return s


def _drive(system, stream, n):
    centers = {}
    for k in range(n):
        smv = stream.frame(k)
        pose = system.track_monocular(smv.timestamp, smv)
        if pose is not None:
            R, t = pose
            centers[k] = -(R.T @ t)
    return centers


def _gt_center(stream, k):
    R, t = stream.gt_pose(k)
    return -(R.T @ t)


def test_forty_frame_gate():
    """tests/test_pipeline.py:53-96's gates, on the port, with the post-hoc
    ATE bound of chip_smoke.py: the reference's own drive misses the 0.02 m
    of tests/test_pipeline.py on a CPU host (0.021-0.051 m over thirteen
    PRNG keys); both drives stay under 0.10 m over every key measured."""
    stream = SyntheticStream(n_points=400, seed=11)
    system = System(port_settings(), MONOCULAR, device="cpu")
    est = _drive(system, stream, 40)
    assert system.tracking.state == State.OK
    m = system.atlas.current
    assert m.n_keyframes() >= 3 and m.n_mappoints() > 100
    assert len(est) >= 30
    ate_live = _umeyama_ate([_gt_center(stream, k) for k in est], list(est.values()))
    assert ate_live < 0.35, ate_live
    traj = system.frame_trajectory()
    gt2 = [_gt_center(stream, round(ts * 30.0)) for ts, _, _, _ in traj]
    es2 = [-(R.T @ t) for _, R, t, _ in traj]
    assert len(es2) >= 35
    ate = _umeyama_ate(gt2, es2)
    assert ate < POSTHOC_ATE_MAX, f"post-hoc ATE {ate:.4f} m"
    system.shutdown()


def test_port_tracks_the_jax_drive():
    """Seed 3, 25 frames: both drives reach OK with no lost frame, and after
    a Sim(3) alignment the port's camera centers lie within 0.05 m (median)
    of the reference drive's."""
    from movslam_tpu.config.settings import Settings as JSettings
    from movslam_tpu.core.camera import Pinhole as JPinhole
    from movslam_tpu.core.system import System as JSystem
    from movslam_tpu.core.tracking import State as JState
    from movslam_tpu.io.synthetic import SyntheticStream as JStream

    js = JSettings()
    js.camera1 = JPinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    jsys = JSystem(js, MONOCULAR)
    j_est = _drive(jsys, JStream(n_points=400, seed=3), 25)
    psys = System(port_settings(), MONOCULAR, device="cpu")
    p_est = _drive(psys, SyntheticStream(n_points=400, seed=3), 25)
    assert jsys.tracking.state == JState.OK and psys.tracking.state == State.OK
    assert jsys.get_total_lost() == 0 and psys.get_total_lost() == 0
    common = sorted(set(j_est) & set(p_est))
    assert len(common) >= 20
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
    assert np.median(np.linalg.norm(aligned - J, axis=0)) < 0.05


def test_stream_renders_reference_frames():
    from movslam_tpu.io.synthetic import SyntheticStream as JStream

    ours, ref = SyntheticStream(n_points=120, seed=4), JStream(n_points=120, seed=4)
    for k in range(3):
        a, b = ours.frame(k), ref.frame(k)
        assert a.ft == b.ft and a.n_mvs == b.n_mvs and a.n_kps == b.n_kps
        assert a.coverage_area == b.coverage_area
        for name in ("im_gray", "mv_delta", "mv_rect", "mv_dindx", "kps_rect"):
            assert_exact(getattr(a, name), getattr(b, name), name)


def test_runs_with_jax_flax_yaml_cv2_blocked(tmp_path):
    code = textwrap.dedent("""
        import os, sys
        for name in ("jax", "flax", "yaml", "cv2", "movslam_tpu"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(2)
        from movslam_tpu_torch.config.settings import Settings, MONOCULAR
        from movslam_tpu_torch.core.camera import Pinhole
        from movslam_tpu_torch.core.system import System
        from movslam_tpu_torch.io.synthetic import SyntheticStream
        s = Settings()
        s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
        system = System(s, MONOCULAR, device="cpu", use_viewer=True)
        system.viewer.out_dir = "frames"
        stream = SyntheticStream(n_points=400, seed=11)
        for k in range(5):
            smv = stream.frame(k)
            system.track_monocular(smv.timestamp, smv)
        items = [(f.timestamp, f) for f in (stream.frame(k) for k in range(5, 9))]
        poses = system.track_monocular_batch(items)  # one window or more
        system.global_bundle_adjustment(iters=2)
        system.shutdown()
        assert system.tracking.state.name == "OK", system.tracking.state
        from movslam_tpu_torch.core import checkpoint, map_merge
        from movslam_tpu_torch.ops import posegraph
        system.save_atlas("a.atlas")
        system.load_atlas("a.atlas")
        assert system.atlas.current.n_keyframes() >= 2
        assert not map_merge.try_merge(system.atlas, device="cpu")  # one map: nothing to weld
        assert system.counts["windows"] >= 1 and len(poses) == 4, system.counts
        assert system.image_count == 9 and system.get_total_lost() == 0
        assert system.viewer.count == 9 and not os.path.exists("frames")  # no cv2: nothing written
        from movslam_tpu_torch.ops.express import save_express_file
        out = save_express_file("ex.png", stream.render(0)[0][200:280, 280:400], 25, device="cpu")
        assert os.listdir(".").count("ex.png.npy") == 1 and (out == 0).any()
        from movslam_tpu_torch.config.settings import STEREO
        from movslam_tpu_torch.config import rectify
        from movslam_tpu_torch.core import stereo, stereo_rectified
        from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream
        s.sensor, s.b, s.bf = STEREO, 0.25, 80.0
        ssys = System(s, STEREO, device="cpu", use_viewer=True)
        for left, right in SyntheticStereoStream(seed=5).pairs(3):
            ssys.track_stereo(left.timestamp, left, right)
        ssys.shutdown()
        assert ssys.viewer.count == 3
        assert ssys.tracking.state.name == "OK" and ssys.atlas.current.n_mappoints() > 100
        assert ssys.tracking.last_kf.depth_right is not None
        from movslam_tpu_torch.config.settings import IMU_MONOCULAR
        from movslam_tpu_torch.core import inertial
        from movslam_tpu_torch.io.synthetic_vi import SyntheticVIStream
        from movslam_tpu_torch.ops import imu, vi_ba
        s.sensor = IMU_MONOCULAR
        visys = System(s, IMU_MONOCULAR, device="cpu")
        vstream = SyntheticVIStream(n_points=400, seed=11)
        for k in range(3):
            smv = vstream.frame(k)
            visys.track_monocular(smv.timestamp, smv, imu=vstream.imu_window(k))
        visys.track_monocular_batch(list(vstream.items(2, start=3)))
        visys.shutdown()
        assert sorted(visys.imu_buffer.by_frame) == [1, 2, 3, 4], visys.imu_buffer.by_frame.keys()
        blocked = ("jax", "jaxlib", "flax", "yaml", "cv2", "movslam_tpu")
        loaded = [m for m in sys.modules if m.split(".")[0] in blocked]
        assert all(sys.modules[m] is None for m in loaded), loaded
        print("slice ran without jax")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "slice ran without jax" in proc.stdout
    assert proc.stdout.count("viewer: cv2 is not installed") == 2  # once per viewer


def test_settings_from_yaml_matches_reference(tmp_path):
    from movslam_tpu.config.settings import Settings as JSettings
    from movslam_tpu_torch.config.settings import SettingsError

    path = os.path.join(REPO, "configs", "TartanAir.yaml")
    got, want = Settings.from_yaml(path), JSettings.from_yaml(path)
    assert got.camera1.K().tolist() == want.camera1.K().tolist()
    assert (got.camera1.width, got.camera1.height, got.camera1.dist) == (
        want.camera1.width, want.camera1.height, want.camera1.dist)
    for name in ("fps", "threshold", "coverage_threshold", "relocalization_distance",
                 "reprojection_error", "reprojection_error_lost", "th_far_points"):
        assert getattr(got, name) == getattr(want, name), name
    broken = tmp_path / "broken.yaml"
    broken.write_text(open(path).read().replace("Optimizer.confidence", "Optimizer.confidenc"))
    with pytest.raises(SettingsError, match="Optimizer.confidence"):
        Settings.from_yaml(str(broken))


def test_device_is_explicit():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            System(port_settings(), MONOCULAR, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):  # stereo defaults to the card too
            System(port_settings(), System.STEREO)
    assert System(port_settings(), System.STEREO, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):  # and so does the visual-inertial sensor
            System(port_settings(), System.IMU_MONOCULAR)
    assert System(port_settings(), System.IMU_MONOCULAR, device="cpu").mapper.imu_buffer is not None
    with pytest.raises(ValueError, match="sensor"):
        System(port_settings(), 2, device="cpu")
    with pytest.raises(ValueError, match="Stereo"):
        System(port_settings(), MONOCULAR, device="cpu").track_stereo_batch([])
    with pytest.raises(TypeError):  # nothing picks the CPU on its own
        TrackState.empty(8)
    with pytest.raises(TypeError):
        TrackState.from_numpy({})
