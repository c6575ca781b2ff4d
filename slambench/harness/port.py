"""The benchmark's one contact with the system under test, the port
(movslam_tpu_torch): its settings, its System and its input type. Imported
only by a run, never by the reference.
"""
from __future__ import annotations


def _pinhole(cam):
    from movslam_tpu_torch.core.camera import Pinhole

    dist = tuple(cam["distortion"]) if any(cam["distortion"]) else ()
    return Pinhole(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["width"], cam["height"], dist=dist)


def settings(config):
    """The port's Settings, built in code from the configuration file (the
    card's host has no yaml), as Settings.from_yaml would read the
    configuration's source file: the camera, extractor and optimizer; a
    `camera2` block as Camera2.*; a STEREO sensor's `stereo` block as
    Stereo.ThDepth and either Stereo.b (a rectified rig) or Stereo.T_c1_c2
    (a raw rig, rectified as from_yaml does); an `imu` block as IMU.NoiseGyro
    and IMU.NoiseAcc."""
    import numpy as np
    from movslam_tpu_torch.config import settings as S

    cam = config["camera"]
    s = S.Settings()
    s.sensor = getattr(S, config["sensor"])
    s.camera1 = _pinhole(cam)
    s.new_width, s.new_height, s.fps = cam["width"], cam["height"], float(cam["fps"])
    if "camera2" in config:
        s.camera2 = _pinhole(config["camera2"])
    if s.sensor == S.STEREO:
        stereo = config["stereo"]
        s.th_depth = float(stereo["th_depth"])
        if "T_c1_c2" in stereo:
            if s.camera2 is None:
                raise ValueError("a raw stereo rig (stereo.T_c1_c2) needs a camera2 block")
            s.T_c1_c2 = np.asarray(stereo["T_c1_c2"], np.float64)
            s.b = float(np.linalg.norm(s.T_c1_c2[:3, 3]))
            s.bf = s.b * s.camera1.fx
            s._precompute_rectification()
        else:
            s.b = float(stereo["b"])
            s.bf = s.b * s.camera1.fx
    if "imu" in config:
        s.imu_noise_gyro = float(config["imu"]["noise_gyro"])
        s.imu_noise_acc = float(config["imu"]["noise_acc"])
    ext, opt = config["extractor"], config["optimizer"]
    s.threshold = int(ext["threshold"])
    s.coverage_threshold = float(ext["coverage_threshold"])
    s.relocalization_distance = float(ext["relocalization_distance"])
    s.reprojection_error = float(opt["reprojection_error"])
    s.reprojection_error_lost = float(opt["reprojection_error_lost"])
    return s


def system(config, device):
    from movslam_tpu_torch.core.system import System

    s = settings(config)
    return System(s, s.sensor, device=device)


def inputs(frames, config):
    """The item the port's batch entry takes for each frame, in the port's
    input type at the configuration's capacities: (timestamp,
    MotionVectorImage) pairs; (timestamp, smv, IMU rows or None) on an
    IMU_MONOCULAR sensor; (timestamp, smv_left, smv_right) on a STEREO one,
    the right frame image-only, as the port's synthetic stereo stream makes
    it."""
    from movslam_tpu_torch.io.mvimage import FrameType, MotionVectorImage

    cam, cap = config["camera"], config["capacity"]
    sensor = config["sensor"]
    out = []
    for k, f in enumerate(frames):
        smv = MotionVectorImage.empty(cam["width"], cam["height"], cap["mvs"], cap["keypoints"])
        smv.frame_no, smv.timestamp, smv.ft = k, f["timestamp"], FrameType(f["ft"])
        smv.im_gray = f["im_gray"]
        n = min(len(f["mv_delta"]), cap["mvs"], cap["keypoints"])
        smv.mv_delta[:n], smv.mv_rect[:n], smv.mv_dindx[:n] = f["mv_delta"][:n], f["mv_rect"][:n], f["mv_dindx"][:n]
        smv.kps_rect[:n] = f["kps_rect"][:n]
        smv.n_mvs = smv.n_kps = n
        smv.coverage_area = f["coverage"]
        if sensor == "IMU_MONOCULAR":
            out.append((f["timestamp"], smv, f["imu"]))
        elif sensor == "STEREO":
            right = MotionVectorImage.empty(f["im_right"].shape[1], f["im_right"].shape[0])
            right.frame_no, right.timestamp, right.ft = k, f["timestamp"], smv.ft
            right.im_gray = f["im_right"]
            out.append((f["timestamp"], smv, right))
        else:
            out.append((f["timestamp"], smv))
    return out


def batch_entry(system):
    """The name of the System's windowed entry for its sensor."""
    return "track_stereo_batch" if system.sensor == system.STEREO else "track_monocular_batch"


def lost_frames(system, fps):
    """Frame indices the tracker marked lost (its per-frame trajectory's flag)."""
    return {round(ts * fps) for ts, _, _, lost in system.frame_trajectory() if lost}
