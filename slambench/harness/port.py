"""The benchmark's one contact with the system under test, the port
(movslam_tpu_torch): its settings, its System and its input type. Imported
only by a run, never by the reference.
"""
from __future__ import annotations


def settings(config):
    """The port's Settings, built in code from the configuration file (the
    card's host has no yaml), as Settings.from_yaml would read the
    configuration's source file."""
    from movslam_tpu_torch.config import settings as S
    from movslam_tpu_torch.core.camera import Pinhole

    cam = config["camera"]
    s = S.Settings()
    s.sensor = getattr(S, config["sensor"])
    dist = tuple(cam["distortion"]) if any(cam["distortion"]) else ()
    s.camera1 = Pinhole(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["width"], cam["height"], dist=dist)
    s.new_width, s.new_height, s.fps = cam["width"], cam["height"], float(cam["fps"])
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
    """(timestamp, MotionVectorImage) per frame, in the port's input type at
    the configuration's capacities."""
    from movslam_tpu_torch.io.mvimage import FrameType, MotionVectorImage

    cam, cap = config["camera"], config["capacity"]
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
        out.append((f["timestamp"], smv))
    return out


def lost_frames(system, fps):
    """Frame indices the tracker marked lost (its per-frame trajectory's flag)."""
    return {round(ts * fps) for ts, _, _, lost in system.frame_trajectory() if lost}
