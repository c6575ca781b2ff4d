"""Settings: typed reader of the reference's YAML schema.

Port of movslam_tpu/config/settings.py. Settings can be built in code (as
the tests and chip_smoke.py do) or read from the reference's OpenCV-style
YAML with `Settings.from_yaml`, which imports `yaml` only when called.
Raw (unrectified) stereo rigs are ROADMAP Queue 1 "stereo" work.
"""
from __future__ import annotations

import dataclasses

from ..core.camera import Pinhole

MONOCULAR = 0
STEREO = 1
IMU_MONOCULAR = 3


class SettingsError(RuntimeError):
    pass


def _load_opencv_yaml(path):
    """OpenCV FileStorage YAML: drop the %YAML:1.0 directive pyyaml rejects."""
    import yaml

    with open(path) as f:
        text = "\n".join(l for l in f.read().splitlines() if not l.startswith("%YAML"))
    data = yaml.safe_load(text)
    if not isinstance(data, dict):
        raise SettingsError(f"empty or malformed settings file: {path}")
    return data


@dataclasses.dataclass
class Settings:
    """The settings the mono per-frame slice reads (the reference's other
    fields belong to later slices)."""

    camera1: Pinhole | None = None
    fps: float = 30.0
    threshold: int = 25
    coverage_threshold: float = 0.2
    relocalization_distance: float = 0.25
    reprojection_error: float = 5.0
    reprojection_error_lost: float = 8.0
    th_far_points: float = 0.0
    sensor: int = MONOCULAR

    @staticmethod
    def from_yaml(path, sensor=MONOCULAR):
        """Read a reference-schema settings file (Settings.cc:149-199)."""
        if sensor != MONOCULAR:
            raise NotImplementedError(
                "stereo and visual-inertial settings: ROADMAP Queue 1, stereo / VI slices"
            )
        d = _load_opencv_yaml(path)

        def req(key, cast=float):
            if key not in d:
                raise SettingsError(f"required parameter missing: {key}")
            return cast(d[key])

        def opt(key, default=None, cast=float):
            return cast(d[key]) if key in d else default

        version = opt("File.version", None, str)
        if version != "1.0":
            raise SettingsError(f"settings file must declare File.version '1.0', got {version!r}")
        s = Settings(sensor=sensor)
        camera_type = req("Camera.type", str)
        if camera_type not in ("PinHole", "Rectified"):
            raise SettingsError(f"unsupported camera model: {camera_type}")
        width, height = int(req("Camera.width")), int(req("Camera.height"))
        new_w = int(opt("Camera.newWidth", width))
        new_h = int(opt("Camera.newHeight", height))
        s.fps = req("Camera.fps")
        dist = ()
        if camera_type == "PinHole":
            dist = tuple(opt(f"Camera1.{k}", 0.0) for k in ("k1", "k2", "p1", "p2", "k3"))
        sx, sy = new_w / width, new_h / height
        s.camera1 = Pinhole(
            fx=req("Camera1.fx") * sx, fy=req("Camera1.fy") * sy,
            cx=req("Camera1.cx") * sx, cy=req("Camera1.cy") * sy,
            width=new_w, height=new_h, dist=dist,
        )
        s.threshold = int(req("MOVExtractor.threshold"))
        s.coverage_threshold = req("MOVExtractor.coverageThreshold")
        s.relocalization_distance = req("MOVExtractor.relocalizationDistance")
        for key in ("Optimizer.iterationCount", "Optimizer.confidence", "Optimizer.algorithm"):
            req(key)  # required by the schema, not read by this slice
        s.reprojection_error = req("Optimizer.reprojectionError")
        s.reprojection_error_lost = req("Optimizer.reprojectionErrorLost")
        s.th_far_points = opt("System.thFarPoints", 0.0)
        return s
