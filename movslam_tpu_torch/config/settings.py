"""Settings: typed reader of the reference's YAML schema.

Port of movslam_tpu/config/settings.py. Settings can be built in code (as
the tests and chip_smoke.py do) or read from the reference's OpenCV-style
YAML with `Settings.from_yaml`, which imports `yaml` only when called.
Stereo rigs are either pre-rectified (`Stereo.b`) or raw PinHole pairs with
`Stereo.T_c1_c2`, which are rectified by config/rectify.py. The IMU noise
model of the visual-inertial sensor comes from the optional `IMU.*` keys.
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
    """OpenCV FileStorage YAML: drop the %YAML:1.0 directive pyyaml rejects
    and read the `!!opencv-matrix` nodes cv::FileStorage emits
    (Stereo.T_c1_c2 is a 4x4 matrix node)."""
    import numpy as np
    import yaml

    class CvLoader(yaml.SafeLoader):
        pass

    def cv_matrix(loader, node):
        d = loader.construct_mapping(node, deep=True)
        return np.asarray(d["data"], np.float64).reshape(int(d["rows"]), int(d["cols"]))

    CvLoader.add_constructor("tag:yaml.org,2002:opencv-matrix", cv_matrix)
    with open(path) as f:
        text = "\n".join(l for l in f.read().splitlines() if not l.startswith("%YAML"))
    data = yaml.load(text, Loader=CvLoader)
    if not isinstance(data, dict):
        raise SettingsError(f"empty or malformed settings file: {path}")
    return data


@dataclasses.dataclass
class Settings:
    """The settings the monocular, stereo and visual-inertial drives read (the
    reference's other fields belong to later slices)."""

    camera1: Pinhole | None = None
    camera2: Pinhole | None = None
    new_width: int = 640
    new_height: int = 480
    fps: float = 30.0
    # stereo: baseline (m), baseline * fx, close-point threshold in baselines
    b: float = 0.0
    bf: float = 0.0
    th_depth: float = 35.0
    # raw (unrectified) rigs: Stereo.T_c1_c2 (4, 4) cam1 -> cam2 and the
    # R1/R2/P1/P2 of config/rectify.py with lazily built remap maps
    need_rectify: bool = False
    T_c1_c2: object = None
    rectification: dict | None = None
    threshold: int = 25
    coverage_threshold: float = 0.2
    relocalization_distance: float = 0.25
    reprojection_error: float = 5.0
    reprojection_error_lost: float = 8.0
    th_far_points: float = 0.0
    sensor: int = MONOCULAR
    # IMU noise densities (EuRoC defaults), from the optional IMU.NoiseGyro /
    # IMU.NoiseAcc keys (the reference declares Settings::readIMU but never
    # defines it, Settings.h:159). The bias random walks of the preintegration
    # are fixed (ops/imu.preintegrate); IMU.GyroWalk, IMU.AccWalk and
    # IMU.Frequency are not read.
    imu_noise_gyro: float = 1.7e-4
    imu_noise_acc: float = 2e-3
    # atlas checkpoints (core/checkpoint.py): loaded by System at start,
    # saved at shutdown (System.LoadAtlasFromFile / SaveAtlasToFile)
    load_atlas: str | None = None
    save_atlas: str | None = None

    @property
    def th_depth_m(self):
        """Close-point depth threshold in meters: mThDepth = b * ThDepth."""
        return self.b * self.th_depth

    @staticmethod
    def from_yaml(path, sensor=MONOCULAR):
        """Read a reference-schema settings file (Settings.cc:149-199)."""
        if sensor not in (MONOCULAR, STEREO, IMU_MONOCULAR):
            raise ValueError(f"unsupported sensor {sensor!r}")
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
        s.new_width, s.new_height = new_w, new_h
        s.fps = req("Camera.fps")
        sx, sy = new_w / width, new_h / height

        def camera(name):
            dist = ()
            if camera_type == "PinHole":
                dist = tuple(opt(f"{name}.{k}", 0.0) for k in ("k1", "k2", "p1", "p2", "k3"))
            return Pinhole(
                fx=req(f"{name}.fx") * sx, fy=req(f"{name}.fy") * sy,
                cx=req(f"{name}.cx") * sx, cy=req(f"{name}.cy") * sy,
                width=new_w, height=new_h, dist=dist,
            )

        s.camera1 = camera("Camera1")
        if "Camera2.fx" in d:
            s.camera2 = camera("Camera2")
        if sensor == STEREO:
            s.th_depth = req("Stereo.ThDepth")
            if camera_type == "Rectified":
                # pre-rectified rig: the baseline is given (Settings.cc:315-319)
                s.b = req("Stereo.b")
                s.bf = s.b * s.camera1.fx
            else:
                # raw PinHole rig: baseline = |translation| of the extrinsics
                # (Settings.cc:321-328); rectification then updates camera1, bf
                if "Stereo.T_c1_c2" not in d:
                    raise SettingsError(
                        "required parameter missing: Stereo.T_c1_c2 "
                        "(PinHole stereo rigs need extrinsics)"
                    )
                import numpy as np

                T = np.asarray(d["Stereo.T_c1_c2"], np.float64)
                if T.shape != (4, 4):
                    raise SettingsError("Stereo.T_c1_c2 must be 4x4")
                s.T_c1_c2 = T
                s.b = float(np.linalg.norm(T[:3, 3]))
                s.bf = s.b * s.camera1.fx
                if s.camera2 is None:
                    raise SettingsError("PinHole stereo requires Camera2.* calibration")
                s._precompute_rectification()
        s.threshold = int(req("MOVExtractor.threshold"))
        s.coverage_threshold = req("MOVExtractor.coverageThreshold")
        s.relocalization_distance = req("MOVExtractor.relocalizationDistance")
        for key in ("Optimizer.iterationCount", "Optimizer.confidence", "Optimizer.algorithm"):
            req(key)  # required by the schema, not read by this slice
        s.reprojection_error = req("Optimizer.reprojectionError")
        s.reprojection_error_lost = req("Optimizer.reprojectionErrorLost")
        s.th_far_points = opt("System.thFarPoints", 0.0)
        s.imu_noise_gyro = opt("IMU.NoiseGyro", s.imu_noise_gyro)
        s.imu_noise_acc = opt("IMU.NoiseAcc", s.imu_noise_acc)
        s.load_atlas = opt("System.LoadAtlasFromFile", None, str)
        s.save_atlas = opt("System.SaveAtlasToFile", None, str)
        return s

    def _precompute_rectification(self):
        """Settings::precomputeRectificationMaps (Settings.cc:430-465):
        Bouguet rectification from T_c1_c2; camera1/camera2 become the
        rectified projection (zero distortion) and bf = b * fx'. The dense
        maps are built lazily (rectify_maps)."""
        import numpy as np

        from .rectify import stereo_rectify

        c1, c2 = self.camera1, self.camera2
        K1 = np.array([[c1.fx, 0, c1.cx], [0, c1.fy, c1.cy], [0, 0, 1]], np.float64)
        K2 = np.array([[c2.fx, 0, c2.cx], [0, c2.fy, c2.cy], [0, 0, 1]], np.float64)
        # stereoRectify takes the transform from LEFT-camera points to
        # RIGHT-camera coordinates: the inverse of T_c1_c2 (Settings.cc:438-443)
        T = np.linalg.inv(self.T_c1_c2)
        size = (self.new_width, self.new_height)
        rect = stereo_rectify(
            K1, tuple(c1.dist or ()), K2, tuple(c2.dist or ()), size, T[:3, :3], T[:3, 3]
        )
        self.rectification = {
            "K1": K1, "K2": K2,
            "dist1": tuple(c1.dist or ()), "dist2": tuple(c2.dist or ()),
            **rect,
        }
        P1 = rect["P1"]
        rectified = Pinhole(
            fx=float(P1[0, 0]), fy=float(P1[1, 1]), cx=float(P1[0, 2]), cy=float(P1[1, 2]),
            width=self.new_width, height=self.new_height,
        )
        self.camera1 = rectified
        self.camera2 = rectified
        self.bf = self.b * float(rect["fc_new"])
        self.need_rectify = True

    def rectify_maps(self):
        """Dense remap maps of both cameras, built at first use:
        {'left': (map_x, map_y), 'right': (map_x, map_y)}, rectified pixel ->
        raw source pixel (config/rectify.py::init_rectify_map)."""
        r = self.rectification
        if r is None:
            return None
        if "maps" not in r:
            from .rectify import init_rectify_map

            size = (self.new_width, self.new_height)
            r["maps"] = {
                "left": init_rectify_map(r["K1"], r["dist1"], r["R1"], r["P1"], size),
                "right": init_rectify_map(r["K2"], r["dist2"], r["R2"], r["P2"], size),
            }
        return r["maps"]
