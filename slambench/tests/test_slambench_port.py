"""The harness builds the port's Settings from a configuration file as the
port's own Settings.from_yaml reads the same values from the reference's
YAML schema, for each sensor."""
import numpy as np
import pytest

from harness import port

EXTRACTOR = {"threshold": 25, "coverage_threshold": 0.2, "relocalization_distance": 0.25}
OPTIMIZER = {"iteration_count": 50, "reprojection_error": 3.0, "reprojection_error_lost": 6.0, "confidence": 0.97,
             "algorithm": 38}
CAMERA = {"fx": 458.654, "fy": 457.296, "cx": 367.215, "cy": 248.375, "width": 752, "height": 480, "fps": 20,
          "distortion": [0.0, 0.0, 0.0, 0.0]}
CAMERA2 = {"fx": 457.587, "fy": 456.134, "cx": 379.999, "cy": 255.238, "width": 752, "height": 480,
           "distortion": [0.0, 0.0, 0.0, 0.0]}
T_C1_C2 = [[0.999997256477797, -0.002317135723275, -0.000343393120620, 0.110074137800478],
           [0.002312067192432, 0.999898048507103, -0.014090668452683, -0.000156612054392],
           [0.000376008102320, 0.014089835846691, 0.999900662638081, 0.000889382785432],
           [0.0, 0.0, 0.0, 1.0]]

CASES = {
    "IMU_MONOCULAR": {"imu": {"noise_gyro": 1.6e-4, "noise_acc": 2.1e-3, "frequency": 200.0}},
    "STEREO": {"stereo": {"b": 0.11, "th_depth": 60.0}},
    "STEREO_RAW": {"stereo": {"th_depth": 60.0, "T_c1_c2": T_C1_C2}, "camera2": CAMERA2},
}


def _yaml(config, camera_type):
    lines = ['%YAML:1.0', 'File.version: "1.0"', f'Camera.type: "{camera_type}"',
             f"Camera.width: {CAMERA['width']}", f"Camera.height: {CAMERA['height']}", f"Camera.fps: {CAMERA['fps']}"]
    for name, cam in (("Camera1", CAMERA), ("Camera2", config.get("camera2"))):
        if cam is not None:
            lines += [f"{name}.{k}: {cam[k]}" for k in ("fx", "fy", "cx", "cy")]
    lines += ["MOVExtractor.threshold: 25", "MOVExtractor.coverageThreshold: 0.2",
              "MOVExtractor.relocalizationDistance: 0.25", "Optimizer.iterationCount: 50",
              "Optimizer.reprojectionError: 3.0", "Optimizer.reprojectionErrorLost: 6.0",
              "Optimizer.confidence: 0.97", "Optimizer.algorithm: 38"]
    stereo, imu = config.get("stereo"), config.get("imu")
    if stereo:
        lines.append(f"Stereo.ThDepth: {stereo['th_depth']}")
        if "b" in stereo:
            lines.append(f"Stereo.b: {stereo['b']}")
        if "T_c1_c2" in stereo:
            data = ", ".join(repr(float(x)) for row in stereo["T_c1_c2"] for x in row)
            lines += ["Stereo.T_c1_c2: !!opencv-matrix", "  rows: 4", "  cols: 4", "  dt: d", f"  data: [{data}]"]
    if imu:
        lines += [f"IMU.NoiseGyro: {imu['noise_gyro']}", f"IMU.NoiseAcc: {imu['noise_acc']}",
                  f"IMU.Frequency: {imu['frequency']}"]
    return "\n".join(lines) + "\n"


def _same_camera(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.fx, a.fy, a.cx, a.cy, a.width, a.height) == pytest.approx((b.fx, b.fy, b.cx, b.cy, b.width, b.height))
        assert not any(a.dist or ()) and not any(b.dist or ())


@pytest.mark.parametrize("case", sorted(CASES))
def test_settings_are_what_from_yaml_reads(case, tmp_path):
    pytest.importorskip("yaml")
    from movslam_tpu_torch.config import settings as S

    sensor = case.split("_RAW")[0]
    config = {"sensor": sensor, "camera": CAMERA, "extractor": EXTRACTOR, "optimizer": OPTIMIZER, **CASES[case]}
    path = tmp_path / "settings.yaml"
    path.write_text(_yaml(config, "PinHole" if case == "STEREO_RAW" or sensor != "STEREO" else "Rectified"))
    want, got = S.Settings.from_yaml(str(path), getattr(S, sensor)), port.settings(config)
    _same_camera(got.camera1, want.camera1)
    _same_camera(got.camera2, want.camera2)
    for name in ("sensor", "new_width", "new_height", "fps", "b", "bf", "th_depth", "need_rectify", "threshold",
                 "coverage_threshold", "relocalization_distance", "reprojection_error", "reprojection_error_lost",
                 "imu_noise_gyro", "imu_noise_acc"):
        assert getattr(got, name) == pytest.approx(getattr(want, name)), name
    assert (got.T_c1_c2 is None) == (want.T_c1_c2 is None)
    if want.rectification is not None:
        for name in ("R1", "R2", "P1", "P2"):
            assert np.allclose(got.rectification[name], want.rectification[name], atol=1e-9), name
