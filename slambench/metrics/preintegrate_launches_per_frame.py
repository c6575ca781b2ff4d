"""CUDA kernels launched while the port's IMU preintegration span
(movslam.imu.preintegrate: every preintegration call, in the init's stages,
in the VI local BA or where a keyframe interval closes) was open, per frame
answered in the traced window."""
from harness import spans

SPAN = "movslam.imu.preintegrate"


def read(record):
    return spans.per_frame(record, SPAN, "launches")
