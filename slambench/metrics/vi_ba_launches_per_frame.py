"""CUDA kernels launched while the port's visual-inertial local BA span
(movslam.mapper.vi_ba) was open, per frame answered in the traced window."""
from harness import spans

SPAN = "movslam.mapper.vi_ba"


def read(record):
    return spans.per_frame(record, SPAN, "launches")
