"""CUDA kernels launched while the port's front-end span
(movslam.frame.front_end) was open, per frame answered in the traced
window."""
from harness import spans

SPAN = "movslam.frame.front_end"


def read(record):
    return spans.per_frame(record, SPAN, "launches")
