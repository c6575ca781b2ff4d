"""CUDA kernels launched while the port's pose span (movslam.frame.pose) was
open, per frame answered in the traced window."""
from harness import spans

SPAN = "movslam.frame.pose"


def read(record):
    return spans.per_frame(record, SPAN, "launches")
