"""Host milliseconds in the port's pose span (movslam.frame.pose: stages 2-4
of the frame program, the snapshot join, frustum gates and both PnP-RANSAC
solves) per frame answered in the traced window."""
from harness import spans

SPAN = "movslam.frame.pose"


def read(record):
    return spans.per_frame(record, SPAN, "host_s", 1e3)
