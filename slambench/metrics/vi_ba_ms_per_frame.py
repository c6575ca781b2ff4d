"""Host milliseconds in the port's visual-inertial local BA span
(movslam.mapper.vi_ba: LocalMapping._local_ba_vi, launch to commit), per
frame answered in the traced window."""
from harness import spans

SPAN = "movslam.mapper.vi_ba"


def read(record):
    return spans.per_frame(record, SPAN, "host_s", 1e3)
