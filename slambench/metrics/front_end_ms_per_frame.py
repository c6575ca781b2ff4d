"""Host milliseconds in the port's front-end span (movslam.frame.front_end:
stages 1 and 1c of the frame program, the extractor and stereo depth of
the per-stage path) per frame answered in the traced window."""
from harness import spans

SPAN = "movslam.frame.front_end"


def read(record):
    return spans.per_frame(record, SPAN, "host_s", 1e3)
