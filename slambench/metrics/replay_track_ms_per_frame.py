"""Host milliseconds of the replay's tracking (movslam.replay.track, each
Tracking.track_fused, by its self time: less the port spans inside it) per
frame answered in the traced window."""
from harness import spans

SPAN = "movslam.replay.track"


def read(record):
    return spans.per_frame(record, SPAN, "self_s", 1e3)
