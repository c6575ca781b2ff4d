"""The share of the traced window in which the host waited on the device
for a window's wire (movslam.replay.wait, the wire's pull)."""
SPAN = "movslam.replay.wait"


def read(record):
    row = record.get("spans", {}).get(SPAN)
    if row is None or not record["window_s"]:
        return None
    return row["host_s"] / record["window_s"]
