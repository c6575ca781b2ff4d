"""Host milliseconds in the port's mapper spans (movslam.mapper.*: keyframe
processing, commits, local BA launches), nested ones counted once, per frame
answered in the traced window."""
from harness import spans

PREFIX = "movslam.mapper."


def read(record):
    rows = {name: row for name, row in record.get("spans", {}).items() if name.startswith(PREFIX)}
    if not rows or not record["frames"]:
        return None
    return 1e3 * sum(row["outer_s"] for row in rows.values()) / record["frames"]
