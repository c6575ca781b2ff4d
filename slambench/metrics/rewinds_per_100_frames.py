"""Rewinds of the windowed drive per 100 window frames: System.counts
["rewinds"] over the window. A rewind discards the windows in flight and
feeds their frames again, so each one is work thrown away."""


def read(record):
    if not record["frames"]:
        return None
    return 100.0 * record["counts"].get("rewinds", 0) / record["frames"]
