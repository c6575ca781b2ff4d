"""Median host milliseconds of the mapper's local BA step over the window:
LocalMapping.lba_ms (the launch of a visual local BA, or a whole
visual-inertial one, or a deferred mapper job's dispatch)."""
import numpy as np


def read(record):
    xs = record["lba_ms"]
    return float(np.median(xs)) if xs else None
