"""1 minus the device's busy time (the union of its kernel, copy and set
intervals in the trace) over the traced window's wall time."""


def read(record):
    if "busy_s" not in record or not record["window_s"]:
        return None
    return 1.0 - record["busy_s"] / record["window_s"]
