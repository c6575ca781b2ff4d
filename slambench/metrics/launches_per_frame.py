"""CUDA kernels the device ran in the traced window, per frame answered."""


def read(record):
    if "launches" not in record or not record["frames"]:
        return None
    return record["launches"] / record["frames"]
