"""What the per-layer metrics read from the port's spans: the rows of
trace.reduce's `spans`, one per span name."""


def per_frame(record, name, key, scale=1.0):
    """scale x the span's `key` per frame answered; None where the traced
    window saw no such span or answered no frame."""
    row = record.get("spans", {}).get(name)
    if row is None or not record["frames"]:
        return None
    return scale * row[key] / record["frames"]
