"""The windowed drive: the System's batch entry (track_stereo_batch on a
STEREO system, track_monocular_batch otherwise) over batches of the
recorded sequence, flush=False, so the port keeps `pipeline_depth` windows
of `window` frames in flight across calls; the final flush, which resolves
every frame fed, closes the measured window. The offline mapping of a
recorded video, and the CLI's default drive.

Warm-up (traffic mix `warmup`): `frames` frames in the same batches, the
last batch flushed.
"""

from harness import port


def _setup(system, mix):
    system.window = int(mix["window"])
    system.pipeline_depth = int(mix["pipeline_depth"])


def _batch(system, items, flush, span):
    entry = port.batch_entry(system)
    with span(entry):
        return getattr(system, entry)(items, flush=flush)


def warm_up(system, feed, mix, span):
    """Returns ({frame: pose or None}, frames used)."""
    _setup(system, mix)
    n, B = int(mix["warmup"]["frames"]), int(mix["batch"])
    poses = []
    for k in range(0, n, B):
        poses += _batch(system, feed[k:min(k + B, n)], k + B >= n, span)
    if len(poses) != n:
        raise RuntimeError(f"the warm-up fed {n} frames and got {len(poses)} answers")
    return dict(enumerate(poses)), n


def measure(system, feed, start, mix, deadline, clock, span):
    """Batches from `start` until the deadline or the last frame, then the
    flush. Returns {frame: pose or None}."""
    B = int(mix["batch"])
    poses, k = [], start
    while k < len(feed) and clock() < deadline:
        stop = min(k + B, len(feed))
        poses += _batch(system, feed[k:stop], False, span)
        k = stop
    poses += _batch(system, [], True, span)
    if len(poses) != k - start:
        raise RuntimeError(f"the window fed {k - start} frames and got {len(poses)} answers")
    return dict(zip(range(start, k), poses))
