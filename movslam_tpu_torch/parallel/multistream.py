"""Several SLAM streams' MV propagation in one call.

Port of movslam_tpu/parallel/multistream.py. The reference vmaps the
per-stream propagation over S streams and shards the stream axis over a
device mesh. Here the S streams go through ops/propagate.py in one batched
call on one device (one candidate join per stream, one score_candidates
launch for all, one claim scatter); with a process group each rank takes
its contiguous share of the streams.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.propagate import propagate_mv_tracks
from .mesh import shard_range


def make_multistream_propagate(device, group=None):
    """Returns fn(imgs (S, H, W), pt (S, N, 2), valid, coverage, age,
    desc (S, N, 8), wh (S, N, 2), mv_delta (S, M, 2), mv_rect (S, M, 4),
    mv_dindx (S, M), mv_valid (S, M), threshold) -> propagate_mv_tracks's
    dict with a leading stream axis (n_kps_capacity = M, as the reference).

    Without a group the fn runs every stream on `device`. With one, rank r
    runs and returns its contiguous share of the S streams (S must split
    evenly); the inputs may be the whole batch, on any device."""
    dev = resolve_device(device)

    def run(imgs, pt, valid, coverage, age, desc, wh, mv_delta, mv_rect, mv_dindx, mv_valid,
            threshold):
        args = [imgs, pt, valid, coverage, age, desc, wh, mv_delta, mv_rect, mv_dindx, mv_valid]
        if group is not None:
            lo, hi = shard_range(imgs.shape[0], group)
            args = [a[lo:hi] for a in args]
        args = [torch.as_tensor(a).to(dev).contiguous() for a in args]
        return propagate_mv_tracks(*args, n_kps_capacity=args[9].shape[1], threshold=threshold)

    return run
