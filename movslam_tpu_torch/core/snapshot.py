"""Device-resident map snapshots for the per-frame program.

Port of movslam_tpu/core/snapshot.py: once per keyframe the host flattens
the reference keyframe's covisible neighbourhood into one (P, 12) f32
tensor (pos, normal, min/max distance, valid, ref-KF flag, track-id bits in
row order); every frame joins against it on the device. Per-frame
visible/found counts accumulate in host arrays and are flushed into the
MapPoint objects once per keyframe.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.frame_step import SNAP_CAP

I32MAX = np.iinfo(np.int32).max
# Rows the reference keeps free for its windowed drive's device-side patch
# (ops/mapper_step.C_PATCH); kept so both drives track the same point set.
SNAP_RESERVE = 1024


class MapSnapshot:
    """Device view of the local map plus the aligned host MapPoints."""

    __slots__ = ("fused", "mps", "obs_pos", "vis_acc", "found_acc")

    def __init__(self, fused, mps, obs_pos):
        self.fused = fused  # (P, 12) f32 tensor
        self.mps = mps  # row -> MapPoint
        self.obs_pos = obs_pos  # row has observations at build time
        self.vis_acc = np.zeros(len(mps), np.int64)
        self.found_acc = np.zeros(len(mps), np.int64)

    def flush_stats(self):
        """Apply accumulated visible/found counts to the MapPoints (idempotent)."""
        for j in np.flatnonzero(self.vis_acc):
            mp = self.mps[j]
            if mp is not None and not mp.bad:
                mp.n_visible += int(self.vis_acc[j])
        for j in np.flatnonzero(self.found_acc):
            mp = self.mps[j]
            if mp is not None and not mp.bad:
                mp.n_found += int(self.found_acc[j])
        self.vis_acc[:] = 0
        self.found_acc[:] = 0


def build_snapshot(m, ref_kf, device, cap=SNAP_CAP):
    """Flatten ref_kf's covisible neighbourhood (80 best covisible KFs) into a
    snapshot on `device`; the last SNAP_RESERVE rows stay empty."""
    kfs = [ref_kf] + ref_kf.best_covisible(m, 80)
    limit = cap - SNAP_RESERVE
    seen = set()
    mps = []
    for kf in kfs:
        for mid in kf.mp_ids[kf.mp_ids >= 0]:
            mid = int(mid)
            if mid in seen:
                continue
            seen.add(mid)
            mp = m.mappoints.get(mid)
            if mp is not None and not mp.bad:
                mps.append(mp)
            if len(mps) >= limit:
                break
        if len(mps) >= limit:
            break

    n = len(mps)
    tid = np.full(cap, I32MAX, np.int32)
    pack = np.zeros((cap, 10), np.float32)
    pack[:, 7] = np.inf  # maxd default
    ref_ids = set(int(x) for x in ref_kf.mp_ids[ref_kf.mp_ids >= 0])
    if n:
        tid[:n] = np.fromiter((mp.track_id for mp in mps), np.int64, n)
        pack[:n, 0:3] = np.stack([mp.pos for mp in mps])
        pack[:n, 3:6] = np.stack([mp.normal for mp in mps])
        pack[:n, 6] = np.fromiter((mp.min_dist for mp in mps), float, n)
        pack[:n, 7] = np.fromiter((mp.max_dist for mp in mps), float, n)
        pack[:n, 8] = 1.0
        pack[:n, 9] = np.fromiter((1.0 if mp.id in ref_ids else 0.0 for mp in mps), float, n)
    fused = np.zeros((cap, 12), np.float32)
    fused[:, 0:10] = pack
    fused[:, 10] = tid.view(np.float32)  # i32 bits, row order
    obs_pos = np.fromiter((len(mp.obs) > 0 for mp in mps), bool, n)
    return MapSnapshot(torch.as_tensor(fused, device=device), mps, obs_pos)
