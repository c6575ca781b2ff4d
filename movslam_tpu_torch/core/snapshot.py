"""Device-resident map snapshots for the per-frame and window programs.

Port of movslam_tpu/core/snapshot.py: once per keyframe the host flattens
the reference keyframe's covisible neighbourhood into one (P, 12) f32
tensor (pos, normal, min/max distance, valid, ref-KF flag, track-id bits in
row order); every frame joins against it on the device. Per-frame
visible/found counts accumulate in host arrays and are flushed into the
MapPoint objects once per keyframe. The snapshot stays in row order (the
programs sort it, ops/frame_step.prep_snapshot), so the windowed drive can
patch rows on the device before the sort.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.frame_step import SNAP_CAP

I32MAX = np.iinfo(np.int32).max


class MapSnapshot:
    """Device view of the local map plus the aligned host MapPoints.

    `mps` may hold None rows: the windowed replay extends a snapshot's host
    view by the device-patched rows, and a patched row whose point the host
    gates rejected has no MapPoint."""

    __slots__ = ("fused", "mps", "version", "obs_pos", "vis_acc", "found_acc", "tids", "_tid_order")

    def __init__(self, fused, mps, version=0, obs_pos=None, tids=None):
        n = len(mps)
        self.fused = fused  # (P, 12) f32 tensor
        self.mps = mps  # row -> MapPoint
        self.version = version  # the map's change index at build time
        self.obs_pos = obs_pos if obs_pos is not None else np.zeros(n, bool)  # row has observations
        self.vis_acc = np.zeros(n, np.int64)
        self.found_acc = np.zeros(n, np.int64)
        # Host copy of the per-row track ids: the windowed drive maps a
        # deferred BA's points to snapshot rows for the device patch.
        self.tids = tids if tids is not None else np.zeros(n, np.int64)
        self._tid_order = None

    def tid_order(self):
        """Cached stable argsort of the row-order track ids and the sorted
        ids (first row wins among duplicates, as the device's stable sort)."""
        if self._tid_order is None:
            order = np.argsort(self.tids, kind="stable")
            self._tid_order = (order, self.tids[order])
        return self._tid_order

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


def build_snapshot(m, ref_kf, device, cap=SNAP_CAP, reserve=0):
    """Flatten ref_kf's covisible neighbourhood (80 best covisible KFs) into a
    snapshot on `device`. The last `reserve` rows stay empty for the windowed
    drive's device-side patch (ops/window_step._apply_patch)."""
    kfs = [ref_kf] + ref_kf.best_covisible(m, 80)
    limit = cap - reserve
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
    return MapSnapshot(torch.as_tensor(fused, device=device), mps, version=m.change_index,
                       obs_pos=obs_pos, tids=tid[:n].astype(np.int64))
