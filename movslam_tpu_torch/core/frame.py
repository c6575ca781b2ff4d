"""Host-side Frame: the per-frame view consumed by the tracking state machine.

Port of movslam_tpu/core/frame.py: a compacted mirror of the device
TrackState (or of the per-frame program's int32 wire) plus the pose and
map-point association slots.
"""
from __future__ import annotations

import itertools

import numpy as np

from ..ops.frame_step import unpack_pt_np


class Frame:
    __slots__ = (
        "id", "timestamp", "pts", "pts_raw", "track_ids", "desc", "ages",
        "R", "t", "_mappoints", "outlier", "image", "reference_kf", "lost", "pose_set",
        "depth_right", "uright", "_track_index", "cap_rows",
        "_fused_matched", "_fused_inlier", "_fused_midx", "_lazy_src",
    )

    _next_id = itertools.count()

    def __init__(self, track_state=None, timestamp=0.0, image=None, fid=None, camera=None):
        self.id = next(Frame._next_id) if fid is None else fid
        self.timestamp = timestamp
        self.image = image
        self.R = np.eye(3)
        self.t = np.zeros(3)
        self.pose_set = False
        self.reference_kf = None
        self.lost = False
        self.depth_right = None  # stereo is not part of the mono slice
        self.uright = None
        self._lazy_src = None
        if track_state is not None:
            d = track_state.to_numpy()
            self.pts_raw = d["pt"].astype(np.float64)
            if camera is not None and camera.dist and any(camera.dist):
                self.pts = camera.undistort_points(self.pts_raw).astype(np.float64)
            else:
                self.pts = self.pts_raw
            self.track_ids = d["track_id"].astype(np.int64)
            self.desc = d["desc"]
            self.ages = d["age"]
            self.cap_rows = d["rows"]
        else:
            self.pts = np.zeros((0, 2))
            self.pts_raw = self.pts
            self.track_ids = np.zeros((0,), np.int64)
            self.desc = np.zeros((0, 8), np.uint32)
            self.ages = np.zeros((0,), np.int32)
            self.cap_rows = np.zeros((0,), np.int64)
        n = len(self.track_ids)
        self._mappoints = [None] * n
        self.outlier = np.zeros(n, bool)
        self._track_index = None

    @property
    def n(self):
        return len(self.track_ids)

    @property
    def track_index(self):
        """trackId -> slot (first occurrence wins, like mvVFMap map::insert)."""
        if self._track_index is None:
            idx = {}
            for i, tid in enumerate(self.track_ids):
                idx.setdefault(int(tid), i)
            self._track_index = idx
        return self._track_index

    @property
    def mappoints(self):
        """Map-point per slot, materialized lazily from the snapshot match."""
        if self._mappoints is None:
            lst = [None] * len(self.track_ids)
            if self._lazy_src is not None:
                mps, midx, mask = self._lazy_src
                for i in np.flatnonzero(mask):
                    mp = mps[int(midx[i])]
                    if mp is not None and not mp.bad:
                        lst[i] = mp
            self._mappoints = lst
        return self._mappoints

    @mappoints.setter
    def mappoints(self, v):
        self._mappoints = v

    def set_lazy_matches(self, snap_mps, midx, mask):
        """Defer map-point object association until a consumer needs it."""
        self._lazy_src = (snap_mps, midx, mask)
        self._mappoints = None

    @staticmethod
    def from_packed(packed, timestamp=0.0, image=None, fid=None, has_dist=False):
        """Build from the per-frame program's int32 wire rows
        (ops/frame_step.packed_cols layout). Descriptors stay on the device."""
        f = Frame(None, timestamp=timestamp, image=image, fid=fid)
        words = np.ascontiguousarray(packed, np.int32)
        meta = words[:, 2].astype(np.int64)
        flags = (meta >> 25) & 0xF
        rows = np.flatnonzero((flags & 4) != 0)
        sel = words[rows]
        meta = meta[rows]
        f.pts_raw = unpack_pt_np(sel[:, 0])
        f.pts = unpack_pt_np(sel[:, 3]) if has_dist else f.pts_raw
        f.track_ids = sel[:, 1].astype(np.int64)
        f.ages = (meta & 0xFFF).astype(np.int32)
        f.desc = None
        f.cap_rows = rows
        n = len(rows)
        f._mappoints = [None] * n
        f.outlier = np.zeros(n, bool)
        fl = flags[rows]
        f._fused_matched = (fl & 1) != 0
        f._fused_inlier = (fl & 2) != 0
        f._fused_midx = ((meta >> 12) & 0x1FFF) - 1
        return f

    def set_pose(self, R, t):
        self.R = np.asarray(R, np.float64)
        self.t = np.asarray(t, np.float64)
        self.pose_set = True

    def center(self):
        return -(self.R.T @ self.t)

    def slot_of_track(self, track_id):
        return self.track_index.get(int(track_id), -1)
