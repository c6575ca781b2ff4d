"""MOVMatcher: all matching is a track-id join.

The port's own copy of movslam_tpu/core/matcher.py (numpy only). Since
motion-vector chains already carry persistent track ids, "matching" in the
C++ reference's MOVMatcher.h degenerates into id equality:
  - frame <-> local map points   (SearchByVideoFeature, :35-68)
  - keyframe <-> frame           (SearchByVideoFeature, :70-103)
  - init frame pair              (SearchForInitialization, :105-137)
  - keyframe <-> keyframe        (SearchForTriangulation, :139-168)
  - map-point fusion gates       (Fuse, :170-277)
"""
from __future__ import annotations

import numpy as np


def match_ids(ids_a, ids_b):
    """Vectorized first-occurrence id join.

    Returns (idx_a, idx_b): positions such that ids_a[idx_a] == ids_b[idx_b],
    one match per unique id (first occurrence on both sides)."""
    ids_a = np.asarray(ids_a)
    ids_b = np.asarray(ids_b)
    common, ia, ib = np.intersect1d(ids_a, ids_b, return_indices=True)
    keep = common >= 0
    return ia[keep], ib[keep]


def search_by_video_feature_kf(kf, frame, mp_map):
    """KF map-points -> frame slots by track id (MOVMatcher.h:70-103).

    Fills frame.mappoints; returns match count."""
    n = 0
    for slot, mid in enumerate(kf.mp_ids):
        if mid < 0:
            continue
        mp = mp_map.mappoints.get(int(mid))
        if mp is None or mp.bad:
            continue
        fslot = frame.slot_of_track(mp.track_id)
        if fslot >= 0:
            frame.mappoints[fslot] = mp
            n += 1
    return n


def search_by_video_feature_local(frame, local_mps, far_points, th_far):
    """Local map points -> frame slots (MOVMatcher.h:35-68).

    Only points flagged track_in_view by the frustum pass participate."""
    n = 0
    for mp in local_mps:
        if far_points and mp.track_depth > th_far:
            continue
        if mp.bad or not mp.track_in_view:
            continue
        fslot = frame.slot_of_track(mp.track_id)
        if fslot >= 0:
            frame.mappoints[fslot] = mp
            n += 1
    return n


def search_for_initialization(f1, f2):
    """Id join between the two init frames (MOVMatcher.h:105-137).

    Returns matches12: slot in f1 -> slot in f2 (or -1)."""
    matches12 = np.full(f1.n, -1, np.int64)
    for j in range(f2.n):
        i = f1.slot_of_track(f2.track_ids[j])
        if i >= 0 and matches12[i] < 0:
            matches12[i] = j
    return matches12


def search_for_triangulation(kf1, kf2):
    """Unmatched-slot id join between two KFs (MOVMatcher.h:139-168).

    Returns (slots1, slots2) arrays of matched, map-point-free slots."""
    free1 = kf1.mp_ids < 0
    free2 = kf2.mp_ids < 0
    ids1 = np.where(free1, kf1.track_ids, -1)
    ids2 = np.where(free2, kf2.track_ids, -1)
    ia, ib = match_ids(ids1, ids2)
    return ia, ib


class FuseCandidates:
    """Precomputed SoA view of a fuse candidate set (MOVMatcher.h:170-277).

    Building position/normal/distance arrays from MapPoint objects costs a
    Python attribute pass per point; SearchInNeighbors fuses the SAME point
    set into ~30 target keyframes, so the arrays are built once here and the
    per-keyframe work is pure vectorized numpy + a survivors-only loop."""

    __slots__ = ("mps", "pos", "normal", "mind", "maxd", "tids")

    def __init__(self, mappoints):
        self.mps = [mp for mp in mappoints if mp is not None and not mp.bad]
        n = len(self.mps)
        if n:
            self.pos = np.stack([mp.pos for mp in self.mps])
            self.normal = np.stack([mp.normal for mp in self.mps])
            self.mind = np.fromiter((mp.min_dist for mp in self.mps), float, n)
            self.maxd = np.fromiter((mp.max_dist for mp in self.mps), float, n)
            self.tids = np.fromiter((mp.track_id for mp in self.mps), np.int64, n)
        else:
            self.pos = np.zeros((0, 3))
            self.normal = np.zeros((0, 3))
            self.mind = np.zeros(0)
            self.maxd = np.zeros(0)
            self.tids = np.zeros(0, np.int64)


def fuse(kf, mappoints, mp_map, camera):
    """Project candidate map points into kf; merge duplicates by track id
    (MOVMatcher.h:170-277). Projection/distance/angle gates are vectorized;
    only survivors touch the graph. Returns number fused.

    mappoints: a list of MapPoints or a prebuilt FuseCandidates."""
    cand = (
        mappoints
        if isinstance(mappoints, FuseCandidates)
        else FuseCandidates(mappoints)
    )
    if not cand.mps:
        return 0
    R, t = kf.pose()
    Ow = kf.center()

    pos = cand.pos
    pc = pos @ R.T + t
    z = pc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = camera.fx * pc[:, 0] / z + camera.cx
        v = camera.fy * pc[:, 1] / z + camera.cy
    po = pos - Ow
    dist = np.linalg.norm(po, axis=1)
    ok = (
        (z >= 0.0)
        & (u >= 0) & (u < camera.width)
        & (v >= 0) & (v < camera.height)
        & (dist >= cand.mind) & (dist <= cand.maxd)
        & (np.einsum("ij,ij->i", po, cand.normal) >= 0.5 * dist)  # < 60 deg
    )
    if not ok.any():
        return 0

    # Vectorized trackId -> kf slot join (first occurrence wins, matching
    # mvVFMap's map::insert semantics).
    if len(kf.track_ids) == 0:
        return 0
    order = np.argsort(kf.track_ids, kind="stable")
    sorted_ids = kf.track_ids[order]
    p = np.minimum(np.searchsorted(sorted_ids, cand.tids), len(sorted_ids) - 1)
    slot_arr = np.where(sorted_ids[p] == cand.tids, order[p], -1)
    ok &= slot_arr >= 0

    fused = 0
    for k in np.flatnonzero(ok):
        mp = cand.mps[k]
        if mp.bad or kf.id in mp.obs:
            continue
        slot = int(slot_arr[k])
        existing_id = kf.mp_ids[slot]
        if existing_id >= 0:
            existing = mp_map.mappoints.get(int(existing_id))
            if existing is not None and not existing.bad and existing.id != mp.id:
                if existing.n_obs() > mp.n_obs():
                    mp.replace(existing, mp_map)
                else:
                    existing.replace(mp, mp_map)
        else:
            mp.add_observation(kf, slot)
            kf.add_mappoint(mp, slot)
        fused += 1
    return fused
