"""Map data model: MapPoint / KeyFrame / Map / Atlas.

The port's own copy of movslam_tpu/core/map.py (numpy only), cut to what the
port calls. Its id counters are its own: ids drawn here never advance the
reference's counters, nor the other way round.

Host-side landmark graph mirroring the C++ reference's map layer
(MapPoint.h, KeyFrame.h, Map.h, Atlas.h) with the pointer web replaced by
id-keyed dictionaries and numpy arrays. All heavy math (triangulation, BA,
PnP, projection filters) runs on the device; this layer only does graph
bookkeeping, which is tiny per frame.

  - MapPoints are keyed by their *track id* (MapPoint.h:175) — the dense join
    key that replaces descriptor matching everywhere.
  - KeyFrames retain their grayscale image for LK relocalization
    (KeyFrame.h:326-329).
  - Covisibility edges require >= 15 shared observations
    (KeyFrame.cc:408), with a best-neighbor fallback.
  - Scale-invariance distances use the 8-level, 1.2-factor synthetic pyramid
    (Frame.cc:102-119).
"""
from __future__ import annotations

import itertools

import numpy as np

SCALE_FACTOR = 1.2
N_LEVELS = 8
COVIS_THRESHOLD = 15


class MapPoint:
    __slots__ = (
        "id", "track_id", "pos", "first_kf_id", "map_id", "obs", "normal",
        "min_dist", "max_dist", "n_visible", "n_found", "bad", "replaced_by",
        # transient per-frame tracking caches (mirrors mbTrackInView etc.)
        "track_in_view", "track_proj", "track_depth", "last_frame_seen",
    )

    _next_id = itertools.count()

    def __init__(self, pos, first_kf_id, track_id, map_id=0):
        self.id = next(MapPoint._next_id)
        self.track_id = int(track_id)
        self.pos = np.asarray(pos, np.float64).copy()
        self.first_kf_id = first_kf_id
        self.map_id = map_id
        self.obs = {}  # kf_id -> slot index
        self.normal = np.zeros(3)
        self.min_dist = 0.0
        self.max_dist = 0.0
        self.n_visible = 1
        self.n_found = 1
        self.bad = False
        self.replaced_by = None
        self.track_in_view = False
        self.track_proj = np.zeros(2)
        self.track_depth = 0.0
        self.last_frame_seen = -1

    def n_obs(self):
        return len(self.obs)

    def found_ratio(self):
        return self.n_found / max(self.n_visible, 1)

    def add_observation(self, kf, slot):
        self.obs[kf.id] = slot

    def remove_observation(self, kf_id):
        self.obs.pop(kf_id, None)

    def update_normal_and_depth(self, mp_map):
        """Mean viewing direction + scale distances (MapPoint.cc:362-432)."""
        if not self.obs:
            return
        kfs = mp_map.keyframes
        normals = []
        ref_kf = None
        for kf_id in self.obs:
            kf = kfs.get(kf_id)
            if kf is None:
                continue
            if ref_kf is None or kf_id == self.first_kf_id:
                ref_kf = kf
            n = self.pos - kf.center()
            nn = np.linalg.norm(n)
            if nn > 1e-9:
                normals.append(n / nn)
        if not normals or ref_kf is None:
            return
        self.normal = np.mean(normals, axis=0)
        dist = np.linalg.norm(self.pos - ref_kf.center())
        self.max_dist = dist * SCALE_FACTOR
        self.min_dist = self.max_dist / (SCALE_FACTOR ** N_LEVELS)

    def set_bad(self, mp_map):
        self.bad = True
        for kf_id, slot in list(self.obs.items()):
            kf = mp_map.keyframes.get(kf_id)
            if kf is not None:
                kf.erase_mappoint_slot(slot)
        self.obs.clear()
        mp_map.mappoints.pop(self.id, None)

    def replace(self, other, mp_map):
        """Merge this point into `other` (MapPoint::Replace semantics)."""
        if other.id == self.id:
            return
        self.replaced_by = other
        for kf_id, slot in list(self.obs.items()):
            kf = mp_map.keyframes.get(kf_id)
            if kf is None:
                continue
            if kf_id not in other.obs:
                other.obs[kf_id] = slot
                kf.mp_ids[slot] = other.id
            else:
                kf.erase_mappoint_slot(slot)
        other.n_found += self.n_found
        other.n_visible += self.n_visible
        self.obs.clear()
        self.bad = True
        mp_map.mappoints.pop(self.id, None)
        other.update_normal_and_depth(mp_map)


def update_normals_batch(mps, mp_map):
    """Batched MapPoint::UpdateNormalAndDepth over a list of points.

    One flat (observation-pair) numpy pass instead of per-point/per-obs
    Python math — used by the mapper stages where hundreds of points update
    at once."""
    mps = [mp for mp in mps if not mp.bad and mp.obs]
    if not mps:
        return
    kfs = mp_map.keyframes

    pair_mp, pair_kf, ref_kf = [], [], []
    for j, mp in enumerate(mps):
        ref = None
        for kf_id in mp.obs:
            pair_mp.append(j)
            pair_kf.append(kf_id)
            if ref is None or kf_id == mp.first_kf_id:
                ref = kf_id
        ref_kf.append(ref)

    uniq_kf = {k: i for i, k in enumerate(dict.fromkeys(pair_kf))}
    centers = np.full((len(uniq_kf), 3), np.nan)
    for k, i in uniq_kf.items():
        kf = kfs.get(k)
        if kf is not None:
            centers[i] = kf.center()

    pm = np.asarray(pair_mp)
    pk = np.fromiter((uniq_kf[k] for k in pair_kf), np.int64, len(pair_kf))
    pos = np.stack([mp.pos for mp in mps])

    d = pos[pm] - centers[pk]
    nn = np.linalg.norm(d, axis=1)
    ok = np.isfinite(nn) & (nn > 1e-9)
    dirs = np.where(ok[:, None], d / np.maximum(nn, 1e-12)[:, None], 0.0)

    acc = np.zeros((len(mps), 3))
    cnt = np.zeros(len(mps))
    np.add.at(acc, pm, dirs)
    np.add.at(cnt, pm, ok.astype(float))

    ref_idx = np.fromiter(
        (uniq_kf[r] if r is not None else 0 for r in ref_kf), np.int64, len(mps)
    )
    ref_dist = np.linalg.norm(pos - centers[ref_idx], axis=1)

    for j, mp in enumerate(mps):
        if cnt[j] == 0 or not np.isfinite(ref_dist[j]):
            continue
        mp.normal = acc[j] / cnt[j]
        mp.max_dist = ref_dist[j] * SCALE_FACTOR
        mp.min_dist = mp.max_dist / (SCALE_FACTOR ** N_LEVELS)


class KeyFrame:
    __slots__ = (
        "id", "frame_id", "timestamp", "R", "t", "track_ids", "pts", "_desc", "_desc_thunk",
        "mp_ids", "image", "covis", "parent", "children", "bad",
        "map_id", "prev_kf", "next_kf", "depth_right", "uright", "Tcp",
        "velocity", "bias_g", "bias_a",
    )

    _next_id = itertools.count()

    # Descriptor archive. The windowed drive archives lazily: a thunk that
    # pulls the keyframe's rows of the window's device-resident descriptor
    # stack on first access, so a keyframe never blocks the replay on a pull.
    @property
    def desc(self):
        if self._desc is None and self._desc_thunk is not None:
            self._desc = self._desc_thunk()
            self._desc_thunk = None
        return self._desc

    @desc.setter
    def desc(self, v):
        self._desc = v
        self._desc_thunk = None

    def set_desc_thunk(self, fn):
        self._desc = None
        self._desc_thunk = fn

    def __init__(self, frame, map_id=0):
        """Build from a tracked Frame (core.frame.Frame)."""
        self.id = next(KeyFrame._next_id)
        self.frame_id = frame.id
        self.timestamp = frame.timestamp
        self.R = frame.R.copy()
        self.t = frame.t.copy()
        self.track_ids = frame.track_ids.copy()
        self.pts = frame.pts.copy()
        self.desc = frame.desc.copy() if frame.desc is not None else None
        self.mp_ids = np.full(len(frame.track_ids), -1, np.int64)
        for slot, mp in enumerate(frame.mappoints):
            if mp is not None and not mp.bad:
                self.mp_ids[slot] = mp.id
        self.image = frame.image  # retained for LK relocalization
        self.covis = {}
        self.parent = None
        self.children = set()
        self.bad = False
        self.map_id = map_id
        self.prev_kf = None
        self.next_kf = None
        # stereo: per-slot depth and right-image u (-1 = none), None for mono
        self.depth_right = frame.depth_right.copy() if frame.depth_right is not None else None
        self.uright = frame.uright.copy() if frame.uright is not None else None
        # Pose relative to parent at cull time (the reference's mTcp,
        # KeyFrame::SetBadFlag): lets trajectory savers recover culled KF
        # poses through the parent chain (System.cc:760-766).
        self.Tcp = None
        # visual-inertial state: world velocity, gyro and accelerometer
        # biases (None until the VI init or a VI local BA sets them)
        self.velocity = None
        self.bias_g = None
        self.bias_a = None

    # --- pose ---------------------------------------------------------
    def center(self):
        return -(self.R.T @ self.t)

    def pose(self):
        return self.R, self.t

    def set_pose(self, R, t):
        self.R = np.asarray(R, np.float64)
        self.t = np.asarray(t, np.float64)

    # --- mappoint slots -------------------------------------------------
    def erase_mappoint_slot(self, slot):
        self.mp_ids[slot] = -1

    def add_mappoint(self, mp, slot):
        self.mp_ids[slot] = mp.id

    def n_tracked_points(self, mp_map, min_obs=1):
        n = 0
        for mid in self.mp_ids:
            if mid >= 0:
                mp = mp_map.mappoints.get(int(mid))
                if mp is not None and not mp.bad and mp.n_obs() >= min_obs:
                    n += 1
        return n

    # --- covisibility ----------------------------------------------------
    def update_connections(self, mp_map):
        """Recount shared observations and rebuild covisibility edges
        (KeyFrame::UpdateConnections)."""
        counter = {}
        for mid in self.mp_ids:
            if mid < 0:
                continue
            mp = mp_map.mappoints.get(int(mid))
            if mp is None or mp.bad:
                continue
            for kf_id in mp.obs:
                if kf_id != self.id:
                    counter[kf_id] = counter.get(kf_id, 0) + 1
        if not counter:
            return
        best_kf, best_w = max(counter.items(), key=lambda kv: kv[1])
        edges = {k: w for k, w in counter.items() if w >= COVIS_THRESHOLD}
        if not edges:
            edges = {best_kf: best_w}
        self.covis = edges
        for kf_id, w in edges.items():
            other = mp_map.keyframes.get(kf_id)
            if other is not None:
                other.covis[self.id] = w
        # Spanning tree: first connection becomes parent.
        if self.parent is None and self.id != mp_map.init_kf_id:
            parent = mp_map.keyframes.get(best_kf)
            if parent is not None and parent.id < self.id:
                self.parent = parent
                parent.children.add(self.id)

    def best_covisible(self, mp_map, n):
        order = sorted(self.covis.items(), key=lambda kv: -kv[1])
        out = []
        for kf_id, _ in order[:n]:
            kf = mp_map.keyframes.get(kf_id)
            if kf is not None and not kf.bad:
                out.append(kf)
        return out

    def scene_median_depth(self, mp_map, q=2):
        """Median (q=2) depth of observed points in this KF's camera frame
        (KeyFrame::ComputeSceneMedianDepth). Vectorized."""
        mids = self.mp_ids[self.mp_ids >= 0]
        if len(mids) == 0:
            return -1.0
        mps = mp_map.mappoints
        pos = [mp.pos for mp in (mps.get(int(i)) for i in mids) if mp is not None and not mp.bad]
        if not pos:
            return -1.0
        zs = np.sort(np.asarray(pos) @ self.R[2] + self.t[2])
        return float(zs[(len(zs) - 1) // q])

    def set_bad(self, mp_map):
        self.bad = True
        for slot, mid in enumerate(self.mp_ids):
            if mid >= 0:
                mp = mp_map.mappoints.get(int(mid))
                if mp is not None:
                    mp.remove_observation(self.id)
        for kf_id in self.covis:
            other = mp_map.keyframes.get(kf_id)
            if other is not None:
                other.covis.pop(self.id, None)
        # Record T_cp = T_cw * T_pw^-1 so savers can recover this pose via
        # the parent chain (KeyFrame::SetBadFlag mTcp; System.cc:760-766).
        anchor = self.parent or self.prev_kf
        if anchor is not None:
            R_cp = self.R @ anchor.R.T
            t_cp = self.t - R_cp @ anchor.t
            self.Tcp = (R_cp, t_cp)
            for ch_id in self.children:
                ch = mp_map.keyframes.get(ch_id)
                if ch is not None and ch.parent is self:
                    ch.parent = anchor
                    anchor.children.add(ch_id)
            self.children.clear()
        # Relink the temporal odometry chain around the removed keyframe
        # (KeyFrame::SetBadFlag mPrevKF/mNextKF surgery).
        if self.prev_kf is not None and self.prev_kf.next_kf is self:
            self.prev_kf.next_kf = self.next_kf
        if self.next_kf is not None and self.next_kf.prev_kf is self:
            self.next_kf.prev_kf = self.prev_kf
        mp_map.keyframes.pop(self.id, None)
        mp_map.culled_keyframes[self.id] = self


class Map:
    """One map: keyframes + mappoints + change counters (Map.h:41-137)."""

    _next_id = itertools.count()

    def __init__(self):
        self.id = next(Map._next_id)
        self.keyframes = {}
        self.mappoints = {}
        self.culled_keyframes = {}  # id -> bad KF (poses via Tcp chain)
        self.init_kf_id = -1
        # visual-inertial init (core/inertial.py): done, the scale it applied,
        # and how many of its staged solves ran
        self.imu_initialized = False
        self.imu_scale = 1.0
        self.imu_init_count = 0
        self.change_index = 0
        self.kf_origins = []

    def add_keyframe(self, kf):
        self.keyframes[kf.id] = kf
        if self.init_kf_id < 0:
            self.init_kf_id = kf.id

    def add_mappoint(self, mp):
        self.mappoints[mp.id] = mp

    def n_keyframes(self):
        return len(self.keyframes)

    def n_mappoints(self):
        return len(self.mappoints)

    def bump_change(self):
        self.change_index += 1

    def clear(self):
        self.keyframes.clear()
        self.mappoints.clear()
        self.culled_keyframes.clear()
        self.init_kf_id = -1
        self.kf_origins = []


class Atlas:
    """Multi-map container (Atlas.h:72-109): active map + stored maps;
    a new map is started on unrecoverable tracking loss."""

    def __init__(self):
        self.maps = []
        self.current = None
        self.cameras = []
        self.create_new_map()

    def create_new_map(self):
        m = Map()
        self.maps.append(m)
        self.current = m
        return m

    def add_camera(self, cam):
        for c in self.cameras:
            if c == cam:
                return c
        self.cameras.append(cam)
        return cam

    def all_maps(self):
        return list(self.maps)
