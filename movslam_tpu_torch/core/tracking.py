"""Tracking: the per-frame front-end state machine (monocular and stereo).

Port of movslam_tpu/core/tracking.py, which mirrors Tracking.cc:215-518 —
{NO_IMAGES_YET, NOT_INITIALIZED, OK, RECENTLY_LOST, LOST} with two-view
initialization, reference-KF tracking, local-map tracking, keyframe
decisions and loss handling. Pose estimation runs the batched PnP of
ops/pnp.py on the system's device; matching is the reference's host-only
track-id join (movslam_tpu/core/matcher.py). RANSAC draws come from one
torch.Generator seeded like the reference's PRNGKey(7). Both drives end in
`track_fused`: the per-frame program's result, or one frame of a replayed
window. In localization-only mode (`only_tracking`) the map is frozen: no
keyframes, no reset, no new map after a loss.
"""
from __future__ import annotations

import enum
import time

import numpy as np
import torch

from ..ops.ba import ba_solve, build_obs_by_point
from ..ops.pnp import make_sampler, pnp_ransac_fused
from ..ops.twoview import reconstruct_two_views
from ..config.settings import STEREO
from .map import KeyFrame, MapPoint
from .matcher import (
    search_by_video_feature_kf,
    search_by_video_feature_local,
    search_for_initialization,
)


class State(enum.IntEnum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


class Tracking:
    def __init__(self, system, atlas, local_mapper, settings, extractor, device):
        self.system = system
        self.atlas = atlas
        self.mapper = local_mapper
        self.settings = settings
        self.extractor = extractor
        self.camera = settings.camera1
        self.device = device

        self.state = State.NO_IMAGES_YET
        self.lost_count = 0
        self.tracked_frames = 0
        self.matches_inliers = 0
        self.last_ref_track_count = 0
        self.max_frames = int(settings.fps / 2)
        self.min_frames = 0
        # Localization-only mode (System::ActivateLocalizationMode,
        # System.cc:171-234, System.h:118-121): track against the frozen map,
        # with no keyframes, no map mutation and no new map after a loss.
        self.only_tracking = False

        self.current = None
        self.last_frame = None
        self.initial_frame = None
        self.ready_to_init = False

        self.reference_kf = None
        self.last_kf = None
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -9999
        self.ts_lost = 0.0
        self.local_kfs = []
        self.local_mps = []
        self.velocity = None  # (R, t) of T_cur * T_last^-1

        # trajectory logs (Tracking.cc:486-505)
        self.rel_poses = []
        self.rel_refs = []
        self.rel_times = []
        self.rel_lost = []

        self.generator = torch.Generator(device).manual_seed(7)
        self.sampler = make_sampler(self.generator)
        cam = settings.camera1
        self.intr = torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy], dtype=torch.float32, device=device)
        # Per-stage durations (ms), the reference's REGISTER_TIMES.
        self.timings = {"track_ref_kf": [], "track_local_map": [], "new_kf": []}

    # ------------------------------------------------------------------
    def grab_frame(self, frame):
        """Track() on a prepared Frame, under the map lock (Tracking.cc:274)."""
        with self.mapper.map_lock:
            return self._grab_frame_locked(frame)

    def _grab_frame_locked(self, frame):
        self.current = frame
        m = self.atlas.current
        if self.state in (State.LOST, State.RECENTLY_LOST):
            self.lost_count += 1
        if self.state == State.NO_IMAGES_YET:
            self.state = State.NOT_INITIALIZED

        if self.state == State.NOT_INITIALIZED:
            if self.settings.sensor == STEREO:
                self._stereo_initialization()
            else:
                self._monocular_initialization()
            if self.state != State.OK:
                self.last_frame = self.current
                return
        else:
            ok = False
            if self.state == State.OK:
                self._check_replaced_in_last_frame()
                ok = self._track_reference_keyframe()
                if not ok:
                    if m.n_keyframes() > 10:
                        self.state = State.RECENTLY_LOST
                        self.ts_lost = self.current.timestamp
                    else:
                        self.state = State.LOST
            elif self.state == State.RECENTLY_LOST:
                ok = self._track_reference_keyframe()
                if not ok:
                    ok = self._relocalization()
                if self.current.timestamp - self.ts_lost > 1.0 and not ok:
                    self.state = State.LOST
                    ok = False
            if self.state == State.LOST:
                if self.only_tracking:
                    self._stay_recently_lost()
                    return
                if m.n_keyframes() < 10:
                    self.system.reset_active_map()
                else:
                    self._create_map_in_atlas()
                self.last_kf = None
                return
            if self.current.reference_kf is None:
                self.current.reference_kf = self.reference_kf
            if ok:
                ok = self._track_local_map()
            self._post_tracking_tail(ok, m)
            if self.state == State.LOST or self.current is None:
                return
        self._log_trajectory()

    def _stay_recently_lost(self):
        """A loss on a frozen map: never reset it nor open a new one; stay
        RECENTLY_LOST and keep retrying."""
        self.state = State.RECENTLY_LOST
        self.current.lost = True
        self.last_frame = self.current

    def _post_tracking_tail(self, ok, m):
        """State update, motion model, VO-match cleanup, keyframe decision
        and loss handling (Tracking.cc:395-484)."""
        if ok:
            self.state = State.OK
        elif self.state == State.OK:
            self.state = State.RECENTLY_LOST
            self.ts_lost = self.current.timestamp

        if ok or self.state == State.RECENTLY_LOST:
            lf, cur = self.last_frame, self.current
            if lf is not None and lf.pose_set and cur.pose_set:
                Rv = cur.R @ lf.R.T
                self.velocity = (Rv, cur.t - Rv @ lf.t)
            else:
                self.velocity = None
            if cur._mappoints is not None:  # Tracking.cc:427-436
                for i, mp in enumerate(cur._mappoints):
                    if mp is not None and mp.n_obs() < 1:
                        cur.outlier[i] = False
                        cur._mappoints[i] = None
            if not self.only_tracking and self._need_new_keyframe() and ok:
                self._create_new_keyframe()
            # Drop outliers so the next frame won't use them (:459-463).
            if cur._mappoints is not None:
                for i in range(cur.n):
                    if cur._mappoints[i] is not None and cur.outlier[i]:
                        cur._mappoints[i] = None
            elif cur._lazy_src is not None:
                mps_, midx_, mask_ = cur._lazy_src
                cur._lazy_src = (mps_, midx_, mask_ & ~cur.outlier)
                cur.outlier = np.zeros(cur.n, bool)

        if self.state == State.LOST:
            if self.only_tracking:
                self._stay_recently_lost()
                return
            if m.n_keyframes() <= 10:
                self.system.reset_active_map()
                self.current = None
                return
            self._create_map_in_atlas()
            return
        if self.current.reference_kf is None:
            self.current.reference_kf = self.reference_kf
        self.last_frame = self.current

    def _log_trajectory(self):
        """Trajectory bookkeeping (Tracking.cc:486-505)."""
        if self.current is None or self.state not in (State.OK, State.RECENTLY_LOST):
            return
        if self.current.pose_set and self.current.reference_kf is not None:
            ref = self.current.reference_kf
            R_rel = self.current.R @ ref.R.T
            self.rel_poses.append((R_rel, self.current.t - R_rel @ ref.t))
            self.rel_refs.append(ref)
            self.rel_times.append(self.current.timestamp)
            self.rel_lost.append(self.state == State.LOST)
        elif self.rel_poses:
            self.rel_poses.append(self.rel_poses[-1])
            self.rel_refs.append(self.rel_refs[-1])
            self.rel_times.append(self.rel_times[-1])
            self.rel_lost.append(self.state == State.LOST)

    # --- per-frame program result ------------------------------------------
    def track_fused(self, frame, out, snapshot):
        """Track() from the per-frame program's result (ops/frame_step): the
        reference-KF gate, the local-map solve and the match/inlier masks
        came from the device; this applies the state machine on the host.
        Entered from the OK state only."""
        t0 = time.perf_counter()
        try:
            return self._track_fused_inner(frame, out, snapshot)
        finally:
            self.timings["track_local_map"].append(1e3 * (time.perf_counter() - t0))

    def _track_fused_inner(self, frame, out, snapshot):
        with self.mapper.map_lock:
            self.current = frame
            m = self.atlas.current
            midx, matched, inlier = frame._fused_midx, frame._fused_matched, frame._fused_inlier

            if not (bool(out["ok"]) and int(out["n_ref_inliers"]) >= 10):
                # TrackReferenceKeyFrame failed (Tracking.cc:325-337).
                if m.n_keyframes() > 10 or self.only_tracking:
                    self.state = State.RECENTLY_LOST
                    self.ts_lost = frame.timestamp
                else:
                    self.state = State.LOST
                    if m.n_keyframes() < 10:
                        self.system.reset_active_map()
                    else:
                        self._create_map_in_atlas()
                    self.last_kf = None
                    return
                # RECENTLY_LOST: keep the last pose; the per-stage path with
                # relocalization takes over next frame.
                frame.set_pose(self.last_frame.R, self.last_frame.t)
                frame.reference_kf = self.reference_kf
                self._post_tracking_tail(False, m)
                if self.state != State.LOST and self.current is not None:
                    self._log_trajectory()
                return

            frame.set_pose(np.asarray(out["R"], np.float64), np.asarray(out["t"], np.float64))
            frame.reference_kf = self.reference_kf
            self.last_ref_track_count = int(out["n_ref_inliers"])

            # SearchLocalPoints + TrackLocalMap bookkeeping (Tracking.cc:
            # 913-929), accumulated in the snapshot and flushed per keyframe.
            snapshot.vis_acc[out["snap_visible"][: len(snapshot.mps)]] += 1
            midx_safe = np.where(matched, midx, 0).astype(np.int64)
            obs_row = snapshot.obs_pos[midx_safe] & matched
            snapshot.found_acc[midx_safe[matched & inlier]] += 1
            n_inl = int(np.count_nonzero(matched & inlier & obs_row))
            frame.set_lazy_matches(snapshot.mps, midx, obs_row)
            frame.outlier = matched & ~inlier
            self.matches_inliers = n_inl
            self.tracked_frames += 1

            ok = n_inl >= 30
            if frame.id < self.last_reloc_frame_id + self.max_frames and n_inl < 50:
                ok = False
            self._post_tracking_tail(ok, m)
            if self.state == State.LOST or self.current is None:
                return
        self._log_trajectory()

    # --- initialization ----------------------------------------------------
    def _monocular_initialization(self):
        """Tracking::MonocularInitialization (Tracking.cc:575-639)."""
        if not self.ready_to_init:
            if self.current.n > 100:
                self.initial_frame = self.current
                self.last_frame = self.current
                self.ready_to_init = True
            return
        if self.current.n <= 100:
            self.ready_to_init = False
            return
        matches12 = search_for_initialization(self.initial_frame, self.current)
        if int(np.sum(matches12 >= 0)) < 100:
            self.ready_to_init = False
            return

        sel = np.flatnonzero(matches12 >= 0)
        cap = 1024
        n = min(len(sel), cap)
        uv1 = np.zeros((cap, 2), np.float32)
        uv2 = np.zeros((cap, 2), np.float32)
        valid = np.zeros(cap, bool)
        uv1[:n] = self.initial_frame.pts[sel[:n]]
        uv2[:n] = self.current.pts[matches12[sel[:n]]]
        valid[:n] = True
        cam = self.camera
        dev = self.device
        res = reconstruct_two_views(
            torch.as_tensor(uv1, device=dev), torch.as_tensor(uv2, device=dev),
            torch.as_tensor(valid, device=dev), cam.fx, cam.fy, cam.cx, cam.cy, self.sampler,
        )
        if not bool(res["ok"]):
            return
        self._create_initial_map(
            sel[:n], matches12, res["triangulated"].cpu().numpy()[:n],
            res["points"].cpu().numpy()[:n],
            res["R21"].cpu().numpy().astype(np.float64), res["t21"].cpu().numpy().astype(np.float64),
        )

    def _create_initial_map(self, sel, matches12, tri, pts3d, R21, t21):
        """Tracking::CreateInitialMapMonocular (Tracking.cc:641-748)."""
        m = self.atlas.current
        self.initial_frame.set_pose(np.eye(3), np.zeros(3))
        self.current.set_pose(R21, t21)
        kf_ini = KeyFrame(self.initial_frame, m.id)
        kf_cur = KeyFrame(self.current, m.id)
        m.add_keyframe(kf_ini)
        m.add_keyframe(kf_cur)
        for k, i in enumerate(sel):
            if not tri[k]:
                continue
            j = int(matches12[i])
            mp = MapPoint(pts3d[k], kf_ini.id, int(self.current.track_ids[j]), m.id)
            mp.add_observation(kf_ini, int(i))
            mp.add_observation(kf_cur, j)
            kf_ini.add_mappoint(mp, int(i))
            kf_cur.add_mappoint(mp, j)
            m.add_mappoint(mp)
            mp.update_normal_and_depth(m)
            self.current.mappoints[j] = mp
        kf_ini.update_connections(m)
        kf_cur.update_connections(m)

        self._global_ba_two_kf(m, kf_ini, kf_cur)  # GlobalBundleAdjustemnt(20)

        med = kf_ini.scene_median_depth(m)
        if med < 0 or kf_cur.n_tracked_points(m, 1) < 50:
            self.system.reset_active_map()
            return
        inv_med = 1.0 / med
        kf_cur.t = kf_cur.t * inv_med
        for mid in list(kf_ini.mp_ids):
            if mid >= 0:
                mp = m.mappoints.get(int(mid))
                if mp is not None:
                    mp.pos = mp.pos * inv_med
                    mp.update_normal_and_depth(m)

        self.mapper.insert_keyframe(kf_ini)
        self.mapper.insert_keyframe(kf_cur)
        self.mapper.spin()
        self.current.set_pose(kf_cur.R, kf_cur.t)
        self.last_kf_frame_id = self.current.id
        self.last_kf = kf_cur
        self.local_kfs = [kf_cur, kf_ini]
        self.local_mps = [mp for mp in m.mappoints.values() if not mp.bad]
        self.reference_kf = kf_cur
        self.current.reference_kf = kf_cur
        self.last_frame = self.current
        m.kf_origins.append(kf_ini)
        self.state = State.OK

    def _global_ba_two_kf(self, m, kf_ini, kf_cur):
        mps = [mp for mp in m.mappoints.values() if not mp.bad]
        if not mps:
            return
        P, O = 1024, 2048
        kfs = [kf_ini, kf_cur]
        kf_R = np.stack([kf.R for kf in kfs]).astype(np.float32)
        kf_t = np.stack([kf.t for kf in kfs]).astype(np.float32)
        mp_pos = np.zeros((P, 3), np.float32)
        mp_valid = np.zeros(P, bool)
        obs_kf = np.zeros(O, np.int32)
        obs_mp = np.zeros(O, np.int32)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_valid = np.zeros(O, bool)
        n_obs = 0
        mps = mps[:P]
        for j, mp in enumerate(mps):
            mp_pos[j] = mp.pos
            mp_valid[j] = True
            for i, kf in enumerate(kfs):
                slot = mp.obs.get(kf.id)
                if slot is not None and n_obs < O:
                    obs_kf[n_obs], obs_mp[n_obs] = i, j
                    obs_uv[n_obs] = kf.pts[slot]
                    obs_valid[n_obs] = True
                    n_obs += 1
        obp = build_obs_by_point(np.where(obs_valid, obs_mp, P), P, 4, O)
        cam = self.camera
        dv = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        res = ba_solve(
            dv(kf_R), dv(kf_t), dv(np.array([True, False])), dv(np.ones(2, bool)),
            dv(mp_pos), dv(mp_valid), dv(obs_kf), dv(obs_mp), dv(obs_uv), dv(obs_valid),
            dv(obp), cam.fx, cam.fy, cam.cx, cam.cy, iters=20,
        )
        kf_cur.set_pose(res["kf_R"][1].cpu().numpy().astype(np.float64),
                        res["kf_t"][1].cpu().numpy().astype(np.float64))
        X = res["mp_pos"].cpu().numpy().astype(np.float64)
        for j, mp in enumerate(mps):
            mp.pos = X[j]
            mp.update_normal_and_depth(m)

    def _stereo_initialization(self):
        """Tracking::StereoInitialization (Tracking.cc:520-573): one keyframe
        at the origin, a map point for every slot with a stereo depth."""
        cur = self.current
        if cur.n <= 500:
            return
        m = self.atlas.current
        cur.set_pose(np.eye(3), np.zeros(3))
        kf = KeyFrame(cur, m.id)
        m.add_keyframe(kf)
        cam = self.camera
        for i in range(cur.n):
            z = cur.depth_right[i] if cur.depth_right is not None else -1
            if z <= 0:
                continue
            mp = MapPoint(cam.unproject(cur.pts[i], z), kf.id, int(cur.track_ids[i]), m.id)
            mp.add_observation(kf, i)
            kf.add_mappoint(mp, i)
            mp.update_normal_and_depth(m)
            m.add_mappoint(mp)
            cur.mappoints[i] = mp
        self.mapper.insert_keyframe(kf)
        self.mapper.spin()
        self.last_frame = cur
        self.last_kf_frame_id = cur.id
        self.last_kf = kf
        self.local_kfs = [kf]
        self.local_mps = [mp for mp in m.mappoints.values() if not mp.bad]
        self.reference_kf = kf
        cur.reference_kf = kf
        m.kf_origins.append(kf)
        self.state = State.OK

    # --- per-stage tracking (init, loss and I-frames) ------------------------
    def _check_replaced_in_last_frame(self):
        for i, mp in enumerate(self.last_frame.mappoints):
            if mp is not None and mp.replaced_by is not None:
                self.last_frame.mappoints[i] = mp.replaced_by

    def _pose_optimization(self, frame, lost):
        """Optimizer::PoseOptimization through the batched PnP."""
        slots = [i for i, mp in enumerate(frame.mappoints) if mp is not None]
        if len(slots) < 4:
            return 0
        cap = 2048
        n = min(len(slots), cap)
        # Stereo rows (ur) join the per-frame solve when there are any (the
        # C++ reference keeps its pose solve mono, Optimizer.cc:437).
        stereo = frame.uright is not None and self.settings.bf > 0
        data = np.zeros((cap, 7 if stereo else 6), np.float32)
        data[:n, 0:3] = np.stack([frame.mappoints[s].pos for s in slots[:n]])
        data[:n, 3:5] = frame.pts[slots[:n]]
        data[:n, 5] = 1.0
        if stereo:
            data[:, 6] = -1.0
            data[:n, 6] = frame.uright[slots[:n]]
        rep = self.settings.reprojection_error_lost if lost else self.settings.reprojection_error
        prior = np.zeros((4, 3), np.float32)
        prior[:3] = frame.R if frame.pose_set else np.eye(3)
        prior[3] = frame.t if frame.pose_set else 0.0
        res = pnp_ransac_fused(
            torch.as_tensor(data, device=self.device), torch.as_tensor(prior, device=self.device),
            self.intr.tolist(), float(rep), self.sampler,
            bf=float(self.settings.bf), stereo=stereo,
        )
        if not bool(res["ok"]):
            return 0
        frame.set_pose(res["R"].cpu().numpy().astype(np.float64), res["t"].cpu().numpy().astype(np.float64))
        inl = res["inliers"].cpu().numpy()
        frame.outlier[:] = True
        for k in range(n):
            frame.outlier[slots[k]] = not inl[k]
        for i in range(frame.n):  # slots without map points are not outliers
            if frame.mappoints[i] is None:
                frame.outlier[i] = False
        return int(res["n_inliers"])

    def _track_reference_keyframe(self):
        """Tracking::TrackReferenceKeyFrame (Tracking.cc:796-814)."""
        t0 = time.perf_counter()
        try:
            if self.reference_kf is None:
                return False
            self.current.mappoints = [None] * self.current.n
            search_by_video_feature_kf(self.reference_kf, self.current, self.atlas.current)
            if self.last_frame is not None and self.last_frame.pose_set:
                self.current.set_pose(self.last_frame.R, self.last_frame.t)
            self.last_ref_track_count = self._pose_optimization(
                self.current, self.state == State.RECENTLY_LOST
            )
            return self.last_ref_track_count >= 10
        finally:
            self.timings["track_ref_kf"].append(1e3 * (time.perf_counter() - t0))

    def _relocalization(self):
        """Tracking::Relocalization stub (Tracking.cc:1341-1352): flag the
        frame lost; recovery runs in the extractor's LK path next frame."""
        self.current.lost = True
        return False

    def _track_local_map(self):
        """Tracking::TrackLocalMap (Tracking.cc:890-945)."""
        t0 = time.perf_counter()
        try:
            self.tracked_frames += 1
            self._update_local_keyframes()
            self._update_local_points()
            self._search_local_points()
            self._pose_optimization(self.current, self.state == State.RECENTLY_LOST)
            self.matches_inliers = 0
            for i, mp in enumerate(self.current.mappoints):
                if mp is not None and not self.current.outlier[i]:
                    mp.n_found += 1
                    if mp.n_obs() > 0:
                        self.matches_inliers += 1
            if (self.current.id < self.last_reloc_frame_id + self.max_frames
                    and self.matches_inliers < 50):
                return False
            if self.state == State.RECENTLY_LOST and self.matches_inliers > 10:
                return True
            return self.matches_inliers >= 30
        finally:
            self.timings["track_local_map"].append(1e3 * (time.perf_counter() - t0))

    def _update_local_keyframes(self):
        """Tracking::UpdateLocalKeyFrames (Tracking.cc:1200-1339)."""
        m = self.atlas.current
        counter = {}
        for mp in self.current.mappoints:
            if mp is None or mp.bad:
                continue
            for kf_id in mp.obs:
                counter[kf_id] = counter.get(kf_id, 0) + 1
        if not counter:
            return
        self.local_kfs = []
        best_kf, best_n = None, 0
        seen = set()
        for kf_id, cnt in counter.items():
            kf = m.keyframes.get(kf_id)
            if kf is None or kf.bad:
                continue
            self.local_kfs.append(kf)
            seen.add(kf_id)
            if cnt > best_n:
                best_n, best_kf = cnt, kf
        # Expand with neighbours (Tracking.cc:1283-1332), including the
        # reference's quirk: adding a parent breaks the outer loop.
        for kf in list(self.local_kfs):
            if len(self.local_kfs) > 80:
                break
            for nb in kf.best_covisible(m, 10):
                if not nb.bad and nb.id not in seen:
                    self.local_kfs.append(nb)
                    seen.add(nb.id)
                    break
            for ch_id in kf.children:
                ch = m.keyframes.get(ch_id)
                if ch is not None and not ch.bad and ch.id not in seen:
                    self.local_kfs.append(ch)
                    seen.add(ch.id)
                    break
            parent = kf.parent
            if parent is not None and not parent.bad and parent.id not in seen:
                self.local_kfs.append(parent)
                seen.add(parent.id)
                break
        if best_kf is not None:
            self.reference_kf = best_kf
            self.current.reference_kf = best_kf

    def _update_local_points(self):
        """Tracking::UpdateLocalPoints (Tracking.cc:1171-1198): reversed local
        KFs, first occurrence wins."""
        m = self.atlas.current
        if not self.local_kfs:
            self.local_mps = []
            return
        ids_rev = np.concatenate([kf.mp_ids for kf in reversed(self.local_kfs)])
        ids_rev = ids_rev[ids_rev >= 0]
        _, first_idx = np.unique(ids_rev, return_index=True)
        ids = ids_rev[np.sort(first_idx)]
        self.local_mps = [
            mp for mp in (m.mappoints.get(int(i)) for i in ids) if mp is not None and not mp.bad
        ]

    def _search_local_points(self):
        """Tracking::SearchLocalPoints (Tracking.cc:1109-1158): frustum filter
        + id join."""
        cam = self.camera
        cur = self.current
        for mp in cur.mappoints:
            if mp is not None and not mp.bad:
                mp.n_visible += 1
                mp.last_frame_seen = cur.id
                mp.track_in_view = False
        cand = [mp for mp in self.local_mps if mp.last_frame_seen != cur.id and not mp.bad]
        if not cand:
            return
        pos = np.stack([mp.pos for mp in cand])
        pc = pos @ cur.R.T + cur.t
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = cam.fx * pc[:, 0] / z + cam.cx
            v = cam.fy * pc[:, 1] / z + cam.cy
        po = pos - cur.center()
        dist = np.linalg.norm(po, axis=-1)
        cosview = np.einsum("ij,ij->i", po, np.stack([mp.normal for mp in cand])) / np.maximum(dist, 1e-9)
        mind = np.array([mp.min_dist for mp in cand])
        maxd = np.array([mp.max_dist for mp in cand])
        bx0, bx1, by0, by1 = cam.undistorted_bounds()
        ok = (
            (z > 0) & (u >= bx0) & (u < bx1) & (v >= by0) & (v < by1)
            & (dist >= 0.8 * mind) & (dist <= 1.2 * maxd) & (cosview > 0.5)
        )
        n_to_match = 0
        for k, mp in enumerate(cand):
            if ok[k]:
                mp.track_in_view = True
                mp.track_proj = np.array([u[k], v[k]])
                mp.track_depth = dist[k]
                mp.n_visible += 1
                n_to_match += 1
            else:
                mp.track_in_view = False
        if n_to_match > 0:
            search_by_video_feature_local(cur, cand, self.mapper.far_points, self.mapper.th_far_points)

    # --- keyframe decisions ------------------------------------------------
    def _need_new_keyframe(self):
        """Tracking::NeedNewKeyFrame (Tracking.cc:947-991)."""
        n_kfs = self.atlas.current.n_keyframes()
        if self.current.id < self.last_reloc_frame_id + self.max_frames and n_kfs > self.max_frames:
            return False
        idle = self.mapper.is_idle()
        c1a = self.current.id >= self.last_kf_frame_id + self.max_frames
        c1b = self.current.id >= self.last_kf_frame_id + self.min_frames and idle
        return (c1a or c1b) and self.matches_inliers > 15 and idle

    def _create_new_keyframe(self):
        """Tracking::CreateNewKeyFrame (Tracking.cc:993-1107)."""
        t0 = time.perf_counter()
        m = self.atlas.current
        snap = getattr(self.system, "_snapshot", None)
        if snap is not None:  # land visible/found counts before culling reads them
            snap.flush_stats()
        kf = KeyFrame(self.current, m.id)
        self.reference_kf = kf
        self.current.reference_kf = kf
        if self.last_kf is not None:
            kf.prev_kf = self.last_kf
            self.last_kf.next_kf = kf
        if self.settings.sensor == STEREO and self.current.depth_right is not None:
            self._create_close_stereo_points(kf, m)
        self.mapper.insert_keyframe(kf)
        self.mapper.spin()
        self.last_kf_frame_id = self.current.id
        self.last_kf = kf
        self.timings["new_kf"].append(1e3 * (time.perf_counter() - t0))

    def _create_close_stereo_points(self, kf, m):
        """Stereo keyframes spawn map points from the closest depths
        (Tracking.cc:1015-1099): all below th_depth, and at least 100."""
        cam = self.camera
        cur = self.current
        depth = cur.depth_right
        order = np.argsort(np.where(depth > 0, depth, np.inf), kind="stable")
        n_pts = 0
        for i in order:
            z = depth[i]
            if z <= 0:
                break
            mp = cur.mappoints[i]
            if mp is None or mp.n_obs() < 1:
                x3d = cur.R.T @ (cam.unproject(cur.pts[i], z) - cur.t)
                mp = MapPoint(x3d, kf.id, int(cur.track_ids[i]), m.id)
                mp.add_observation(kf, int(i))
                kf.add_mappoint(mp, int(i))
                mp.update_normal_and_depth(m)
                m.add_mappoint(mp)
                cur.mappoints[i] = mp
            n_pts += 1
            if z > self.settings.th_depth_m and n_pts > 100:
                break

    # --- resets ----------------------------------------------------------
    def _create_map_in_atlas(self):
        """Tracking::CreateMapInAtlas (Tracking.cc:750-777)."""
        self.atlas.create_new_map()
        self.state = State.NO_IMAGES_YET
        self.velocity = None
        self.ready_to_init = False
        self.last_kf = None
        self.reference_kf = None
        self.last_frame = None
        self.current = None

    def reset_active_map(self):
        self.atlas.current.clear()
        self.state = State.NO_IMAGES_YET
        self.ready_to_init = False
        self.velocity = None
        self.last_kf = None
        self.reference_kf = None
        self.last_frame = None
        self.mapper.recent_points = []
        self.mapper.queue.clear()
        self.mapper.drop_jobs()
