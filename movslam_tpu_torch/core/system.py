"""System: the public SLAM facade of the port (monocular, per frame).

Port of the per-frame monocular drive of movslam_tpu/core/system.py
(System.h:96-189): `System(settings, MONOCULAR, device=...)`, then
`track_monocular(timestamp, smv)` per frame, `shutdown()` and the
trajectory savers. Device work runs on `device` ("cuda" on the card; "cpu"
for the tests) — a CUDA request without a card raises. In the OK state a
P-frame runs the whole per-frame program (ops/frame_step) and the host
replays its int32 wire; initialization, loss and I-frames take the
per-stage path (extractor, then Tracking.grab_frame).

Not part of this slice (ROADMAP Queue 1): the windowed drive
(`track_monocular_batch`), stereo, visual-inertial, localization mode,
the mapper thread, global BA and atlas checkpoints.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from movslam_tpu.core import trajectory as traj
from movslam_tpu.core.map import Atlas
from movslam_tpu.core.verbose import Verbose
from movslam_tpu.io.mvimage import FrameType, MotionVectorImage

from ..config.settings import IMU_MONOCULAR, MONOCULAR, STEREO, Settings
from ..device import resolve_device
from ..ops.frame_step import N_SCALARS, SNAP_CAP, packed_cols, tracked_frame_step, unpack_bits_np
from .extractor import MAX_COV, MOVExtractor
from .frame import Frame
from .local_mapping import LocalMapping
from .snapshot import build_snapshot
from .tracking import State, Tracking


class System:
    MONOCULAR = MONOCULAR
    STEREO = STEREO
    IMU_MONOCULAR = IMU_MONOCULAR

    def __init__(self, settings, sensor=MONOCULAR, device="cuda", async_mapping=False):
        if sensor != MONOCULAR:
            raise NotImplementedError(
                "stereo and visual-inertial sensors: ROADMAP Queue 1, stereo / VI slices"
            )
        if async_mapping:
            raise NotImplementedError("the mapper thread: ROADMAP Queue 1, windowed-drive slice")
        self.device = resolve_device(device)
        self.settings = settings if isinstance(settings, Settings) else Settings.from_yaml(settings, sensor)
        self.sensor = sensor
        Verbose.log("Input sensor set to: Monocular")
        cam = self.settings.camera1
        self.atlas = Atlas()
        self.atlas.add_camera(cam)
        self.mapper = LocalMapping(self.atlas, cam, self.device, far_points=self.settings.th_far_points)
        self.extractor = MOVExtractor(
            threshold=self.settings.threshold,
            coverage_threshold=self.settings.coverage_threshold,
            relocalization_distance=self.settings.relocalization_distance,
            device=self.device,
        )
        self.tracking = Tracking(self, self.atlas, self.mapper, self.settings, self.extractor, self.device)

        self._prev_state = None
        self._prev_img = None
        self._reset_requested = False
        self._snapshot = None
        self._snapshot_key = None
        self._has_dist = bool(cam.dist and any(cam.dist))
        d = (list(cam.dist) + [0.0] * 5)[:5]
        self._dist_pack = torch.tensor(
            d + list(cam.undistorted_bounds()) + [0.0], dtype=torch.float32, device=self.device
        )
        self.image_count = 0
        self.track_ms = []

    # ------------------------------------------------------------------
    def _build_reloc(self):
        """Projected map points of the reference KF for the extractor's LK
        recovery path (MOVExtractor.cc:161-243)."""
        tr = self.tracking
        kf, lf = tr.reference_kf, tr.last_frame
        if kf is None or lf is None or not lf.pose_set:
            return None
        m = self.atlas.current
        cam = self.settings.camera1
        cap = 512
        proj = np.zeros((cap, 2), np.float32)
        valid = np.zeros(cap, bool)
        ids = np.full(cap, -1, np.int32)
        n = 0
        for mid in kf.mp_ids:
            if mid < 0 or n >= cap:
                continue
            mp = m.mappoints.get(int(mid))
            if mp is None or mp.bad:
                continue
            pc = lf.R @ mp.pos + lf.t
            if pc[2] <= 0:
                continue
            u = cam.fx * pc[0] / pc[2] + cam.cx
            v = cam.fy * pc[1] / pc[2] + cam.cy
            if not (0 <= u < cam.width and 0 <= v < cam.height):
                continue
            proj[n] = (u, v)
            ids[n] = mp.track_id
            valid[n] = True
            n += 1
        if n == 0:
            return None
        return {"kf_img": kf.image, "proj_pts": proj, "proj_valid": valid, "track_ids": ids}

    def _refresh_snapshot(self):
        """(Re)publish the map snapshot when the map, its version or the
        reference KF changed (once per keyframe, not per frame)."""
        tr = self.tracking
        m = self.atlas.current
        if tr.reference_kf is None:
            self._snapshot = None
            return
        key = (m.id, tr.reference_kf.id, m.change_index)
        if self._snapshot is not None and self._snapshot_key == key:
            return
        with self.mapper.map_lock:
            if self._snapshot is not None:
                self._snapshot.flush_stats()
            self._snapshot = build_snapshot(m, tr.reference_kf, self.device)
        self._snapshot_key = key

    def _track_monocular_fused(self, timestamp, smv, img_dev):
        """The per-frame program path (OK-state P-frames): one device program,
        one wire pull, host replay through Tracking.track_fused."""
        tr = self.tracking
        self._refresh_snapshot()
        snap = self._snapshot
        if snap is None:
            return False
        mvk_pack, n_mvs = smv.packed_joint()
        # Constant-velocity motion model (Tracking.cc:414-424).
        R_prior, t_prior = tr.last_frame.R, tr.last_frame.t
        if tr.velocity is not None:
            Rv, tv = tr.velocity
            R_prior, t_prior = Rv @ R_prior, Rv @ t_prior + tv
        trailer = np.zeros((2, 8), np.float32)
        trailer.reshape(-1)[0:9] = np.asarray(R_prior, np.float32).reshape(-1)
        trailer.reshape(-1)[9:12] = t_prior
        trailer.reshape(-1)[12] = smv.coverage_area
        out = tracked_frame_step(
            img_dev, self._prev_img, self._prev_state,
            torch.as_tensor(np.concatenate([mvk_pack, trailer]), device=self.device),
            snap.fused, tr.intr, tr.sampler, self._dist_pack,
            n_mvs=n_mvs, reproj_err=float(self.settings.reprojection_error),
            threshold=float(self.extractor.threshold),
            coverage_threshold=float(self.extractor.coverage_threshold),
            capacity=self.extractor.capacity, max_cov=MAX_COV, has_dist=self._has_dist,
        )
        state = out["state"]
        wire = out["wire"].cpu().numpy()  # the one pull per frame
        C = packed_cols(self._has_dist)
        N = state.capacity
        scal = wire[N * C : N * C + N_SCALARS]
        frame = Frame.from_packed(
            wire[: N * C].reshape(N, C), timestamp=timestamp, image=smv.im_gray,
            fid=self.image_count, has_dist=self._has_dist,
        )
        pose = np.ascontiguousarray(scal[0:12]).view(np.float32)
        host_out = {
            "R": pose[0:9].reshape(3, 3).astype(np.float64),
            "t": pose[9:12].astype(np.float64),
            "n_ref_inliers": int(scal[12]),
            "n_inliers": int(scal[13]),
            "ok": scal[14] > 0,
            "snap_visible": unpack_bits_np(wire[N * C + N_SCALARS :], SNAP_CAP),
        }
        self._prev_state = state
        self.extractor._next_id_dev = state.next_id
        tr.track_fused(frame, host_out, snap)
        return True

    def track_monocular(self, timestamp, smv: MotionVectorImage):
        """System::TrackMonocular (System.cc:171-234): returns (R, t) of the
        camera-from-world pose, or None while initializing or lost."""
        t0 = time.perf_counter()
        if self._reset_requested:
            self._prev_state = None
            self._snapshot = None
            self._reset_requested = False
        tr = self.tracking
        img_dev = torch.as_tensor(smv.im_gray, device=self.device)

        fused_done = False
        if (
            tr.state == State.OK and self._prev_state is not None
            and tr.last_frame is not None and tr.last_frame.pose_set and not tr.last_frame.lost
            and smv.ft != FrameType.I_FRAME
        ):
            fused_done = self._track_monocular_fused(timestamp, smv, img_dev)
            if fused_done:
                self._prev_img = img_dev
        if not fused_done:
            reloc = None
            if tr.last_frame is not None and tr.last_frame.lost and tr.state == State.RECENTLY_LOST:
                reloc = self._build_reloc()
            state = self.extractor.extract(smv, self._prev_state, self._prev_img, reloc, img_dev=img_dev)
            frame = Frame(state, timestamp=timestamp, image=smv.im_gray, fid=self.image_count,
                          camera=self.settings.camera1)
            self._prev_state = state
            self._prev_img = img_dev
            tr.grab_frame(frame)

        self.image_count += 1
        self.track_ms.append(1e3 * (time.perf_counter() - t0))
        if tr.current is not None and tr.current.pose_set:
            return tr.current.R, tr.current.t
        return None

    def track_monocular_batch(self, items, flush=True):
        raise NotImplementedError(
            "the windowed drive (ops/window_step.py, ops/mapper_step.py): ROADMAP Queue 1, next slice"
        )

    def track_stereo(self, timestamp, smv, smv_right):
        raise NotImplementedError("stereo tracking: ROADMAP Queue 1, stereo slice")

    def global_bundle_adjustment(self, iters=20, mesh=None):
        raise NotImplementedError("global BA: ROADMAP Queue 1, pose graph / map merge / global BA slice")

    # --- control ---------------------------------------------------------
    def reset_active_map(self):
        Verbose.log("SYSTEM-> Resetting active map")
        self.tracking.reset_active_map()
        self._reset_requested = True

    def shutdown(self):
        if self._snapshot is not None:
            self._snapshot.flush_stats()
        self.mapper.spin(final=True)

    # --- counters (results.txt contract) ---------------------------------
    def get_total_lost(self):
        return self.tracking.lost_count

    def get_fps(self):
        return self.settings.fps

    def mean_track_ms(self):
        return float(np.mean(self.track_ms)) if self.track_ms else 0.0

    # --- savers ------------------------------------------------------------
    def save_keyframe_trajectory_kitti(self, filename):
        traj.save_keyframe_trajectory_kitti(self.atlas, filename)

    def save_keyframe_trajectory_euroc(self, filename):
        traj.save_keyframe_trajectory_euroc(self.atlas, filename)

    def save_keyframe_trajectory_tum(self, filename):
        traj.save_keyframe_trajectory_tum(self.atlas, filename)

    def frame_trajectory(self):
        """Per-frame (ts, R_cw, t_cw, lost) against the bundle-adjusted
        keyframe poses (System.cc:458-720 saver semantics)."""
        return list(traj.frame_trajectory(self.tracking))

    def save_trajectory_euroc(self, filename):
        traj.save_frame_trajectory(self.tracking, filename, scale_ts=1e9)

    def save_trajectory_tum(self, filename):
        traj.save_frame_trajectory(self.tracking, filename, scale_ts=1.0)

    def save_point_cloud(self, filename):
        traj.save_point_cloud(self.atlas, filename)
