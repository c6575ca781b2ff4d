"""System: the public SLAM facade of the port (monocular, stereo and
visual-inertial monocular).

Port of the drives of movslam_tpu/core/system.py (System.h:96-189):
`System(settings, MONOCULAR | STEREO | IMU_MONOCULAR, device=...)`, then
either `track_monocular(timestamp, smv, imu=None)` / `track_stereo(timestamp,
left, right)` per frame or `track_monocular_batch(items, flush=)` /
`track_stereo_batch(items, flush=)` for the windowed drive, `shutdown()` and
the trajectory savers. An IMU_MONOCULAR system takes each frame's IMU samples
(core/inertial.ImuBuffer rows) with the frame: `imu=` per frame, `(ts, smv,
imu)` triples windowed; its mapper solves gravity and metric scale and runs
the visual-inertial local BA. `activate_localization_mode()` freezes the map;
`global_bundle_adjustment()` optimizes every keyframe of the active map;
`save_atlas(path)` / `load_atlas(path)` write and read an atlas checkpoint
(core/checkpoint.py), also at start and shutdown when the settings name a
file. Device
work runs on `device` ("cuda" on the card; "cpu" for the tests) — a CUDA
request without a card raises.

Per frame: in the OK state a P-frame runs the whole per-frame program
(ops/frame_step) and the host replays its int32 wire; initialization, loss
and I-frames take the per-stage path (extractor, then Tracking.grab_frame).
A stereo frame always takes the per-stage path, with its depth from
core/stereo.py; inside a window the depth comes from the frame program.

Windowed: runs of OK-state P-frames go W at a time through the window
program (ops/window_step) against one frozen snapshot; up to
`pipeline_depth` windows are in flight, each chained on the device-resident
carry of the one before it, and each is replayed through the same state
machine when its wire is pulled. Keyframes made at replay hand their
triangulation and local BA to the next window program (core/local_mapping
deferred mode); a replay that ends a window early rewinds the track state
on the device and feeds the remaining frames again.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..config.settings import IMU_MONOCULAR, MONOCULAR, STEREO, Settings
from ..device import resolve_device
from ..io.mvimage import FrameType, MotionVectorImage
from ..ops.frame_step import N_SCALARS, SNAP_CAP, packed_cols, tracked_frame_step, unpack_bits_np
from ..ops.mapper_step import C_PATCH, MAPPER_SMALL, P_PATCH, split_mapper_wire
from ..ops.window_step import tracked_window_step
from ..trace import span
from . import trajectory as traj
from .checkpoint import load_atlas, save_atlas
from .extractor import MAX_COV, MOVExtractor
from .frame import Frame
from .inertial import ImuBuffer
from .local_mapping import LocalMapping, global_bundle_adjustment
from .map import Atlas
from .snapshot import MapSnapshot, build_snapshot
from .stereo import compute_stereo_depth
from .stereo_rectified import rectify_pair
from .tracking import State, Tracking
from .trackstate import TrackState
from .verbose import Verbose


class System:
    MONOCULAR = MONOCULAR
    STEREO = STEREO
    IMU_MONOCULAR = IMU_MONOCULAR

    def __init__(self, settings, sensor=MONOCULAR, device="cuda", async_mapping=False, use_viewer=False):
        if sensor not in (MONOCULAR, STEREO, IMU_MONOCULAR):
            raise ValueError(f"unsupported sensor {sensor!r}")
        self.device = resolve_device(device)
        self.settings = settings if isinstance(settings, Settings) else Settings.from_yaml(settings, sensor)
        self.sensor = sensor
        Verbose.log("Input sensor set to: " + {MONOCULAR: "Monocular", STEREO: "Stereo",
                                                IMU_MONOCULAR: "Monocular-Inertial"}[sensor])
        cam = self.settings.camera1
        self.atlas = Atlas()
        self.atlas.add_camera(cam)
        self.mapper = LocalMapping(
            self.atlas, cam, self.device, monocular=(sensor != STEREO),
            far_points=self.settings.th_far_points, bf=self.settings.bf, stereo_b=self.settings.b,
        )
        # Visual-inertial: the per-frame IMU sample buffer feeds the mapper's
        # gravity/scale init and VI local BA.
        self.imu_buffer = None
        if sensor == IMU_MONOCULAR:
            self.imu_buffer = self.mapper.imu_buffer = ImuBuffer()
            self.mapper.imu_noise = (self.settings.imu_noise_gyro, self.settings.imu_noise_acc)
        self.extractor = MOVExtractor(
            threshold=self.settings.threshold,
            coverage_threshold=self.settings.coverage_threshold,
            relocalization_distance=self.settings.relocalization_distance,
            device=self.device,
        )
        self.tracking = Tracking(self, self.atlas, self.mapper, self.settings, self.extractor, self.device)
        self.mapper.tracking = self.tracking

        self._prev_state = None
        self._prev_img = None
        self._reset_requested = False
        self._snapshot = None
        self._snapshot_key = None
        self._has_dist = bool(cam.dist and any(cam.dist))
        d = (list(cam.dist) + [0.0] * 5)[:5]
        self._dist_pack = torch.tensor(
            d + list(cam.undistorted_bounds()) + [self.settings.bf], dtype=torch.float32,
            device=self.device,
        )
        self.image_count = 0
        self.track_ms = []

        # The windowed drive. _wfq: windows in flight (dispatched, not yet
        # replayed; oldest first, each chained on the one before it).
        # _pending: frames buffered across batch calls, so that windows can
        # span the caller's batch boundaries and the keyframe-aligned
        # schedule stays in phase (see _batch_drive).
        self.window = 8  # frames per window (the decoder's lookahead, VideoDecoder.cc:163)
        self.pipeline_depth = 2  # windows in flight at once
        self._wfq = []
        self._pending = []
        # What the drives did, counted where it happens: windows by length,
        # window frames handed to the window program (re-dispatches after a
        # rewind included), speculative windows, rewinds (scale_rewinds: those
        # an init stage caused), and frames the per-frame paths ran through
        # the P-frame extraction; the mapper counts into it too (init stages,
        # VI BAs, keyframe intervals integrated).
        self.counts = self.mapper.counts = collections.Counter()

        self.async_mapping = async_mapping
        if async_mapping:
            self.mapper.start_thread()

        # The headless viewer (viz/viewer.py): set viewer.out_dir to stream
        # annotated PNGs.
        self.viewer = None
        if use_viewer:
            from ..viz.viewer import Viewer

            self.viewer = Viewer(self)

        if self.settings.load_atlas:
            try:
                self.load_atlas(self.settings.load_atlas)
            except FileNotFoundError:
                Verbose.log(f"Atlas file not found: {self.settings.load_atlas}")

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
        reference KF changed (once per keyframe, not per frame). The last
        C_PATCH rows stay free for the windowed drive's device-side patch;
        both drives leave them free, so both track the same point set."""
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
            self._snapshot = build_snapshot(m, tr.reference_kf, self.device, reserve=C_PATCH)
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

    def track_monocular(self, timestamp, smv: MotionVectorImage, imu=None):
        """System::TrackMonocular (System.cc:171-234): returns (R, t) of the
        camera-from-world pose, or None while initializing or lost.

        imu: on an IMU_MONOCULAR system, the (N, 7) IMU samples [dt gx gy gz
        ax ay az] over the interval since the previous frame."""
        if self.sensor == STEREO:
            raise ValueError("sensor not set to Monocular")
        self._flush_windows()
        if self.imu_buffer is not None and imu is not None:
            self.imu_buffer.add(self.image_count, imu)
        with span("drive.per_frame"):
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
                    self.mapper.tick()
                    self.counts["per_frame_p"] += 1
            if not fused_done:
                self._track_per_stage(timestamp, smv, img_dev)
            return self._frame_done(t0, smv)

    def _track_per_stage(self, timestamp, smv, img_dev, smv_right=None):
        """The per-stage path: extractor (with the LK recovery inputs after a
        loss), stereo depth when there is a right frame, then
        Tracking.grab_frame."""
        tr = self.tracking
        reloc = None
        if tr.last_frame is not None and tr.last_frame.lost and tr.state == State.RECENTLY_LOST:
            reloc = self._build_reloc()
        if smv.ft != FrameType.I_FRAME and self._prev_state is not None:
            self.counts["per_frame_p"] += 1
        with span("frame.front_end"):
            state = self.extractor.extract(smv, self._prev_state, self._prev_img, reloc, img_dev=img_dev)
            frame = Frame(state, timestamp=timestamp, image=smv.im_gray, fid=self.image_count,
                          camera=self.settings.camera1)
            if smv_right is not None:
                compute_stereo_depth(frame, img_dev, smv_right.im_gray, self.settings, self.device)
        self._prev_state = state
        self._prev_img = img_dev
        self.mapper.tick()
        tr.grab_frame(frame)

    def _frame_done(self, t0, smv):
        """Count the frame, show it to the viewer and return its pose, (R, t)
        or None."""
        self.image_count += 1
        self.track_ms.append(1e3 * (time.perf_counter() - t0))
        cur = self.tracking.current
        if self.viewer is not None and cur is not None:
            self.viewer.update(cur, smv)
        return (cur.R, cur.t) if cur is not None and cur.pose_set else None

    # --- windowed drive (W frames per window program) ----------------------
    def _patch_inputs(self, snap):
        """The device-side snapshot patch for a window: the launched,
        uncommitted mapper job's device-resident results plus their row
        metadata. Returns (patch_tri, patch_mp, patch_meta, job), all None
        when nothing is pending."""
        d = self.mapper._deferred
        if d is None or d.get("committed") or d["map"] is not self.atlas.current:
            return None, None, None, None
        meta = torch.as_tensor(self._ba_patch_meta(snap, d["ba"]), device=self.device)
        return d["out"]["patch_tri"], d["out"]["patch_mp"], meta, d

    @staticmethod
    def _ba_patch_meta(snap, ba):
        """Patch row metadata of a mapper job: meta[0] = number of base rows
        (the triangulations land behind them), meta[1:] = BA point -> base
        snapshot row by track id, SNAP_CAP meaning "drop". Among rows with one
        track id the first wins (the stable argsort here pairs with the
        device's stable sort), and among BA points with one id only the first
        keeps its row, so no snapshot row is written twice."""
        n_base = len(snap.mps)
        meta = np.full(P_PATCH + 1, SNAP_CAP, np.float32)
        meta[0] = n_base
        if ba is not None and n_base:
            order, sorted_tids = snap.tid_order()
            tids = np.fromiter((mp.track_id for mp in ba["mps"]), np.int64, len(ba["mps"]))[:P_PATCH]
            pos = np.minimum(np.searchsorted(sorted_tids, tids), n_base - 1)
            rows = np.where(sorted_tids[pos] == tids, order[pos], SNAP_CAP)
            _, first = np.unique(rows, return_index=True)
            keep = np.zeros(len(rows), bool)
            keep[first] = True
            meta[1 : len(tids) + 1] = np.where(keep, rows, SNAP_CAP)
        return meta

    def _window_eligible(self, smv):
        tr = self.tracking
        return (
            self.window >= 2 and tr.state == State.OK
            and self._prev_state is not None and self._prev_img is not None
            and tr.last_frame is not None and tr.last_frame.pose_set and not tr.last_frame.lost
            and smv.ft != FrameType.I_FRAME
        )

    def track_monocular_batch(self, items, flush=True):
        """Track a batch of (timestamp, smv) pairs, or (timestamp, smv, imu)
        triples on an IMU_MONOCULAR system; returns poses (R, t) or None in
        stream order. Runs of OK-state P-frames go through the
        window program (ops/window_step); initialization, loss recovery and
        I-frames fall back to track_monocular.

        The drive is pipelined: window k+1 is handed to the device, chained
        on window k's device-resident carry (track state, pose chain),
        before window k has been replayed through the Tracking state
        machine. flush=False keeps the last windows in flight across calls
        (the returned list then lags the input by up to pipeline_depth
        windows plus a partial one; call once more with flush=True, or with
        items=[], to drain). With flush=True every passed frame is resolved
        before returning."""
        if self.imu_buffer is not None:
            self._absorb_imu(items)
        return self._batch_drive([it[:2] for it in items], flush, per_frame=self.track_monocular)

    def _absorb_imu(self, items):
        """File the IMU samples of (ts, smv, imu) items under the frame ids the
        items will get: the frames still buffered (_pending) and in flight
        (_wfq) come first. A rewind feeds frames again under the same ids, so
        it neither adds samples twice nor loses any."""
        ahead = len(self._pending) + sum(len(wf["run"]) for wf in self._wfq)
        for k, it in enumerate(items):
            if len(it) == 3 and it[2] is not None:
                self.imu_buffer.add(self.image_count + ahead + k, it[2])

    def track_stereo_batch(self, items, flush=True):
        """Track a batch of (timestamp, smv_left, smv_right) triples: the
        windowed drive of track_monocular_batch with the right-image stack in
        every window and the stereo depth computed inside the window program
        (ops/frame_step stage 1c). A raw rig's pairs are rectified first."""
        if self.sensor != STEREO:
            raise ValueError("sensor not set to Stereo")
        if self.settings.need_rectify:
            items = [(it[0], *rectify_pair(it[1], it[2], self.settings)) for it in items]
        return self._batch_drive([it[:3] for it in items], flush, per_frame=self.track_stereo)

    def _rewind(self, wf, consumed):
        """After an unclean replay every later window chained on a carry that
        is no longer valid: discard them all and return the frames to feed
        again, in order. A staged mapper job that a discarded window carried
        never commits from that window's wire: it goes back to the mapper."""
        self.counts["rewinds"] += 1
        refeed = list(wf["run"][consumed:])
        for w2 in self._wfq:
            self.mapper.restage(w2.get("fused_job"))
            refeed.extend(w2["run"])
        self._wfq.clear()
        return refeed

    def _batch_drive(self, items, flush, per_frame):
        results = []
        todo = self._pending + list(items)
        self._pending = []
        wfq = self._wfq
        while todo:
            # Host-side lookahead: with flush=False, fewer than a window's
            # frames stay buffered for the next call instead of being forced
            # into short windows: the keyframe-aligned window schedule is
            # W-periodic but out of phase with the caller's batches.
            if (
                not flush and len(todo) < self.window
                and (wfq or (self._window_eligible(todo[0][1]) and self._snapshot is not None))
            ):
                self._pending = todo
                return results
            # Fill the pipeline: dispatch windows until the depth cap or
            # until the head of todo is not window-eligible. Each dispatch
            # beyond the first chains SPECULATIVELY on the previous window's
            # device carry. The previous keyframe's mapper results ride each
            # dispatch as a device-side snapshot patch (_patch_inputs) or as
            # the staged job the window runs itself (take_staged), so windows
            # track at most one keyframe stale without a blocking commit.
            while len(wfq) < self.pipeline_depth and todo:
                run = self._collect_run(todo, speculative=bool(wfq))
                if run is None:
                    break
                wf = self._dispatch_window(run, carry=wfq[-1] if wfq else None)
                if wf is None:
                    break
                wfq.append(wf)
                del todo[: len(run)]
            if not wfq:
                # Per-frame fallback (I-frame at the head, init or loss
                # states, no snapshot). No window will carry a staged job or
                # the patch: launch a staged job standalone now and land
                # whatever already finished, so the per-frame path does not
                # track a snapshot missing the last keyframe's points.
                self.mapper.dispatch_staged_async()
                self.mapper.poke_commit(blocking=False)
                results.append(per_frame(*todo.pop(0)))
                continue
            # Replay the OLDEST window in flight (the one device wait).
            wf = wfq.pop(0)
            poses, consumed, clean = self._replay_window(wf)
            results.extend(poses)
            if not clean:
                todo[:0] = self._rewind(wf, consumed)
        if flush:
            while wfq:
                wf = wfq.pop(0)
                poses, consumed, clean = self._replay_window(wf)
                results.extend(poses)
                if not clean:
                    for it in self._rewind(wf, consumed):
                        results.append(per_frame(*it))
        return results

    def _sim_kf_schedule(self, start_count, cooldown, last_kf_id, n):
        """Forward-simulate the keyframe decision over the next n OK frames.

        In the windowed drive the keyframe timing is deterministic on the
        host: NeedNewKeyFrame (Tracking.cc:947-991; its c2, matches > 15,
        holds whenever tracking is OK) fires exactly when the frames-mode
        mapper cooldown expires. Mirrors the replay loop's order (decision
        inside track_fused, then mapper.tick()). Returns (kf_offsets,
        cooldown_end, last_kf_end), so that window boundaries can be placed
        ON keyframes: a mid-window keyframe leaves the rest of the window
        tracking a stale snapshot."""
        tr = self.tracking
        if tr.only_tracking:
            # Localization mode: no keyframe ever fires; windows cap at W
            # and the cooldown ticks down.
            return [], max(0, cooldown - n), last_kf_id
        nkfs = self.atlas.current.n_keyframes()
        busy = self.mapper.busy_frames
        offs = []
        c, lk = cooldown, last_kf_id
        for j in range(n):
            fid = start_count + j
            reloc_gate = fid < tr.last_reloc_frame_id + tr.max_frames and nkfs > tr.max_frames
            eligible = fid >= lk + tr.max_frames or fid >= lk + tr.min_frames
            if c == 0 and eligible and not reloc_gate:
                offs.append(j)
                lk = fid
                c = busy  # insert_keyframe resets the cooldown
                nkfs += 1
            if c > 0:
                c -= 1  # mapper.tick()
        return offs, c, lk

    def _collect_run(self, todo, speculative=False):
        """Collect a window run from the head of todo, its length a power of
        two, sized so that a predicted keyframe lands on the window's LAST
        frame (then nothing tracks a stale snapshot and no rewind is
        needed). speculative=True skips the host tracking-state checks (the
        state is not known yet: the previous window has not been replayed)
        and asks for a mature map, where speculation pays."""
        if not todo:
            return None
        if speculative:
            if self.window < 2 or self.atlas.current.n_keyframes() < 10:
                return None
            if todo[0][1].ft == FrameType.I_FRAME:
                return None
        elif not self._window_eligible(todo[0][1]):
            return None
        run = []
        for it in todo:
            if len(run) >= self.window or it[1].ft == FrameType.I_FRAME:
                break
            run.append(it)
        L = 1 << (len(run).bit_length() - 1) if run else 0
        # Align the window's end with the next predicted keyframe. A
        # speculative run predicts from the NEWEST in-flight window's
        # simulated exit state (stored at dispatch).
        if speculative and self._wfq:
            start, cool, lastkf = self._wfq[-1]["sched_exit"]
        else:
            start, cool, lastkf = self.image_count, self.mapper.cooldown, self.tracking.last_kf_frame_id
        offs, _, _ = self._sim_kf_schedule(start, cool, lastkf, len(run))
        if offs and offs[0] + 1 >= 2:
            # The largest power of two that ends at or before the keyframe:
            # ending ON it is ideal, ending before it is clean too.
            L = min(L, 1 << ((offs[0] + 1).bit_length() - 1))
        elif offs and offs[0] == 0 and len(run) >= self.window:
            # The keyframe is due at the window's FIRST frame. With the
            # mature-map cooldown equal to the window length, keyframes and
            # window boundaries are both W-periodic: accepting would lock
            # every later window into starting on a keyframe, W-1 frames
            # stale. Decline: the head frame goes through the per-frame path,
            # which shifts the phase by one, and the next windows end ON
            # their keyframes.
            return None
        run = run[:L]
        return run if len(run) >= 2 else None

    def _dispatch_window(self, run, carry=None):
        """Hand one window to the device without waiting for it.

        carry=None chains on the host tracking state (pose chain, previous
        image and state: the entry after per-frame tracking). carry=<an
        in-flight window record> chains on that window's device-resident
        outputs (state, pose_carry) without pulling them. Returns the
        in-flight record, or None when there is no map snapshot yet.

        run items are (ts, smv) for mono and (ts, smv, smv_right) for stereo:
        a stereo window adds the right-image stack."""
        with span("drive.dispatch"):
            stereo = len(run[0]) == 3
            tr = self.tracking
            if tr.reference_kf is None:  # no snapshot without a reference keyframe
                return None
            # Windowed drive: the frame-count mapper throttle (a readiness poll
            # starves keyframes when W frames replay faster than a BA solves) and
            # the deferred mapper, its SMALL jobs run by the window program.
            self.mapper.throttle_mode = "frames"
            self.mapper.defer_mapping = True
            self.mapper.fuse_mapper = True
            # Adaptive cadence: a young map needs dense keyframes; a mature one
            # gets a cooldown of exactly the window length, so the schedule
            # (_sim_kf_schedule) lands one keyframe on the LAST frame of each
            # full window.
            self.mapper.busy_frames = 3 if self.atlas.current.n_keyframes() < 8 else self.window
            with span("dispatch.inputs"):
                mvks = []
                n_mvs = None
                for it in run:
                    mvk, m = it[1].packed_joint_i16()
                    mvks.append(mvk)
                    n_mvs = m if n_mvs is None else n_mvs
                    if m != n_mvs:
                        raise ValueError(f"mixed MV capacities within a window: {m} and {n_mvs}")
                mvk_stack = torch.as_tensor(np.stack(mvks), device=self.device)
                imgs_dev = torch.as_tensor(np.stack([it[1].im_gray for it in run]), device=self.device)
                imgs_right = None
                if stereo:
                    imgs_right = torch.as_tensor(np.stack([it[2].im_gray for it in run]), device=self.device)
            with span("dispatch.snapshot"):
                # The launched mapper job is NOT committed here: the snapshot is
                # built from the host graph as it is, and the job's device-resident
                # results ride into the window program as a snapshot PATCH. The host
                # graph catches up at replay.
                self._refresh_snapshot()
                snap = self._snapshot
                if snap is None:
                    return None
                patch_tri, patch_mp, patch_meta, patch_job = self._patch_inputs(snap)
                # The job staged at the last replayed keyframe rides THIS window.
                staged = self.mapper.take_staged(self.atlas.current)
                if staged is not None and patch_job is not None:
                    # Both pending happens only after an irregular schedule (a BIG
                    # job still in flight when a SMALL one staged): land the launched
                    # one now so that one patch source remains, then REBUILD the
                    # snapshot, since the commit just put that job's points into the
                    # host graph.
                    self.mapper.poke_commit(blocking=True)
                    self._refresh_snapshot()
                    snap = self._snapshot
                    if snap is None:
                        self.mapper.restage(staged)
                        return None
                    patch_tri, patch_mp, patch_meta, patch_job = self._patch_inputs(snap)
                mtri = mba = None
                if staged is not None:
                    mtri = torch.as_tensor(staged["tri_wire"], device=self.device)
                    mba = torch.as_tensor(staged["ba_wire"], device=self.device)
                    patch_meta = torch.as_tensor(self._ba_patch_meta(snap, staged["ba"]), device=self.device)

            if carry is None:
                prev_state, prev_img = self._prev_state, self._prev_img
                pose_pack = np.zeros(25, np.float32)
                pose_pack[0:9] = np.asarray(tr.last_frame.R, np.float32).reshape(-1)
                pose_pack[9:12] = tr.last_frame.t
                if tr.velocity is not None:
                    Rv, tv = tr.velocity
                    pose_pack[12:21] = np.asarray(Rv, np.float32).reshape(-1)
                    pose_pack[21:24] = tv
                    pose_pack[24] = 1.0
                pose_pack = torch.as_tensor(pose_pack, device=self.device)
            else:
                prev_state = carry["out"]["state"]
                prev_img = carry["imgs_dev"][-1]
                pose_pack = carry["out"]["pose_carry"]

            with span("window"):
                out = tracked_window_step(
                    imgs_dev, prev_img, prev_state, mvk_stack, pose_pack, snap.fused, tr.intr, tr.sampler,
                    self._dist_pack, imgs_right, patch_tri=patch_tri, patch_mp=patch_mp, patch_meta=patch_meta,
                    mtri=mtri, mba=mba, n_mvs=n_mvs,
                    reproj_err=float(self.settings.reprojection_error),
                    threshold=float(self.extractor.threshold),
                    coverage_threshold=float(self.extractor.coverage_threshold),
                    capacity=self.extractor.capacity, max_cov=MAX_COV, has_dist=self._has_dist,
                    has_stereo=stereo,
                )
            # This window's device output is the carry of whatever is dispatched
            # next: a speculative window, or the per-frame path after a clean
            # replay.
            self._prev_state = out["state"]
            self._prev_img = imgs_dev[-1]
            self.extractor._next_id_dev = out["state"].next_id
            # The scheduler's simulated state at this window's exit (image
            # counter, mapper cooldown, last keyframe id), so that a speculative
            # next window can be keyframe-aligned before this one has replayed.
            if carry is None:
                start, cool, lastkf = self.image_count, self.mapper.cooldown, tr.last_kf_frame_id
            else:
                start, cool, lastkf = carry["sched_exit"]
            _, cool_x, lastkf_x = self._sim_kf_schedule(start, cool, lastkf, len(run))
            self.counts["windows"] += 1
            self.counts[f"windows_len_{len(run)}"] += 1
            self.counts["window_frames"] += len(run)
            if carry is not None:
                self.counts["spec_windows"] += 1
            return {
                "out": out, "run": run, "snap": snap, "imgs_dev": imgs_dev, "n_mvs": n_mvs,
                "patch_job": patch_job, "fused_job": staged, "stereo": stereo,
                "sched_exit": (start + len(run), cool_x, lastkf_x),
                "imu_stage": self.atlas.current.imu_init_count,
            }

    def _replay_window(self, wf):
        """Pull one in-flight window's wire (the one device wait) and replay
        it through the Tracking state machine. Returns (poses, consumed,
        clean): clean is True iff every frame was consumed with tracking
        still OK, i.e. a window chained on this one's device carry is valid."""
        with span("drive.replay"):
            t0 = time.perf_counter()
            out, run, snap, imgs_dev = wf["out"], wf["run"], wf["snap"], wf["imgs_dev"]
            stereo = wf["stereo"]
            W = len(run)
            tr = self.tracking
            with span("replay.wait"):
                wire = out["wire"].cpu().numpy()

            # The window tracked against base + device patch (the launched
            # mapper job's results, or the staged job the window ran itself,
            # whose result trails this wire). Make sure that job is in the host
            # graph (the window-run one commits here; a launched one normally
            # landed at the keyframe processed since this window's dispatch),
            # then extend the snapshot's host view so that patched rows resolve
            # to MapPoints.
            with span("replay.commit"):
                fused_job = wf["fused_job"]
                if fused_job is not None and not fused_job.get("committed"):
                    sz = MAPPER_SMALL
                    mlen = sz["C"] * 3 + sz["K"] * 12 + sz["P"] * 3 + sz["O"] * 2
                    self.mapper.commit_fused(fused_job, *split_mapper_wire(
                        np.ascontiguousarray(wire[-mlen:]).view(np.float32),
                        C=sz["C"], K=sz["K"], P=sz["P"], O=sz["O"],
                    ))
                patch_job = fused_job if fused_job is not None else wf["patch_job"]
                if patch_job is not None:
                    if not patch_job.get("committed"):
                        self.mapper.poke_commit(blocking=True)
                    tri = patch_job["tri"]
                    created = tri.get("created", {}) if tri is not None else {}
                    ext = [created.get(i) for i in range(C_PATCH)]
                    obs_ext = np.fromiter((mp is not None and not mp.bad for mp in ext), bool, C_PATCH)
                    snap.flush_stats()
                    snap = MapSnapshot(snap.fused, list(snap.mps) + ext, version=snap.version,
                                       obs_pos=np.concatenate([snap.obs_pos, obs_ext]))

            C = packed_cols(self._has_dist, stereo)
            N = self.extractor.capacity
            P = snap.fused.shape[0]
            o1 = W * N * C
            o2 = o1 + W * N_SCALARS
            o3 = o2 + W * (P // 32)
            packed_w = wire[:o1].reshape(W, N, C)
            scal_w = wire[o1:o2].reshape(W, N_SCALARS)
            visbits_w = wire[o2:o3].reshape(W, P // 32)

            poses = []
            consumed = 0
            rewound = False
            for k in range(W):
                if k and self.atlas.current.imu_init_count != wf["imu_stage"]:
                    break  # an init stage ran at the last frame (below)
                ts, smv = run[k][:2]
                scal = scal_w[k]
                frame = Frame.from_packed(packed_w[k], timestamp=ts, image=smv.im_gray,
                                          fid=self.image_count, has_dist=self._has_dist, stereo=stereo)
                pose = np.ascontiguousarray(scal[0:12]).view(np.float32)
                host_out = {
                    "R": pose[0:9].reshape(3, 3).astype(np.float64),
                    "t": pose[9:12].astype(np.float64),
                    "n_ref_inliers": int(scal[12]),
                    "n_inliers": int(scal[13]),
                    "ok": scal[14] > 0,
                    "snap_visible": unpack_bits_np(visbits_w[k], P),
                }
                with span("replay.track"):
                    tr.track_fused(frame, host_out, snap)
                self.mapper.tick()
                self.image_count += 1
                consumed = k + 1
                cur = tr.current
                poses.append((cur.R, cur.t) if cur is not None and cur.pose_set else None)
                if self.viewer is not None and cur is not None:
                    self.viewer.update(cur, smv)
                if tr.state != State.OK:
                    break
                n_kfs = self.atlas.current.n_keyframes()
                th_margin = 40 if n_kfs < 12 else 33
                if tr.last_kf_frame_id == frame.id:
                    # A keyframe made at this frame changes the map: the rest of
                    # the window tracked a snapshot that is now stale. Its
                    # descriptors are archived LAZILY from the device-resident
                    # desc_w: pulled only if a consumer reads them.
                    kf = tr.last_kf
                    if kf is not None and len(frame.cap_rows):
                        kf.set_desc_thunk(
                            lambda d=out["desc_w"], i=k, r=frame.cap_rows:
                            d[i].cpu().numpy().view(np.uint32)[r]
                        )
                    # Stereo and young maps always rewind (stale-snapshot frames
                    # degrade the gauge while it is still forming). A mature map keeps
                    # consuming: windows are keyframe-ALIGNED, so a mid-window
                    # keyframe only follows a schedule miss, and the stale rest
                    # is tolerated unless the very next frame is already near
                    # the loss gate (30 local-map inliers, Tracking.cc:930).
                    if k + 1 < W and (stereo or n_kfs < 10 or int(scal_w[k + 1, 13]) < th_margin):
                        rewound = True
                        break
                elif (
                    k + 1 < W and 15 < int(scal[13]) < th_margin
                    and self.mapper.cooldown > 1 and frame.id >= tr.last_kf_frame_id + 3
                ):
                    # Thin local-map margin with the next keyframe still frames
                    # away: the reference's mapper inserts keyframes whenever
                    # idle (mMinFrames = 0, Tracking.cc:137), so it would
                    # replenish the map NOW. Break the window, expire the
                    # cooldown so that the next replayed frame makes a keyframe,
                    # and feed the rest again against the refreshed snapshot.
                    self.mapper.cooldown = 0
                    rewound = True
                    break
            if self.atlas.current.imu_init_count != wf["imu_stage"] and (consumed < W or self._wfq):
                # An init stage re-expressed the map and the tracker (a
                # keyframe of this window ran it, or the mapper thread did):
                # the window's later frames and every window chained on it
                # tracked in the old frame. Rewind them, as after a
                # mid-window keyframe; they are tracked again from the
                # rescaled last frame and motion model.
                self.counts["scale_rewinds"] += 1
                rewound = True

            if patch_job is not None:
                # The extended view is window-local: land its visible/found
                # counts on the MapPoints before it goes away.
                snap.flush_stats()
            clean = consumed == W and tr.state == State.OK and not rewound
            if not clean:
                # Rewind the device track state to the last consumed frame,
                # rebuilt on the device from the packed/desc side channels.
                k = consumed - 1
                with span("replay.rebuild"):
                    self._prev_state = TrackState.rebuild(out["packed_w"][k], out["desc_w"][k], int(scal_w[k, 15]))
                self._prev_img = imgs_dev[k]
                self.extractor._next_id_dev = self._prev_state.next_id
            dt = time.perf_counter() - t0
            self.track_ms.extend([1e3 * dt / max(consumed, 1)] * consumed)
            return poses, consumed, clean

    def _flush_windows(self):
        """Drain the windows in flight (if any): replay them and push a
        rewound remainder, then the buffered frames, through the per-frame
        path. Called at every per-frame entry point and at shutdown, so that
        mixed batch/per-frame use and flush=False streams stay consistent."""
        # The buffered frames come after every frame in flight. They are
        # taken out first: track_monocular enters here again.
        pend, self._pending = self._pending, []
        while self._wfq:
            wf = self._wfq.pop(0)
            _, consumed, clean = self._replay_window(wf)
            if not clean:
                pend[:0] = self._rewind(wf, consumed)
        for it in pend:
            if len(it) == 3:
                self.track_stereo(*it)
            else:
                self.track_monocular(*it)

    def track_stereo(self, timestamp, smv, smv_right):
        """System::TrackStereo (System.cc:236-300): the per-stage path on the
        left frame, stereo depth from a left->right LK (core/stereo.py), then
        the state machine. Returns (R, t) or None."""
        if self.sensor != STEREO:
            raise ValueError("sensor not set to Stereo")
        self._flush_windows()
        if self.settings.need_rectify:
            smv, smv_right = rectify_pair(smv, smv_right, self.settings)
        with span("drive.per_frame"):
            t0 = time.perf_counter()
            if self._reset_requested:
                self._prev_state = None
                self._snapshot = None
                self._reset_requested = False
            self._track_per_stage(timestamp, smv, torch.as_tensor(smv.im_gray, device=self.device), smv_right)
            return self._frame_done(t0, smv)

    def global_bundle_adjustment(self, iters=20, mesh=None):
        """Full-map BA over the active map (System::GlobalBundleAdjustment,
        System.cc:162-169): the mapper is drained and its work in flight
        committed, then every keyframe is optimized (the origin fixed) on
        this system's device and written back under the map lock.

        mesh: a torch.distributed process group (every rank calls this on
        the same map). The points are then sharded over its ranks
        (parallel/gba.py) and every rank commits the whole result; like the
        reference's mesh path it solves the monocular rows only."""
        self.mapper.spin(final=True)
        if mesh is not None:
            from ..parallel.gba import global_bundle_adjustment_sharded

            global_bundle_adjustment_sharded(self.atlas.current, self.mapper.camera, mesh,
                                             device=self.device, bf=self.mapper.bf, iters=iters,
                                             map_lock=self.mapper.map_lock)
            return
        global_bundle_adjustment(self.atlas.current, self.mapper.camera, device=self.device,
                                 bf=self.mapper.bf, iters=iters, map_lock=self.mapper.map_lock)

    # --- control ---------------------------------------------------------
    def reset_active_map(self):
        Verbose.log("SYSTEM-> Resetting active map")
        self.tracking.reset_active_map()
        self._reset_requested = True

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (System.h:118-121, System.cc:171-234):
        freeze mapping and track against the frozen map, with no keyframes,
        triangulation, BA or new-map recovery. Everything in flight lands
        first: the windows, the queued keyframes, the staged and launched
        mapper jobs and the pending BA."""
        self._flush_windows()
        if self.async_mapping:
            self.mapper.wait_idle()
        self.mapper.spin(final=True)
        self.mapper.dispatch_staged_async()
        self.mapper.poke_commit(blocking=True)
        self.tracking.only_tracking = True

    def deactivate_localization_mode(self):
        """System::DeactivateLocalizationMode: resume mapping."""
        self._flush_windows()
        self.tracking.only_tracking = False

    def localization_mode_active(self):
        return self.tracking.only_tracking

    def shutdown(self):
        self._flush_windows()
        if self._snapshot is not None:
            self._snapshot.flush_stats()
        if self.async_mapping:
            self.mapper.stop_thread()
        self.mapper.spin(final=True)
        if self.settings.save_atlas:
            self.save_atlas(self.settings.save_atlas)

    # --- counters (results.txt contract) ---------------------------------
    def get_total_lost(self):
        return self.tracking.lost_count

    def get_fps(self):
        return self.settings.fps

    def mean_track_ms(self):
        return float(np.mean(self.track_ms)) if self.track_ms else 0.0

    def get_timings(self):
        """Per-stage host times in ms, as n / mean / p50 / p95 (the
        reference's REGISTER_TIMES, Tracking.h:165-178, LocalMapping.h:107-123)."""
        def stats(xs):
            if not xs:
                return {"n": 0}
            a = np.asarray(xs)
            return {"n": len(a), "mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
                    "p95": float(np.percentile(a, 95))}

        out = {k: stats(v) for k, v in self.tracking.timings.items()}
        out["frame_total"] = stats(self.track_ms)
        out["local_ba"] = stats(self.mapper.lba_ms)
        return out

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

    # --- checkpoint (System::SaveAtlas / LoadAtlas, System.cc:1014-1098) ------
    def save_atlas(self, filename):
        save_atlas(self.atlas, filename)
        Verbose.log(f"Atlas saved to {filename}")

    def load_atlas(self, filename):
        """Replace the atlas with the one in the file; the mapper and the
        tracker work on it from the next frame on."""
        self.atlas = load_atlas(filename)
        self.mapper.atlas = self.atlas
        self.tracking.atlas = self.atlas
        Verbose.log(f"Atlas loaded from {filename}")
