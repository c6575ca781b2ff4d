"""Headless viewer: frame overlays + top-down map renders to PNG.

Port of movslam_tpu/viz/viewer.py, which replaces the C++ reference's
Pangolin/imshow Viewer/FrameDrawer/MapDrawer (Viewer.cc, FrameDrawer.cc,
MapDrawer.cc) with an offscreen renderer: no GL dependency; frames are
drawn with cv2 primitives and saved on demand or streamed to a directory.

It reads host-side state only (the Frame's numpy track ids, points,
map-point slots and outlier flags, the atlas, the tracking state), so it
adds no device sync. cv2 is imported inside the drawing calls: the package
imports without it, and a host without it renders and writes nothing and
says so once.
"""
from __future__ import annotations

import os

import numpy as np


class Viewer:
    def __init__(self, system, out_dir=None, every=1, history=12):
        self.system = system
        self.out_dir = out_dir
        self.every = max(1, every)
        self.count = 0
        self.last_frame_render = None
        self.history = history
        self._tracks = {}  # track_id -> list of recent points
        self._said_no_cv2 = False
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def _cv2(self):
        """cv2, or None (and one line saying so) on a host without it."""
        try:
            import cv2
        except ImportError:
            if not self._said_no_cv2:
                self._said_no_cv2 = True
                print("viewer: cv2 is not installed; nothing is rendered or written")
            return None
        return cv2

    def update(self, frame, smv):
        self.count += 1
        # Track-history polylines (FrameDrawer's green VideoFeature trails,
        # FrameDrawer.cc:129-190).
        seen = set()
        for tid, pt in zip(frame.track_ids, getattr(frame, 'pts_raw', frame.pts)):
            tid = int(tid)
            seen.add(tid)
            self._tracks.setdefault(tid, []).append(tuple(pt))
            if len(self._tracks[tid]) > self.history:
                self._tracks[tid] = self._tracks[tid][-self.history:]
        for tid in list(self._tracks):
            if tid not in seen:
                del self._tracks[tid]
        if self.count % self.every:
            return
        img = self.draw_frame(frame, smv)
        self.last_frame_render = img
        cv2 = self._cv2()
        if self.out_dir is not None and cv2 is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            cv2.imwrite(os.path.join(self.out_dir, f"frame_{self.count:06d}.png"), img)

    def draw_frame(self, frame, smv):
        """FrameDrawer::DrawFrame: tracked features as rectangles/circles,
        map-point matches highlighted (FrameDrawer.cc:36-367)."""
        img = smv.im_gray
        out = np.stack([img] * 3, axis=-1).copy()
        cv2 = self._cv2()
        if cv2 is None:
            return out
        for i in range(frame.n):
            pr = getattr(frame, 'pts_raw', frame.pts)
            x, y = int(pr[i, 0]), int(pr[i, 1])
            trail = self._tracks.get(int(frame.track_ids[i]), [])
            if len(trail) > 1:
                pts = np.asarray(trail, np.int32).reshape(-1, 1, 2)
                cv2.polylines(out, [pts], False, (0, 200, 0), 1)
            if frame.mappoints[i] is not None and not frame.outlier[i]:
                cv2.rectangle(out, (x - 4, y - 4), (x + 4, y + 4), (0, 255, 0), 1)
                cv2.circle(out, (x, y), 1, (0, 255, 0), -1)
            else:
                cv2.circle(out, (x, y), 1, (255, 0, 0), -1)
        state = self.system.tracking.state.name
        n_mp = sum(1 for mp in frame.mappoints if mp is not None)
        cv2.putText(
            out, f"{state}  tracks:{frame.n} matches:{n_mp}",
            (10, out.shape[0] - 10), cv2.FONT_HERSHEY_PLAIN, 1.0, (255, 255, 255), 1,
        )
        return out

    def draw_map(self, size=640, covis=True, frusta=True):
        """MapDrawer top-down (x-z) view (MapDrawer.cc equivalents):
        map points (black), keyframe frusta (blue wedges along the optical
        axis, DrawKeyFrames), covisibility graph edges (light green lines
        between covisible keyframes, DrawGraph ≥15-obs edges), spanning-tree
        edges (dark green), and the current camera (red)."""
        out = np.full((size, size, 3), 255, np.uint8)
        cv2 = self._cv2()
        if cv2 is None:
            return out
        m = self.system.atlas.current
        pts = [mp.pos for mp in m.mappoints.values() if not mp.bad]
        live = {kf.id: kf for kf in m.keyframes.values() if not kf.bad}
        kfs = [kf.center() for kf in live.values()]
        if not pts and not kfs:
            return out
        allp = np.array(pts + kfs)
        lo = allp.min(axis=0) - 1
        hi = allp.max(axis=0) + 1
        span = max(hi[0] - lo[0], hi[2] - lo[2])

        def to_px(p):
            return (
                int((p[0] - lo[0]) / span * (size - 20)) + 10,
                int((p[2] - lo[2]) / span * (size - 20)) + 10,
            )

        for p in pts:
            cv2.circle(out, to_px(p), 1, (0, 0, 0), -1)
        if covis:
            # Covisibility edges (draw once per pair) + spanning tree.
            for kf in live.values():
                a = to_px(kf.center())
                for oid in kf.covis:
                    if oid > kf.id and oid in live:
                        cv2.line(out, a, to_px(live[oid].center()),
                                 (144, 238, 144), 1)
                if kf.parent is not None and kf.parent.id in live:
                    cv2.line(out, a, to_px(live[kf.parent.id].center()),
                             (0, 128, 0), 1)
        for kf in live.values():
            c = kf.center()
            px = to_px(c)
            if frusta:
                # Wedge along the camera optical axis (world z of R^T e_z).
                fwd = kf.R.T @ np.array([0.0, 0.0, 1.0])
                f2 = np.array([fwd[0], fwd[2]])
                n = np.linalg.norm(f2)
                if n > 1e-6:
                    f2 /= n
                    side = np.array([-f2[1], f2[0]])
                    L = max(4, size // 80)
                    tip = (px[0] + int(f2[0] * L), px[1] + int(f2[1] * L))
                    wl = (px[0] + int((f2[0] * L + side[0] * L * 0.5) * 0.7),
                          px[1] + int((f2[1] * L + side[1] * L * 0.5) * 0.7))
                    wr = (px[0] + int((f2[0] * L - side[0] * L * 0.5) * 0.7),
                          px[1] + int((f2[1] * L - side[1] * L * 0.5) * 0.7))
                    cv2.line(out, px, wl, (255, 0, 0), 1)
                    cv2.line(out, px, wr, (255, 0, 0), 1)
                    cv2.line(out, wl, tip, (255, 0, 0), 1)
                    cv2.line(out, wr, tip, (255, 0, 0), 1)
            cv2.circle(out, px, 2, (255, 0, 0), -1)
        cur = self.system.tracking.current
        if cur is not None and cur.pose_set:
            cc = -(cur.R.T @ cur.t)
            cv2.circle(out, to_px(cc), 4, (0, 0, 255), -1)
        return out
