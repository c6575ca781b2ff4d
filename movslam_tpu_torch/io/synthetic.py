"""Synthetic motion-vector stream — the fake decoder backend.

Port of movslam_tpu/io/synthetic.py (numpy only; it differs from the
reference only in taking the port's Pinhole, so both packages render the
same frames from the same seed).

Renders a known camera trajectory over a 3D scene (textured background plane
plus foreground point patches) and emits MotionVectorImage frames with
*exact* motion vectors, fulfilling the test-strategy gap noted in SURVEY.md
§4: the full pipeline is testable without FFmpeg or datasets, with
ground-truth poses for ATE checks.

Codec emulation: like a real H.264 encoder, motion vectors are emitted for a
16x16 macroblock grid tiling the WHOLE frame — each destination block carries
the true optical flow at its center (foreground patch flow where a patch
covers it, background-plane flow elsewhere). Geometry conventions match the
decoder semantics (the reference decoder's VideoDecoder.cc:211-350):
  - mv delta = dst - src: a feature at p in frame t-1 moves to p + delta.
  - source rects are inclusive pixel bounds, clamped to the image.
  - destination blocks out of bounds bottom/right are dropped.
  - coverage = sum of destination block areas / image area.

Each foreground point carries a distinctive stripe texture patch so the
EXPRESS detector fires on it and descriptors stay stable under tracking.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.camera import Pinhole
from .mvimage import FrameType, MotionVectorImage

MB = 16


def _make_patch(rng, size=20):
    """A stripe-textured patch that passes EXPRESS (bright stripe on flat bg)."""
    patch = np.full((size, size), 128, np.float32)
    orient = rng.integers(0, 4)
    off = rng.integers(3, size - 9)
    width = rng.integers(4, 7)
    lo, hi = (40, 235) if rng.integers(0, 2) else (235, 40)
    patch[:] = lo
    if orient == 0:
        patch[:, off : off + width] = hi
    elif orient == 1:
        patch[off : off + width, :] = hi
    else:
        rr, cc = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        diag = rr + cc if orient == 2 else rr - cc + size
        patch[(diag >= off) & (diag < off + 2 * width)] = hi
    return patch


def _smooth_texture(rng, size=1024):
    """Low-frequency texture: blurred noise, mild contrast (LK-trackable but
    rarely EXPRESS-triggering)."""
    t = rng.normal(0, 1, (size // 8, size // 8))
    t = np.kron(t, np.ones((8, 8)))
    k = np.ones(9) / 9.0
    for axis in (0, 1):
        t = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, t)
    t = (t - t.min()) / (np.ptp(t) + 1e-9)
    return (80 + t * 90).astype(np.float32)  # range [80, 170]


def _orbit_pose(t, radius=0.8, z_amp=0.15):
    """Smooth camera-from-world pose at time t: gentle lateral arc + yaw."""
    ang = 0.15 * t
    C = np.array(
        [radius * np.sin(ang), 0.3 * np.sin(0.5 * ang), z_amp * np.sin(0.8 * ang)]
    )
    yaw = 0.05 * np.sin(ang)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    R_cw = R_wc.T
    t_cw = -R_cw @ C
    return R_cw.astype(np.float32), t_cw.astype(np.float32)


@dataclasses.dataclass
class SyntheticStream:
    """Iterable synthetic MV video with ground truth."""

    n_points: int = 400
    width: int = 640
    height: int = 480
    fps: float = 30.0
    seed: int = 0
    keyint: int = 1000  # I-frame interval (reference README uses keyint=1000)
    max_mvs: int = 4096
    max_kps: int = 2048
    bg_depth: float = 30.0
    pose_fn: object = None  # t -> (R_cw, t_cw); default _orbit_pose

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.camera = Pinhole(
            320.0, 320.0, self.width / 2, self.height / 2, self.width, self.height
        )
        # Foreground points in a slab in front of the initial camera.
        self.points = np.stack(
            [
                rng.uniform(-8, 8, self.n_points),
                rng.uniform(-6, 6, self.n_points),
                rng.uniform(5, 14, self.n_points),
            ],
            axis=-1,
        ).astype(np.float32)
        self.patches = [_make_patch(rng) for _ in range(self.n_points)]
        self.bg_tex = _smooth_texture(rng)
        self.pose_fn = self.pose_fn or _orbit_pose
        self._rng = rng

    # --- ground truth ----------------------------------------------------
    def gt_pose(self, frame_idx):
        """Ground-truth camera-from-world (R_cw, t_cw) at frame index."""
        return self.pose_fn(float(frame_idx))

    def _project(self, frame_idx):
        R, t = self.gt_pose(frame_idx)
        pc = self.points @ R.T + t
        z = pc[:, 2]
        uv = np.stack(
            [
                self.camera.fx * pc[:, 0] / np.maximum(z, 1e-6) + self.camera.cx,
                self.camera.fy * pc[:, 1] / np.maximum(z, 1e-6) + self.camera.cy,
            ],
            axis=-1,
        )
        vis = (z > 0.5) & self.camera.in_image(uv, margin=12)
        return uv.astype(np.float32), vis

    def _bg_world(self, frame_idx, uv):
        """World (X, Y) on the z=bg_depth plane seen at pixels uv (..., 2)."""
        R, t = self.gt_pose(frame_idx)
        C = -R.T @ t  # camera center in world
        rays_c = np.stack(
            [
                (uv[..., 0] - self.camera.cx) / self.camera.fx,
                (uv[..., 1] - self.camera.cy) / self.camera.fy,
                np.ones_like(uv[..., 0]),
            ],
            axis=-1,
        )
        rays_w = rays_c @ R  # R_wc = R.T; (r @ R) == R.T @ r rowwise
        s = (self.bg_depth - C[2]) / rays_w[..., 2]
        return C[None, :2] + s[..., None] * rays_w[..., :2] if uv.ndim == 2 else C[:2] + s[..., None] * rays_w[..., :2]

    def _bg_project(self, frame_idx, world_xy):
        """Project world points on the bg plane into frame frame_idx pixels."""
        R, t = self.gt_pose(frame_idx)
        P = np.concatenate(
            [world_xy, np.full(world_xy.shape[:-1] + (1,), self.bg_depth, np.float32)],
            axis=-1,
        )
        pc = P @ R.T + t
        return np.stack(
            [
                self.camera.fx * pc[..., 0] / pc[..., 2] + self.camera.cx,
                self.camera.fy * pc[..., 1] / pc[..., 2] + self.camera.cy,
            ],
            axis=-1,
        ).astype(np.float32)

    # --- rendering ---------------------------------------------------------
    def render(self, frame_idx):
        """Gray image: textured background plane + foreground patches."""
        uu, vv = np.meshgrid(
            np.arange(self.width, dtype=np.float32),
            np.arange(self.height, dtype=np.float32),
        )
        uv = np.stack([uu, vv], axis=-1)
        w_xy = self._bg_world(frame_idx, uv.reshape(-1, 2)).reshape(
            self.height, self.width, 2
        )
        T = self.bg_tex.shape[0]
        tx = (w_xy[..., 0] * 18.0) % T
        ty = (w_xy[..., 1] * 18.0) % T
        x0 = np.floor(tx).astype(np.int64) % T
        y0 = np.floor(ty).astype(np.int64) % T
        x1 = (x0 + 1) % T
        y1 = (y0 + 1) % T
        fx = tx - np.floor(tx)
        fy = ty - np.floor(ty)
        img = (
            self.bg_tex[y0, x0] * (1 - fx) * (1 - fy)
            + self.bg_tex[y0, x1] * fx * (1 - fy)
            + self.bg_tex[y1, x0] * (1 - fx) * fy
            + self.bg_tex[y1, x1] * fx * fy
        )

        uv_pts, vis = self._project(frame_idx)
        for i in np.flatnonzero(vis):
            p = self.patches[i]
            s = p.shape[0]
            cx, cy = int(uv_pts[i, 0]), int(uv_pts[i, 1])
            x0_, y0_ = cx - s // 2, cy - s // 2
            x1_, y1_ = x0_ + s, y0_ + s
            if x0_ < 0 or y0_ < 0 or x1_ > self.width or y1_ > self.height:
                continue
            img[y0_:y1_, x0_:x1_] = p
        return np.clip(img, 0, 255).astype(np.uint8), uv_pts, vis

    # --- MV synthesis ------------------------------------------------------
    def _block_flow(self, frame_idx, centers):
        """True src position in frame-1 for pixels `centers` (B, 2) of frame."""
        uv_cur, vis_cur = self._project(frame_idx)
        uv_prev, vis_prev = self._project(frame_idx - 1)
        both = vis_cur & vis_prev

        # Background flow: bg-plane point seen at center, projected into prev.
        w_xy = self._bg_world(frame_idx, centers)
        src = self._bg_project(frame_idx - 1, w_xy)

        # Foreground override: nearest visible point whose patch covers center.
        if both.any():
            fg_uv = uv_cur[both]
            fg_prev = uv_prev[both]
            d = np.linalg.norm(centers[:, None, :] - fg_uv[None, :, :], axis=-1)
            j = np.argmin(d, axis=1)
            covered = d[np.arange(len(centers)), j] <= 10.0  # patch half-size
            flow_fg = fg_uv[j] - fg_prev[j]
            src = np.where(covered[:, None], centers - flow_fg, src)
        return src

    def frame(self, frame_idx):
        """Build the MotionVectorImage for frame_idx."""
        smv = MotionVectorImage.empty(
            self.width, self.height, self.max_mvs, self.max_kps
        )
        smv.frame_no = frame_idx
        smv.timestamp = frame_idx / self.fps
        smv.ft = (
            FrameType.I_FRAME if frame_idx % self.keyint == 0 else FrameType.P_FRAME
        )

        img, _, _ = self.render(frame_idx)
        smv.im_gray = img

        if smv.ft == FrameType.P_FRAME:
            # Macroblock grid of destination blocks tiling the frame.
            gx = np.arange(MB // 2, self.width - MB // 2, MB, dtype=np.float32)
            gy = np.arange(MB // 2, self.height - MB // 2, MB, dtype=np.float32)
            cx, cy = np.meshgrid(gx, gy)
            centers = np.stack([cx.ravel(), cy.ravel()], axis=-1)
            srcs = self._block_flow(frame_idx, centers)

            coverage = 0.0
            for c, s in zip(centers, srcs):
                if c[0] + MB / 2 >= self.width or c[1] + MB / 2 >= self.height:
                    continue  # VideoDecoder.cc:236-241 drops these
                dx0 = max(c[0] - MB / 2, 0.0)
                dy0 = max(c[1] - MB / 2, 0.0)
                dindx = smv.add_kp((dx0, dy0, MB, MB))
                sx0 = max(s[0] - MB / 2, 0.0)
                sy0 = max(s[1] - MB / 2, 0.0)
                sx1 = min(s[0] + MB / 2, self.width - 1)
                sy1 = min(s[1] + MB / 2, self.height - 1)
                smv.add_mv((c[0] - s[0], c[1] - s[1]), (sx0, sy0, sx1, sy1), dindx)
                coverage += MB * MB
            smv.coverage_area = coverage / float(self.width * self.height)
        return smv

    def frames(self, n, start=0):
        for k in range(start, start + n):
            yield self.frame(k)
