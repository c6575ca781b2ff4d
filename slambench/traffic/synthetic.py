"""The benchmark's frozen copy of the port's synthetic motion-vector streams.

A copy of movslam_tpu_torch/io/synthetic.py (numpy only, no import of the
port), so that later changes to the port's generators cannot move the
yardstick. It renders the same frames from the
same seed (slambench/tests/test_slambench_traffic.py holds the two equal),
with two differences that change no number: the pinhole camera is a
parameter (the port's stream fixes fx = fy = 320 at the image centre), and
a frame is a dict of plain arrays cut to its used rows, not the port's
MotionVectorImage; the drives copy it into the port's input type.

The scene: a textured background plane at z = bg_depth and n_points
foreground points in a slab in front of the first camera, each with a
stripe patch, seen along a fixed smooth orbit (`_orbit_pose`, a function of
the frame index). A P-frame carries one motion vector per 16x16 macroblock
tiling the image, with the true flow at the block's centre.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MB = 16
I_FRAME, P_FRAME = 0, 1  # the port's FrameType values


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def in_image(self, uv, margin=0):
        return (
            (uv[..., 0] >= margin) & (uv[..., 0] < self.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < self.height - margin)
        )


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
    """Low-frequency texture: blurred noise, mild contrast."""
    t = rng.normal(0, 1, (size // 8, size // 8))
    t = np.kron(t, np.ones((8, 8)))
    k = np.ones(9) / 9.0
    for axis in (0, 1):
        t = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, t)
    t = (t - t.min()) / (np.ptp(t) + 1e-9)
    return (80 + t * 90).astype(np.float32)  # range [80, 170]


def _orbit_pose(t, radius=0.8, z_amp=0.15):
    """Camera-from-world pose at frame time t: gentle lateral arc + yaw."""
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


PATHS = {"orbit": _orbit_pose}


class Scene:
    """One seeded synthetic sequence seen by `camera` at `fps`."""

    def __init__(self, camera, fps, seed, n_points=400, keyint=1000, path="orbit",
                 bg_depth=30.0):
        self.camera, self.fps, self.keyint, self.bg_depth = camera, float(fps), keyint, bg_depth
        self.width, self.height = camera.width, camera.height
        self.pose_fn = PATHS[path]
        rng = np.random.default_rng(seed)
        self.points = np.stack(
            [
                rng.uniform(-8, 8, n_points),
                rng.uniform(-6, 6, n_points),
                rng.uniform(5, 14, n_points),
            ],
            axis=-1,
        ).astype(np.float32)
        self.patches = [_make_patch(rng) for _ in range(n_points)]
        self.bg_tex = _smooth_texture(rng)

    # --- ground truth ----------------------------------------------------
    def gt_pose(self, frame_idx):
        """Ground-truth camera-from-world (R_cw, t_cw) at frame index."""
        return self.pose_fn(float(frame_idx))

    def _project(self, frame_idx):
        R, t = self.gt_pose(frame_idx)
        pc = self.points @ R.T + t
        z = pc[:, 2]
        cam = self.camera
        uv = np.stack(
            [
                cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx,
                cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy,
            ],
            axis=-1,
        )
        vis = (z > 0.5) & cam.in_image(uv, margin=12)
        return uv.astype(np.float32), vis

    def _bg_world(self, frame_idx, uv):
        """World (X, Y) on the z = bg_depth plane seen at pixels uv (N, 2)."""
        R, t = self.gt_pose(frame_idx)
        C = -R.T @ t
        cam = self.camera
        rays_c = np.stack(
            [
                (uv[..., 0] - cam.cx) / cam.fx,
                (uv[..., 1] - cam.cy) / cam.fy,
                np.ones_like(uv[..., 0]),
            ],
            axis=-1,
        )
        rays_w = rays_c @ R
        s = (self.bg_depth - C[2]) / rays_w[..., 2]
        return C[None, :2] + s[..., None] * rays_w[..., :2]

    def _bg_project(self, frame_idx, world_xy):
        """Project world points on the bg plane into frame frame_idx pixels."""
        R, t = self.gt_pose(frame_idx)
        P = np.concatenate(
            [world_xy, np.full(world_xy.shape[:-1] + (1,), self.bg_depth, np.float32)],
            axis=-1,
        )
        pc = P @ R.T + t
        cam = self.camera
        return np.stack(
            [
                cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                cam.fy * pc[..., 1] / pc[..., 2] + cam.cy,
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
        w_xy = self._bg_world(frame_idx, uv.reshape(-1, 2)).reshape(self.height, self.width, 2)
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
        return np.clip(img, 0, 255).astype(np.uint8)

    # --- MV synthesis ------------------------------------------------------
    def _block_flow(self, frame_idx, centers):
        """True src position in frame-1 for pixels `centers` (B, 2) of frame."""
        uv_cur, vis_cur = self._project(frame_idx)
        uv_prev, vis_prev = self._project(frame_idx - 1)
        both = vis_cur & vis_prev
        w_xy = self._bg_world(frame_idx, centers)
        src = self._bg_project(frame_idx - 1, w_xy)
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
        """Frame frame_idx as plain arrays: im_gray (H, W) u8; ft; timestamp;
        on a P-frame mv_delta (M, 2), mv_rect (M, 4) inclusive x0 y0 x1 y1,
        mv_dindx (M,) and kps_rect (M, 4) x y w h, one row per macroblock
        kept, and coverage; gt_R, gt_t the ground-truth pose."""
        ft = I_FRAME if frame_idx % self.keyint == 0 else P_FRAME
        out = {"ft": ft, "timestamp": frame_idx / self.fps, "im_gray": self.render(frame_idx)}
        delta = np.zeros((0, 2), np.float32)
        rect = np.zeros((0, 4), np.float32)
        kps = np.zeros((0, 4), np.float32)
        coverage = 0.0
        if ft == P_FRAME:
            gx = np.arange(MB // 2, self.width - MB // 2, MB, dtype=np.float32)
            gy = np.arange(MB // 2, self.height - MB // 2, MB, dtype=np.float32)
            cx, cy = np.meshgrid(gx, gy)
            centers = np.stack([cx.ravel(), cy.ravel()], axis=-1)
            srcs = self._block_flow(frame_idx, centers)
            # Blocks out of bounds bottom/right are dropped (the reference
            # decoder's VideoDecoder.cc:236-241).
            keep = (centers[:, 0] + MB / 2 < self.width) & (centers[:, 1] + MB / 2 < self.height)
            c, s = centers[keep], srcs[keep]
            kps = np.zeros((len(c), 4), np.float32)
            kps[:, 0] = np.maximum(c[:, 0] - MB / 2, 0.0)
            kps[:, 1] = np.maximum(c[:, 1] - MB / 2, 0.0)
            kps[:, 2:] = MB
            rect = np.zeros((len(c), 4), np.float32)
            rect[:, 0] = np.maximum(s[:, 0] - MB / 2, 0.0)
            rect[:, 1] = np.maximum(s[:, 1] - MB / 2, 0.0)
            rect[:, 2] = np.minimum(s[:, 0] + MB / 2, self.width - 1)
            rect[:, 3] = np.minimum(s[:, 1] + MB / 2, self.height - 1)
            delta = (c - s).astype(np.float32)
            coverage = len(c) * MB * MB / float(self.width * self.height)
        out.update(mv_delta=delta, mv_rect=rect, kps_rect=kps, coverage=coverage,
                   mv_dindx=np.arange(len(delta), dtype=np.int32))
        R, t = self.gt_pose(frame_idx)
        out.update(gt_R=R, gt_t=t)
        return out
