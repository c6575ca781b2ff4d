"""Per-frame motion-vector bundle with fixed-capacity padded arrays.

The port's own copy of movslam_tpu/io/mvimage.py, cut to what the port
calls (numpy only). `FrameType` keeps the reference's `IntEnum` values, so a
frame type compares equal across the two packages.

Host-side equivalent of the C++ reference's MotionVectorImage (Frame.h:109-156):
the MV chain records are kept as flat arrays padded to static capacities,
and the per-track candidate lookup is a batched point-in-rect join on the
device (ops/mvselect.py).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class FrameType(enum.IntEnum):
    I_FRAME = 0
    P_FRAME = 1
    B_FRAME = 2


# Default capacities (640x480 has ~1200 16x16 blocks; multi-ref MVs multiply
# chain records).
MAX_MVS = 4096
MAX_KPS = 2048


@dataclasses.dataclass
class MotionVectorImage:
    """One decoded frame + its motion-vector side data.

    mv_delta[i]   : per-hop displacement (dx, dy); a track at p in the
                    previous frame moves to p + mv_delta[i]
                    (VideoDecoder.cc:220-224, MOVExtractor.cc:283).
    mv_rect[i]    : source block as inclusive bounds (x0, y0, x1, y1)
                    (VideoDecoder.cc:294-345).
    mv_dindx[i]   : index into kps of the destination block this chain record
                    terminates at, or -1 for intermediate hops
                    (VideoDecoder.cc:243-253).
    kps_rect[k]   : destination macroblocks (x, y, w, h) — candidate seeds for
                    new tracks (VideoDecoder.cc:244-253).
    coverage_area : fraction of the frame covered by MV destination blocks
                    (VideoDecoder.cc:347-350).
    """

    width: int
    height: int
    frame_no: int = 0
    timestamp: float = 0.0
    ft: FrameType = FrameType.P_FRAME

    im_gray: np.ndarray | None = None  # (H, W) uint8
    im_rgb: np.ndarray | None = None  # (H, W, 3) uint8, when the decoder runs with rgb=True

    mv_delta: np.ndarray | None = None  # (MAX_MVS, 2) f32
    mv_rect: np.ndarray | None = None  # (MAX_MVS, 4) f32 inclusive x0,y0,x1,y1
    mv_dindx: np.ndarray | None = None  # (MAX_MVS,) i32
    n_mvs: int = 0

    kps_rect: np.ndarray | None = None  # (MAX_KPS, 4) f32 x,y,w,h
    n_kps: int = 0

    coverage_area: float = 0.0

    # B-frame forward-prediction records (the C++ reference's bmap,
    # VideoDecoder.cc:255-286: collected there, read nowhere; so here).
    bmv_delta: np.ndarray | None = None  # (n_bmvs, 2) f32
    bmv_rect: np.ndarray | None = None  # (n_bmvs, 4) f32
    n_bmvs: int = 0

    @staticmethod
    def empty(width, height, max_mvs=MAX_MVS, max_kps=MAX_KPS):
        smv = MotionVectorImage(width=width, height=height)
        smv.im_gray = np.zeros((height, width), np.uint8)
        smv.mv_delta = np.zeros((max_mvs, 2), np.float32)
        smv.mv_rect = np.full((max_mvs, 4), -1.0, np.float32)
        smv.mv_dindx = np.full((max_mvs,), -1, np.int32)
        smv.kps_rect = np.zeros((max_kps, 4), np.float32)
        return smv

    def add_mv(self, delta_xy, rect_x0y0x1y1, dindx=-1):
        i = self.n_mvs
        if i >= self.mv_delta.shape[0]:
            return -1  # capacity overflow: drop (the C++ reference never bounds this)
        self.mv_delta[i] = delta_xy
        self.mv_rect[i] = rect_x0y0x1y1
        self.mv_dindx[i] = dindx
        self.n_mvs += 1
        return i

    def add_kp(self, rect_xywh):
        k = self.n_kps
        if k >= self.kps_rect.shape[0]:
            return -1
        self.kps_rect[k] = rect_xywh
        self.n_kps += 1
        return k

    def packed(self):
        """mv_pack (M, 8) f32 [delta(2) rect(4) dindx valid] and kps_pack
        (K, 5) f32 [rect(4) valid]: one host->device copy each."""
        M = self.mv_delta.shape[0]
        mv_pack = np.zeros((M, 8), np.float32)
        mv_pack[:, 0:2] = self.mv_delta
        mv_pack[:, 2:6] = self.mv_rect
        mv_pack[:, 6] = self.mv_dindx
        mv_pack[: self.n_mvs, 7] = 1.0
        K = self.kps_rect.shape[0]
        kps_pack = np.zeros((K, 5), np.float32)
        kps_pack[:, 0:4] = self.kps_rect
        kps_pack[: self.n_kps, 4] = 1.0
        return mv_pack, kps_pack

    def packed_joint(self):
        """ONE host->device copy for all per-frame MV data: (M+K, 8) f32
        where rows [0:M] are mv_pack and rows [M:M+K] hold kps rect(4)+valid
        in the first 5 columns. Returns (arr, M)."""
        mv_pack, kps_pack = self.packed()
        M, K = mv_pack.shape[0], kps_pack.shape[0]
        joint = np.zeros((M + K, 8), np.float32)
        joint[:M] = mv_pack
        joint[M:, 0:5] = kps_pack
        return joint, M

    def packed_joint_i16(self):
        """Half-width upload for the windowed drive: (M+K+1, 8) i16 with the
        row layout of packed_joint plus ONE trailer row. Block rects can be
        fractional (quarter-pel-shifted source rects, synthetic continuous
        flow): they are ROUNDED to the nearest pixel before the i16 cast
        (truncation would shift inclusive rect bounds by up to ~1 px);
        dindx/valid are small integers, exact in i16. The per-hop delta is
        stored in 1/64-pel fixed point (the decoder emits motion/4/(ref+1),
        so ref in {0, 1, 3} is exact and other refs round at ~0.008 px). The
        trailer row carries coverage_area in Q14. Returns (arr_i16, M)."""
        M = self.mv_delta.shape[0]
        K = self.kps_rect.shape[0]
        joint = np.zeros((M + K + 1, 8), np.int16)
        np.clip(
            np.round(self.mv_delta * 64.0), -32767, 32767,
            out=joint[:M, 0:2], casting="unsafe",
        )
        joint[:M, 2:6] = np.round(self.mv_rect)
        joint[:M, 6] = self.mv_dindx
        joint[: self.n_mvs, 7] = 1
        joint[M : M + K, 0:4] = np.round(self.kps_rect)
        joint[M : M + self.n_kps, 4] = 1
        joint[M + K, 0] = int(round(self.coverage_area * 16384.0))
        return joint, M
