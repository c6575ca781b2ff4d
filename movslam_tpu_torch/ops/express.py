"""Batched EXPRESS detector/descriptor for 16x16 macroblocks.

Port of movslam_tpu/ops/express.py (see there for the algorithm and its
documented divergences from the C++ reference). `gather_blocks` is direct
clamped indexing here; the reference's one-hot bf16 matmuls were a TPU
gather workaround and give the same integer pixels.
"""
from __future__ import annotations

import numpy as np
import torch

from .bitdesc import pack_bits

BLOCK = 16
N_SLICES = 2 * BLOCK - 1  # 31 diagonals per orientation
ROUNDS = int(round(N_SLICES * 0.25))  # 8: required streak length
PRECHECK = int(BLOCK * BLOCK * 0.125)  # 32: minimum extreme pixels


def _build_diag_tables():
    """Diagonal membership masks (256, 62) and lengths (62,) for the main
    (col - row = const) and anti (row + col = const) orientations."""
    idx = np.arange(BLOCK * BLOCK)
    r, c = idx // BLOCK, idx % BLOCK
    main_d = (c - r) + (BLOCK - 1)
    anti_d = r + c
    masks = np.zeros((BLOCK * BLOCK, 2 * N_SLICES), np.float32)
    masks[idx, main_d] = 1.0
    masks[idx, N_SLICES + anti_d] = 1.0
    lengths = masks.sum(0)
    return masks, lengths


_DIAG_MASKS, _DIAG_LENGTHS = _build_diag_tables()


def _has_run(b, run_len):
    """True where the boolean (..., N) sequence holds `run_len` Trues in a row."""
    cs = torch.cumsum(b.to(torch.int32), dim=-1)
    cs = torch.nn.functional.pad(cs, (1, 0))
    win = cs[..., run_len:] - cs[..., :-run_len]
    return (win == run_len).any(-1)


def block_center(blocks):
    """Floor of the mean of the 4 central pixels: (..., 16, 16) -> (...,) f32."""
    c = blocks[..., BLOCK // 2 - 1 : BLOCK // 2 + 1, BLOCK // 2 - 1 : BLOCK // 2 + 1]
    return torch.floor(c.to(torch.float32).mean(dim=(-2, -1)))


def extreme_mask(blocks, threshold):
    """Per-pixel extreme classification: (..., 16, 16) -> (..., 256) bool."""
    b = blocks.to(torch.float32)
    center = block_center(blocks)[..., None, None]
    thr = float(threshold)
    ex = (b < center - thr) | (b > center + thr)
    return ex.reshape(ex.shape[:-2] + (BLOCK * BLOCK,))


def compute_descriptor(blocks, threshold):
    """Batched descriptor: (..., 16, 16) -> (..., 8) int32."""
    return pack_bits(extreme_mask(blocks, threshold))


def _express_pass(ex):
    """EXPRESS cornerness test on extreme masks (..., 256) -> (...,) bool."""
    prefilter = ex.sum(-1) >= PRECHECK
    masks = torch.as_tensor(_DIAG_MASKS, device=ex.device)
    lengths = torch.as_tensor(_DIAG_LENGTHS, device=ex.device)
    sums = ex.to(torch.float32) @ masks  # exact: integer counts <= 16
    winb = sums * 2.0 >= lengths
    w_main, w_anti = winb[..., :N_SLICES], winb[..., N_SLICES:]
    ok_main = _has_run(w_main, ROUNDS) & _has_run(~w_main, ROUNDS)
    ok_anti = _has_run(w_anti, ROUNDS) & _has_run(~w_anti, ROUNDS)
    return prefilter & (ok_main | ok_anti)


def compute_express(blocks, threshold):
    """Batched detector: (..., 16, 16) -> (...,) bool."""
    return _express_pass(extreme_mask(blocks, threshold))


def detect_and_describe(blocks, threshold):
    """Fused detector + descriptor: returns (pass (B,) bool, desc (B, 8) i32)."""
    ex = extreme_mask(blocks, threshold)
    return _express_pass(ex), pack_bits(ex)


def gather_blocks(img, tl_xy):
    """16x16 blocks at integer top-left (x, y), clamped into the image.

    img: (H, W); tl_xy: (B, 2) int. Returns (B, 16, 16) f32."""
    H, W = img.shape
    x0 = tl_xy[:, 0].clamp(0, W - BLOCK).to(torch.int64)
    y0 = tl_xy[:, 1].clamp(0, H - BLOCK).to(torch.int64)
    d = torch.arange(BLOCK, device=img.device)
    yi = (y0[:, None] + d)[:, :, None]
    xi = (x0[:, None] + d)[:, None, :]
    return img[yi, xi].to(torch.float32)


def dense_grid_detect(img, threshold):
    """Dense-grid EXPRESS scan (MOVExtractor.cc:39-61): centers at
    (8 + 16 i, 8 + 16 j) with center < dim - 8 and tl + 16 < dim.

    Returns (centers (G, 2) f32, passed (G,) bool, desc (G, 8) i32)."""
    H, W = img.shape
    half = BLOCK // 2
    xs = np.arange(half, W - half, BLOCK)
    ys = np.arange(half, H - half, BLOCK)
    xs = xs[(xs - half + BLOCK) < W]
    ys = ys[(ys - half + BLOCK) < H]
    cx, cy = np.meshgrid(xs, ys)
    centers = torch.as_tensor(
        np.stack([cx.ravel(), cy.ravel()], axis=-1).astype(np.float32),
        device=img.device,
    )
    tl = centers.to(torch.int32) - half
    passed, desc = detect_and_describe(gather_blocks(img, tl), threshold)
    return centers, passed, desc
