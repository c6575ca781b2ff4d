"""Motion-vector track propagation — the device heart of the feature layer.

Port of movslam_tpu/ops/propagate.py (P-frame path of the reference's
MOVExtractor, MOVExtractor.cc:245-451): every (track, candidate) pair is
scored in parallel and the order-dependent destination-block claim is a
scatter-min over priority ranks (`scatter_reduce(..., "amin")`).

Candidate scoring always goes through kernels.score_blocks: the CUDA kernel
on the card, its plain version on the CPU. There is no switch.
"""
from __future__ import annotations

import torch

from . import express
from .bitdesc import popcount
from .kernels import score_blocks
from .mvselect import N_CAND, candidate_mvs

ACCEPT_HAMMING = 40  # MOVExtractor.cc:316
MIN_SEED_COUNT = 60  # MOVExtractor.cc:418 fallback gate
I32_MAX = 2**31 - 1


def priority_rank(valid, age, desc):
    """Rank tracks by (age desc, descriptor popcount desc); invalid last.
    Returns (N,) int32 where 0 is the highest priority (MOVExtractor.cc:249)."""
    key = torch.clamp(age, max=1 << 21) * 512 + popcount(desc)
    key = torch.where(valid, key, torch.full_like(key, -1))
    order = torch.argsort(-key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank.to(torch.int32)


def _block_inbounds(pt, wh, width, height):
    """Reference bounds check: tl >= 0 and tl + wh < dim (strict)."""
    whi = wh.to(torch.int32)
    tlx = torch.floor(pt[..., 0]).to(torch.int32) - (wh[..., 0] / 2).to(torch.int32)
    tly = torch.floor(pt[..., 1]).to(torch.int32) - (wh[..., 1] / 2).to(torch.int32)
    return (tlx >= 0) & (tly >= 0) & (tlx + whi[..., 0] < width) & (tly + whi[..., 1] < height)


def propagate_mv_tracks(
    img, prev_pt, prev_valid, prev_coverage, prev_age, prev_desc, prev_wh,
    mv_delta, mv_rect, mv_dindx, mv_valid, n_kps_capacity, threshold,
):
    """Core MV propagation (MOVExtractor.cc:245-335), batched.

    Returns dict: new_pt (N,2), accepted (N,) bool, new_desc (N,8) i32,
    dist (N,) i32, kp_claimed (K,) bool (lbFound, for seed suppression)."""
    H, W = img.shape
    N = prev_pt.shape[0]
    dev = prev_pt.device

    mv_track = prev_valid & ~prev_coverage
    cand = candidate_mvs(prev_pt, mv_track, mv_rect, mv_valid)  # (N, 4)
    has_cand = cand[:, 0] >= 0
    multi = cand[:, 1] >= 0

    cand_safe = cand.clamp(min=0).to(torch.int64)
    cand_pt = prev_pt[:, None, :] + mv_delta[cand_safe]  # (N, 4, 2)
    cand_inb = _block_inbounds(cand_pt, prev_wh[:, None, :], W, H)

    tl = (cand_pt.to(torch.int32).reshape(-1, 2) - express.BLOCK // 2).contiguous()
    prev_rep = prev_desc.repeat_interleave(N_CAND, dim=0).contiguous()
    dist_flat, desc_flat = score_blocks(img, tl, prev_rep, threshold)
    cand_desc = desc_flat.reshape(N, N_CAND, 8)
    cand_dist = dist_flat.reshape(N, N_CAND)

    # Unusable candidates never win; slot 0 is kept unless a usable one
    # scores strictly below 256 (single-candidate tracks skip the tournament).
    usable = (cand >= 0) & cand_inb
    score = torch.where(usable, cand_dist, torch.full_like(cand_dist, 10_000))
    best_v, best_j = score.min(dim=1)
    chosen_j = torch.where(multi & (best_v < 256), best_j, torch.zeros_like(best_j))

    rows = torch.arange(N, device=dev)
    chosen = cand[rows, chosen_j]
    new_pt = cand_pt[rows, chosen_j]
    new_desc = cand_desc[rows, chosen_j]
    dist = cand_dist[rows, chosen_j]
    inb = cand_inb[rows, chosen_j]
    dindx = torch.where(has_cand, mv_dindx[chosen.clamp(min=0).to(torch.int64)],
                        torch.full_like(chosen, -1))

    # Destination-block claim in priority order, regardless of the later
    # distance check (MOVExtractor.cc:306-309). Row n_kps_capacity is a
    # dummy that absorbs ineligible tracks.
    rank = priority_rank(prev_valid, prev_age, prev_desc)
    eligible = mv_track & has_cand & inb
    claims = eligible & (dindx >= 0) & (dindx < n_kps_capacity)
    claim_target = torch.where(claims, dindx, torch.full_like(dindx, n_kps_capacity))
    big = torch.full_like(rank, I32_MAX)
    winner_rank = torch.full((n_kps_capacity + 1,), I32_MAX, dtype=torch.int32, device=dev)
    winner_rank = winner_rank.scatter_reduce(
        0, claim_target.to(torch.int64), torch.where(eligible, rank, big), "amin"
    )
    dsafe = dindx.clamp(0, n_kps_capacity).to(torch.int64)
    wins = (dindx < 0) | (rank == winner_rank[dsafe])
    accepted = eligible & wins & (dist <= ACCEPT_HAMMING)

    kp_claimed = torch.zeros(n_kps_capacity + 1, dtype=torch.int32, device=dev)
    kp_claimed = kp_claimed.scatter_reduce(
        0, claim_target.to(torch.int64), claims.to(torch.int32), "amax"
    )[:n_kps_capacity] > 0

    return {
        "new_pt": new_pt, "accepted": accepted, "new_desc": new_desc,
        "dist": dist, "kp_claimed": kp_claimed,
    }


def seed_new_tracks(img, kps_rect, kps_valid, kp_claimed, threshold, width, height):
    """New tracks from unclaimed MV destination blocks (MOVExtractor.cc:379-416).

    Returns (pt (K,2), desc (K,8), accept (K,) bool, seed_order (K,) i32)."""
    x, y, w, h = kps_rect[:, 0], kps_rect[:, 1], kps_rect[:, 2], kps_rect[:, 3]
    pt = torch.stack([x + w * 0.5, y + h * 0.5], dim=-1)
    inb = (x >= 0) & (y >= 0) & (x + w < width) & (y + h < height)
    tl = pt.to(torch.int32) - express.BLOCK // 2
    passed, desc = express.detect_and_describe(express.gather_blocks(img, tl), threshold)
    accept = kps_valid & ~kp_claimed & inb & passed
    seed_order = torch.cumsum(accept.to(torch.int32), dim=0).to(torch.int32) - 1
    return pt, desc, accept, seed_order
