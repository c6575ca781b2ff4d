"""Motion-vector track propagation — the device heart of the feature layer.

Port of movslam_tpu/ops/propagate.py (P-frame path of the reference's
MOVExtractor, MOVExtractor.cc:245-451): every (track, candidate) pair is
scored in parallel and the order-dependent destination-block claim is a
scatter-min over priority ranks (`scatter_reduce(..., "amin")`).

Each track's candidates are scored and chosen by kernels.score_candidates:
one CUDA kernel launch on the card, its plain version on the CPU. There is
no switch. S streams go through one call (the reference's jax.vmap over
streams, parallel/multistream.py): one batched candidate join, one launch,
one claim scatter; one stream is the case S = 1.
"""
from __future__ import annotations

import torch

from . import express
from .bitdesc import popcount
from .kernels import score_candidates
from .mvselect import candidate_mvs

ACCEPT_HAMMING = 40  # MOVExtractor.cc:316
MIN_SEED_COUNT = 60  # MOVExtractor.cc:418 fallback gate
I32_MAX = 2**31 - 1


def priority_rank(valid, age, desc):
    """Rank tracks by (age desc, descriptor popcount desc); invalid last.
    Returns (..., N) int32 where 0 is the highest priority
    (MOVExtractor.cc:249), ranked along the last axis."""
    key = torch.clamp(age, max=1 << 21) * 512 + popcount(desc)
    key = torch.where(valid, key, torch.full_like(key, -1))
    order = torch.argsort(-key, dim=-1, stable=True)
    pos = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos).to(torch.int32)


def propagate_mv_tracks(
    img, prev_pt, prev_valid, prev_coverage, prev_age, prev_desc, prev_wh,
    mv_delta, mv_rect, mv_dindx, mv_valid, n_kps_capacity, threshold,
):
    """Core MV propagation (MOVExtractor.cc:245-335), batched.

    One stream: img (H, W), track arrays (N, ...), MV arrays (M, ...).
    S streams: img (S, H, W) and a leading S on every track and MV array;
    each stream's results are those of a call of its own.

    Returns dict: new_pt (N,2), accepted (N,) bool, new_desc (N,8) i32,
    dist (N,) i32, kp_claimed (K,) bool (lbFound, for seed suppression),
    each with the leading S of the inputs."""
    dev = prev_pt.device
    lead = prev_pt.shape[:-2]  # () for one stream, (S,) for S
    S = img.shape[0] if img.dim() == 3 else 1
    N, M, K = prev_pt.shape[-2], mv_rect.shape[-2], n_kps_capacity

    mv_track = prev_valid & ~prev_coverage
    cand = candidate_mvs(prev_pt, mv_track, mv_rect, mv_valid)  # (..., N, 4), per stream
    has_cand = (cand[..., 0] >= 0).reshape(-1)
    # Tracks and MV rows of all streams as one run each; candidates become
    # global rows, stream s's offset by s*M.
    stream = torch.arange(S * N, device=dev) // N if N else torch.zeros(0, dtype=torch.int64, device=dev)
    if S > 1:
        cand = torch.where(cand >= 0, cand + (torch.arange(S, device=dev) * M).to(cand.dtype)[:, None, None],
                           cand)
    chosen, new_pt, dist, new_desc, inb = score_candidates(
        img, prev_pt.reshape(-1, 2), cand.reshape(-1, 4), mv_delta.reshape(-1, 2),
        prev_wh.reshape(-1, 2), prev_desc.reshape(-1, 8), threshold)
    dindx = torch.where(has_cand, mv_dindx.reshape(-1)[chosen.clamp(min=0).to(torch.int64)],
                        torch.full_like(chosen, -1))

    # Destination-block claim in priority order, regardless of the later
    # distance check (MOVExtractor.cc:306-309). Each stream owns K + 1 rows
    # of one table; its row K is a dummy that absorbs ineligible tracks.
    rank = priority_rank(prev_valid, prev_age, prev_desc).reshape(-1)
    eligible = mv_track.reshape(-1) & has_cand & inb
    claims = eligible & (dindx >= 0) & (dindx < K)
    base = stream * (K + 1)
    claim_target = base + torch.where(claims, dindx, torch.full_like(dindx, K)).to(torch.int64)
    big = torch.full_like(rank, I32_MAX)
    winner_rank = torch.full((S * (K + 1),), I32_MAX, dtype=torch.int32, device=dev)
    winner_rank = winner_rank.scatter_reduce(0, claim_target, torch.where(eligible, rank, big), "amin")
    dsafe = base + dindx.clamp(0, K).to(torch.int64)
    wins = (dindx < 0) | (rank == winner_rank[dsafe])
    accepted = eligible & wins & (dist <= ACCEPT_HAMMING)

    kp_claimed = torch.zeros(S * (K + 1), dtype=torch.int32, device=dev)
    kp_claimed = kp_claimed.scatter_reduce(0, claim_target, claims.to(torch.int32), "amax")
    kp_claimed = kp_claimed.reshape(S, K + 1)[:, :K] > 0

    return {
        "new_pt": new_pt.reshape(*lead, N, 2), "accepted": accepted.reshape(*lead, N),
        "new_desc": new_desc.reshape(*lead, N, 8), "dist": dist.reshape(*lead, N),
        "kp_claimed": kp_claimed.reshape(*lead, K),
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
