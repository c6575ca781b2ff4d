"""Batched motion-vector candidate selection.

Port of movslam_tpu/ops/mvselect.py: the (track, mv) containment relation
is a dense (N, M) predicate reduced to the first 4 containing MVs per track
in MV index order (the reference's 4-slot `mvi` pixel image).
"""
from __future__ import annotations

import torch

N_CAND = 4  # the reference's 4 mvi slots per pixel


def _contains(pts, mv_rect):
    """(..., N, M) containment of floor(pts (..., N, 2)) in mv_rect (..., M, 4)."""
    ix = torch.floor(pts[..., 0])[..., None]
    iy = torch.floor(pts[..., 1])[..., None]
    x0, y0, x1, y1 = (mv_rect[..., None, :, c] for c in range(4))
    return (ix >= x0) & (ix <= x1) & (iy >= y0) & (iy <= y1)


def candidate_mvs(track_pt, track_valid, mv_rect, mv_valid):
    """First-4 MV candidates per track: (N, 4) int32 MV indices or -1.

    track_pt (N, 2) f32; track_valid (N,) bool; mv_rect (M, 4) f32 inclusive
    (x0, y0, x1, y1); mv_valid (M,) bool. Slot k holds the (k+1)-th MV whose
    rect contains floor(pt) (MOVExtractor.cc:264-270). With a leading
    stream axis on every argument ((S, N, 2), (S, M, 4), ...) each stream's
    tracks join its own MVs: (S, N, 4) indices into the stream's rows."""
    contains = _contains(track_pt, mv_rect) & mv_valid[..., None, :] & track_valid[..., None]
    rank = torch.cumsum(contains.to(torch.int32), dim=-1) - 1
    m_idx = torch.arange(mv_rect.shape[-2], dtype=torch.int32, device=mv_rect.device)
    neg = torch.tensor(-1, dtype=torch.int32, device=mv_rect.device)
    slots = [
        torch.where(contains & (rank == k), m_idx, neg).amax(dim=-1)
        for k in range(N_CAND)
    ]
    return torch.stack(slots, dim=-1)


def point_covered(pts, mv_rect, mv_valid):
    """Whether any valid MV source rect contains floor(pt): (N,) bool."""
    return (_contains(pts, mv_rect) & mv_valid[None, :]).any(dim=1)
