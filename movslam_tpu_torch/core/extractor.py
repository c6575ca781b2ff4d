"""MOVExtractor — feature tracking from motion vectors, batched on device.

Port of movslam_tpu/core/extractor.py (MOVExtractor.cc:63-455):

  P-frame : MV propagation + coverage LK + seeds + low-coverage fallback
            (`_p_frame_body`), compacted into a fixed-capacity TrackState.
  I-frame : LK carry-over of live tracks (MOVExtractor.cc:81-120) or a
            dense-grid cold start (:123-157).
  reloc   : LK from the last keyframe's image toward projected map points
            (:161-243), merged ahead of propagation.
"""
from __future__ import annotations

import math

import torch

from movslam_tpu.io.mvimage import FrameType, MotionVectorImage

from ..ops import express
from ..ops.lk import lk_track
from ..ops.mvselect import point_covered
from ..ops.propagate import MIN_SEED_COUNT, priority_rank, propagate_mv_tracks, seed_new_tracks
from .trackstate import MAX_TRACKS, TrackState

MAX_COV = 512  # capacity for coverage-flagged (LK) tracks per frame
BIG = 2**31 - 1


def _segment(pt, tid, age, desc, wh, cov, accept, order):
    return {
        "pt": pt, "track_id": tid, "age": age, "desc": desc, "wh": wh,
        "coverage": cov, "accept": accept, "order": order,
    }


def _compact(segments, capacity, next_id):
    """Merge candidate segments into a TrackState of (at most) `capacity`
    rows. Earlier segments win; duplicate track ids keep their first
    accepted occurrence (std::map::insert first-wins, MOVExtractor.cc:117)."""
    cat = lambda k: torch.cat([s[k] for s in segments], dim=0)  # noqa: E731
    pt, tid, age, desc = cat("pt"), cat("track_id"), cat("age"), cat("desc")
    wh, cov, accept = cat("wh"), cat("coverage"), cat("accept")
    offsets, off = [], 0
    for s in segments:
        offsets.append(off)
        off += int(s["accept"].shape[0])
    order = torch.cat([s["order"].to(torch.int32) + o for s, o in zip(segments, offsets)])
    big = torch.full_like(order, BIG)
    order = torch.where(accept, order, big)

    # lexsort((order, tid_key)) as two stable sorts: secondary key first.
    tid_key = torch.where(accept, tid, torch.full_like(tid, BIG))
    p1 = torch.argsort(order, stable=True)
    perm = p1[torch.argsort(tid_key[p1], stable=True)]
    tid_sorted = tid_key[perm]
    first = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=tid.device), tid_sorted[1:] != tid_sorted[:-1]]
    )
    keep = torch.zeros_like(accept).scatter(0, perm, first) & accept

    take = torch.argsort(torch.where(keep, order, big), stable=True)[:capacity]
    valid = keep[take]
    return TrackState(
        pt=pt[take],
        track_id=torch.where(valid, tid[take], torch.full_like(tid[take], -1)),
        age=age[take],
        desc=desc[take],
        mb_wh=wh[take],
        coverage=cov[take] & valid,
        valid=valid,
        next_id=next_id,
    )


def _p_frame_body(
    img, prev_img, prev: TrackState, mv_delta, mv_rect, mv_dindx, mv_valid,
    kps_rect, kps_valid, coverage_area, threshold, coverage_threshold,
    capacity=MAX_TRACKS, max_cov=MAX_COV,
):
    """One P-frame of extraction (MOVExtractor.cc:245-451)."""
    H, W = img.shape
    N = prev.capacity
    dev = prev.device
    i32 = dict(dtype=torch.int32, device=dev)

    # --- 1. MV propagation of non-coverage tracks -------------------------
    prop = propagate_mv_tracks(
        img, prev.pt, prev.valid, prev.coverage, prev.age, prev.desc, prev.mb_wh,
        mv_delta, mv_rect, mv_dindx, mv_valid, kps_rect.shape[0], threshold,
    )
    rank = priority_rank(prev.valid, prev.age, prev.desc)
    seg_prop = _segment(
        prop["new_pt"], prev.track_id, prev.age + 1, prop["new_desc"], prev.mb_wh,
        torch.zeros(N, dtype=torch.bool, device=dev), prop["accepted"], rank,
    )

    # --- 2. coverage-flagged tracks: pyramidal LK -------------------------
    is_cov = prev.valid & prev.coverage
    cov_rank = torch.cumsum(is_cov.to(torch.int32), dim=0) - 1
    slot_ok = is_cov & (cov_rank < max_cov)
    slot_idx = torch.where(slot_ok, cov_rank, torch.full_like(cov_rank, max_cov - 1))
    gather_idx = torch.zeros(max_cov, **i32).scatter_reduce(
        0, slot_idx, torch.where(slot_ok, torch.arange(N, **i32), torch.zeros(N, **i32)), "amax"
    ).to(torch.int64)
    slot_used = torch.zeros(max_cov, **i32).scatter_reduce(
        0, slot_idx, slot_ok.to(torch.int32), "amax"
    ) > 0
    cov_pts = prev.pt[gather_idx]
    if bool(slot_used.any()):  # steady-state frames have no coverage tracks
        lk_pts, lk_status = lk_track(prev_img, img, cov_pts, slot_used)
    else:
        lk_pts, lk_status = cov_pts, torch.zeros(max_cov, dtype=torch.bool, device=dev)
    seg_cov = _segment(
        lk_pts, prev.track_id[gather_idx], prev.age[gather_idx] + 1,
        prev.desc[gather_idx], prev.mb_wh[gather_idx],
        torch.ones(max_cov, dtype=torch.bool, device=dev), slot_used & lk_status,
        torch.arange(max_cov, **i32),
    )

    # --- 3. new-track seeds from unclaimed MV destination blocks ----------
    seed_pt, seed_desc, seed_accept, seed_order = seed_new_tracks(
        img, kps_rect, kps_valid, prop["kp_claimed"], threshold, W, H
    )
    n_seeds = seed_accept.to(torch.int32).sum().to(torch.int32)
    K = kps_rect.shape[0]
    seed_ids = prev.next_id + 1 + seed_order
    seg_seed = _segment(
        seed_pt, torch.where(seed_accept, seed_ids, torch.full_like(seed_ids, -1)),
        torch.zeros(K, **i32), seed_desc, kps_rect[:, 2:4],
        torch.zeros(K, dtype=torch.bool, device=dev), seed_accept, torch.arange(K, **i32),
    )

    # --- 4. low-coverage fallback: dense grid, MV-free areas --------------
    fallback_on = (coverage_area < coverage_threshold) | (n_seeds < MIN_SEED_COUNT)
    g_centers, g_pass, g_desc = express.dense_grid_detect(img, threshold)
    G = g_centers.shape[0]
    fb_accept = fallback_on & g_pass & ~point_covered(g_centers, mv_rect, mv_valid)
    fb_order = (torch.cumsum(fb_accept.to(torch.int32), dim=0) - 1).to(torch.int32)
    fb_ids = prev.next_id + n_seeds + 1 + fb_order
    seg_fb = _segment(
        g_centers, torch.where(fb_accept, fb_ids, torch.full_like(fb_ids, -1)),
        torch.zeros(G, **i32), g_desc,
        torch.full((G, 2), float(express.BLOCK), dtype=torch.float32, device=dev),
        torch.ones(G, dtype=torch.bool, device=dev), fb_accept, fb_order,
    )
    n_fb = fb_accept.to(torch.int32).sum().to(torch.int32)
    next_id = (prev.next_id + n_seeds + n_fb).to(torch.int32)
    return _compact([seg_prop, seg_cov, seg_seed, seg_fb], capacity, next_id)


def _i_frame_carryover(img, prev_img, prev: TrackState, capacity=MAX_TRACKS):
    """LK carry-over of all live tracks across a GOP boundary
    (MOVExtractor.cc:81-120). Coverage flags reset; descriptors retained."""
    new_pts, status = lk_track(prev_img, img, prev.pt, prev.valid)
    N = prev.capacity
    dev = prev.device
    seg = _segment(
        new_pts, prev.track_id, prev.age + 1, prev.desc, prev.mb_wh,
        torch.zeros(N, dtype=torch.bool, device=dev), prev.valid & status,
        torch.arange(N, dtype=torch.int32, device=dev),
    )
    return _compact([seg], capacity, prev.next_id)


def _i_frame_coldstart(img, threshold, next_id, capacity=MAX_TRACKS):
    """Dense-grid EXPRESS detection with fresh ids (MOVExtractor.cc:123-157)."""
    centers, passed, desc = express.dense_grid_detect(img, threshold)
    G = centers.shape[0]
    dev = img.device
    order = (torch.cumsum(passed.to(torch.int32), dim=0) - 1).to(torch.int32)
    ids = next_id + 1 + order
    seg = _segment(
        centers, torch.where(passed, ids, torch.full_like(ids, -1)),
        torch.zeros(G, dtype=torch.int32, device=dev), desc,
        torch.full((G, 2), float(express.BLOCK), dtype=torch.float32, device=dev),
        torch.zeros(G, dtype=torch.bool, device=dev), passed, order,
    )
    n_new = passed.to(torch.int32).sum().to(torch.int32)
    return _compact([seg], capacity, (next_id + n_new).to(torch.int32))


def _relocalize_lk(kf_img, img, proj_pts, proj_valid, track_ids, reloc_dist, threshold):
    """LK from the last KF image toward projected map points
    (MOVExtractor.cc:161-243). Returns a merge-ready segment."""
    H, W = img.shape
    dev = img.device
    new_pts, status = lk_track(kf_img, img, proj_pts, proj_valid)
    dist = torch.linalg.vector_norm(new_pts - proj_pts, dim=-1)
    ok = status & (dist < reloc_dist * math.sqrt(float(H * H + W * W)))
    tl = new_pts.to(torch.int32) - express.BLOCK // 2
    inb = (
        (tl[:, 0] >= 0) & (tl[:, 1] >= 0)
        & (tl[:, 0] + express.BLOCK < W) & (tl[:, 1] + express.BLOCK < H)
    )
    desc = express.compute_descriptor(express.gather_blocks(img, tl), threshold)
    R = proj_pts.shape[0]
    return _segment(
        new_pts, track_ids, torch.zeros(R, dtype=torch.int32, device=dev), desc,
        torch.full((R, 2), float(express.BLOCK), dtype=torch.float32, device=dev),
        torch.zeros(R, dtype=torch.bool, device=dev), ok & inb,
        torch.arange(R, dtype=torch.int32, device=dev),
    )


def _merge_reloc(seg_reloc, state: TrackState, capacity):
    seg_main = _segment(
        state.pt, state.track_id, state.age, state.desc, state.mb_wh,
        state.coverage, state.valid,
        torch.arange(state.capacity, dtype=torch.int32, device=state.device),
    )
    return _compact([seg_reloc, seg_main], capacity, state.next_id)


class MOVExtractor:
    """Host-side facade choosing among the extraction programs
    (MOVExtractor.h: threshold, coverageThreshold, relocalizationDistance)."""

    def __init__(self, threshold=25, coverage_threshold=0.2,
                 relocalization_distance=0.05, capacity=MAX_TRACKS, device="cpu"):
        self.threshold = float(threshold)
        self.coverage_threshold = float(coverage_threshold)
        self.relocalization_distance = float(relocalization_distance)
        self.capacity = capacity
        self.device = torch.device(device)
        # Persistent id counter (mCurrentId): survives map resets, which clear
        # the previous frame but not the extractor (MOVExtractor.h:38).
        self._next_id_dev = None

    @property
    def next_id(self):
        return 0 if self._next_id_dev is None else int(self._next_id_dev)

    def extract(self, smv: MotionVectorImage, prev_state, prev_img, reloc=None, img_dev=None):
        """One frame of extraction; returns the new TrackState.

        reloc: optional dict(kf_img, proj_pts, proj_valid, track_ids) for the
        lost-track LK recovery path."""
        dev = self.device
        img = img_dev if img_dev is not None else torch.as_tensor(smv.im_gray, device=dev)

        if smv.ft == FrameType.I_FRAME or prev_state is None:
            if prev_state is not None and bool(prev_state.valid.any()):
                out = _i_frame_carryover(img, prev_img, prev_state, capacity=self.capacity)
            else:
                if prev_state is not None:
                    next_id = prev_state.next_id
                elif self._next_id_dev is not None:
                    next_id = self._next_id_dev
                else:
                    next_id = torch.tensor(0, dtype=torch.int32, device=dev)
                out = _i_frame_coldstart(img, self.threshold, next_id, capacity=self.capacity)
            self._next_id_dev = out.next_id
            return out

        mv_pack, kps_pack = (torch.as_tensor(a, device=dev) for a in smv.packed())
        state = _p_frame_body(
            img, prev_img, prev_state,
            mv_pack[:, 0:2], mv_pack[:, 2:6], mv_pack[:, 6].to(torch.int32), mv_pack[:, 7] > 0,
            kps_pack[:, 0:4], kps_pack[:, 4] > 0,
            torch.tensor(smv.coverage_area, dtype=torch.float32, device=dev),
            self.threshold, self.coverage_threshold, capacity=self.capacity,
        )
        if reloc is not None:
            seg_reloc = _relocalize_lk(
                torch.as_tensor(reloc["kf_img"], device=dev), img,
                torch.as_tensor(reloc["proj_pts"], device=dev),
                torch.as_tensor(reloc["proj_valid"], device=dev),
                torch.as_tensor(reloc["track_ids"], device=dev),
                self.relocalization_distance, self.threshold,
            )
            state = _merge_reloc(seg_reloc, state, self.capacity)
        self._next_id_dev = state.next_id
        return state
