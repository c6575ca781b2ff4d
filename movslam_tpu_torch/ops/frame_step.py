"""Per-frame tracking program: extraction -> snapshot join -> two PnP stages
-> int32 result wire.

Port of movslam_tpu/ops/frame_step.py (optional keypoint undistortion,
optional stereo depth from a left->right LK inside the program). The wire
layout is the reference's, word for word, so the two can be diffed:

    wire = packed (N, 3..6) i32 | 16 scalars | P/32 visibility words
    packed word 0: pt as 2 x i16 in 1/32-px fixed point
           word 1: track id
           word 2: meta = age (12 b) | midx + 1 (13 b) | flags (4 b)
          [+1 word: undistorted pt, 2 x i16 1/32 px, when has_dist]
          [+2 words: stereo depth and right-image u as f32 BIT PATTERNS,
           -1.0 = none, when has_stereo]
    scalars: R (9) t (3) as f32 bits | n_ref | n_inliers | ok | next_id
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.trackstate import TrackState
from ..device import wrap_i32
from .lk import lk_track
from .pnp import pnp_ransac

SNAP_CAP = 4096  # map-snapshot capacity (points)
N_SCALARS = 16
PT_FIX = 32.0  # wire fixed-point scale for pixel coords (1/32 px)


def packed_cols(has_dist=False, has_stereo=False):
    """Per-slot wire width in int32 words."""
    return 3 + (1 if has_dist else 0) + (2 if has_stereo else 0)


def pack_pt_i32(pt):
    """(N, 2) f32 pixels -> (N,) i32 words carrying 2 x i16 in 1/32 px."""
    q = torch.round(pt * PT_FIX).clamp(-32767.0, 32767.0).to(torch.int64)
    return wrap_i32((q[:, 0] & 0xFFFF) | (q[:, 1] << 16))


def unpack_pt_dev(bits):
    """Device inverse of pack_pt_i32: (N,) i32 words -> (N, 2) f32 pixels."""
    x = (((bits & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.float32) / PT_FIX  # sign-extended low half
    y = (bits >> 16).to(torch.float32) / PT_FIX
    return torch.stack([x, y], dim=-1)


def unpack_pt_np(bits):
    """Host inverse of pack_pt_i32 ((N,) i32 -> (N, 2) f64 pixels)."""
    bits = np.asarray(bits, np.int32)
    x = ((bits << 16) >> 16).astype(np.float64) / PT_FIX
    y = (bits >> 16).astype(np.float64) / PT_FIX
    return np.stack([x, y], axis=-1)


def pack_bits_i32(b):
    """(P,) bool -> (P/32,) i32 carrying the u32 bitmask (P % 32 == 0)."""
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    return wrap_i32((b.reshape(-1, 32).to(torch.int64) << shifts).sum(1))


def unpack_bits_np(i32_words, n):
    """Host inverse of pack_bits_i32: (P/32,) i32 -> (n,) bool."""
    u = np.ascontiguousarray(i32_words, np.int32).view(np.uint32)
    bits = (u[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    return bits.reshape(-1)[:n].astype(bool)


def undistort_points(uv, intr, dist):
    """Iterative keypoint undistortion (Frame.cc:682-713): 8 fixed-point
    steps of the inverse Brown-Conrady model, dist = (k1, k2, p1, p2, k3)."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


def prep_snapshot(snap_fused):
    """Split the (P, 12) row-order snapshot and sort its track ids (col 10,
    i32 bits) stably: returns (snap_pack (P, 10), tid_sorted (P,), perm)."""
    tid = snap_fused[:, 10].contiguous().view(torch.int32)
    perm = torch.argsort(tid, stable=True)
    return snap_fused[:, 0:10], tid[perm], perm


def match_snapshot(track_id, valid, snap_tid_sorted, snap_perm, snap_valid):
    """Join tracks to snapshot rows by track id: (N,) row index or -1."""
    P = snap_tid_sorted.shape[0]
    pos = torch.searchsorted(snap_tid_sorted, track_id).clamp(max=P - 1)
    hit = (snap_tid_sorted[pos] == track_id) & valid & (track_id >= 0)
    row = snap_perm[pos]
    hit = hit & snap_valid[row]
    return torch.where(hit, row, torch.full_like(row, -1))


def _project_gate(R, t, pos, intr, bounds, normal, mind, maxd):
    """isInFrustum (Frame.cc:456-532): depth, in-image (undistorted bounds),
    scale-distance band, viewing angle < 60 deg. Returns (uv, ok)."""
    pc = pos @ R.T + t
    z = pc[:, 2]
    zc = z.clamp(min=1e-6)
    u = intr[0] * pc[:, 0] / zc + intr[2]
    v = intr[1] * pc[:, 1] / zc + intr[3]
    Ow = -(R.T @ t)
    po = pos - Ow
    dist = torch.linalg.vector_norm(po, dim=-1)
    cosv = (po * normal).sum(-1) / dist.clamp(min=1e-9)
    ok = (
        (z > 0)
        & (u >= bounds[0]) & (u < bounds[1]) & (v >= bounds[2]) & (v < bounds[3])
        & (dist >= 0.8 * mind) & (dist <= 1.2 * maxd) & (cosv > 0.5)
    )
    return torch.stack([u, v], dim=-1), ok


def _frame_program_body(
    img, prev_img, prev_state, mv_pack, kps_pack, coverage_area, prior_R, prior_t,
    snap, intr, sampler, dist_pack=None, img_right=None, *, reproj_err, threshold,
    coverage_threshold, capacity, max_cov, has_dist=False, has_stereo=False,
):
    """Stages 1-5 of the per-frame program, shared by tracked_frame_step and
    window_step.tracked_window_step. `snap` is a prepared snapshot
    (prep_snapshot's tuple): the window program sorts once per window, after
    its device-side patch. `sampler` draws the RANSAC samples of stage 1,
    then of stage 2. With has_stereo, img_right is the rectified right image
    and dist_pack[9] the rig's bf. Returns (state, packed, scalars,
    snap_visible, R2, t2, chain_ok), where chain_ok is the host gate that
    advances the pose chain (res2.ok and n_ref >= 10, core/tracking.py
    track_fused)."""
    from ..core.extractor import _p_frame_body

    H, W = img.shape
    dev = img.device
    if dist_pack is None:
        dist_pack = torch.zeros(10, dtype=torch.float32, device=dev)
        bounds = torch.tensor([0.0, float(W), 0.0, float(H)], dtype=torch.float32, device=dev)
    else:
        bounds = dist_pack[5:9]
    snap_pack, snap_tid_sorted, snap_perm = snap
    snap_pos, snap_normal = snap_pack[:, 0:3], snap_pack[:, 3:6]
    snap_mind, snap_maxd = snap_pack[:, 6], snap_pack[:, 7]
    snap_valid = snap_pack[:, 8] > 0
    snap_ref_mask = snap_pack[:, 9] > 0

    # --- 1. feature tracking (MV propagation + LK + seeding) ---------------
    state = _p_frame_body(
        img, prev_img, prev_state, mv_pack[:, 0:2], mv_pack[:, 2:6],
        mv_pack[:, 6].to(torch.int32), mv_pack[:, 7] > 0, kps_pack[:, 0:4], kps_pack[:, 4] > 0,
        coverage_area, threshold, coverage_threshold, capacity, max_cov,
    )
    pt_un = undistort_points(state.pt, intr, dist_pack) if has_dist else state.pt

    # --- 1c. stereo depth: left->right LK, epipolar and disparity gates, and
    # a median-distance trim (Frame::ComputeStereoMatches, Frame.cc:281-354)
    if has_stereo:
        bf = dist_pack[9]
        lk_r, st_ok = lk_track(img, img_right, state.pt, state.valid)
        dy = (lk_r[:, 1] - state.pt[:, 1]).abs()
        disp = state.pt[:, 0] - lk_r[:, 0]
        good = st_ok & state.valid & (dy < 2.0) & (disp > 0.1) & (disp < bf)
        none = torch.full_like(disp, -1.0)
        depth = torch.where(good, bf / disp.clamp(min=0.1), none)
        # masked lower median: the sort pads with inf, so n_good == 0 reads inf
        dsort = torch.sort(torch.where(good, depth, torch.full_like(depth, torch.inf)),
                           stable=True).values
        n_good = good.sum()
        med = dsort[(n_good - 1).clamp(min=0) // 2]
        good = good & ((depth < 6.0 * med) | (n_good <= 10))
        depth = torch.where(good, depth, none)
        ur = torch.where(good, lk_r[:, 0], none)

    # --- 2. map association by track id -------------------------------------
    midx = match_snapshot(state.track_id, state.valid, snap_tid_sorted, snap_perm, snap_valid)
    msafe = midx.clamp(min=0)
    mpos, nrm = snap_pos[msafe], snap_normal[msafe]
    mind, maxd = snap_mind[msafe], snap_maxd[msafe]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]

    # --- 3. stage 1: reference-keyframe gate + pose from the prior ---------
    _, gate_prior = _project_gate(prior_R, prior_t, mpos, intr, bounds, nrm, mind, maxd)
    matched = midx >= 0
    is_ref = snap_ref_mask[msafe] & matched
    stereo_kw = {}
    if has_stereo:
        stereo_kw = {"ur": torch.where(matched, ur, none), "bf": bf}
    res1 = pnp_ransac(mpos, pt_un, is_ref & gate_prior, fx, fy, cx, cy, reproj_err,
                      prior_R, prior_t, sampler, **stereo_kw)
    n_ref = res1["n_inliers"]
    R1 = torch.where(res1["ok"], res1["R"], prior_R)
    t1 = torch.where(res1["ok"], res1["t"], prior_t)

    # --- 4. stage 2: full local-map solve from the stage-1 pose ------------
    _, gate1 = _project_gate(R1, t1, mpos, intr, bounds, nrm, mind, maxd)
    use2 = matched & gate1
    # Visibility over the whole snapshot (every frustum-passing point,
    # matched or not, Tracking.cc:1143-1147).
    _, snap_visible = _project_gate(R1, t1, snap_pos, intr, bounds, snap_normal, snap_mind, snap_maxd)
    snap_visible = snap_visible & snap_valid
    res2 = pnp_ransac(mpos, pt_un, use2, fx, fy, cx, cy, reproj_err, R1, t1, sampler,
                      **stereo_kw)

    # --- 5. int32 wire -------------------------------------------------------
    i32 = lambda b: b.to(torch.int32)  # noqa: E731
    flags = i32(use2) + 2 * i32(res2["inliers"]) + 4 * i32(state.valid) + 8 * i32(state.coverage)
    meta = state.age.clamp(0, 4095) | ((midx.clamp(min=-1).to(torch.int32) + 1) << 12) | (flags << 25)
    cols = [pack_pt_i32(state.pt), state.track_id, meta]
    if has_dist:
        cols.append(pack_pt_i32(pt_un))
    if has_stereo:
        # f32 bit patterns: a view, never an arithmetic cast
        cols += [depth.contiguous().view(torch.int32), ur.contiguous().view(torch.int32)]
    packed = torch.stack(cols, dim=1)
    pose = torch.cat([res2["R"].reshape(-1), res2["t"]]).contiguous().view(torch.int32)
    scalars = torch.cat([
        pose,
        torch.stack([i32(n_ref), i32(res2["n_inliers"]), i32(res2["ok"]), i32(state.next_id)]),
    ])
    chain_ok = res2["ok"] & (n_ref >= 10)
    return state, packed, scalars, snap_visible, res2["R"], res2["t"], chain_ok


def tracked_frame_step(
    img, prev_img, prev_state: TrackState, mvk_pack, snap_fused, intr, sampler,
    dist_pack=None, img_right=None, *, n_mvs, reproj_err, threshold, coverage_threshold,
    capacity, max_cov, has_dist=False, has_stereo=False,
):
    """One frame of tracking. mvk_pack is MotionVectorImage.packed_joint()
    plus two trailer rows carrying [prior_R (9), prior_t (3), coverage_area].
    Returns dict(state, wire, packed, scalars, snap_visible)."""
    aux = mvk_pack[-2:].reshape(-1)[0:13]
    mvk_pack = mvk_pack[:-2]
    state, packed, scalars, snap_visible, _, _, _ = _frame_program_body(
        img, prev_img, prev_state, mvk_pack[:n_mvs], mvk_pack[n_mvs:, 0:5], aux[12],
        aux[0:9].reshape(3, 3), aux[9:12], prep_snapshot(snap_fused), intr, sampler, dist_pack,
        img_right, reproj_err=reproj_err, threshold=threshold,
        coverage_threshold=coverage_threshold, capacity=capacity, max_cov=max_cov,
        has_dist=has_dist, has_stereo=has_stereo,
    )
    wire = torch.cat([packed.reshape(-1), scalars, pack_bits_i32(snap_visible)])
    return {"state": state, "wire": wire, "packed": packed, "scalars": scalars,
            "snap_visible": snap_visible}
