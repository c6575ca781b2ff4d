"""Windowed tracking: W frames per call against one frozen map snapshot.

Port of movslam_tpu/ops/window_step.py. The decoder keeps a lookahead
queue (VideoDecoder.cc:163-368), so W decoded frames are available ahead of
the tracker; this program runs the per-frame body
(ops/frame_step._frame_program_body) over them, carrying

    TrackState, previous image, pose chain (last pose + constant-velocity
    model, Tracking.cc:414-424)

on the device and returning one int32 wire for the whole window:

    W*N*packed_cols packed words | W*16 scalars | W*P/32 visibility words
    [| mapper result, f32 bits]

The host replays the W per-frame results through the Tracking state machine.
The map snapshot is frozen for the window: a keyframe created at frame k
only becomes matchable at the next window (bounded by W frames; the
reference's own mapper-thread latency delays new points similarly,
LocalMapping.cc:50-115).

The reference's `lax.scan` is a Python loop here, and its one-signature
devices are gone: the mapper section runs only when a staged job's wires are
passed, and the snapshot patch is applied only when there is one.
"""
from __future__ import annotations

import torch

from ..trace import span
from .frame_step import _frame_program_body, pack_bits_i32, prep_snapshot
from .mapper_step import MAPPER_SMALL, mapper_body


def _apply_patch(snap_fused, patch_tri, patch_mp, patch_meta):
    """Scatter a deferred mapper job's device-resident results into a copy
    of the map snapshot: BA-moved point positions (rows patch_meta[1:]) and
    device-gated new triangulations (rows [n_base, n_base + C_PATCH) of the
    reserved tail, n_base = patch_meta[0]). A row index >= P means "drop":
    such rows, and triangulations that failed the gates, are written to one
    spare row past the end that is cut off again, so no index leaves the
    tensor and no kept row is written twice. The host graph commits the same
    results at the next keyframe; this patch only freshens the window's
    transient view."""
    P = snap_fused.shape[0]
    dev = snap_fused.device
    ext = torch.cat([snap_fused, torch.zeros((1, snap_fused.shape[1]), dtype=snap_fused.dtype, device=dev)])
    n_base = patch_meta[0].to(torch.int64)
    rows_ba = patch_meta[1:].to(torch.int64).clamp(0, P)
    ext[rows_ba, 0:3] = patch_mp

    tidb = patch_tri[:, 3:4]  # track id (i32 bits): copied, never computed on
    ok = patch_tri[:, 4] > 0
    idx = n_base + torch.arange(patch_tri.shape[0], dtype=torch.int64, device=dev)
    rows_t = torch.where(ok & (idx < P), idx, torch.full_like(idx, P))
    one = torch.ones_like(tidb)
    newrow = torch.cat(
        [
            patch_tri[:, 0:3],    # X
            patch_tri[:, 5:8],    # normal
            patch_tri[:, 8:10],   # mind, maxd (update_normals_batch parity)
            one,                  # valid
            one,                  # ref-KF member: fresh points back the stage-1 gate
            tidb,
            torch.zeros_like(tidb),
        ],
        dim=1,
    )
    ext[rows_t] = newrow
    return ext[:P]


def tracked_window_step(
    imgs, prev_img, prev_state, mvk_packs, pose_pack, snap_fused, intr, sampler,
    dist_pack=None, imgs_right=None, patch_tri=None, patch_mp=None, patch_meta=None,
    mtri=None, mba=None, *, n_mvs, reproj_err, threshold, coverage_threshold, capacity,
    max_cov, has_dist=False, has_stereo=False,
):
    """W frames of tracking.

    imgs      : (W, H, Wd) u8 — the window's gray frames.
    imgs_right: (W, H, Wd) u8 — with has_stereo, the rectified right frames;
                dist_pack[9] then carries the rig's bf.
    prev_img  : (H, Wd) u8 — the frame before the window.
    prev_state: TrackState entering the window.
    mvk_packs : (W, M+K+1, 8) i16 — per frame MotionVectorImage.
                packed_joint_i16(): deltas in 1/64 pel, rects/dindx/valid as
                integers, one trailer row with coverage_area in Q14.
    pose_pack : (25,) f32 — [last_R(9) | last_t(3) | vel_R(9) | vel_t(3) |
                has_vel(1)], the pose chain's entry point.
    sampler   : the RANSAC draw (ops/pnp.py), called twice per frame in
                frame order (stage 1, then stage 2).
    patch_*   : a pending mapper job's device-resident results and their row
                metadata (_apply_patch), or None.
    mtri, mba : a staged SMALL-class mapper job's wires (ops/mapper_step), or
                None. The job runs first; its patch bundles replace patch_tri
                and patch_mp (patch_meta is the job's own), and its result
                trails the wire.
    Returns dict(state, wire, desc_w (W, N, 8), packed_w (W, N, C),
    pose_carry (25,)), pose_carry in pose_pack's layout."""
    W = imgs.shape[0]

    mwire = None
    if mtri is not None:
        with span("window.mapper"):
            mout = mapper_body(mtri, mba, intr, dist_pack[9] if has_stereo else 0.0,
                               K=MAPPER_SMALL["K"], P=MAPPER_SMALL["P"], O=MAPPER_SMALL["O"])
        mwire = mout["wire"]
        patch_tri, patch_mp = mout["patch_tri"], mout["patch_mp"]

    # Device-side snapshot patch, then ONE sort for the whole window.
    with span("window.patch"):
        if patch_tri is not None:
            snap_fused = _apply_patch(snap_fused, patch_tri, patch_mp, patch_meta)
        snap = prep_snapshot(snap_fused)

    l_R = pose_pack[0:9].reshape(3, 3)
    l_t = pose_pack[9:12]
    v_R = pose_pack[12:21].reshape(3, 3)
    v_t = pose_pack[21:24]
    has_vel = pose_pack[24] > 0

    mvk_w = mvk_packs.to(torch.float32)
    cov_w = mvk_w[:, -1, 0] * (1.0 / 16384.0)
    mv_w = mvk_w[:, :n_mvs].clone()
    mv_w[:, :, 0:2] *= 1.0 / 64.0
    kps_w = mvk_w[:, n_mvs:-1, 0:5]

    state, p_img = prev_state, prev_img
    packed_w, scalars_w, visbits_w, desc_w = [], [], [], []
    for k in range(W):
        # Constant-velocity prior (Tracking.cc:414-424).
        prior_R = torch.where(has_vel, v_R @ l_R, l_R)
        prior_t = torch.where(has_vel, v_R @ l_t + v_t, l_t)
        state, packed, scalars, snap_visible, R2, t2, chain_ok = _frame_program_body(
            imgs[k], p_img, state, mv_w[k], kps_w[k], cov_w[k], prior_R, prior_t, snap,
            intr, sampler, dist_pack, imgs_right[k] if has_stereo else None,
            reproj_err=reproj_err, threshold=threshold,
            coverage_threshold=coverage_threshold, capacity=capacity, max_cov=max_cov,
            has_dist=has_dist, has_stereo=has_stereo,
        )
        # The pose chain mirrors the host replay: on a ref-gate or solve
        # failure the frame keeps the previous pose (track_fused).
        R_cur = torch.where(chain_ok, R2, l_R)
        t_cur = torch.where(chain_ok, t2, l_t)
        v_R = R_cur @ l_R.T  # T_cur * T_last^-1
        v_t = t_cur - v_R @ l_t
        l_R, l_t, p_img = R_cur, t_cur, imgs[k]
        has_vel = torch.ones_like(has_vel)
        packed_w.append(packed)
        scalars_w.append(scalars)
        visbits_w.append(pack_bits_i32(snap_visible))
        desc_w.append(state.desc)

    packed_w = torch.stack(packed_w)
    pose_carry = torch.cat([l_R.reshape(-1), l_t, v_R.reshape(-1), v_t,
                            has_vel.to(torch.float32)[None]])
    parts = [packed_w.reshape(-1), torch.stack(scalars_w).reshape(-1),
             torch.stack(visbits_w).reshape(-1)]
    if mwire is not None:
        parts.append(mwire.contiguous().view(torch.int32))  # f32 result as bit patterns
    return {
        "state": state,
        "wire": torch.cat(parts),
        # Device-resident side channels: per-frame descriptors (pulled only
        # when a keyframe's archive is read) and the packed stack (a
        # mid-window rewind rebuilds the TrackState from it).
        "desc_w": torch.stack(desc_w),
        "packed_w": packed_w,
        "pose_carry": pose_carry,
    }
