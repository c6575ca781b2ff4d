"""Atlas multi-map merging: track-id correspondences, Sim3 alignment and
pose-graph relaxation.

The port's own copy of movslam_tpu/core/map_merge.py (numpy on the host; the
pose graph runs on the device the caller names). The reference keeps
disconnected maps forever (its Atlas has no merging step). Here, when a newly
spawned map shares persistent track ids with an older one (tracks that
survived the loss: the extractor's id counter is never reset,
MOVExtractor.h:38), the maps are aligned with a scale-aware Umeyama fit over
the shared landmarks, welded into one graph, and relaxed with the SE(3) pose
graph (ops/posegraph.py).

As in the reference, the fit is plain least squares over the shared points
(no outlier rejection) with a free scale for every sensor (metric stereo and
visual-inertial maps too), and KeyFrame.velocity is not rotated into the old
map's frame (ROADMAP Queue 3).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.posegraph import pose_graph_solve, relative_pose
from .map import update_normals_batch

MIN_SHARED = 15  # shared track ids needed to weld
RELAX_ITERS = 15  # LM iterations of the pose-graph relaxation


def shared_track_correspondences(m_old, m_new):
    """Pairs of (mp_old, mp_new) sharing a track id (one per id)."""
    by_tid_old = {}
    for mp in m_old.mappoints.values():
        if not mp.bad:
            by_tid_old.setdefault(mp.track_id, mp)
    pairs = []
    for mp in m_new.mappoints.values():
        if not mp.bad and mp.track_id in by_tid_old:
            pairs.append((by_tid_old[mp.track_id], mp))
    return pairs


def umeyama_sim3(x_new, x_old):
    """Similarity (s, R, t) with x_old ~= s R x_new + t."""
    mu_o = x_old.mean(0)
    mu_n = x_new.mean(0)
    oc = x_old - mu_o
    nc = x_new - mu_n
    n = len(x_old)
    cov = oc.T @ nc / n
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (nc * nc).sum() / n
    s = float((d * S.diagonal()).sum() / max(var, 1e-12))
    t = mu_o - s * R @ mu_n
    return s, R, t


def merge_maps(atlas, m_old, m_new, *, device):
    """Weld m_new into m_old if they share enough landmarks.

    Returns True on success. All of m_new's keyframes/points are expressed in
    m_old's frame (KF poses get T_c,w_old = R_c2 R^T with rescaled
    translation; points x_old = s R x_new + t), duplicate landmarks are
    replaced, and the combined keyframe graph is relaxed."""
    pairs = shared_track_correspondences(m_old, m_new)
    if len(pairs) < MIN_SHARED:
        return False

    x_old = np.stack([a.pos for a, _ in pairs])
    x_new = np.stack([b.pos for _, b in pairs])
    s, R, t = umeyama_sim3(x_new, x_old)
    # Reject degenerate fits.
    resid = np.linalg.norm((x_new @ (s * R).T + t) - x_old, axis=1)
    scale_ref = np.median(np.linalg.norm(x_old - x_old.mean(0), axis=1)) + 1e-9
    if np.median(resid) > 0.2 * scale_ref:
        return False

    # --- transform m_new into m_old's frame --------------------------------
    for kf in m_new.keyframes.values():
        R_c1 = kf.R @ R.T
        t_c1 = s * kf.t - R_c1 @ t
        kf.set_pose(R_c1, t_c1)
        kf.map_id = m_old.id
    for mp in m_new.mappoints.values():
        mp.pos = s * (R @ mp.pos) + t
        mp.map_id = m_old.id

    # --- weld graphs --------------------------------------------------------
    for kf in m_new.keyframes.values():
        m_old.keyframes[kf.id] = kf
    for mp in list(m_new.mappoints.values()):
        m_old.mappoints[mp.id] = mp
    # Replace duplicate landmarks (keep the older, better-observed one).
    for mp_o, mp_n in pairs:
        if not mp_n.bad and not mp_o.bad:
            if mp_o.n_obs() >= mp_n.n_obs():
                mp_n.replace(mp_o, m_old)
            else:
                mp_o.replace(mp_n, m_old)

    for kf in m_new.keyframes.values():
        kf.update_connections(m_old)
    update_normals_batch(list(m_old.mappoints.values()), m_old)

    # --- pose-graph relaxation over the combined keyframe graph ------------
    kfs = sorted(
        (kf for kf in m_old.keyframes.values() if not kf.bad), key=lambda k: k.id
    )
    K = len(kfs)
    if K >= 3:
        idx = {kf.id: i for i, kf in enumerate(kfs)}
        ei, ej, eR, et, ew = [], [], [], [], []
        for kf in kfs:
            # odometry chain + strong covisibility edges, measured from the
            # current estimates (which already include the Sim3 weld).
            neighbors = set()
            if kf.prev_kf is not None and kf.prev_kf.id in idx:
                neighbors.add(kf.prev_kf.id)
            for nb_id, w in kf.covis.items():
                if w >= 30 and nb_id in idx:
                    neighbors.add(nb_id)
            for nb_id in neighbors:
                if nb_id >= kf.id:
                    continue
                nb = m_old.keyframes[nb_id]
                Rm, tm = relative_pose(kf.R, kf.t, nb.R, nb.t)
                ei.append(idx[kf.id]); ej.append(idx[nb_id])
                eR.append(Rm); et.append(tm); ew.append(1.0)
        if ei:
            fixed = np.zeros(K, bool)
            fixed[0] = True
            node_R = np.stack([kf.R for kf in kfs]).astype(np.float32)
            node_t = np.stack([kf.t for kf in kfs]).astype(np.float32)
            dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
            R_out, t_out, _ = pose_graph_solve(
                dev(node_R), dev(node_t), dev(fixed), dev(np.ones(K, bool)),
                dev(np.asarray(ei, np.int64)), dev(np.asarray(ej, np.int64)),
                dev(np.stack(eR).astype(np.float32)), dev(np.stack(et).astype(np.float32)),
                dev(np.asarray(ew, np.float32)), iters=RELAX_ITERS,
            )
            R_out = R_out.cpu().numpy().astype(np.float64)
            t_out = t_out.cpu().numpy().astype(np.float64)
            # Correct landmarks with their reference keyframe's correction.
            corrections = {}
            for i, kf in enumerate(kfs):
                R_old_kf, t_old_kf = kf.R.copy(), kf.t.copy()
                kf.set_pose(R_out[i], t_out[i])
                # x' = T_new^-1 T_old x
                Rc = R_out[i].T @ R_old_kf
                tc = R_out[i].T @ (t_old_kf - t_out[i])
                corrections[kf.id] = (Rc, tc)
            for mp in m_old.mappoints.values():
                if mp.bad or not mp.obs:
                    continue
                ref = corrections.get(mp.first_kf_id)
                if ref is None:
                    ref = next(
                        (corrections[k] for k in mp.obs if k in corrections), None
                    )
                if ref is not None:
                    mp.pos = ref[0] @ mp.pos + ref[1]
            update_normals_batch(list(m_old.mappoints.values()), m_old)

    # --- retire m_new --------------------------------------------------------
    if m_new in atlas.maps:
        atlas.maps.remove(m_new)
    if atlas.current is m_new:
        atlas.current = m_old
    m_old.bump_change()
    return True


def try_merge(atlas, *, device):
    """Attempt to weld the current map into any older map (newest first);
    the pose graph runs on `device`."""
    cur = atlas.current
    for m in reversed(atlas.maps):
        if m is cur:
            continue
        if merge_maps(atlas, m, cur, device=device):
            return True
    return False
