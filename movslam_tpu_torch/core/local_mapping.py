"""LocalMapping: keyframe processing, point culling, triangulation, fusion
and local bundle adjustment — the per-frame (synchronous) mapper.

Port of the per-frame path of movslam_tpu/core/local_mapping.py
(LocalMapping.cc:50-115 with `defer_mapping=False`): process new KF ->
cull recent points -> triangulate every candidate pair of every neighbour
in one device batch -> fuse with neighbours -> local BA. The local BA is
launched on the device and committed at the next keyframe (or shutdown),
so it overlaps the tracking of the frames in between. The deferred/fused
mapper of the windowed drive, the mapper thread, visual-inertial BA and map
merge are later slices of ROADMAP Queue 1 and raise NotImplementedError.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..ops.ba import ba_solve_wire, build_obs_by_point
from ..ops.triangulate import MAX_PAIRS, triangulate_pairs_np
from .map import MapPoint, update_normals_batch
from .matcher import FuseCandidates, fuse, search_for_triangulation
from .verbose import Verbose

# LBA capacities of the reference (padded there for one compile; here they
# are the problem-size caps that keep both drives on the same problems).
MAX_OPT_KF = 24
MAX_FIX_KF = 24
MAX_BA_MP = 2048
MAX_BA_OBS = 16384
MOPP = 16
CHI2_PRUNE = 5.0  # Optimizer.cc delta
REPROJ_TRI = 5.0  # CreateNewMapPoints reprojection gate


def _bucket(n, lo, hi):
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


def assemble_ba_problem(kfs, n_opt, mps, init_kf_id, K, mopp=MOPP,
                        p_lo=512, p_hi=MAX_BA_MP, o_lo=2048, o_hi=MAX_BA_OBS):
    """Pack a BA problem into fixed-shape arrays (the reference's layout).
    kfs[:n_opt] are optimized except the init KF; kfs[n_opt:] are fixed.
    Per point the `mopp` earliest keyframes' observations are kept, then a
    point-major total cap. Returns None when the problem is empty."""
    if not kfs or not mps:
        return None
    mps = mps[:p_hi]
    P = _bucket(len(mps), p_lo, p_hi)
    kf_pack = np.zeros((K, 14), np.float32)
    kf_pack[:, 0] = kf_pack[:, 4] = kf_pack[:, 8] = 1.0
    kf_pack[:, 12] = 1.0  # padding rows fixed and invalid
    for i, kf in enumerate(kfs):
        kf_pack[i, 0:9] = np.asarray(kf.R).reshape(9)
        kf_pack[i, 9:12] = kf.t
        kf_pack[i, 12] = (i >= n_opt) or (kf.id == init_kf_id)
        kf_pack[i, 13] = 1.0
    kf_fixed = kf_pack[:, 12] > 0
    mp_pack = np.zeros((P, 4), np.float32)
    mp_pack[: len(mps), 0:3] = np.stack([mp.pos for mp in mps])
    mp_pack[: len(mps), 3] = 1.0

    mp_id_arr = np.fromiter((mp.id for mp in mps), np.int64, len(mps))
    sort_perm = np.argsort(mp_id_arr)
    sorted_ids = mp_id_arr[sort_perm]

    blocks = []
    for i, kf in enumerate(kfs):
        slots = np.flatnonzero(kf.mp_ids >= 0)
        if len(slots) == 0:
            continue
        mids = kf.mp_ids[slots]
        pos = np.minimum(np.searchsorted(sorted_ids, mids), len(sorted_ids) - 1)
        j_idx = np.where(sorted_ids[pos] == mids, sort_perm[pos], -1)
        keep = j_idx >= 0
        slots, j_idx = slots[keep], j_idx[keep]
        blocks.append((np.full(len(slots), i, np.int32), j_idx.astype(np.int32),
                       kf.pts[slots].astype(np.float32), slots.astype(np.int32), kf.id))
    if not blocks:
        return None
    all_kf = np.concatenate([b[0] for b in blocks])
    all_mp = np.concatenate([b[1] for b in blocks])
    all_uv = np.concatenate([b[2] for b in blocks])
    all_slot = np.concatenate([b[3] for b in blocks])
    all_kfid = np.concatenate([np.full(len(b[0]), b[4], np.int64) for b in blocks])
    order = np.lexsort((all_kfid, all_mp))
    mp_sorted = all_mp[order]
    first = np.concatenate([[True], mp_sorted[1:] != mp_sorted[:-1]])
    group_start = np.maximum.accumulate(np.where(first, np.arange(len(order)), 0))
    within = np.arange(len(order)) - group_start
    sel = order[within < mopp][:o_hi]
    O = _bucket(len(sel), o_lo, o_hi)
    sel = sel[:O]
    n_obs = len(sel)
    obs_pack = np.zeros((O, 6), np.float32)
    obs_pack[:n_obs, 0] = all_kf[sel]
    obs_pack[:n_obs, 1] = all_mp[sel]
    obs_pack[:n_obs, 2:4] = all_uv[sel]
    obs_pack[:, 4] = -1.0  # no stereo column
    obs_pack[:n_obs, 5] = 1.0
    obs_mp = np.where(obs_pack[:, 5] > 0, obs_pack[:, 1].astype(np.int64), P)
    return {
        "kf_pack": kf_pack, "mp_pack": mp_pack, "obs_pack": obs_pack,
        "obp": build_obs_by_point(obs_mp, P, mopp, O),
        "obs_meta": (all_kf[sel], all_mp[sel], all_slot[sel]),
        "kf_fixed": kf_fixed, "mps": mps,
    }


def problem_wire(prob):
    """Flatten an assembled problem into ba_solve_wire's input layout."""
    wire = np.concatenate([
        prob["kf_pack"].reshape(-1), prob["mp_pack"].reshape(-1),
        prob["obs_pack"].reshape(-1), prob["obp"].reshape(-1).astype(np.float32),
    ])
    shapes = (prob["kf_pack"].shape[0], prob["mp_pack"].shape[0],
              prob["obs_pack"].shape[0], prob["obp"].shape[1])
    return wire, shapes


def split_ba_wire(out, K, P, O):
    """ba_solve_wire's flat result -> (out_kf (K, 12), out_mp (P, 3), out_obs (O, 2))."""
    out = np.asarray(out)
    o0, o1 = K * 12, K * 12 + P * 3
    return out[:o0].reshape(K, 12), out[o0:o1].reshape(P, 3), out[o1:].reshape(O, 2)


def commit_ba_result(res, obs_meta, kfs, mps, kf_fixed, m):
    """Prune chi2 > 5 / non-positive-depth observations and write optimized
    poses and points back (Optimizer.cc:761-841). Caller holds the map lock."""
    out_kf, out_mp, out_obs = (np.asarray(x) for x in res)
    chi2, depth = out_obs[:, 0], out_obs[:, 1]
    R_out = out_kf[:, 0:9].reshape(-1, 3, 3).astype(np.float64)
    t_out = out_kf[:, 9:12].astype(np.float64)
    X_out = out_mp.astype(np.float64)
    o_kf, o_mp, o_slot = obs_meta
    n = len(o_kf)
    for o in np.flatnonzero((chi2[:n] > CHI2_PRUNE) | (depth[:n] <= 0)):
        mp = mps[o_mp[o]]
        if mp.bad or mp.replaced_by is not None:
            continue
        kf = kfs[o_kf[o]]
        # Fusion may have re-pointed the slot since the solve was launched:
        # only sever the association the solve judged.
        if kf.mp_ids[int(o_slot[o])] != mp.id:
            continue
        kf.erase_mappoint_slot(int(o_slot[o]))
        mp.remove_observation(kf.id)
    for i, kf in enumerate(kfs):
        if not kf_fixed[i] and not kf.bad:
            kf.set_pose(R_out[i], t_out[i])
    alive = []
    for j, mp in enumerate(mps):
        if not mp.bad and mp.replaced_by is None:
            mp.pos = X_out[j]
            alive.append(mp)
    update_normals_batch(alive, m)
    m.bump_change()


class LocalMapping:
    def __init__(self, atlas, camera, device, far_points=0.0):
        self.atlas = atlas
        self.camera = camera
        self.device = device
        self.far_points = far_points > 0.0
        self.th_far_points = far_points
        self.recent_points = []
        self.current_kf = None
        self.queue = []
        self.lba_ms = []
        self.map_lock = threading.RLock()
        self.n_culled_kfs = 0
        self._pending_ba = None

    # --- queue interface (Tracking -> mapper) ------------------------------
    def insert_keyframe(self, kf):
        self.queue.append(kf)

    def is_idle(self):
        """AcceptKeyFrames: busy while the launched local BA has not finished
        on the device (polled without blocking, like the reference's
        jax.Array.is_ready), so the keyframe rate follows BA latency."""
        if self.queue:
            return False
        pending = self._pending_ba
        return pending is None or pending["done"] is None or pending["done"].query()

    def spin(self, final=False):
        """Drain the queue inline; final=True also commits the pending BA."""
        while self.queue:
            self.process_one()
        if final:
            self._commit_pending_ba()

    def process_one(self):
        self._commit_pending_ba()  # the previous keyframe's BA lands first
        if (self.current_kf is not None and not self.current_kf.bad
                and self.current_kf.map_id == self.atlas.current.id):
            with self.map_lock:
                self._keyframe_culling(self.atlas.current, self.current_kf)
        with self.map_lock:
            if not self.queue:
                return
            kf = self.queue.pop(0)
            self.current_kf = kf
            m = self.atlas.current
            self._process_new_keyframe(kf, m)
            self._map_point_culling(m)
            self._create_new_map_points(m)
            if not self.queue:
                self._search_in_neighbors(m)
        if not self.queue and m.n_keyframes() > 2:
            t0 = time.perf_counter()
            self._local_ba(m)
            self.lba_ms.append(1e3 * (time.perf_counter() - t0))
        if (len(self.atlas.maps) > 1 and m.n_keyframes() >= 5
                and m.n_keyframes() % 5 == 0):
            raise NotImplementedError(
                "multi-map welding (core/map_merge.py): ROADMAP Queue 1, pose graph / map merge slice"
            )

    # --- stages -----------------------------------------------------------
    def _keyframe_culling(self, m, kf):
        """Redundant-keyframe removal (ORB-SLAM3 policy): a covisible KF is
        culled when > 90% of its points are seen by >= 3 other KFs."""
        protected = {kf.id}
        if kf.prev_kf is not None:
            protected.add(kf.prev_kf.id)
        for org in m.kf_origins:
            protected.add(org.id)
        for cand in kf.best_covisible(m, 30):
            if cand.id in protected or cand.bad:
                continue
            n_mps = n_red = 0
            for mid in cand.mp_ids:
                if mid < 0:
                    continue
                mp = m.mappoints.get(int(mid))
                if mp is None or mp.bad:
                    continue
                n_mps += 1
                if mp.n_obs() > 3:
                    n_red += 1
            if n_mps > 10 and n_red > 0.9 * n_mps:
                cand.set_bad(m)
                self.n_culled_kfs += 1

    def _process_new_keyframe(self, kf, m):
        """LocalMapping::ProcessNewKeyFrame (LocalMapping.cc:171-212)."""
        touched = []
        for slot, mid in enumerate(kf.mp_ids):
            if mid < 0:
                continue
            mp = m.mappoints.get(int(mid))
            if mp is None or mp.bad:
                kf.mp_ids[slot] = -1
                continue
            if kf.id not in mp.obs:
                mp.add_observation(kf, slot)
                touched.append(mp)
            else:
                self.recent_points.append(mp)
        update_normals_batch(touched, m)
        kf.update_connections(m)
        m.add_keyframe(kf)

    def _map_point_culling(self, m):
        """LocalMapping::MapPointCulling (LocalMapping.cc:117-156), mono."""
        cur_id = self.current_kf.id
        keep = []
        for mp in self.recent_points:
            if mp.bad:
                continue
            if mp.found_ratio() < 0.25:
                mp.set_bad(m)
            elif cur_id - mp.first_kf_id >= 2 and mp.n_obs() <= 2:
                mp.set_bad(m)
            elif cur_id - mp.first_kf_id < 3:
                keep.append(mp)
        self.recent_points = keep

    def _create_new_map_points(self, m):
        """LocalMapping::CreateNewMapPoints (LocalMapping.cc:220-501): every
        candidate pair of every neighbour triangulated in ONE device batch."""
        job = self._prepare_triangulation(m)
        if job is None:
            return 0
        X = triangulate_pairs_np(job["P1"], job["P2s"], job["uv1"], job["uv2"], self.device)
        return self._commit_triangulation(job, X.astype(np.float64), m)

    def _prepare_triangulation(self, m):
        """Collect the candidate pairs of every eligible covisible neighbour."""
        kf1 = self.current_kf
        neighbors = kf1.best_covisible(m, 30)
        if not neighbors:
            return None
        cam = self.camera
        R1, t1 = kf1.pose()
        Ow1 = kf1.center()
        P1 = cam.K() @ np.concatenate([R1, t1.reshape(3, 1)], axis=1)
        cand, P2s = [], []
        for kf2 in neighbors:
            baseline = np.linalg.norm(kf2.center() - Ow1)
            med = kf2.scene_median_depth(m)
            if med <= 0 or baseline / med < 0.01:
                continue
            s1, s2 = search_for_triangulation(kf1, kf2)
            if len(s1) == 0:
                continue
            R2, t2 = kf2.pose()
            P2 = cam.K() @ np.concatenate([R2, t2.reshape(3, 1)], axis=1)
            for a, b in zip(s1, s2):
                cand.append((kf2, int(a), int(b)))
                P2s.append(P2)
        if not cand:
            return None
        if len(cand) > MAX_PAIRS:
            Verbose.log(f"LocalMapping: truncating {len(cand)} triangulation candidates to {MAX_PAIRS}")
            cand, P2s = cand[:MAX_PAIRS], P2s[:MAX_PAIRS]
        return {
            "kf1": kf1, "cand": cand, "P1": P1, "P2s": np.stack(P2s),
            "uv1": np.stack([kf1.pts[a] for (_, a, _) in cand]),
            "uv2": np.stack([kf2.pts[b] for (kf2, _, b) in cand]),
            "R1": R1, "t1": t1, "Ow1": Ow1,
        }

    def _commit_triangulation(self, job, X, m):
        """Gate the triangulated candidates (parallax, depth, reprojection,
        distances) and create the surviving MapPoints."""
        kf1 = job["kf1"]
        if kf1.bad:
            return 0
        cand, uv1, uv2 = job["cand"], job["uv1"], job["uv2"]
        R1, t1, Ow1 = job["R1"], job["t1"], job["Ow1"]
        cam = self.camera
        C = len(cand)
        X = np.asarray(X, np.float64)[:C]
        R2_arr = np.stack([kf2.R for (kf2, _, _) in cand])
        t2_arr = np.stack([kf2.t for (kf2, _, _) in cand])
        Ow2_arr = np.einsum("cij,cj->ci", -R2_arr.transpose(0, 2, 1), t2_arr)

        def rays(uv):
            return np.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy, np.ones(C)], axis=1)

        ray1 = rays(uv1) @ R1
        ray2 = np.einsum("cji,cj->ci", R2_arr, rays(uv2))
        cos_par = np.einsum("ci,ci->c", ray1, ray2) / (
            np.linalg.norm(ray1, axis=1) * np.linalg.norm(ray2, axis=1) + 1e-12
        )
        finite = np.isfinite(X).all(axis=1)
        pc2_all = np.einsum("cij,cj->ci", R2_arr, X) + t2_arr
        z2 = pc2_all[:, 2]
        pc1_all = X @ R1.T + t1
        z1 = pc1_all[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u1 = cam.fx * pc1_all[:, 0] / pc1_all[:, 2] + cam.cx
            v1 = cam.fy * pc1_all[:, 1] / pc1_all[:, 2] + cam.cy
            u2 = cam.fx * pc2_all[:, 0] / z2 + cam.cx
            v2 = cam.fy * pc2_all[:, 1] / z2 + cam.cy
        e1 = (u1 - uv1[:, 0]) ** 2 + (v1 - uv1[:, 1]) ** 2
        e2 = (u2 - uv2[:, 0]) ** 2 + (v2 - uv2[:, 1]) ** 2
        d1 = np.linalg.norm(X - Ow1, axis=1)
        d2 = np.linalg.norm(X - Ow2_arr, axis=1)
        good = (
            finite & (cos_par < 0.9998)
            & (z1 > 0) & (z2 > 0) & (e1 <= REPROJ_TRI) & (e2 <= REPROJ_TRI) & (d1 > 0) & (d2 > 0)
        )
        if self.far_points:
            good &= (d1 < self.th_far_points) & (d2 < self.th_far_points)

        live_tids = {mp.track_id for mp in m.mappoints.values() if not mp.bad}
        new_mps = []
        for i in np.flatnonzero(good):
            kf2, s1_, s2_ = cand[i]
            if kf1.mp_ids[s1_] >= 0 or kf2.mp_ids[s2_] >= 0:
                continue  # claimed by an earlier pair this round
            tid = int(kf2.track_ids[s2_])
            if tid in live_tids:
                continue
            live_tids.add(tid)
            mp = MapPoint(X[i], kf1.id, tid, m.id)
            mp.add_observation(kf1, int(s1_))
            mp.add_observation(kf2, int(s2_))
            kf1.add_mappoint(mp, int(s1_))
            kf2.add_mappoint(mp, int(s2_))
            m.add_mappoint(mp)
            self.recent_points.append(mp)
            new_mps.append(mp)
        update_normals_batch(new_mps, m)
        return len(new_mps)

    def _search_in_neighbors(self, m):
        """LocalMapping::SearchInNeighbors (LocalMapping.cc:503-608)."""
        kf1 = self.current_kf
        targets = []
        seen = {kf1.id}
        for kf2 in kf1.best_covisible(m, 30):
            if kf2.id not in seen:
                targets.append(kf2)
                seen.add(kf2.id)
            for kf3 in kf2.best_covisible(m, 5):
                if kf3.id not in seen:
                    targets.append(kf3)
                    seen.add(kf3.id)
        own = [m.mappoints.get(int(mid)) for mid in kf1.mp_ids if mid >= 0]
        own_cand = FuseCandidates([mp for mp in own if mp is not None and not mp.bad])
        for kf2 in targets:
            fuse(kf2, own_cand, m, self.camera)
        if targets:
            all_mids = np.unique(np.concatenate([kf2.mp_ids for kf2 in targets]))
            fuse_candidates = [
                mp for mp in (m.mappoints.get(int(mid)) for mid in all_mids if mid >= 0)
                if mp is not None and not mp.bad
            ]
            fuse(kf1, fuse_candidates, m, self.camera)
        refresh = [m.mappoints.get(int(mid)) for mid in kf1.mp_ids if mid >= 0]
        update_normals_batch([mp for mp in refresh if mp is not None and not mp.bad], m)
        kf1.update_connections(m)

    # --- local bundle adjustment -------------------------------------------
    def _local_ba(self, m):
        """Optimizer::LocalBundleAdjustment (Optimizer.cc:461-841): local =
        current + covisible KFs; fixed = other observers + init KF. The solve
        is launched on the device; its result is committed at the next
        keyframe (or shutdown)."""
        kf0 = self.current_kf
        local = [kf0] + kf0.best_covisible(m, MAX_OPT_KF - 1)
        local_ids = {kf.id for kf in local}
        local_mps = {}
        for kf in local:
            for mid in kf.mp_ids:
                if mid >= 0 and mid not in local_mps:
                    mp = m.mappoints.get(int(mid))
                    if mp is not None and not mp.bad:
                        local_mps[int(mid)] = mp
        if not local_mps:
            return
        mps = list(local_mps.values())[:MAX_BA_MP]
        fixed = {}
        for mp in mps:
            for kf_id in mp.obs:
                if kf_id not in local_ids and kf_id not in fixed:
                    kf = m.keyframes.get(kf_id)
                    if kf is not None and not kf.bad:
                        fixed[kf_id] = kf
        fixed = list(fixed.values())[:MAX_FIX_KF]
        if not fixed and not any(kf.id == m.init_kf_id for kf in local):
            return  # the reference aborts without fixed KFs (Optimizer.cc:525-529)
        kfs = local + fixed
        prob = assemble_ba_problem(kfs, len(local), mps, m.init_kf_id, MAX_OPT_KF + MAX_FIX_KF)
        if prob is None:
            return
        wire, (K, P, O, mopp) = problem_wire(prob)
        cam = self.camera
        res = ba_solve_wire(
            torch.as_tensor(wire, device=self.device), [cam.fx, cam.fy, cam.cx, cam.cy],
            0.0, K=K, P=P, O=O, MOPP=mopp,
        )
        done = None
        if res.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._pending_ba = {
            "res": res, "done": done, "shape": (K, P, O), "obs_meta": prob["obs_meta"],
            "kfs": kfs, "mps": prob["mps"], "kf_fixed": prob["kf_fixed"], "map": m,
        }

    def _commit_pending_ba(self):
        pending, self._pending_ba = self._pending_ba, None
        if pending is None or pending["map"] is not self.atlas.current:
            return  # nothing launched, or the map was reset since
        res = split_ba_wire(pending["res"].cpu().numpy(), *pending["shape"])  # waits here
        with self.map_lock:
            commit_ba_result(res, pending["obs_meta"], pending["kfs"], pending["mps"],
                             pending["kf_fixed"], pending["map"])
