"""LocalMapping: keyframe processing, point culling, triangulation, fusion
and local bundle adjustment.

Port of movslam_tpu/core/local_mapping.py
(LocalMapping.cc:50-115): process new KF -> cull recent points ->
triangulate every candidate pair of every neighbour in one device batch ->
fuse with neighbours -> local BA. Two modes:

  per frame (`defer_mapping=False`): triangulation is committed at once; the
      local BA is launched on the device and committed at the next keyframe
      (or shutdown), so it overlaps the tracking of the frames in between.
  deferred (`defer_mapping=True`, set by the windowed drive): keyframe n's
      triangulation + local BA become ONE mapper job (ops/mapper_step). A
      SMALL job is staged as host wires for the next window program to run
      (`fuse_mapper`); any other is launched standalone. Either way the
      result is committed one keyframe later, and until then it reaches the
      tracker as a device-side snapshot patch.

`start_thread` runs the queue on a mapper thread (System.cc:129): graph
mutation happens under `map_lock`, device waits outside it.

Visual-inertial (`imu_buffer` set by System for IMU_MONOCULAR): at 6, 12 and
24 keyframes (`vi_min_kfs` * 2^stage) the gravity/scale init
(core/inertial.py) re-expresses the map metric; once it has run, the
per-frame mode's local BA is the joint visual-inertial one (`_local_ba_vi`,
ops/vi_ba.py) over the temporal keyframe chain, committed at once.

When tracking loss has spawned a new map, every fifth keyframe of it tries
to weld it back into an older map (core/map_merge.py). Global BA
(`global_bundle_adjustment`) optimizes every keyframe of a map at once.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..ops.ba import ba_solve_wire, build_obs_by_point
from ..ops.mapper_step import (
    BA_MOPP, MAPPER_BIG, MAPPER_SMALL, TRI_CAP, mapper_step_wire, split_mapper_wire,
)
from ..ops.triangulate import MAX_PAIRS, triangulate_pairs_np
from ..ops.vi_ba import vi_ba_solve
from .inertial import _stack_windows, preintegrate_windows, visual_inertial_init
from .map import MapPoint, update_normals_batch
from .map_merge import try_merge
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
        if kf.uright is not None:
            ur = np.where(kf.uright[slots] >= 0, kf.uright[slots], -1.0)
        else:
            ur = np.full(len(slots), -1.0)
        blocks.append((np.full(len(slots), i, np.int32), j_idx.astype(np.int32),
                       kf.pts[slots].astype(np.float32), slots.astype(np.int32), kf.id,
                       ur.astype(np.float32)))
    if not blocks:
        return None
    all_kf = np.concatenate([b[0] for b in blocks])
    all_mp = np.concatenate([b[1] for b in blocks])
    all_uv = np.concatenate([b[2] for b in blocks])
    all_slot = np.concatenate([b[3] for b in blocks])
    all_ur = np.concatenate([b[5] for b in blocks])
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
    obs_pack[:, 4] = -1.0  # right-image u of stereo observations, -1 = mono
    obs_pack[:n_obs, 4] = all_ur[sel]
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


# Global-BA capacities: bucketed keyframe counts and larger point and
# observation caps than local BA. As in the reference, _bucket doubles from
# the first entry up to the last, so the buckets are 48, 96, 192, 384 and 768:
# 385-512 keyframes pad to 768, a 4608 x 4608 Schur system.
GBA_KF_BUCKETS = (48, 96, 192, 384, 512)
GBA_MAX_MP = 16384
GBA_MAX_OBS = 65536


def gba_windows(m):
    """The good keyframes of map m in id order, as (keyframes, number of
    leading fixed anchors) windows of at most GBA_KF_BUCKETS[-1]: one window
    when they fit, else overlapping windows, each anchored by the keyframes
    it shares with the one before."""
    kfs = sorted((kf for kf in m.keyframes.values() if not kf.bad), key=lambda k: k.id)
    if not kfs:
        return []
    max_kf = GBA_KF_BUCKETS[-1]
    windows = [(kfs[:max_kf], 0)]
    if len(kfs) > max_kf:
        # At most half a window overlaps, so the step stays positive for
        # small buckets.
        overlap = min(64, max_kf // 2)
        step = max_kf - overlap
        i = step
        while i + overlap < len(kfs):
            windows.append((kfs[i:i + max_kf], overlap))
            i += step
        Verbose.log(f"GlobalBA: {len(kfs)} keyframes -> {len(windows)} overlapping windows of <= {max_kf}")
    return windows


def gba_problem(m, kfs, n_anchor):
    """Assemble one global-BA window: kfs[:n_anchor] fixed (the previous
    window's keyframes; 0 in the first window, where the init keyframe
    anchors), every other keyframe optimized, every good point they see.
    Returns (keyframes in problem order, the problem or None)."""
    K = _bucket(len(kfs), GBA_KF_BUCKETS[0], GBA_KF_BUCKETS[-1])
    kf_ids = {kf.id for kf in kfs}
    mps, seen = [], set()
    for kf in kfs:
        for mid in kf.mp_ids:
            if mid >= 0 and mid not in seen:
                seen.add(int(mid))
                mp = m.mappoints.get(int(mid))
                if mp is not None and not mp.bad:
                    mps.append(mp)
    if len(mps) > GBA_MAX_MP:
        Verbose.log(f"GlobalBA: truncating {len(mps)} map points to {GBA_MAX_MP}")
        mps = mps[:GBA_MAX_MP]
    # Gauge: the init keyframe when the window holds it, else its first.
    anchor_id = m.init_kf_id if m.init_kf_id in kf_ids else kfs[0].id
    # Fixed anchors go last: assemble_ba_problem fixes kfs[n_opt:].
    ordered = kfs[n_anchor:] + kfs[:n_anchor]
    return ordered, assemble_ba_problem(ordered, len(kfs) - n_anchor, mps, anchor_id, K,
                                        p_lo=512, p_hi=GBA_MAX_MP, o_lo=2048, o_hi=GBA_MAX_OBS)


def global_bundle_adjustment(m, camera, *, device, bf=0.0, iters=20, map_lock=None):
    """Full-map bundle adjustment (Optimizer::BundleAdjustment /
    System::GlobalBundleAdjustment, Optimizer.cc:61-395, System.cc:162-169):
    every good keyframe optimized (the origin fixed), every good map point,
    `iters` LM iterations on `device`, written back under `map_lock`. The
    keyframe count is bucketed; a map beyond the largest bucket runs in
    overlapping windows (gba_windows), so every keyframe is still
    optimized. bf (baseline * fx) adds the stereo row."""
    for w_kfs, n_anchor in gba_windows(m):
        ordered, prob = gba_problem(m, w_kfs, n_anchor)
        if prob is None:
            continue
        wire, (Kw, Pw, Ow, mopp) = problem_wire(prob)
        res = ba_solve_wire(torch.as_tensor(wire, device=device),
                            [camera.fx, camera.fy, camera.cx, camera.cy], bf,
                            K=Kw, P=Pw, O=Ow, MOPP=mopp, iters=iters)
        res = split_ba_wire(res.cpu().numpy(), Kw, Pw, Ow)  # waits here, outside the lock
        with map_lock if map_lock is not None else contextlib.nullcontext():
            commit_ba_result(res, prob["obs_meta"], ordered, prob["mps"], prob["kf_fixed"], m)


class LocalMapping:
    def __init__(self, atlas, camera, device, monocular=True, far_points=0.0, bf=0.0,
                 stereo_b=0.0):
        self.atlas = atlas
        self.camera = camera
        self.device = device
        self.monocular = monocular
        self.bf = float(bf)  # baseline * fx of a stereo rig, 0 for mono
        self.stereo_b = float(stereo_b)
        self.far_points = far_points > 0.0
        self.th_far_points = far_points
        self.recent_points = []
        self.current_kf = None
        self.queue = []
        self.lba_ms = []
        self.lba_count = 0
        # The mapper's clock: the reference's mapper thread is busy for
        # roughly 1-3 frame times per keyframe (LocalMapping.cc:57,106), which
        # throttles the keyframe cadence. cooldown counts frames until idle.
        self.cooldown = 0
        self.busy_frames = 0  # 0 = a keyframe whenever the mapper is idle
        # "latency": poll the pending BA's readiness (the per-frame drive);
        # "frames": the busy_frames cooldown only (deterministic: the
        # windowed drive, where W frames replay far faster than a BA solves).
        self.throttle_mode = "latency"
        # Tracking and the mapper thread share map_lock (the reference's
        # mMutexMapUpdate, Map.h:137); device waits happen outside it.
        self.map_lock = threading.RLock()
        # The three job slots below are emptied by whichever thread commits
        # first: taking a job out of its slot is atomic under this lock.
        self._slot_lock = threading.Lock()
        self._thread = None
        self._finish = False
        self._processing = False
        self.n_culled_kfs = 0
        self._pending_ba = None
        # Deferred mapping (see the module docstring). Young maps (fewer
        # than defer_min_kfs keyframes) stay synchronous: they need fresh
        # points at once.
        self.defer_mapping = False
        self.defer_min_kfs = 8
        self._deferred = None  # the launched, uncommitted standalone job
        self.fuse_mapper = False
        self._staged = None  # the SMALL job waiting for a window to run it
        self.n_fused_jobs = 0  # jobs a window ran, committed from its wire
        self.n_standalone_jobs = 0  # jobs launched through mapper_step_wire
        # Visual-inertial (set by System when the sensor is IMU_MONOCULAR).
        self.imu_buffer = None
        self.imu_noise = (1.7e-4, 2e-3)
        self.vi_min_kfs = 6
        # What the VI path did: one (stage, keyframes, scale or None, ms,
        # preintegration steps) per init attempt, and per _local_ba_vi call
        # its ms and preintegration steps.
        self.vi_inits = []
        self.vi_ba_ms = []
        self.vi_ba_steps = []

    # --- queue interface (Tracking -> mapper) ------------------------------
    def insert_keyframe(self, kf):
        self.queue.append(kf)
        self.cooldown = self.busy_frames

    def drop_jobs(self):
        """Forget every job in flight: the active map was cleared in place,
        so the `map is current` test of the commits cannot tell."""
        self._pending_ba = self._deferred = self._staged = None

    def _take(self, slot, only_if=lambda job: True):
        """Empty a job slot (`_pending_ba`, `_deferred`, `_staged`) and return
        what it held, or None: each job reaches exactly one committer."""
        with self._slot_lock:
            job = getattr(self, slot)
            if job is None or not only_if(job):
                return None
            setattr(self, slot, None)
            return job

    def tick(self):
        """Called once per tracked frame (the mapper's clock)."""
        if self.cooldown > 0:
            self.cooldown -= 1

    def is_idle(self):
        """AcceptKeyFrames: busy while a keyframe is queued or in work, while
        the cooldown runs, and (latency mode) while the launched local BA
        has not finished on the device, polled without blocking, so the
        keyframe rate follows BA latency."""
        if self.queue or self.cooldown != 0 or self._processing:
            return False
        if self.throttle_mode == "latency":
            pending = self._pending_ba
            if pending is not None and pending["done"] is not None:
                return pending["done"].query()
        return True

    # --- threaded mode (LocalMapping::Run, LocalMapping.cc:50-115) ---------
    def start_thread(self):
        if self._thread is not None:
            return
        self._finish = False
        self._thread = threading.Thread(target=self._run_loop, daemon=True)
        self._thread.start()

    def _run_loop(self):
        while not self._finish:
            if self.queue:
                self._processing = True
                try:
                    self.process_one()
                finally:
                    self._processing = False
            else:
                time.sleep(0.0005)  # the reference polls at 500 us

    def wait_idle(self, timeout=60.0):
        """Block until the mapper thread has drained its queue."""
        t0 = time.time()
        while (self.queue or self._processing) and time.time() - t0 < timeout:
            time.sleep(0.001)

    def stop_thread(self):
        if self._thread is None:
            return
        self._finish = True
        self._thread.join(timeout=30)
        self._thread = None
        self.spin(final=True)

    def spin(self, final=False):
        """Drain the queue inline. Safe in both modes: the pop and all graph
        mutation happen under the reentrant map lock, so the mapper thread
        contends instead of popping twice. final=True also commits the work
        in flight (pending BA, deferred or staged mapper job)."""
        while self.queue:
            self.process_one()
        if final:
            self._commit_pending_ba()
            self._commit_deferred()

    def process_one(self):
        # The previous keyframe's device work lands first: it was launched
        # asynchronously and has been overlapping with tracking.
        self._commit_pending_ba()
        self._commit_deferred()
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
            deferred = self.defer_mapping and m.n_keyframes() >= self.defer_min_kfs
            if deferred:
                tri_job = self._prepare_triangulation(m, cap=TRI_CAP)
                tri_fits_small = tri_job is None or len(tri_job["cand"]) <= MAPPER_SMALL["C"]
                if not self.queue:
                    self._search_in_neighbors(m)
                ba_job = (
                    self._prepare_local_ba(m, small_ok=tri_fits_small)
                    if not self.queue and m.n_keyframes() > 2 else None
                )
            else:
                self._create_new_map_points(m)
                if not self.queue:
                    self._search_in_neighbors(m)
        if deferred:
            if tri_job is not None or ba_job is not None:
                t0 = time.perf_counter()
                size = self._mapper_size_class(tri_job, ba_job)
                if self.fuse_mapper and size is MAPPER_SMALL:
                    # Stage for the next window program to run.
                    tri_w, ba_w = self._build_mapper_wires(tri_job, ba_job, size)
                    tri_w[0, 30] = 1.0  # the reference's in-program on/off flag
                    self._staged = {"tri_wire": tri_w, "ba_wire": ba_w, "tri": tri_job,
                                    "ba": ba_job, "map": m, "size": size}
                else:
                    self._dispatch_mapper_step(tri_job, ba_job, m)
                self.lba_ms.append(1e3 * (time.perf_counter() - t0))
                self.lba_count += 1
        elif not self.queue and m.n_keyframes() > 2:
            t0 = time.perf_counter()
            if self.imu_buffer is not None and m.imu_initialized:
                self._local_ba_vi(m)  # joint visual-inertial, committed at once
            else:
                self._local_ba(m)  # launched; committed at the next keyframe
            self.lba_ms.append(1e3 * (time.perf_counter() - t0))
            self.lba_count += 1
        if self.imu_buffer is not None:
            self._staged_vi_init(m)
        # Multi-map welding: when tracking loss spawned a new map and enough
        # tracks are shared, merge it back (Sim3 + pose-graph relaxation).
        if len(self.atlas.maps) > 1 and m.n_keyframes() >= 5 and m.n_keyframes() % 5 == 0:
            self._commit_deferred()
            with self.map_lock:
                self._commit_pending_ba()
                try_merge(self.atlas, device=self.device)

    def _staged_vi_init(self, m):
        """The gravity/scale init, staged like ORB-SLAM3's repeated inertial
        inits: a first solve at vi_min_kfs keyframes sees a short, weakly
        exciting baseline; solving again at 2x and 4x the keyframe count
        tightens scale and gravity. The pre-scale mapper work lands first."""
        stage = m.imu_init_count
        if stage >= 3 or m.n_keyframes() < self.vi_min_kfs * (2 ** stage):
            return
        t0 = time.perf_counter()
        self._commit_pending_ba()
        self._commit_deferred()
        with self.map_lock:
            res = visual_inertial_init(
                m, list(m.keyframes.values()), self.imu_buffer, device=self.device,
                noise_gyro=self.imu_noise[0], noise_acc=self.imu_noise[1],
            )
        if res is not None:
            m.imu_init_count = stage + 1
        self.vi_inits.append((stage, m.n_keyframes(), None if res is None else float(res["scale"]),
                              1e3 * (time.perf_counter() - t0),
                              None if res is None else res["preintegrate_steps"]))

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
            if (m.imu_initialized and cand.prev_kf is not None and cand.next_kf is not None
                    and cand.next_kf.timestamp - cand.prev_kf.timestamp > 3.0):
                continue  # keep the preintegration chain dense (ORB-SLAM3's 3 s gap guard)
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
            else:  # only fresh stereo points from Tracking
                self.recent_points.append(mp)
        update_normals_batch(touched, m)
        kf.update_connections(m)
        m.add_keyframe(kf)

    def _map_point_culling(self, m):
        """LocalMapping::MapPointCulling (LocalMapping.cc:117-156)."""
        th_obs = 2 if self.monocular else 3
        cur_id = self.current_kf.id
        keep = []
        for mp in self.recent_points:
            if mp.bad:
                continue
            if mp.found_ratio() < 0.25:
                mp.set_bad(m)
            elif cur_id - mp.first_kf_id >= 2 and mp.n_obs() <= th_obs:
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

    def _prepare_triangulation(self, m, cap=MAX_PAIRS):
        """Collect the candidate pairs of every eligible covisible neighbour,
        at most `cap` of them (the device batch's capacity)."""
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
            if self.monocular:
                med = kf2.scene_median_depth(m)
                if med <= 0 or baseline / med < 0.01:
                    continue
            elif baseline < self.stereo_b:
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
        if len(cand) > cap:
            Verbose.log(f"LocalMapping: truncating {len(cand)} triangulation candidates to {cap}")
            cand, P2s = cand[:cap], P2s[:cap]
        return {
            "kf1": kf1, "cand": cand, "P1": P1, "P2s": np.stack(P2s),
            "uv1": np.stack([kf1.pts[a] for (_, a, _) in cand]),
            "uv2": np.stack([kf2.pts[b] for (kf2, _, b) in cand]),
            "R1": R1, "t1": t1, "Ow1": Ow1,
        }

    def _commit_triangulation(self, job, X, m):
        """Gate the triangulated candidates (parallax, depth, reprojection,
        distances) and create the surviving MapPoints. X may come from a
        mapper job pulled one keyframe later: the per-slot claim checks
        re-validate against the current graph. job["created"] maps candidate
        index -> MapPoint: the windowed replay resolves device-patched
        snapshot rows (n_base + i) to host objects through it."""
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

        # Stereo: unproject from the stereo depth where the stereo parallax
        # beats the motion parallax (LocalMapping.cc:341-393).
        if not self.monocular:
            s1_arr = np.fromiter((a for (_, a, _) in cand), np.int64, C)
            z1s = kf1.depth_right[s1_arr] if kf1.depth_right is not None else np.full(C, -1.0)
            z2s = np.array([
                kf2.depth_right[b] if kf2.depth_right is not None else -1.0
                for (kf2, _, b) in cand
            ])
            cps1 = np.where(z1s > 0, np.cos(2 * np.arctan2(self.stereo_b / 2, z1s)), 2.0)
            cps2 = np.where(z2s > 0, np.cos(2 * np.arctan2(self.stereo_b / 2, z2s)), 2.0)
            use1 = (z1s > 0) & (cps1 <= cps2)
            use2 = (z2s > 0) & (cps2 < cps1) & ~use1
            X1 = (cam.unproject(uv1, z1s) - kf1.t) @ kf1.R  # R^T (pc - t), row-wise
            X2 = np.einsum("cji,cj->ci", R2_arr, cam.unproject(uv2, z2s) - t2_arr)
            X = np.where(use1[:, None], X1, np.where(use2[:, None], X2, X))

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

        # Map-level track-id dedup: keyframe n's job is prepared before
        # keyframe n-1's result lands in the graph, so both can carry the
        # same not-yet-mapped track.
        live_tids = {mp.track_id for mp in m.mappoints.values() if not mp.bad}
        new_mps = []
        created = job["created"] = {}
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
            created[int(i)] = mp
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
    def _select_local_ba(self, m, max_mp):
        """Problem selection of Optimizer::LocalBundleAdjustment
        (Optimizer.cc:461-841): local = current + covisible KFs; points =
        theirs (at most max_mp); fixed = the points' other observers. Returns
        (n_local, kfs, mps), or None when there is nothing to solve or no
        keyframe would hold the gauge (Optimizer.cc:525-529)."""
        kf0 = self.current_kf
        local = [kf0] + kf0.best_covisible(m, MAX_OPT_KF - 1)
        sel = self._points_and_fixed(m, local, max_mp)
        if sel is None:
            return None
        mps, fixed = sel
        if not fixed and not any(kf.id == m.init_kf_id for kf in local):
            return None
        return len(local), local + fixed, mps

    @staticmethod
    def _points_and_fixed(m, local, max_mp):
        """The points seen by the local keyframes (at most max_mp) and the
        fixed keyframes: the points' other observers. None without points."""
        local_ids = {kf.id for kf in local}
        local_mps = {}
        for kf in local:
            for mid in kf.mp_ids:
                if mid >= 0 and mid not in local_mps:
                    mp = m.mappoints.get(int(mid))
                    if mp is not None and not mp.bad:
                        local_mps[int(mid)] = mp
        if not local_mps:
            return None
        mps = list(local_mps.values())[:max_mp]
        fixed = {}
        for mp in mps:
            for kf_id in mp.obs:
                if kf_id not in local_ids and kf_id not in fixed:
                    kf = m.keyframes.get(kf_id)
                    if kf is not None and not kf.bad:
                        fixed[kf_id] = kf
        return mps, list(fixed.values())[:MAX_FIX_KF]

    def _local_ba(self, m):
        """The per-frame mode's local BA: launched on the device, committed
        at the next keyframe (or shutdown)."""
        sel = self._select_local_ba(m, MAX_BA_MP)
        if sel is None:
            return
        n_local, kfs, mps = sel
        prob = assemble_ba_problem(kfs, n_local, mps, m.init_kf_id, MAX_OPT_KF + MAX_FIX_KF)
        if prob is None:
            return
        wire, (K, P, O, mopp) = problem_wire(prob)
        cam = self.camera
        res = ba_solve_wire(
            torch.as_tensor(wire, device=self.device), [cam.fx, cam.fy, cam.cx, cam.cy],
            self.bf, K=K, P=P, O=O, MOPP=mopp,
        )
        self._pending_ba = {
            "res": res, "done": self._record_done(res), "shape": (K, P, O),
            "obs_meta": prob["obs_meta"], "kfs": kfs, "mps": prob["mps"],
            "kf_fixed": prob["kf_fixed"], "map": m,
        }

    def _local_ba_vi(self, m):
        """Joint visual-inertial local BA over the temporal keyframe chain
        (prev_kf links, at most MAX_OPT_KF): preintegrated inertial and bias
        random-walk edges between consecutive states, solved with the visual
        edges by ops/vi_ba.vi_ba_solve (ORB-SLAM3's LocalInertialBA shape,
        G2oTypes.h:522-666), and committed at once. The device wait happens
        outside the map lock, the writeback under it. Monocular rows only: the
        reference's third (stereo) row is zero on a monocular rig."""
        t0 = time.perf_counter()
        chain = [self.current_kf]
        while (len(chain) < MAX_OPT_KF and chain[-1].prev_kf is not None
               and not chain[-1].prev_kf.bad and chain[-1].prev_kf.id in m.keyframes):
            chain.append(chain[-1].prev_kf)
        chain.reverse()  # temporal order: edges between consecutive rows
        if len(chain) < 2:
            return self._local_ba(m)
        sel = self._points_and_fixed(m, chain, MAX_BA_MP)
        if sel is None:
            return
        mps, fixed = sel
        kfs = chain + fixed
        K = MAX_OPT_KF + MAX_FIX_KF
        prob = assemble_ba_problem(kfs, len(chain), mps, m.init_kf_id, K)
        if prob is None:
            return

        # Per-KF velocity/bias, with defaults for keyframes made after the VI
        # init: a finite-difference velocity, the previous keyframe's bias.
        kf_v = np.zeros((K, 3), np.float32)
        kf_bg = np.zeros((K, 3), np.float32)
        kf_ba = np.zeros((K, 3), np.float32)
        for i, kf in enumerate(kfs):
            if kf.bias_g is not None:
                kf_bg[i] = kf.bias_g
                kf_ba[i] = kf.bias_a
            elif 0 < i < len(chain) and kfs[i - 1].bias_g is not None:
                kf_bg[i] = kfs[i - 1].bias_g
                kf_ba[i] = kfs[i - 1].bias_a
            if kf.velocity is not None:
                kf_v[i] = kf.velocity
            elif 0 < i < len(chain):
                dt = max(kf.timestamp - kfs[i - 1].timestamp, 1e-3)
                kf_v[i] = (kf.center() - kfs[i - 1].center()) / dt

        # The chain's windows padded to K-1 edges, each preintegrated at its
        # start keyframe's bias.
        gyro, acc, dts, valid, w_ok = _stack_windows(chain, self.imu_buffer)
        E = len(chain) - 1
        pad = lambda x: np.concatenate([x, np.zeros((K - 1 - E,) + x.shape[1:], x.dtype)])  # noqa: E731
        pre_bg0, pre_ba0 = pad(kf_bg[:E]), pad(kf_ba[:E])
        pres, steps = preintegrate_windows(pad(gyro), pad(acc), pad(dts), pad(valid), pre_bg0, pre_ba0,
                                           self.device, sigma_g=self.imu_noise[0], sigma_a=self.imu_noise[1])
        dev = lambda x: torch.as_tensor(x, device=self.device)  # noqa: E731
        kf_pack, mp_pack, obs_pack = prob["kf_pack"], prob["mp_pack"], prob["obs_pack"]
        cam = self.camera
        res = vi_ba_solve(
            dev(kf_pack[:, 0:9].reshape(K, 3, 3)), dev(kf_pack[:, 9:12]), dev(kf_pack[:, 12] > 0),
            dev(kf_pack[:, 13] > 0), dev(kf_v), dev(kf_bg), dev(kf_ba), dev(mp_pack[:, 0:3]),
            dev(mp_pack[:, 3] > 0), dev(obs_pack[:, 0].astype(np.int64)), dev(obs_pack[:, 1].astype(np.int64)),
            dev(obs_pack[:, 2:4]), dev(obs_pack[:, 5] > 0), dev(prob["obp"].astype(np.int64)),
            pres, dev(pad(w_ok)), dev(pre_bg0), dev(pre_ba0), cam.fx, cam.fy, cam.cx, cam.cy,
            kf_vb_fixed=dev(np.arange(K) >= len(chain)),  # every chain state's v/b is free
        )
        res = {k: v.cpu().numpy() for k, v in res.items()}  # waits here, outside the lock
        out_kf = np.concatenate([res["kf_R"].reshape(K, 9), res["kf_t"]], axis=1)
        out_obs = np.stack([res["chi2"], res["depth"]], axis=1)
        with self.map_lock:
            commit_ba_result((out_kf, res["mp_pos"], out_obs), prob["obs_meta"], kfs, prob["mps"],
                             prob["kf_fixed"], m)
            for i, kf in enumerate(chain):
                if not kf.bad:
                    kf.velocity = res["kf_v"][i].astype(np.float64)
                    kf.bias_g = res["kf_bg"][i].astype(np.float64)
                    kf.bias_a = res["kf_ba"][i].astype(np.float64)
        self.vi_ba_ms.append(1e3 * (time.perf_counter() - t0))
        self.vi_ba_steps.append(steps)

    @staticmethod
    def _record_done(x):
        """A CUDA event after the work that made x (None on the CPU, where
        the work is done when the call returns)."""
        if x.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record()
        return done

    # --- deferred mapper jobs (ops/mapper_step) ----------------------------
    def _prepare_local_ba(self, m, small_ok=False):
        """Assemble the local-BA problem at one of the two mapper size
        classes (same selection as _local_ba). small_ok gates the SMALL class
        on the triangulation side fitting too (one size per job)."""
        sel = self._select_local_ba(m, MAPPER_BIG["P"])
        if sel is None:
            return None
        n_local, kfs, mps = sel
        # SMALL only when every axis surely fits. The obs count is bounded
        # above by the raw per-KF slot counts (the per-point cap and the
        # local-point join only shrink it): a borderline problem takes BIG,
        # never a truncation.
        sm = MAPPER_SMALL
        small = (
            small_ok and len(kfs) <= sm["K"] and len(mps) <= sm["P"]
            and sum(int(np.count_nonzero(kf.mp_ids >= 0)) for kf in kfs) <= sm["O"]
        )
        size = sm if small else MAPPER_BIG
        prob = assemble_ba_problem(
            kfs, n_local, mps, m.init_kf_id, size["K"], mopp=BA_MOPP,
            p_lo=size["P"], p_hi=size["P"], o_lo=size["O"], o_hi=size["O"],
        )
        if prob is None:
            return None
        wire, shapes = problem_wire(prob)
        return {"wire": wire, "shapes": shapes, "obs_meta": prob["obs_meta"], "kfs": kfs,
                "mps": prob["mps"], "kf_fixed": prob["kf_fixed"], "small": small}

    def _mapper_size_class(self, tri_job, ba_job):
        """One size class per job: the BA prep already folded the tri side
        into its SMALL decision; without a BA job the tri count alone picks."""
        if ba_job is not None:
            return MAPPER_SMALL if ba_job["small"] else MAPPER_BIG
        n_tri = len(tri_job["cand"]) if tri_job is not None else 0
        return MAPPER_SMALL if n_tri <= MAPPER_SMALL["C"] else MAPPER_BIG

    def _build_mapper_wires(self, tri_job, ba_job, size):
        """The host-side tri/BA wires of one keyframe's mapper job
        (ops/mapper_step.mapper_body). Returns (tri_wire, ba_wire) np f32."""
        C, K, P, O = size["C"], size["K"], size["P"], size["O"]
        tri_wire = np.zeros((C + 1, 32), np.float32)
        if tri_job is not None:
            cand = tri_job["cand"]
            n = len(cand)
            tri_wire[0, 0:12] = np.asarray(tri_job["P1"], np.float32).reshape(-1)
            tri_wire[0, 12:21] = np.asarray(tri_job["R1"], np.float32).reshape(-1)
            tri_wire[0, 21:24] = np.asarray(tri_job["t1"], np.float32)
            tri_wire[0, 24] = self.th_far_points if self.far_points else 0.0
            tri_wire[1 : n + 1, 0:12] = np.asarray(tri_job["P2s"], np.float32).reshape(n, 12)
            tri_wire[1 : n + 1, 12:14] = tri_job["uv1"]
            tri_wire[1 : n + 1, 14:16] = tri_job["uv2"]
            # Per-candidate pose and identity for the device-side gates and
            # the next window's snapshot patch.
            tri_wire[1 : n + 1, 16:25] = np.stack([kf2.R for (kf2, _, _) in cand]).reshape(n, 9)
            tri_wire[1 : n + 1, 25:28] = np.stack([kf2.t for (kf2, _, _) in cand])
            tri_wire[1 : n + 1, 28] = np.fromiter(
                (kf2.track_ids[b] for (kf2, _, b) in cand), np.int64, n
            ).astype(np.int32).view(np.float32)  # id bits in an f32 lane
            tri_wire[1 : n + 1, 29] = 1.0
        if ba_job is not None:
            ba_wire = ba_job["wire"]
        else:
            ba_wire = np.zeros(K * 14 + P * 4 + O * 6 + P * BA_MOPP, np.float32)
        return tri_wire, ba_wire

    def _dispatch_mapper_step(self, tri_job, ba_job, m):
        """Launch this keyframe's mapper job standalone; its result is pulled
        and committed at the NEXT keyframe (process_one -> _commit_deferred),
        and its patch bundles stay on the device for the next window."""
        size = self._mapper_size_class(tri_job, ba_job)
        tri_wire, ba_wire = self._build_mapper_wires(tri_job, ba_job, size)
        cam = self.camera
        out = mapper_step_wire(
            torch.as_tensor(tri_wire, device=self.device), torch.as_tensor(ba_wire, device=self.device),
            [cam.fx, cam.fy, cam.cx, cam.cy], self.bf,
            C=size["C"], K=size["K"], P=size["P"], O=size["O"],
        )
        self.n_standalone_jobs += 1
        self._deferred = {"out": out, "done": self._record_done(out["wire"]), "tri": tri_job,
                          "ba": ba_job, "map": m, "size": size}

    def poke_commit(self, blocking=True):
        """Land finished deferred mapper work into the host graph now. The
        windowed drive calls this before it publishes a snapshot that must
        not miss the last keyframe's triangulations. blocking=False commits
        the deferred job only if the device has finished it; an unfinished
        one commits at the next keyframe's process_one."""
        self._commit_pending_ba()
        self._commit_deferred(blocking=blocking)

    def take_staged(self, m):
        """Pop the staged job if it belongs to map m. The caller
        (System._dispatch_window) hands its wires to the window program and
        commits it from the window's result wire at replay."""
        return self._take("_staged", lambda st: st["map"] is m)

    def restage(self, st):
        """Put a taken job back: the speculative window that carried it was
        discarded after a rewind. Its wires are pure host data, so running
        them later commits the same result. If a NEWER job was staged
        meanwhile (a mid-window keyframe processed during the replay that
        caused the rewind), it is not clobbered: the blocking commit lands
        it (and any earlier standalone job) now, and the older job is
        launched standalone, so its triangulation and BA still land."""
        if st is None or st.get("committed"):
            return
        if self._staged is not None:
            self._commit_deferred()
            if st["map"] is self.atlas.current:
                self._dispatch_mapper_step(st["tri"], st["ba"], st["map"])
            return
        self._staged = st

    def commit_fused(self, st, X, out_kf, out_mp, out_obs):
        """Commit a job the window program ran, from the mapper section that
        trails the window's wire (the writeback of _commit_deferred on host
        arrays)."""
        st["committed"] = True
        self.n_fused_jobs += 1
        self._commit_mapper_result(st, X, out_kf, out_mp, out_obs)

    def _commit_mapper_result(self, job, X, out_kf, out_mp, out_obs):
        m = job["map"]
        if m is not self.atlas.current:
            return  # the map was reset or switched since the job was made
        with self.map_lock:
            if job["tri"] is not None:
                self._commit_triangulation(job["tri"], X.astype(np.float64), m)
            ba = job["ba"]
            if ba is not None:
                commit_ba_result((out_kf, out_mp, out_obs), ba["obs_meta"], ba["kfs"], ba["mps"],
                                 ba["kf_fixed"], m)

    def dispatch_staged_async(self):
        """Launch the staged job standalone without waiting for it: the
        windowed drive calls this when no window will carry the job (a
        per-frame stretch), so those frames do not track a snapshot that
        misses the last keyframe's triangulations for good."""
        if self._staged is None or self._deferred is not None:
            return
        self._flush_staged()

    def _flush_staged(self):
        """A staged job no window consumed (per-frame stretch, map switch,
        shutdown): launch it standalone now."""
        st = self._take("_staged")
        if st is None:
            return
        self._commit_deferred()  # land any earlier standalone job first
        if st["map"] is self.atlas.current:
            self._dispatch_mapper_step(st["tri"], st["ba"], st["map"])

    def _commit_deferred(self, blocking=True):
        """Pull and commit the launched mapper job: insert the gated
        triangulations, then write back the BA solution. When blocking, a
        staged job is first launched standalone (it must land before graph
        work that assumes it did)."""
        if blocking and self._staged is not None:
            self._flush_staged()
        d = self._take("_deferred", lambda d: blocking or d["done"] is None or d["done"].query())
        if d is None:
            return
        d["committed"] = True
        size = d["size"]
        # The pull waits for the device, outside the map lock.
        res = split_mapper_wire(d["out"]["wire"], C=size["C"], K=size["K"], P=size["P"], O=size["O"])
        self._commit_mapper_result(d, *res)

    def _commit_pending_ba(self):
        pending = self._take("_pending_ba")
        if pending is None or pending["map"] is not self.atlas.current:
            return  # nothing launched, or the map was reset since
        res = split_ba_wire(pending["res"].cpu().numpy(), *pending["shape"])  # waits here
        with self.map_lock:
            commit_ba_result(res, pending["obs_meta"], pending["kfs"], pending["mps"],
                             pending["kf_fixed"], pending["map"])
