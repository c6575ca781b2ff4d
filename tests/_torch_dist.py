"""Multi-process harness for the port's process-group tests (gloo, CPU).

`run(world, fn, tmp_path, *args)` spawns `world` ranks with
torch.multiprocessing.spawn; each joins a gloo group over a FileStore in
tmp_path (no TCP port, so parallel test workers never collide), calls
fn(rank, *args) and pickles the result. This module imports torch, numpy and
the port only: spawned ranks import it to find `fn`, and never import jax.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, fn, store_path, out_dir, args):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run(world, fn, tmp_path, *args):
    """fn(rank, *args) on `world` gloo ranks; returns the per-rank results."""
    out_dir = str(tmp_path)
    mp.spawn(_entry, args=(world, fn, os.path.join(out_dir, "store"), out_dir, args),
             nprocs=world, join=True)
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def sharded_ba_case(rng, n_shards=8):
    """tests/test_parallel.py::test_sharded_ba_matches_single_device's
    problem: K = 6 keyframes, 16 points with 3 observations each per shard,
    point-contiguous over n_shards shards; obp_single lists each point's
    observations (global indices, padding O)."""
    from movslam_tpu_torch.ops.lie import so3_exp

    K, P_per, MOPP = 6, 16, 8
    P = P_per * n_shards
    O_per = P_per * 3
    O = O_per * n_shards
    fx = fy = 200.0
    cx, cy = 64.0, 48.0
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(8, 14, P)], -1).astype(np.float32)
    Rs = np.stack([so3_exp(torch.tensor([0.0, 0.03 * k, 0.0])).numpy() for k in range(K)])
    ts = np.stack([np.array([-0.3 * k, 0, 0], np.float32) for k in range(K)])
    obs_kf = np.zeros(O, np.int32)
    obs_mp = np.zeros(O, np.int32)
    obs_uv = np.zeros((O, 2), np.float32)
    for pg in range(P):
        for c in range(3):
            og = pg * 3 + c
            k = (pg + c) % K
            pc = Rs[k] @ pts[pg] + ts[k]
            obs_kf[og], obs_mp[og] = k, pg
            obs_uv[og] = (fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy) + rng.normal(0, 0.3, 2)
    ts_p = ts + rng.normal(0, 0.03, ts.shape).astype(np.float32)
    pts_p = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    obp_single = np.full((P, MOPP), O, np.int32)
    obp_single[:, :3] = np.arange(O).reshape(P, 3)
    return {
        "kf_R": Rs.astype(np.float32), "kf_t": ts_p, "kf_fixed": np.arange(K) == 0,
        "kf_valid": np.ones(K, bool), "mp_pos": pts_p, "mp_valid": np.ones(P, bool),
        "obs_kf": obs_kf, "obs_mp": obs_mp, "obs_uv": obs_uv, "obs_valid": np.ones(O, bool),
        "obp_single": obp_single, "intr": (fx, fy, cx, cy),
    }


def local_indices(case, D):
    """obs_mp and obs_by_point with shard-local indices for D point-
    contiguous shards (shard d's rows index its own points and observations,
    padding = the shard's observation count)."""
    P, O = case["mp_pos"].shape[0], case["obs_kf"].shape[0]
    Pd, Od = P // D, O // D
    shard_o = np.arange(O) // Od
    shard_p = np.arange(P) // Pd
    obs_mp = case["obs_mp"] - shard_o * Pd
    obp = case["obp_single"]
    obp = np.where(obp < O, obp - (shard_p * Od)[:, None], Od).astype(np.int32)
    return obs_mp.astype(np.int32), obp


def sharded_ba_rank(rank, case, iters):
    """One rank of the port's sharded BA on `case`; returns numpy (R, t,
    the local points, costs)."""
    from movslam_tpu_torch.parallel.sharded_ba import make_sharded_ba

    D = dist.get_world_size()
    P, O = case["mp_pos"].shape[0], case["obs_kf"].shape[0]
    Pd, Od = P // D, O // D
    pts, obs = slice(rank * Pd, (rank + 1) * Pd), slice(rank * Od, (rank + 1) * Od)
    obs_mp, obp = local_indices(case, D)
    t = torch.as_tensor
    step = make_sharded_ba(iters=iters)
    out = step(t(case["kf_R"]), t(case["kf_t"]), t(case["kf_fixed"]), t(case["kf_valid"]),
               t(case["mp_pos"][pts]), t(case["mp_valid"][pts]), t(case["obs_kf"][obs]),
               t(obs_mp[obs]), t(case["obs_uv"][obs]), t(case["obs_valid"][obs]),
               t(obp[pts]), *case["intr"])
    return [x.numpy() for x in out]


GBA_CAMERA = (300.0, 300.0, 160.0, 120.0, 320, 240)  # tests/_torch_parity.gba_map's


def camera_settings(cam=GBA_CAMERA):
    """Monocular Settings with a pinhole (fx, fy, cx, cy, width, height)."""
    from movslam_tpu_torch.config.settings import Settings
    from movslam_tpu_torch.core.camera import Pinhole

    s = Settings()
    s.camera1 = Pinhole(*cam)
    return s


def map_state(m):
    """A map's keyframe poses and point positions by id, and observation counts."""
    return {
        "kf": {k: (kf.R.copy(), kf.t.copy()) for k, kf in m.keyframes.items()},
        "mp": {k: mp.pos.copy() for k, mp in m.mappoints.items()},
        "obs": {k: len(mp.obs) for k, mp in m.mappoints.items()},
    }


def perturb_poses(m, sigma=0.01, seed=0):
    """Move every keyframe but the first by ~sigma m, so that a global BA
    of a map its local BAs already converged has something to correct."""
    rng = np.random.default_rng(seed)
    for kf in sorted(m.keyframes.values(), key=lambda k: k.id)[1:]:
        kf.set_pose(kf.R, kf.t + rng.normal(0, sigma, 3))


def remove_scale_gauge(a, b, kfs, ids):
    """parallel/gba.py::remove_scale_gauge on two map_states: state a's
    translations and points (ids) with the scale about kfs[0] removed."""
    from movslam_tpu_torch.parallel.gba import remove_scale_gauge as remove

    def pose(st, i):
        return np.array([st["kf"][k][i] for k in kfs])

    return remove(pose(a, 0), pose(a, 1), np.array([a["mp"][i] for i in ids]), pose(b, 0), pose(b, 1), 0)


def mean_reprojection(state, atlas_path, cam):
    """Mean squared reprojection error (px^2) of a map_state over the
    observations of the map in atlas_path that the state still holds."""
    from movslam_tpu_torch.core import checkpoint

    m = checkpoint.load_atlas(atlas_path).current
    fx, fy, cx, cy = cam[:4]
    errs = []
    for kid, kf in m.keyframes.items():
        R, t = state["kf"][kid]
        for slot in np.flatnonzero(kf.mp_ids >= 0):
            mid = int(kf.mp_ids[slot])
            if mid in state["mp"]:
                pc = R @ state["mp"][mid] + t
                if pc[2] > 1e-6:
                    u, v = fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy
                    errs.append((u - kf.pts[slot, 0]) ** 2 + (v - kf.pts[slot, 1]) ** 2)
    return float(np.mean(errs))


def gba_rank(rank, atlas_path, iters, cam=GBA_CAMERA):
    """System.global_bundle_adjustment(mesh=the world group) on a System
    that loads `atlas_path`; returns the map's state (map_state)."""
    from movslam_tpu_torch.config.settings import MONOCULAR
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.core.verbose import Verbose

    Verbose.level = Verbose.QUIET
    system = System(camera_settings(cam), MONOCULAR, device="cpu")
    system.load_atlas(atlas_path)
    system.global_bundle_adjustment(iters=iters, mesh=dist.group.WORLD)
    return map_state(system.atlas.current)


def stereo_gba_rank(rank):
    """A map with a stereo row (bf = 80) through the sharded global BA with
    bf = 80 and bf = 0, and through the single-device one with bf = 80.
    True when the two sharded solves are equal and the single-device one
    differs from them."""
    from movslam_tpu_torch.core import camera, local_mapping, map as pmap
    from movslam_tpu_torch.parallel import gba
    from tests._torch_parity import gba_map

    runs = []
    for sharded, bf in ((True, 80.0), (True, 0.0), (False, 80.0)):
        m, cam, kfs = gba_map(pmap, camera, n_kf=12, n_mp=200, seed=4, bf=80.0)
        if sharded:
            gba.global_bundle_adjustment_sharded(m, cam, device="cpu", bf=bf, iters=3)
        else:
            local_mapping.global_bundle_adjustment(m, cam, device="cpu", bf=bf, iters=3)
        runs.append(np.stack([kf.t for kf in kfs]))
    return np.array_equal(runs[0], runs[1]) and not np.allclose(runs[0], runs[2], atol=1e-6)
