"""Global bundle adjustment over a process group.

Port of movslam_tpu/parallel/gba.py: System.global_bundle_adjustment(mesh=
group) lands here. The windows, anchors and problem assembly are the
single-device global BA's (core/local_mapping.py::global_bundle_adjustment);
the map points and their observations are split point-contiguously over the
group's ranks and solved by parallel/sharded_ba.py. Every rank holds the
same map: each assembles the same problem, solves its shard, all-gathers
the point shards and commits the whole result, so the maps stay identical.

Monocular rows only, as in the reference: `bf` is taken and not passed on
(the reference's gba.py:107 takes it, :129-132 drop it), so a stereo map
loses its right-image row here but keeps it on one device
(ROADMAP Queue 3).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.local_mapping import commit_ba_result, gba_problem, gba_windows
from ..ops.ba import build_obs_by_point
from .mesh import all_gather_shards, group_or_world, rank, world_size
from .sharded_ba import make_sharded_ba


def _shard_problem(prob, D, mopp):
    """Partition an assembled BA problem point-contiguously over D shards.

    Points: P split into D equal chunks (P is a power-of-two bucket).
    Observations: each shard's rows (the assembly emits them point-major),
    padded to one capacity, with obs_mp re-indexed into the LOCAL point
    chunk. Returns arrays whose leading dims are D * chunk."""
    mp_pack, obs_pack = prob["mp_pack"], prob["obs_pack"]
    P = mp_pack.shape[0]
    if P % D:
        raise ValueError(f"{P} points do not split over {D} shards")
    Pd = P // D
    obs_mp = obs_pack[:, 1].astype(np.int64)
    obs_valid = obs_pack[:, 5] > 0
    shard_of = np.where(obs_valid, obs_mp // Pd, -1)
    counts = np.array([(shard_of == d).sum() for d in range(D)])
    Od = 1 << int(np.maximum(counts.max(), 1) - 1).bit_length()
    Od = min(Od, obs_pack.shape[0])

    obs_sh = np.zeros((D, Od, 6), np.float32)
    obp_sh = np.zeros((D, Pd, mopp), np.int64)
    for d in range(D):
        rows = np.flatnonzero(shard_of == d)[:Od]
        obs_sh[d, :len(rows)] = obs_pack[rows]
        obs_sh[d, :len(rows), 1] -= d * Pd  # local point index
        local_mp = np.where(obs_sh[d, :, 5] > 0, obs_sh[d, :, 1].astype(np.int64), Pd)
        obp_sh[d] = build_obs_by_point(local_mp, Pd, mopp, Od)
    return {
        "kf_pack": prob["kf_pack"],
        "mp_pos": mp_pack[:, 0:3],
        "mp_valid": mp_pack[:, 3] > 0,
        "obs_kf": obs_sh[:, :, 0].reshape(-1).astype(np.int32),
        "obs_mp": obs_sh[:, :, 1].reshape(-1).astype(np.int32),
        "obs_uv": obs_sh[:, :, 2:4].reshape(-1, 2),
        "obs_valid": obs_sh[:, :, 5].reshape(-1) > 0,
        "obp": obp_sh.reshape(-1, mopp),
        "Od": Od,
    }


def _host_chi2_depth(kfs, obs_meta, R, t, X, camera, n_obs):
    """Per-observation chi2 and depth after the solve, for the pruning
    commit (Optimizer.cc:761-818; ops/ba.py's out_obs)."""
    o_kf, o_mp, o_slot = obs_meta
    n = len(o_kf)
    out = np.zeros((n_obs, 2), np.float32)
    if n == 0:
        return out
    pc = np.einsum("oij,oj->oi", R[o_kf], X[o_mp]) + t[o_kf]
    z = pc[:, 2]
    u = camera.fx * pc[:, 0] / np.maximum(z, 1e-9) + camera.cx
    v = camera.fy * pc[:, 1] / np.maximum(z, 1e-9) + camera.cy
    uv = np.stack([kfs[int(o_kf[i])].pts[int(o_slot[i])] for i in range(n)])
    out[:n, 0] = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    out[:n, 1] = z
    return out


def global_bundle_adjustment_sharded(m, camera, group=None, *, device, bf=0.0, iters=20,
                                     map_lock=None):
    """Full-map BA over a process group (default: the world group; without
    an initialized group this raises). Same windows and anchors as the
    single-device global BA; each rank solves on `device` (CUDA for NCCL,
    the CPU for gloo). `bf` is not used (see the module docstring)."""
    g = group_or_world(group)
    for w_kfs, n_anchor in gba_windows(m):
        _sharded_window(m, camera, g, w_kfs, n_anchor, iters, map_lock, torch.device(device))


def _sharded_window(m, camera, group, kfs, n_anchor, iters, map_lock, device):
    D, r = world_size(group), rank(group)
    ordered, prob = gba_problem(m, kfs, n_anchor)  # P: a power of two >= 512
    if prob is None:
        return
    K = prob["kf_pack"].shape[0]
    sh = _shard_problem(prob, D, prob["obp"].shape[1])
    Pd, Od = sh["mp_pos"].shape[0] // D, sh["Od"]
    pts, obs = slice(r * Pd, (r + 1) * Pd), slice(r * Od, (r + 1) * Od)

    def on(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    kf_pack = sh["kf_pack"]
    step = make_sharded_ba(group, iters=iters)
    R, t, X_local, _ = step(
        on(kf_pack[:, 0:9].reshape(-1, 3, 3)), on(kf_pack[:, 9:12]), on(kf_pack[:, 12] > 0),
        on(kf_pack[:, 13] > 0), on(sh["mp_pos"][pts]), on(sh["mp_valid"][pts]),
        on(sh["obs_kf"][obs]), on(sh["obs_mp"][obs]), on(sh["obs_uv"][obs]),
        on(sh["obs_valid"][obs]), on(sh["obp"][pts]), camera.fx, camera.fy, camera.cx, camera.cy,
    )
    X = all_gather_shards(X_local, group).cpu().numpy().astype(np.float64)
    R = R.cpu().numpy().astype(np.float64)
    t = t.cpu().numpy().astype(np.float64)

    out_kf = np.zeros((K, 12), np.float32)
    out_kf[:, 0:9] = R.reshape(K, 9)
    out_kf[:, 9:12] = t
    out_obs = _host_chi2_depth(ordered, prob["obs_meta"], R, t, X, camera, prob["obs_pack"].shape[0])
    res = (out_kf, X[:prob["mp_pack"].shape[0]].astype(np.float32), out_obs)
    with map_lock if map_lock is not None else contextlib.nullcontext():
        commit_ba_result(res, prob["obs_meta"], ordered, prob["mps"], prob["kf_fixed"], m)


def remove_scale_gauge(Ra, ta, Xa, Rb, tb, k0):
    """Monocular global BA fixes one keyframe (k0), so two solves of one
    problem (on the group and on one device, or in two summation orders)
    agree up to a scale about that keyframe's camera centre, a direction
    that rounding moves freely (ROADMAP Queue 3, Atlas (g)-(h)). Returns the
    least-squares scale taking a's camera centres onto b's, and a's
    translations and points with it applied (numpy; rotations (K, 3, 3),
    translations (K, 3), points (P, 3))."""
    Ra, ta, Xa, Rb, tb = (np.asarray(x, np.float64) for x in (Ra, ta, Xa, Rb, tb))
    c0 = -Rb[k0].T @ tb[k0]
    ca = -np.einsum("kji,kj->ki", Ra, ta) - c0
    cb = -np.einsum("kji,kj->ki", Rb, tb) - c0
    s = float((ca * cb).sum() / max((ca * ca).sum(), 1e-30))
    return s, -np.einsum("kij,kj->ki", Ra, c0 + s * ca), c0 + s * (Xa - c0)
