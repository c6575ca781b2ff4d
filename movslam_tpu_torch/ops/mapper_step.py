"""Per-keyframe mapper program: triangulation + local BA on one set of wires.

Port of movslam_tpu/ops/mapper_step.py. The reference's mapper thread runs
CreateNewMapPoints (LocalMapping.cc:220-501) and LocalBundleAdjustment
(Optimizer.cc:461-841) as separate stages; here both read one pair of host
wires and write one flat result:

    inputs : tri_wire  (C+1, 32) — row 0 = [P1 flat(12) | R1(9) | t1(3) |
             th_far(1)]; rows 1.. = [P2 flat(12) | uv1(2) | uv2(2) | R2(9) |
             t2(3) | tid i32-bits(1) | valid(1)] per candidate pair
             ba_wire   flat f32 — the ops.ba.ba_solve_wire layout
    outputs: wire      flat f32 [X C*3 | out_kf K*12 | out_mp P*3 | out_obs O*2]
             patch_tri (C_PATCH, 10) [X(3) | tid bits | ok | normal(3) |
             mind | maxd] — new points that passed the CreateNewMapPoints
             gates (LocalMapping.cc:311-495) on the device
             patch_mp  (P_PATCH, 3) — BA-optimized point positions

LocalMapping launches this at keyframe n. The window program tracking the
next frames either takes patch_tri/patch_mp as device-resident inputs and
scatters them into its map snapshot (ops/window_step._apply_patch), or runs
`mapper_body` itself on a staged job's wires; the flat wire is pulled and
committed into the host graph at keyframe n+1.

The two size classes and the pinned patch shapes are the reference's: they
keep both drives on the same problems and give the window program one patch
layout whichever class ran. Track ids ride in f32 lanes as bit patterns and
are only ever copied (slices, `cat`, `where`), never computed on.
"""
from __future__ import annotations

import numpy as np
import torch

from .ba import ba_solve_packed
from .triangulate import triangulate_pairs

TRI_CAP = 4096
BA_K = 48
BA_P = 2048
BA_O = 8192
BA_MOPP = 16

# Patch shapes shared by SMALL and BIG: the first C_PATCH gated
# triangulations and all BA point positions ride to the next window's
# snapshot patch.
C_PATCH = 1024
P_PATCH = 2048

# SMALL covers the common live local-BA problem (<= 32 KFs, <= 1024 points,
# <= 4096 obs, <= 1024 tri pairs); BIG is the cap. The window program runs
# SMALL jobs itself; BIG ones go through mapper_step_wire.
MAPPER_SMALL = {"C": 1024, "K": 32, "P": 1024, "O": 4096}
MAPPER_BIG = {"C": TRI_CAP, "K": BA_K, "P": BA_P, "O": BA_O}

REPROJ_TRI = 5.0  # CreateNewMapPoints reprojection gate (LocalMapping.cc:420)
COS_PARALLAX = 0.9998  # ray parallax gate (~1.15 deg)
# MapPoint scale-invariance band — must match core/map.py (SCALE_FACTOR,
# N_LEVELS); duplicated here because ops/ never imports core/.
SCALE_FACTOR = 1.2
N_LEVELS = 8


def _tri_gates(X, row0, P2s, uv1, uv2, R2s, t2s, cand_valid, intr):
    """CreateNewMapPoints acceptance gates on the device (mirrors the host's
    _commit_triangulation numpy gates, core/local_mapping.py): finite,
    parallax, positive depths, reprojection <= delta, positive/far distances.
    Returns (ok (C,), normal (C, 3), mind (C,), maxd (C,)) as the host
    commit's update_normals_batch would assign to the new 2-observation
    point. The host commit stays canonical: this gate only decides which rows
    patch the NEXT window's transient snapshot."""
    P1 = row0[0:12].reshape(3, 4)
    R1 = row0[12:21].reshape(3, 3)
    t1 = row0[21:24]
    th_far = row0[24]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]

    Ow1 = -(R1.T @ t1)
    Ow2 = -torch.einsum("cji,cj->ci", R2s, t2s)

    def rays(uv):
        return torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, torch.ones_like(uv[:, 0])], dim=1)

    ray1 = rays(uv1) @ R1  # R1^T r, row-wise
    ray2 = torch.einsum("cji,cj->ci", R2s, rays(uv2))
    cos_par = (ray1 * ray2).sum(-1) / (
        torch.linalg.vector_norm(ray1, dim=1) * torch.linalg.vector_norm(ray2, dim=1) + 1e-12
    )

    Xh = torch.cat([X, torch.ones_like(X[:, :1])], dim=1)  # (C, 4)
    p1 = Xh @ P1.T  # z1 = p1[:, 2] since K's last row is [0 0 1]
    p2 = torch.einsum("cij,cj->ci", P2s, Xh)
    z1, z2 = p1[:, 2], p2[:, 2]
    z1s = torch.where(z1.abs() < 1e-9, torch.full_like(z1, 1e-9), z1)
    z2s = torch.where(z2.abs() < 1e-9, torch.full_like(z2, 1e-9), z2)
    e1 = (p1[:, 0] / z1s - uv1[:, 0]) ** 2 + (p1[:, 1] / z1s - uv1[:, 1]) ** 2
    e2 = (p2[:, 0] / z2s - uv2[:, 0]) ** 2 + (p2[:, 1] / z2s - uv2[:, 1]) ** 2

    d1 = torch.linalg.vector_norm(X - Ow1, dim=1)
    d2 = torch.linalg.vector_norm(X - Ow2, dim=1)
    ok = (
        cand_valid
        & torch.isfinite(X).all(dim=1)
        & (cos_par < COS_PARALLAX)
        & (z1 > 0) & (z2 > 0)
        & (e1 <= REPROJ_TRI) & (e2 <= REPROJ_TRI)
        & (d1 > 0) & (d2 > 0)
    )
    ok = ok & ((th_far <= 0) | ((d1 < th_far) & (d2 < th_far)))
    # Host parity (update_normals_batch): normal = mean of the two unit
    # viewing directions, band from d1 (the creating keyframe).
    u1dir = (X - Ow1) / d1.clamp(min=1e-9)[:, None]
    u2dir = (X - Ow2) / d2.clamp(min=1e-9)[:, None]
    normal = 0.5 * (u1dir + u2dir)
    maxd = d1 * SCALE_FACTOR
    mind = maxd / (SCALE_FACTOR ** N_LEVELS)
    return ok, normal, mind, maxd


def _pin(a, n):
    """First n rows of a, zero-padded to n (a copy: id bit lanes survive)."""
    if a.shape[0] >= n:
        return a[:n]
    out = torch.zeros((n,) + a.shape[1:], dtype=a.dtype, device=a.device)
    out[: a.shape[0]] = a
    return out


def mapper_body(tri_wire, ba_wire, intr, bf, *, K=BA_K, P=BA_P, O=BA_O, MOPP=BA_MOPP, iters=10):
    """Triangulation + LM BA + patch bundles of one keyframe, shared by
    mapper_step_wire and the window program (ops/window_step), which runs a
    staged job's wires ahead of its frames. `intr` is fx fy cx cy as host
    floats or a (4,) tensor. Returns dict(wire, patch_tri, patch_mp)."""
    row0 = tri_wire[0]
    P1 = row0[0:12].reshape(3, 4)
    P2s = tri_wire[1:, 0:12].reshape(-1, 3, 4)
    uv1 = tri_wire[1:, 12:14]
    uv2 = tri_wire[1:, 14:16]
    R2s = tri_wire[1:, 16:25].reshape(-1, 3, 3)
    t2s = tri_wire[1:, 25:28]
    tid_bits = tri_wire[1:, 28]
    cand_valid = tri_wire[1:, 29] > 0
    X = triangulate_pairs(P1, P2s, uv1, uv2)  # (C, 3)
    ok, normal, mind, maxd = _tri_gates(X, row0, P2s, uv1, uv2, R2s, t2s, cand_valid, intr)

    o0 = K * 14
    o1 = o0 + P * 4
    o2 = o1 + O * 6
    out_kf, out_mp, out_obs = ba_solve_packed(
        ba_wire[:o0].reshape(K, 14), ba_wire[o0:o1].reshape(P, 4), ba_wire[o1:o2].reshape(O, 6),
        ba_wire[o2:].reshape(P, MOPP), intr, bf, iters=iters,
    )

    patch_tri = torch.cat(
        [
            _pin(X, C_PATCH),
            _pin(tid_bits, C_PATCH)[:, None],
            _pin(ok.to(torch.float32), C_PATCH)[:, None],
            _pin(normal, C_PATCH),
            _pin(mind, C_PATCH)[:, None],
            _pin(maxd, C_PATCH)[:, None],
        ],
        dim=1,
    )
    patch_mp = _pin(out_mp, P_PATCH)
    wire = torch.cat([X.reshape(-1), out_kf.reshape(-1), out_mp.reshape(-1), out_obs.reshape(-1)])
    return {"wire": wire, "patch_tri": patch_tri, "patch_mp": patch_mp}


def mapper_step_wire(tri_wire, ba_wire, intr, bf, *, C=TRI_CAP, K=BA_K, P=BA_P, O=BA_O,
                     MOPP=BA_MOPP, iters=10):
    """One keyframe's device work: C-pair DLT triangulation + (K, P, O) LM
    BA. Padded rows are harmless: zero tri rows fail the device gates and the
    host gates; zero-validity BA rows contribute nothing and fixed or invalid
    keyframes come back unchanged."""
    if tri_wire.shape[0] != C + 1:
        raise ValueError(f"tri_wire has {tri_wire.shape[0]} rows, expected C + 1 = {C + 1}")
    return mapper_body(tri_wire, ba_wire, intr, bf, K=K, P=P, O=O, MOPP=MOPP, iters=iters)


def split_mapper_wire(out, C=TRI_CAP, K=BA_K, P=BA_P, O=BA_O):
    """Host inverse: flat result -> (X (C, 3), out_kf (K, 12), out_mp (P, 3),
    out_obs (O, 2)). A tensor is pulled here (the one device wait)."""
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    out = np.asarray(out)
    a = C * 3
    b = a + K * 12
    c = b + P * 3
    return (out[:a].reshape(C, 3), out[a:b].reshape(K, 12), out[b:c].reshape(P, 3),
            out[c:].reshape(O, 2))
