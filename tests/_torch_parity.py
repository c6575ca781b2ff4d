"""Parity helpers for the PyTorch port: one numpy input, two implementations.

Inputs are made with numpy from a seed, fed to the JAX reference function
(movslam_tpu) and to its port (movslam_tpu_torch), and the outputs are
compared as numpy arrays with a stated tolerance.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)  # tier-1 runs several xdist workers on one host


def to_np(x):
    """torch tensor / jax array / numpy -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def u32(x):
    """Descriptor words as uint32 bit patterns, whichever side they came from."""
    a = np.ascontiguousarray(to_np(x))
    return a.view(np.uint32) if a.dtype == np.int32 else a


def t(x, dtype=None):
    """numpy -> CPU torch tensor (a copy)."""
    a = np.array(x, dtype=dtype) if dtype is not None else np.array(x)
    return torch.from_numpy(a)


def assert_exact(got, want, what=""):
    """Bit-exact: integer outputs (descriptors, ids, counts, wire words)."""
    np.testing.assert_array_equal(to_np(got), to_np(want), err_msg=what)


def assert_close(got, want, atol, rtol=0.0, what=""):
    """Float outputs within a stated tolerance."""
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol, err_msg=what)


def jax_state_arrays(st):
    """A JAX TrackState's leaves as a dict of numpy arrays (for from_numpy)."""
    return {
        "pt": np.asarray(st.pt), "track_id": np.asarray(st.track_id),
        "age": np.asarray(st.age), "desc": np.asarray(st.desc),
        "mb_wh": np.asarray(st.mb_wh), "coverage": np.asarray(st.coverage),
        "valid": np.asarray(st.valid), "next_id": np.asarray(st.next_id),
    }


def assert_state_equal(port_state, jax_state, lk_rows=None, lk_atol=1e-3):
    """TrackState parity: integer fields exact; positions exact except on
    LK-tracked rows (default: the coverage-flagged ones), held to lk_atol."""
    j = jax_state_arrays(jax_state)
    assert_exact(port_state.valid, j["valid"], "valid")
    assert_exact(port_state.track_id, j["track_id"], "track_id")
    assert_exact(port_state.age, j["age"], "age")
    assert_exact(u32(port_state.desc), j["desc"], "desc")
    assert_exact(port_state.coverage, j["coverage"], "coverage")
    assert_exact(int(port_state.next_id), int(j["next_id"]), "next_id")
    assert_close(port_state.mb_wh, j["mb_wh"], 0.0, what="mb_wh")
    lk = j["coverage"] if lk_rows is None else np.asarray(lk_rows)
    v = j["valid"]
    pt = to_np(port_state.pt)
    assert_close(pt[v & ~lk], j["pt"][v & ~lk], 0.0, what="pt (MV, seed, grid)")
    assert_close(pt[v & lk], j["pt"][v & lk], lk_atol, what="pt (LK)")


def synthetic_pframe(capacity=512, n_mvs=1024, n_kps=512, H=240, W=320, seed=0):
    """The random P-frame inputs of __graft_entry__._example_pframe_args, as
    numpy: a textured image pair, a half-full track state and MV tables."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (H, W)).astype(np.uint8)
    prev_img = rng.integers(0, 255, (H, W)).astype(np.uint8)
    n = capacity // 2
    state = {
        "pt": rng.uniform(16, 200, (capacity, 2)).astype(np.float32),
        "track_id": np.arange(capacity, dtype=np.int32),
        "age": rng.integers(0, 5, capacity).astype(np.int32),
        "desc": rng.integers(0, 2**32, (capacity, 8), dtype=np.uint32),
        "mb_wh": np.full((capacity, 2), 16.0, np.float32),
        "coverage": np.zeros(capacity, bool),
        "valid": np.arange(capacity) < n,
        "next_id": np.int32(capacity),
    }
    mv_delta = rng.normal(0, 2, (n_mvs, 2)).astype(np.float32)
    x0 = rng.uniform(0, W - 17, n_mvs).astype(np.float32)
    y0 = rng.uniform(0, H - 17, n_mvs).astype(np.float32)
    mv_rect = np.stack([x0, y0, x0 + 16, y0 + 16], -1)
    mv_dindx = (np.arange(n_mvs) % n_kps).astype(np.int32)
    mv_valid = np.ones(n_mvs, bool)
    kx = rng.uniform(0, W - 17, n_kps).astype(np.float32)
    ky = rng.uniform(0, H - 17, n_kps).astype(np.float32)
    kps_rect = np.stack([kx, ky, np.full(n_kps, 16.0), np.full(n_kps, 16.0)], -1).astype(np.float32)
    kps_valid = np.ones(n_kps, bool)
    return {
        "img": img, "prev_img": prev_img, "state": state,
        "mv_delta": mv_delta, "mv_rect": mv_rect, "mv_dindx": mv_dindx,
        "mv_valid": mv_valid, "kps_rect": kps_rect, "kps_valid": kps_valid,
    }


def candidate_case(seed, H=240, W=320, N=256, M=512, threshold=25.0):
    """numpy inputs of kernels.score_candidates that reach every case of its
    choice rule: rows without a candidate, with 1-4 candidates, tracks
    within 8 px of the borders (some just outside, where truncation and floor
    differ), ties between two slots holding the same MV, near-matching
    previous descriptors, and rows whose every candidate scores exactly 256.
    Returns dict(img, prev_pt, cand, mv_delta, prev_wh, prev_desc)."""
    from movslam_tpu_torch.ops.kernels import score_blocks_ref

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    pt = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], -1)
    off = rng.uniform(-2.0, 8.0, N)
    side = np.where(rng.uniform(size=N) < 0.5, rng.integers(0, 4, N), -1)
    pt[side == 0, 0] = off[side == 0]
    pt[side == 1, 0] = W - off[side == 1]
    pt[side == 2, 1] = off[side == 2]
    pt[side == 3, 1] = H - off[side == 3]
    pt = pt.astype(np.float32)
    mv_delta = rng.normal(0, 3, (max(M, 1), 2)).astype(np.float32)[:M]
    k = rng.integers(0, 5, N)
    cand = rng.integers(0, max(M, 1), (N, 4)).astype(np.int32)
    cand[np.arange(4)[None, :] >= k[:, None]] = -1
    tie = (k >= 2) & (rng.uniform(size=N) < 0.2)
    cand[tie, 1] = cand[tie, 0]
    flat = (k >= 2) & (rng.uniform(size=N) < 0.08)  # every slot the same MV
    cand[flat] = cand[flat, :1]
    wh = np.full((N, 2), 16.0, np.float32)
    wh[rng.uniform(size=N) < 0.15] = 8.0
    wh[rng.uniform(size=N) < 0.1] = 32.0

    # Each slot's descriptor, to make near matches and exact-256 rows.
    cand_pt = pt[:, None, :] + mv_delta[np.maximum(cand, 0)] if M else np.zeros((N, 4, 2), np.float32)
    tl = cand_pt.astype(np.int32).reshape(-1, 2) - 8
    zeros = np.zeros((4 * N, 8), np.int32)
    _, desc = score_blocks_ref(torch.from_numpy(img), torch.from_numpy(tl), torch.from_numpy(zeros),
                               threshold)
    desc = desc.numpy().view(np.uint32).reshape(N, 4, 8)
    prev = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    near = (k >= 1) & ~flat & (rng.uniform(size=N) < 0.3)
    j = rng.integers(0, np.maximum(k, 1))
    flips = np.where(rng.uniform(size=(N, 8)) < 0.05, np.uint32(1) << rng.integers(0, 32, (N, 8)).astype(np.uint32), 0)
    prev[near] = desc[near, j[near]] ^ flips[near].astype(np.uint32)
    prev[flat] = ~desc[flat, 0]
    return {"img": img, "prev_pt": pt, "cand": cand, "mv_delta": mv_delta, "prev_wh": wh,
            "prev_desc": prev.view(np.int32)}


def replay_jax_draws(keys, split=True):
    """A port sampler that replays the reference's RANSAC draws.

    Each call consumes the next JAX key and returns what the reference
    draws from it: `jax.random.randint(k, (n_hyp, sample), 0, max(n_valid,
    1))`, with k = split(key)[0] for PnP (pnp.py:207) and k = key for the
    two-view initializer (twoview.py:147)."""
    import jax

    keys = list(keys)

    def sampler(n_hyp, sample, n_valid):
        key = keys.pop(0)
        k = jax.random.split(key)[0] if split else key
        u = jax.random.randint(k, (n_hyp, sample), 0, max(int(n_valid), 1))
        return torch.as_tensor(np.array(u), dtype=torch.int64, device=n_valid.device)

    return sampler


def window_keys(key, n_frames):
    """The per-stage PnP keys of a reference window program, in the order a
    port sampler is called: window_step.py splits `key` once per frame
    (`k, sub = split(k)`), frame_step.py splits `sub` into the keys of stage 1
    and stage 2. Feed the list to replay_jax_draws."""
    import jax

    keys = []
    for _ in range(n_frames):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        keys += [k1, k2]
    return keys


def port_window_inputs(jax_state, snap_fused, pose_pack, tri_wire=None, ba_wire=None, device="cpu"):
    """What a reference window program starts from, as the port's tensors,
    bit for bit: a JAX TrackState, a MapSnapshot.fused image, a pose_pack and
    (optionally) a staged mapper job's tri/BA wires, all through numpy.
    Returns (TrackState, snap, pose_pack, tri_wire, ba_wire)."""
    from movslam_tpu_torch.core.trackstate import TrackState

    def dev(a):
        return None if a is None else torch.from_numpy(np.array(to_np(a))).to(device)

    return (TrackState.from_numpy(jax_state_arrays(jax_state), device=device), dev(snap_fused),
            dev(pose_pack), dev(tri_wire), dev(ba_wire))


# Track ids whose f32 bit patterns are a denormal, a large normal and two
# NaNs: they must cross every f32 lane unchanged.
ID_BIT_CASES = np.array([1, 2**23 + 1, 0x7FC00001, -4194303, 0x7F800001], np.int64).astype(np.int32)


def look_at_pose(center, yaw=0.0):
    """Camera-from-world (R, t) of a camera at `center` looking along +z,
    turned by `yaw` about y."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    return R, -R @ np.asarray(center, np.float64)


def mapper_job_case(seed, C, K, P, O, mopp=16, intr=(320.0, 320.0, 160.0, 120.0), n_kf=6,
                    n_pts=90, tri_world=None, tri_tids=None, cam0=None, th_far=0.0,
                    ba_world=None, ba_noise=0.03, baseline=0.25, n_fixed=2):
    """One keyframe's mapper job as the host would stage it (numpy): the
    (C+1, 32) tri wire and the flat BA wire of ops/mapper_step.

    BA side: n_kf keyframes `baseline` metres apart, the first n_fixed fixed
    (one fixed camera leaves mono BA a free scale), the others with perturbed
    poses; `ba_world` (or n_pts random points 4-8 m ahead) observed by every
    keyframe with 0.3 px noise and started ba_noise off. Tri side: camera
    `cam0` (default: the first keyframe) against one of the other keyframes
    per candidate; `tri_world` (or random points) with 0.2 px noise. A sixth
    of the candidates each fail one gate by a wide margin: reprojection
    (uv2 + 20 px), parallax (second camera = first), the valid flag.
    Returns dict(tri_wire, ba_wire, intr, n_tri, bad (n_tri,) bool, tids)."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = intr
    Kmat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    poses = [look_at_pose([baseline * i, 0.02 * (i % 2), 0.0], yaw=0.01 * i) for i in range(n_kf)]

    def proj(Rt, X):
        pc = X @ Rt[0].T + Rt[1]
        return np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1)

    # --- BA wire -----------------------------------------------------------
    if ba_world is None:
        ba_world = np.stack([rng.uniform(-2, 3, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                             rng.uniform(4, 8, n_pts)], 1)
    n_pts = len(ba_world)
    kf_pack = np.zeros((K, 14), np.float32)
    kf_pack[:, 0] = kf_pack[:, 4] = kf_pack[:, 8] = 1.0
    kf_pack[:, 12] = 1.0
    obs = []
    for i, (R, tt) in enumerate(poses):
        uv = proj((R, tt), ba_world) + rng.normal(0, 0.3, (n_pts, 2))
        obs.append(np.stack([np.full(n_pts, i), np.arange(n_pts), uv[:, 0], uv[:, 1],
                             -np.ones(n_pts), np.ones(n_pts)], 1))
        if i >= n_fixed:
            R = look_at_pose([0, 0, 0], yaw=rng.normal(0, 0.004))[0] @ R
            tt = tt + rng.normal(0, 0.02, 3)
        kf_pack[i, 0:9] = R.reshape(-1)
        kf_pack[i, 9:12] = tt
        kf_pack[i, 12] = i < n_fixed
        kf_pack[i, 13] = 1.0
    obs = np.concatenate(obs)
    obs = obs[np.lexsort((obs[:, 0], obs[:, 1]))][:O]  # point-major, as the host assembles
    obs_pack = np.zeros((O, 6), np.float32)
    obs_pack[:, 4] = -1.0
    obs_pack[: len(obs)] = obs
    mp_pack = np.zeros((P, 4), np.float32)
    mp_pack[:n_pts, 0:3] = ba_world + rng.normal(0, ba_noise, ba_world.shape)
    mp_pack[:n_pts, 3] = 1.0
    from movslam_tpu_torch.ops.ba import build_obs_by_point

    obs_mp = np.where(obs_pack[:, 5] > 0, obs_pack[:, 1].astype(np.int64), P)
    obp = build_obs_by_point(obs_mp, P, mopp, O)
    ba_wire = np.concatenate([kf_pack.ravel(), mp_pack.ravel(), obs_pack.ravel(),
                              obp.ravel().astype(np.float32)]).astype(np.float32)

    # --- tri wire ----------------------------------------------------------
    if tri_world is None:
        n_tri = min(C, 48)
        tri_world = np.stack([rng.uniform(-2, 3, n_tri), rng.uniform(-1.5, 1.5, n_tri),
                              rng.uniform(4, 8, n_tri)], 1)
    n_tri = len(tri_world)
    assert n_tri <= C
    if tri_tids is None:
        tri_tids = (5000 + np.arange(n_tri)).astype(np.int32)
        tri_tids[: len(ID_BIT_CASES)] = ID_BIT_CASES
    R1, t1 = poses[0] if cam0 is None else cam0
    tri_wire = np.zeros((C + 1, 32), np.float32)
    tri_wire[0, 0:12] = (Kmat @ np.concatenate([R1, t1[:, None]], 1)).reshape(-1)
    tri_wire[0, 12:21] = R1.reshape(-1)
    tri_wire[0, 21:24] = t1
    tri_wire[0, 24] = th_far
    uv1 = proj((R1, t1), tri_world) + rng.normal(0, 0.2, (n_tri, 2))
    which = 1 + np.arange(n_tri) % (n_kf - 1)
    kind = np.where(np.arange(n_tri) % 6 == 5, (np.arange(n_tri) // 6) % 3, -1)
    kind[: len(ID_BIT_CASES)] = -1  # the id-bit cases pass the gates
    for i in range(n_tri):
        R2, t2 = (R1, t1) if kind[i] == 1 else poses[which[i]]
        uv2 = proj((R2, t2), tri_world[i:i + 1])[0] + rng.normal(0, 0.2, 2)
        if kind[i] == 0:
            uv2 = uv2 + 20.0
        row = tri_wire[1 + i]
        row[0:12] = (Kmat @ np.concatenate([R2, t2[:, None]], 1)).reshape(-1)
        row[12:14] = uv1[i]
        row[14:16] = uv2
        row[16:25] = R2.reshape(-1)
        row[25:28] = t2
        row[29] = 0.0 if kind[i] == 2 else 1.0
    tri_wire[1 : n_tri + 1, 28] = np.asarray(tri_tids, np.int32).view(np.float32)
    return {"tri_wire": tri_wire, "ba_wire": ba_wire, "intr": np.asarray(intr, np.float32),
            "n_tri": n_tri, "bad": kind >= 0, "tids": np.asarray(tri_tids, np.int32)}


def window_case(seed, W=4, N=512, P=1024, depth_fn=None):
    """A W-frame window at 240x320 made with the port alone: frame 0's tracks
    on the background plane (or, with depth_fn(stream, pts) -> camera depths,
    unprojected at those depths) are the map; a quarter of them come as a staged
    mapper job's triangulation candidates (so the device patch changes what
    matches); the job's BA refines the first base rows with every keyframe
    fixed. numpy arrays, and the entering TrackState (`st0`) on the CPU,
    padded to N rows (a cold start has one row per grid cell)."""
    from movslam_tpu_torch.core.extractor import MOVExtractor
    from movslam_tpu_torch.io.synthetic import SyntheticStream
    from movslam_tpu_torch.ops.frame_step import SNAP_CAP
    from movslam_tpu_torch.ops.mapper_step import MAPPER_SMALL, P_PATCH

    stream = SyntheticStream(n_points=150, seed=seed, width=320, height=240, max_mvs=1024, max_kps=512)
    frames = [stream.frame(k) for k in range(W + 1)]
    st0 = MOVExtractor(threshold=25, capacity=N, device="cpu").extract(frames[0], None, None)
    v = st0.valid.numpy()
    tids = st0.track_id.numpy()[v]
    pts0 = st0.pt.numpy()[v].astype(np.float64)
    if depth_fn is None:
        world = np.concatenate([stream._bg_world(0, pts0), np.full((len(tids), 1), stream.bg_depth)], 1)
    else:
        z = depth_fn(stream, pts0)
        Rc, tc = stream.gt_pose(0)
        cam = np.stack([(pts0[:, 0] - 160.0) * z / 320.0, (pts0[:, 1] - 120.0) * z / 320.0, z], 1)
        world = (cam - tc) @ Rc  # R^T (X_cam - t), row-wise
    held = np.arange(len(tids)) % 4 == 3
    base_t, base_w = tids[~held][::-1], world[~held][::-1]
    n = len(base_t)
    snap = np.zeros((P, 12), np.float32)
    snap[:, 7] = np.inf
    snap[:n, 0:3], snap[:n, 5] = base_w, 1.0
    snap[:n, 6], snap[:n, 7], snap[:n, 8] = 1.0, 1000.0, 1.0
    snap[:n, 9] = (np.arange(n) % 5) != 0
    tid_col = np.full(P, np.iinfo(np.int32).max, np.int32)
    tid_col[:n] = base_t
    snap[:, 10] = tid_col.view(np.float32)
    R0, t0 = stream.gt_pose(0)
    pose_pack = np.zeros(25, np.float32)
    pose_pack[0:9], pose_pack[9:12] = R0.reshape(-1), t0
    intr = (320.0, 320.0, 160.0, 120.0)
    n_ba = min(60, n)
    job = mapper_job_case(seed, **MAPPER_SMALL, intr=intr, tri_world=world[held],
                          tri_tids=tids[held].astype(np.int32), cam0=(R0, t0),
                          ba_world=base_w[:n_ba].astype(np.float64), ba_noise=0.01, baseline=2.0, n_fixed=6)
    meta = np.full(P_PATCH + 1, SNAP_CAP, np.float32)
    meta[0] = n
    meta[1 : n_ba + 1] = np.arange(n_ba)
    pad = torch.zeros(N - st0.capacity, dtype=torch.bool)
    grow = lambda x, fill: torch.cat([x, torch.full((N - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype)])  # noqa: E731
    st0 = type(st0)(pt=grow(st0.pt, 0.0), track_id=grow(st0.track_id, -1), age=grow(st0.age, 0),
                    desc=grow(st0.desc, 0), mb_wh=grow(st0.mb_wh, 16.0), coverage=torch.cat([st0.coverage, pad]),
                    valid=torch.cat([st0.valid, pad]), next_id=st0.next_id)
    return dict(imgs=np.stack([f.im_gray for f in frames[1:]]), prev_img=frames[0].im_gray, st0=st0,
                mvk=np.stack([f.packed_joint_i16()[0] for f in frames[1:]]),
                n_mvs=frames[1].packed_joint_i16()[1], snap=snap, pose_pack=pose_pack,
                intr=np.asarray(intr, np.float32), job=job, meta=meta, n_base=n)


STEREO_BF = 80.0  # baseline 0.25 m x fx 320 of the stereo cases below


def stereo_settings():
    """tests/test_stereo_window.py::_settings on the port: a rectified rig,
    b = 0.25 m, bf = 80 at 640x480."""
    from movslam_tpu_torch.config.settings import STEREO, Settings
    from movslam_tpu_torch.core.camera import Pinhole

    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    s.fps = 30.0
    s.sensor = STEREO
    s.b, s.bf, s.th_depth = 0.25, STEREO_BF, 50.0
    return s


def stereo_window_case(seed, W=4, N=512, P=1024):
    """window_case plus what a stereo window adds: `imgs_right`, the window's
    frames rendered from a camera 0.25 m to the right (the construction of
    io/synthetic_stereo.py at 240x320), and `dist_pack` (no distortion, the
    image bounds, bf in [9])."""
    from movslam_tpu_torch.io.synthetic import SyntheticStream
    from movslam_tpu_torch.ops.lk import lk_track

    kw = dict(n_points=150, seed=seed, width=320, height=240, max_mvs=1024, max_kps=512)
    left = SyntheticStream(**kw)
    base_pose = left.pose_fn

    def right_pose(tt):
        R, tr = base_pose(tt)
        return R, tr - np.array([STEREO_BF / 320.0, 0, 0], np.float32)

    right = SyntheticStream(pose_fn=right_pose, **kw)
    right.points, right.patches, right.bg_tex = left.points, left.patches, left.bg_tex

    def stereo_depth(stream, pts0):
        """Frame 0's depths from its own stereo pair, as a stereo map has
        them; the background's where the match fails."""
        pt = torch.from_numpy(pts0.astype(np.float32))
        out, ok = lk_track(torch.from_numpy(left.render(0)[0]), torch.from_numpy(right.render(0)[0]),
                           pt, torch.ones(len(pt), dtype=torch.bool))
        disp = (pt[:, 0] - out[:, 0]).numpy().astype(np.float64)
        good = ok.numpy() & (disp > 0.5)
        return np.where(good, STEREO_BF / np.maximum(disp, 0.5), stream.bg_depth)

    sc = window_case(seed, W, N, P, depth_fn=stereo_depth)
    sc["imgs_right"] = np.stack([right.render(k)[0] for k in range(1, W + 1)])
    sc["dist_pack"] = np.array([0.0] * 5 + [0.0, 320.0, 0.0, 240.0, STEREO_BF], np.float32)
    return sc


def stereo_words(packed, has_dist=False):
    """(depth, ur) f32 arrays from the two stereo words of packed rows (..., C)."""
    c = 4 if has_dist else 3
    a = np.ascontiguousarray(to_np(packed)).astype(np.int32)
    return (np.ascontiguousarray(a[..., c]).view(np.float32),
            np.ascontiguousarray(a[..., c + 1]).view(np.float32))


def assert_stereo_words(got_packed, want_packed, what=""):
    """The stereo columns of two packed stacks: the -1.0 sentinels (the gate
    masks) equal bit for bit, ur within 1e-3 px, depth within 1e-3 relative."""
    gd, gu = stereo_words(got_packed)
    wd, wu = stereo_words(want_packed)
    assert_exact(gd == -1.0, wd == -1.0, f"{what}: depth gate mask")
    assert_exact(gu == -1.0, wu == -1.0, f"{what}: ur gate mask")
    assert_exact((gd == -1.0), (gu == -1.0), f"{what}: depth and ur gated together")
    have = wd != -1.0
    assert_close(gu[have], wu[have], 1e-3, what=f"{what}: ur (px)")
    assert_close(gd[have], wd[have], 0.0, rtol=1e-3, what=f"{what}: depth")
    return have


def stereo_metric_errors(system, stream):
    """Camera-centre errors of a stereo drive in metres, with no fitted scale
    or alignment (tests/test_stereo_window.py::_run): the estimate's world
    frame is the init camera frame, so it is composed with the ground-truth
    pose of the init frame. Returns (init frame, errors from there on)."""
    tr = system.tracking
    k0 = min(kf.frame_id for kf in system.atlas.current.keyframes.values())
    R0, t0 = stream.gt_pose(k0)
    errs = []
    for k, (R_rel, t_rel) in enumerate(tr.rel_poses):
        if k + 1 < k0:
            continue  # no estimate exists before initialization
        ref = tr.rel_refs[k]
        R, tt = R_rel @ ref.R, R_rel @ ref.t + t_rel
        Rg, tg = R @ R0, R @ t0 + tt
        R_gt, t_gt = stream.gt_pose(k + 1)
        errs.append(np.linalg.norm(R_gt.T @ t_gt - Rg.T @ tg))
    return k0, np.array(errs)


class _FakeFrame:
    """What KeyFrame(frame) reads (tests/test_inertial.py::_FakeFrame)."""

    def __init__(self, fid, ts, R, t, track_ids, pts):
        self.id, self.timestamp, self.R, self.t = fid, ts, R, t
        self.track_ids, self.pts = track_ids, pts
        self.desc = self.ages = self.image = self.depth_right = self.uright = None
        self.mappoints = [None] * len(track_ids)


def gba_map(mapmod, cammod, n_kf=120, n_mp=600, noise=5e-3, seed=0, per_kf=40, bf=0.0):
    """tests/test_global_ba.py::_build_map over either package's map and camera
    modules: a circular trajectory observing a point cloud, each keyframe the first
    `per_kf` visible points, with poses (but the first) and points perturbed
    so that BA has something to correct. bf > 0 adds each observation's
    right-image column u - bf / z (a rectified stereo rig)."""
    rng = np.random.default_rng(seed)
    cam = cammod.Pinhole(300.0, 300.0, 160.0, 120.0, 320, 240)
    m = mapmod.Map()
    X_true = rng.uniform(-4, 4, (n_mp, 3))
    X_true[:, 2] += 12.0
    kfs, sels = [], []
    for k in range(n_kf):
        s = k / n_kf
        c = np.array([3 * np.sin(2 * np.pi * s), 3 * np.cos(2 * np.pi * s), -1.0 + 2 * s])
        R = np.eye(3)
        t_cw = -R @ c
        pc = X_true @ R.T + t_cw
        u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
        v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
        vis = (pc[:, 2] > 1) & (u >= 0) & (u < 320) & (v >= 0) & (v < 240)
        sel = np.flatnonzero(vis)[:per_kf]
        kf = mapmod.KeyFrame(_FakeFrame(k, k / 10.0, R, t_cw, sel.astype(np.int64),
                                        np.stack([u[sel], v[sel]], axis=1)), m.id)
        if bf > 0:
            kf.uright = u[sel] - bf / pc[sel, 2]
        m.add_keyframe(kf)
        kfs.append(kf)
        sels.append(sel)
    mps = [mapmod.MapPoint(X_true[j] + rng.normal(0, noise, 3), kfs[0].id, j, m.id) for j in range(n_mp)]
    for mp in mps:
        m.add_mappoint(mp)
    for kf, sel in zip(kfs, sels):
        for slot, j in enumerate(sel):
            mps[int(j)].add_observation(kf, slot)
            kf.mp_ids[slot] = mps[int(j)].id
    for kf in kfs[1:]:
        kf.set_pose(kf.R, kf.t + rng.normal(0, noise * 4, 3))
    return m, cam, kfs


def ring_graph(rng, K=12):
    """tests/test_posegraph_imu.py::test_pose_graph_closes_loop's graph: K
    poses on a rising ring, odometry edges plus one loop edge measured
    exactly, the poses initialized with accumulated drift. Returns
    (pose_graph_solve's arguments as numpy, R_gt, t_gt)."""
    from movslam_tpu_torch.ops.lie import so3_exp
    from movslam_tpu_torch.ops.posegraph import relative_pose

    def rot(w):
        return so3_exp(torch.as_tensor(np.asarray(w, np.float32))).numpy()

    R_gt = np.stack([rot([0, 2 * np.pi * k / K, 0]) for k in range(K)]).astype(np.float32)
    t_gt = np.stack([[np.cos(2 * np.pi * k / K), 0.1 * k, np.sin(2 * np.pi * k / K)]
                     for k in range(K)]).astype(np.float32)
    ei, ej, eR, et = [], [], [], []
    for i, j in [(k + 1, k) for k in range(K - 1)] + [(0, K - 1)]:
        Rm, tm = relative_pose(R_gt[i], t_gt[i], R_gt[j], t_gt[j])
        ei.append(i), ej.append(j), eR.append(Rm), et.append(tm)
    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(1, K):
        R0[k] = rot(rng.normal(0, 0.02, 3) * k / K) @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(0, 0.05, 3) * k / K
    fixed = np.zeros(K, bool)
    fixed[0] = True
    args = (R0, t0, fixed, np.ones(K, bool), np.array(ei, np.int32), np.array(ej, np.int32),
            np.stack(eR).astype(np.float32), np.stack(et).astype(np.float32), np.ones(len(ei), np.float32))
    return args, R_gt, t_gt
