"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. build   : compile movslam_tpu_torch/csrc/score_blocks.cu with nvcc
               (both kernels).
  2. kernels : each kernel on the card against its plain PyTorch version,
               bit-exact: score_blocks at B = 8192 blocks of a 480x640 image
               and on border coordinates; score_candidates at N = 2048
               tracks x M = 4096 MVs (the main path's shapes) and on a
               small case full of border tracks, ties and exact-256 rows.
               Per kernel: device time per launch (CUDA events around a
               CUDA graph of 200 launches), the profiler's kernel time,
               wrapper time per call (events around one Python call), the
               plain version's times, and the bound from this run's bytes.
  3. drive   : System.track_monocular on device="cuda" over
               SyntheticStream(n_points=400, seed=11) for 40 frames at
               640x480, with the gates of tests/test_pipeline.py (0 lost,
               live ATE < 0.35 m, post-hoc ATE < 0.10 m) and
               score_candidates launched once on every P-frame.
  4. launches: the same drive twice more under torch.profiler over frames
               30-39: as it is, and with the scoring step put back to the
               unfused composition (the score_blocks kernel inside
               score_candidates_ref), counting CUDA launches per frame.
  5. windows : the windowed drive on the card at full width (640x480,
               2048 tracks, 4096 MVs, SNAP_CAP 4096, mapper class 32/1024/4096,
               W=8, pipeline_depth=2) over SyntheticStream(n_points=400,
               seed=42): 48 warm-up frames, then 96 timed ones fed to
               System.track_monocular_batch in batches of 8 with flush=False
               and one final flush=True; 16 more frames under torch.profiler
               for the launches per frame inside a window; and a per-frame
               drive of the same frames for comparison. Gates: 0 lost, every
               frame counted and answered, >= 5 keyframes, > 100 map points,
               the ATE bounds of phase 3, at least one speculative window and
               one mapper job committed from a window's wire, and
               score_candidates launched once for every P-frame the system
               says it dispatched (re-dispatches after rewinds included).
Before the last line it prints the card's name and power limit and one JSON
line describing each kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The port imports neither jax, flax nor the JAX package movslam_tpu, and
this script checks that none of them was loaded.
"""
from __future__ import annotations

import collections
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 40
PROFILED = range(30, 40)
W_WARM, W_TIMED, W_PROFILED, W_BATCH = 48, 96, 16, 8  # phase 5, in frames
PROF_STAGES = ("disp_pack_host", "disp_upload", "disp_commit_snap", "disp_jit_call", "disp_tail",
               "rep_wire_pull", "rep_pre", "rep_track_fused")
GRAPH_LAUNCHES = 200
THR = 25.0
# Post-hoc ATE bound. tests/test_pipeline.py asks < 0.02 m of the reference
# on this stream, which the reference's own per-frame drive does not meet on
# a CPU host: it measures 0.021-0.051 m across thirteen PRNG keys, the port
# 0.020-0.073 m across thirteen generator seeds (the RANSAC winner flips with
# the draw; PERF.md). 0.10 m, a sixth of the 0.60 m path, bounds that spread.
POSTHOC_ATE_MAX = 0.10
LIVE_ATE_MAX = 0.35
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the f32 rate outside
# the tensor cores, taken as the rate of the kernels' 32-bit integer ops.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BANNED = ("jax", "flax", "movslam_tpu")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def umeyama_ate(gt_centers, est_centers):
    """Scale-aligned ATE RMSE (Horn/Umeyama with scale)."""
    import numpy as np

    gt, est = np.asarray(gt_centers).T, np.asarray(est_centers).T
    mu_g, mu_e = gt.mean(1, keepdims=True), est.mean(1, keepdims=True)
    gc, ec = gt - mu_g, est - mu_e
    U, d, Vt = np.linalg.svd(gc @ ec.T / gt.shape[1])
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (d * S.diagonal()).sum() / ((ec * ec).sum() / ec.shape[1])
    err = np.linalg.norm(s * R @ est + (mu_g - s * R @ mu_e) - gt, axis=0)
    return float(np.sqrt((err ** 2).mean()))


def call_ms(fn, reps=50, warmup=5):
    """Median time of one Python call of fn(), CUDA events around it: the
    host's dispatch and the device's work, whichever is longer."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, n=GRAPH_LAUNCHES, reps=5):
    """Device time per call of fn(): CUDA events around the replay of a CUDA
    graph that captured n calls, divided by n (median of reps replays)."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2]


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total", "device_time_total",
                 "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def profiler_ms(fn, kernel_name, n=50):
    """The profiler's device time per launch of the kernel named kernel_name
    over n calls of fn(), or None when the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel_name in e.key]
    count = sum(e.count for e in rows)
    us = sum(_device_us(e) for e in rows)
    return us / count / 1e3 if count and us else None


def bound(nbytes, ops):
    """Least time in ms for the work, and which side bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want):
    """Largest absolute difference over matching outputs (0 when bit-exact)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf")
        if g.numel() == 0 or torch.equal(g, w):
            continue
        d = (g.double() - w.double()).abs()
        err = max(err, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return err


def candidate_case(kernels, rng, dev, H, W, N, M):
    """score_candidates inputs: tracks anywhere and within 8 px of the
    borders (some just outside), 0-4 candidates per track, ties between two
    slots holding one MV, near-matching previous descriptors, and rows whose
    every candidate scores exactly 256."""
    import numpy as np
    import torch

    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    pt = np.stack([rng.uniform(-2, W + 2, N), rng.uniform(-2, H + 2, N)], -1).astype(np.float32)
    edge = np.arange(N) % 4 == 0
    pt[edge] = rng.uniform(-2, 8, (int(edge.sum()), 2))
    mv_delta = rng.normal(0, 3, (M, 2)).astype(np.float32)
    k = rng.integers(0, 5, N)
    cand = rng.integers(0, M, (N, 4)).astype(np.int32)
    cand[np.arange(4)[None, :] >= k[:, None]] = -1
    tie = (k >= 2) & (np.arange(N) % 5 == 1)
    cand[tie, 1] = cand[tie, 0]
    flat = (k >= 2) & (np.arange(N) % 11 == 3)
    cand[flat] = cand[flat, :1]
    wh = np.full((N, 2), 16.0, np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (img, pt, cand, mv_delta, wh)]
    tl = ((args[1] + args[3][args[2][:, 0].clamp(min=0).long()]).to(torch.int32) - 8).contiguous()
    _, desc0 = kernels.score_blocks_ref(args[0], tl, torch.zeros((N, 8), dtype=torch.int32, device=dev), THR)
    prev = torch.as_tensor(rng.integers(0, 2**32, (N, 8), dtype=np.uint32).view(np.int32), device=dev)
    near = torch.as_tensor((k >= 1) & ~flat & (np.arange(N) % 3 == 0), device=dev)
    prev = torch.where(near[:, None], desc0, prev)
    prev = torch.where(torch.as_tensor(flat, device=dev)[:, None], ~desc0, prev)
    return args + [prev.contiguous()]


def drive(system_cls, settings, frames, monocular, profile_frames=()):
    """One per-frame drive; returns (system, est centers, profiler or None,
    wall seconds of the profiled frames)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    system = system_cls(settings, monocular, device="cuda")
    est, prof, wall = {}, None, 0.0
    for k, smv in enumerate(frames):
        if profile_frames and k == profile_frames[0]:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t0 = time.perf_counter()
        pose = system.track_monocular(smv.timestamp, smv)
        if pose is not None:
            R, t = pose
            est[k] = -(R.T @ t)
        if profile_frames and k == profile_frames[-1]:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.__exit__(None, None, None)
    torch.cuda.synchronize()
    return system, est, prof, wall


def launch_counts(prof, n_frames):
    """CUDA kernel launches per frame (runtime launch calls; kernels the
    device ran) and device-busy ms per frame, from one profiler trace."""
    import torch

    launch_names = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
    host_launches = device_kernels = 0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.key in launch_names:
            host_launches += e.count
        elif (e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
              and not e.key.startswith(("Memcpy", "Memset"))):
            device_kernels += e.count
            busy_us += _device_us(e)
    return host_launches / n_frames, device_kernels / n_frames, busy_us / 1e3 / n_frames

def windowed_phase(System, settings, monocular, SyntheticStream, kernels, card):
    """Phase 5 (see the module docstring). Returns the numbers it printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n_fed = W_WARM + W_TIMED + W_PROFILED
    stream = SyntheticStream(n_points=400, seed=42)
    items = [(f.timestamp, f) for f in (stream.frame(k) for k in range(n_fed))]  # rendering is set-up
    gt = lambda k: -(stream.gt_pose(k)[0].T @ stream.gt_pose(k)[1])  # noqa: E731

    kernels.score_blocks.launches = kernels.score_candidates.launches = 0
    system = System(settings, monocular, device="cuda")
    system._prof = collections.defaultdict(float)
    poses = []
    for k in range(0, W_WARM, W_BATCH):  # the last warm-up batch drains the pipeline
        poses += system.track_monocular_batch(items[k:k + W_BATCH], flush=k + W_BATCH >= W_WARM)
    torch.cuda.synchronize()
    warm_counts, warm_prof = collections.Counter(system.counts), dict(system._prof)
    warm_jobs = (system.mapper.n_fused_jobs, system.mapper.n_standalone_jobs)
    t0 = time.perf_counter()
    for k in range(W_WARM, W_WARM + W_TIMED, W_BATCH):
        poses += system.track_monocular_batch(items[k:k + W_BATCH], flush=False)
    poses += system.track_monocular_batch([], flush=True)
    torch.cuda.synchronize()
    win_ms = 1e3 * (time.perf_counter() - t0) / W_TIMED
    timed = collections.Counter(system.counts)
    timed.subtract(warm_counts)
    prof_s = {k: system._prof[k] - warm_prof.get(k, 0.0) for k in PROF_STAGES}
    jobs = (system.mapper.n_fused_jobs - warm_jobs[0], system.mapper.n_standalone_jobs - warm_jobs[1])

    # Launches per frame inside windows: the next frames under the profiler.
    before = collections.Counter(system.counts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(W_WARM + W_TIMED, n_fed, W_BATCH):
            poses += system.track_monocular_batch(items[k:k + W_BATCH], flush=False)
        poses += system.track_monocular_batch([], flush=True)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / W_PROFILED
    profiled = collections.Counter(system.counts)
    profiled.subtract(before)
    host, devk, busy = launch_counts(prof, W_PROFILED)
    launches = {"score_candidates": kernels.score_candidates.launches,
                "score_blocks": kernels.score_blocks.launches}
    system.shutdown()
    torch.cuda.synchronize()

    m = system.atlas.current
    est = {k: -(p[0].T @ p[1]) for k, p in enumerate(poses) if p is not None}
    ate_live = umeyama_ate([gt(k) for k in est], list(est.values()))
    traj = system.frame_trajectory()
    ate_post = umeyama_ate([gt(round(ts * 30.0)) for ts, _, _, _ in traj],
                           [-(R.T @ t) for _, R, t, _ in traj])
    c = system.counts
    by_len = {int(k.rsplit("_", 1)[1]): v for k, v in sorted(timed.items()) if k.startswith("windows_len_") and v}
    dispatched = c["window_frames"] + c["per_frame_p"]

    # The same frames through the per-frame drive, in the same call.
    psys = System(settings, monocular, device="cuda")
    for k, (ts, smv) in enumerate(items[:W_WARM + W_TIMED]):
        if k == W_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        psys.track_monocular(ts, smv)
    torch.cuda.synchronize()
    pf_ms = 1e3 * (time.perf_counter() - t0) / W_TIMED
    pf_lost = psys.get_total_lost()
    psys.shutdown()
    torch.cuda.synchronize()

    print(f"windows: windowed drive {win_ms:.2f} ms/frame ({1e3 / win_ms:.2f} frames/s) over the "
          f"{W_TIMED} timed frames (W={system.window}, depth {system.pipeline_depth}, batches of "
          f"{W_BATCH}, flush=False) on {card}", flush=True)
    print(f"windows: per-frame drive of the same frames {pf_ms:.2f} ms/frame ({1e3 / pf_ms:.2f} "
          f"frames/s), lost {pf_lost}, in the same call on {card}", flush=True)
    print(f"windows: timed windows by length {by_len}, {timed['window_frames']} window frames, "
          f"{timed['per_frame_p']} per-frame P-frames, {timed['spec_windows']} speculative windows, "
          f"{timed['rewinds']} rewinds ({100.0 * timed['rewinds'] / W_TIMED:.2f} per 100 frames) on {card}",
          flush=True)
    print(f"windows: timed mapper jobs: {jobs[0]} run by a window and committed from its wire, "
          f"{jobs[1]} standalone; whole drive {system.mapper.n_fused_jobs} / "
          f"{system.mapper.n_standalone_jobs} on {card}", flush=True)
    print("windows: host seconds by stage over the timed frames: "
          + ", ".join(f"{k} {prof_s[k]:.3f}" for k in PROF_STAGES) + f" on {card}", flush=True)
    print(f"windows: {W_PROFILED} more frames under the profiler ({profiled['window_frames']} window "
          f"frames, {profiled['per_frame_p']} per-frame): {host:.1f} launch calls/frame, {devk:.1f} "
          f"device kernels/frame, device busy {busy:.2f} ms of {prof_wall_ms:.2f} ms/frame with the "
          f"profiler on (idle {1 - busy / prof_wall_ms:.3f}; {1 - busy / win_ms:.3f} against the "
          f"unprofiled {win_ms:.2f} ms) on {card}", flush=True)
    print(f"windows: state {system.tracking.state.name}, {m.n_keyframes()} keyframes, "
          f"{m.n_mappoints()} map points, {len(poses)} poses ({len(est)} set), lost "
          f"{system.get_total_lost()}, live ATE {ate_live:.4f} m, post-hoc ATE {ate_post:.4f} m; "
          f"score_candidates launches {launches['score_candidates']} for {dispatched} P-frames "
          f"dispatched ({c['window_frames']} in windows, {c['per_frame_p']} per frame)", flush=True)
    checks = {
        "0 lost": system.get_total_lost() == 0,
        "every frame counted": system.image_count == n_fed,
        "one pose per frame": len(poses) == n_fed and all(p is not None for p in poses[W_WARM:]),
        ">= 5 keyframes": m.n_keyframes() >= 5,
        "> 100 map points": m.n_mappoints() > 100,
        f"live ATE < {LIVE_ATE_MAX}": ate_live < LIVE_ATE_MAX,
        f"post-hoc ATE < {POSTHOC_ATE_MAX}": ate_post < POSTHOC_ATE_MAX,
        "a speculative window": c["spec_windows"] >= 1,
        "a mapper job committed from a window's wire": system.mapper.n_fused_jobs >= 1,
        "score_candidates once per dispatched P-frame": launches["score_candidates"] == dispatched,
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"windowed drive gates failed: {bad}")
    return {
        "ms_per_frame": win_ms, "per_frame_drive_ms_per_frame": pf_ms, "per_frame_drive_lost": pf_lost,
        "windows_by_length": by_len,
        "window_frames": timed["window_frames"], "per_frame_p": timed["per_frame_p"],
        "speculative_windows": timed["spec_windows"], "rewinds": timed["rewinds"],
        "mapper_jobs_fused": jobs[0], "mapper_jobs_standalone": jobs[1], "prof_seconds": prof_s,
        "profiled": {"host_launches": host, "device_kernels": devk, "busy_ms": busy, "wall_ms": prof_wall_ms},
        "ate_live": ate_live, "ate_post": ate_post, "keyframes": m.n_keyframes(),
        "launches": launches, "p_frames_dispatched": dispatched,
    }


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"numpy/torch missing: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA card")
    sys.path.insert(0, HERE)
    try:
        from movslam_tpu_torch.config.settings import MONOCULAR, Settings
        from movslam_tpu_torch.core.camera import Pinhole
        from movslam_tpu_torch.core.system import System
        from movslam_tpu_torch.core.tracking import State
        from movslam_tpu_torch.io.mvimage import FrameType
        from movslam_tpu_torch.io.synthetic import SyntheticStream
        from movslam_tpu_torch.ops import kernels, propagate
    except ImportError as e:
        fail(f"the port (movslam_tpu_torch) does not import from {HERE}: {e}")

    def check_banned():
        for banned in BANNED:
            if banned in sys.modules:
                fail(f"{banned} was imported")

    check_banned()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda")
    t_phase = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"{name}: phase took {now - t_phase[0]:.1f} s", flush=True)
        t_phase[0] = now

    # --- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    print(f"build: score_blocks.cu compiled and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 2. kernels against their plain versions, and their times ---------
    rng = np.random.default_rng(0)
    H, W, B, N, M = 480, 640, 8192, 2048, 4096
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    tl = np.stack([rng.integers(-8, W, B), rng.integers(-8, H, B)], -1).astype(np.int32)
    prev = rng.integers(0, 2**32, (B, 8), dtype=np.uint32).view(np.int32)
    edge_img = rng.integers(0, 256, (128, 256)).astype(np.uint8)
    edge_tl = np.array([[0, 0], [240, 112], [0, 112], [240, 0], [5, 100], [100, 5],
                        [239, 111], [1, 1], [-8, -8], [250, 125]], np.int32)
    blocks_err = 0.0
    for im, coords, pv in ((img, tl, prev), (edge_img, edge_tl, prev[:10])):
        args = [torch.as_tensor(a, device=dev) for a in (im, coords, pv)]
        for thr in (THR, 7.5):
            got = kernels.score_blocks(*args, thr)
            want = kernels.score_blocks_ref(*args, thr)
            torch.cuda.synchronize()
            err = max_err(got, want)
            blocks_err = max(blocks_err, err)
            if err:
                fail(f"score_blocks differs from score_blocks_ref at B={len(coords)} thr={thr}: {err}")
    print(f"kernels: score_blocks bit-exact with score_blocks_ref at B={B} ({H}x{W}) "
          f"and on border coords", flush=True)

    cand_err = 0.0
    for (h, w, n, m) in ((H, W, N, M), (120, 160, 300, 64), (64, 64, 8, 16)):
        cargs = candidate_case(kernels, rng, dev, h, w, n, m)
        for thr in (THR, 7.5):
            got = kernels.score_candidates(*cargs, thr)
            want = kernels.score_candidates_ref(*cargs, thr)
            torch.cuda.synchronize()
            err = max_err(got, want)
            cand_err = max(cand_err, err)
            if err:
                fail(f"score_candidates differs from score_candidates_ref at N={n} M={m} thr={thr}: {err}")
        if (h, w, n, m) == (H, W, N, M):
            main_cargs = cargs
    print(f"kernels: score_candidates bit-exact with score_candidates_ref at N={N} M={M} "
          f"({H}x{W}) and on border, tie and exact-256 cases", flush=True)

    bargs = [torch.as_tensor(a, device=dev) for a in (img, tl, prev)]
    times = {}
    for name, fn, ref, args, kname in (
        ("score_blocks", kernels.score_blocks, kernels.score_blocks_ref, bargs, "score_blocks_kernel"),
        ("score_candidates", kernels.score_candidates, kernels.score_candidates_ref, main_cargs,
         "score_candidates_kernel"),
    ):
        t = {
            "plain_ms": call_ms(lambda: ref(*args, THR)),
            "ms": graph_ms(lambda: fn(*args, THR)),
            "wrapper_ms": call_ms(lambda: fn(*args, THR)),
            "profiler_ms": profiler_ms(lambda: fn(*args, THR), kname),
        }
        try:
            t["plain_device_ms"] = graph_ms(lambda: ref(*args, THR))
        except RuntimeError as e:  # a plain version that cannot be captured
            print(f"kernels: {name} plain version not captured in a graph: {e}", flush=True)
            t["plain_device_ms"] = None
        out = fn(*args, THR)
        nbytes = sum(a.numel() * a.element_size() for a in args) + sum(
            o.numel() * o.element_size() for o in out)
        blocks = B if name == "score_blocks" else 4 * N
        ops = blocks * (2 * 256 + 3 * 8)  # two compares a pixel; xor, popc, add a word
        t["bound_ms"], t["bound_by"] = bound(nbytes, ops)
        t["bytes"] = nbytes
        times[name] = t
        us = {k: (v * 1e3 if v is not None else float("nan")) for k, v in t.items() if k.endswith("ms")}
        print(f"kernels: {name}: device {us['ms']:.3f} us/launch (graph of {GRAPH_LAUNCHES}), "
              f"profiler {us['profiler_ms']:.3f} us/launch, wrapper {us['wrapper_ms']:.2f} us/call, "
              f"plain {us['plain_ms']:.2f} us/call (device {us['plain_device_ms']:.2f} us), "
              f"bound {us['bound_ms']:.4f} us ({t['bound_by']}, {nbytes} B) on {card}", flush=True)

    phase_done("kernels")

    # --- 3. the per-frame monocular drive on the card -----------------------
    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    stream = SyntheticStream(n_points=400, seed=11)
    frames = [stream.frame(k) for k in range(N_FRAMES)]  # rendering is set-up
    n_pframes = sum(1 for k, f in enumerate(frames) if k > 0 and f.ft == FrameType.P_FRAME)
    kernels.score_blocks.launches = kernels.score_candidates.launches = 0
    system, est, _, _ = drive(System, s, frames, MONOCULAR)
    launches = {"score_candidates": kernels.score_candidates.launches,
                "score_blocks": kernels.score_blocks.launches}
    system.shutdown()
    torch.cuda.synchronize()

    m = system.atlas.current
    gt = lambda k: -(stream.gt_pose(k)[0].T @ stream.gt_pose(k)[1])  # noqa: E731
    ate_live = umeyama_ate([gt(k) for k in est], list(est.values()))
    traj = system.frame_trajectory()
    ate_post = umeyama_ate([gt(round(ts * 30.0)) for ts, _, _, _ in traj],
                           [-(R.T @ t) for _, R, t, _ in traj])
    track_ms = float(np.mean(system.track_ms[10:N_FRAMES]))
    lost = system.get_total_lost()
    print(f"drive: state {system.tracking.state.name}, {m.n_keyframes()} keyframes, "
          f"{m.n_mappoints()} map points, {len(est)} poses, lost {lost}", flush=True)
    print(f"drive: live ATE {ate_live:.4f} m, post-hoc ATE {ate_post:.4f} m, "
          f"score_candidates launches {launches['score_candidates']} over {n_pframes} P-frames, "
          f"score_blocks launches {launches['score_blocks']}", flush=True)
    print(f"drive: mean track_ms over frames 10-{N_FRAMES - 1}: {track_ms:.2f} ms on {card}", flush=True)
    checks = {
        "state OK": system.tracking.state == State.OK,
        "0 lost": lost == 0,
        ">= 3 keyframes": m.n_keyframes() >= 3,
        "> 100 map points": m.n_mappoints() > 100,
        f">= {N_FRAMES - 10} poses": len(est) >= N_FRAMES - 10,
        f"live ATE < {LIVE_ATE_MAX}": ate_live < LIVE_ATE_MAX,
        f"post-hoc ATE < {POSTHOC_ATE_MAX}": ate_post < POSTHOC_ATE_MAX,
        "score_candidates on every P-frame": launches["score_candidates"] == n_pframes,
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"drive gates failed: {bad}")

    phase_done("drive")

    # --- 4. launches per frame, fused scoring vs the unfused composition ------
    unfused = functools.partial(kernels.score_candidates_ref, block_scorer=kernels.score_blocks)
    per_frame = {}
    fused = propagate.score_candidates
    for label, scorer in (("score_candidates", fused), ("unfused", unfused)):
        propagate.score_candidates = scorer
        kernels.score_blocks.launches = kernels.score_candidates.launches = 0
        try:
            psys, _, prof, wall = drive(System, s, frames, MONOCULAR, PROFILED)
        finally:
            propagate.score_candidates = fused
        host, devk, busy = launch_counts(prof, len(PROFILED))
        per_frame[label] = {
            "host_launches": host, "device_kernels": devk, "busy_ms": busy,
            "wall_ms": wall * 1e3 / len(PROFILED),
            "track_ms_10_29": float(np.mean(psys.track_ms[10:30])),
            "score_blocks": kernels.score_blocks.launches,
            "score_candidates": kernels.score_candidates.launches, "lost": psys.get_total_lost(),
        }
        psys.shutdown()
        torch.cuda.synchronize()
        r = per_frame[label]
        print(f"launches: {label} scoring, frames {PROFILED[0]}-{PROFILED[-1]} under the profiler: "
              f"{host:.1f} launch calls/frame, {devk:.1f} device kernels/frame, device busy "
              f"{busy:.2f} ms of {r['wall_ms']:.2f} ms/frame with the profiler on "
              f"(idle {1 - busy / r['wall_ms']:.3f}); "
              f"track_ms frames 10-29 {r['track_ms_10_29']:.2f} ms; score_blocks launches "
              f"{r['score_blocks']}, score_candidates launches {r['score_candidates']}, "
              f"lost {r['lost']} on {card}", flush=True)
    d_host = per_frame["unfused"]["host_launches"] - per_frame["score_candidates"]["host_launches"]
    d_dev = per_frame["unfused"]["device_kernels"] - per_frame["score_candidates"]["device_kernels"]
    print(f"launches: fusing the scoring step removes {d_host:.1f} launch calls/frame "
          f"({d_dev:.1f} device kernels/frame)", flush=True)
    if per_frame["unfused"]["score_blocks"] == 0:
        fail("the unfused composition never launched score_blocks")
    phase_done("launches")

    # --- 5. the windowed drive on the card -------------------------------------
    win = windowed_phase(System, s, MONOCULAR, SyntheticStream, kernels, card)
    phase_done("windows")
    check_banned()

    src = "movslam_tpu_torch/csrc/score_blocks.cu"
    replaces = "movslam_tpu/ops/pallas_kernels.py:129"
    rows = []
    for name, launched, path in (
        ("score_candidates", launches["score_candidates"],
         "per-frame drive (phase 3); launches_windowed: windowed drive (phase 5)"),
        ("score_blocks", per_frame["unfused"]["score_blocks"],
         "per-frame drive with unfused scoring (phase 4)"),
    ):
        t = times[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launched, "launches_windowed": win["launches"][name], "path": path,
            "max_abs_err": cand_err if name == "score_candidates" else blocks_err,
            "ms": t["ms"], "wrapper_ms": t["wrapper_ms"], "profiler_ms": t["profiler_ms"],
            "plain_ms": t["plain_ms"], "plain_device_ms": t["plain_device_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
        })
    print(json.dumps({"launches_per_frame": per_frame, "card": card}), flush=True)
    print(json.dumps({"windowed_drive": win, "card": card}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
