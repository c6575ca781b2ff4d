"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. build   : compile movslam_tpu_torch/csrc/score_blocks.cu (two
               kernels) and csrc/segment_sum.cu with nvcc, in parallel.
  2. kernels : each kernel on the card against its plain PyTorch version,
               bit-exact: score_blocks at B = 8192 blocks of a 480x640 image
               and on border coordinates; score_candidates at N = 2048
               tracks x M = 4096 MVs (the main path's shapes), on a
               small case full of border tracks, ties and exact-256 rows, at
               M = 8192 (the CLI decoder's capacity) and over S = 8 streams
               x N = 2048 x M = 8192 in one launch (also equal to 8
               single-stream launches).
               Per kernel: device time per launch (CUDA events around a
               CUDA graph of 200 launches), the profiler's kernel time,
               wrapper time per call (events around one Python call), the
               plain version's times, and the bound from this run's bytes.
               segment_sum at phase 3's local-BA shapes (K = 48, P = 1024,
               O = 4096) and at the global-BA caps (K = 768, P = 16,384,
               O = 65,536): each sum of ops/ba.py (by keyframe, C = 6 and
               36; by point, C = 3 and 9; the Schur pair scatter, C = 36)
               on the plans of ops/ba.segment_plans and on plans of every
               row, inputs made on the card: bit-equal to CPU index_add_
               on the same inputs, and two launches bit-equal; device time
               per launch (graph of 200, or 20 at the caps' pair scatter),
               wrapper and plain times, and index_add_'s device time.
  3. drive   : System.track_monocular on device="cuda" over
               SyntheticStream(n_points=400, seed=11) for 40 frames at
               640x480, with the gates of tests/test_pipeline.py (0 lost,
               live ATE < 0.35 m, post-hoc ATE < 0.10 m),
               score_candidates launched once on every P-frame and
               segment_sum launched. Then the same drive again with the
               same seed, frames 16-19 under torch.profiler: every
               dispatched program's int32 wire, every pose and the
               trajectory bit-equal to the first drive's.
  4. launches: CUDA launches per frame over frames 16-19: those of phase
               3's repeat (the fused scoring), and those of the first 20
               frames driven once more with the scoring step put back to
               the unfused composition (the score_blocks kernel inside
               score_candidates_ref).
  5. windows : the windowed drive on the card at full width (640x480,
               2048 tracks, 4096 MVs, SNAP_CAP 4096, mapper class 32/1024/4096,
               W=8, pipeline_depth=2) over SyntheticStream(n_points=400,
               seed=42): 48 warm-up frames, then 96 timed ones fed to
               System.track_monocular_batch in batches of 8 with flush=False
               and one final flush=True; 16 more frames under torch.profiler
               for the launches per frame inside a window; 16 more in
               localization mode (activate_localization_mode: keyframes, map
               points and the map's change index must not move, >= 12 of the
               16 frames answered); and a per-frame drive of the warm-up and
               the first 24 timed frames for comparison. Gates: 0 lost, every
               frame counted and answered, >= 5 keyframes, > 100 map points,
               the ATE bounds of phase 3, at least one speculative window and
               one mapper job committed from a window's wire, and
               score_candidates launched once for every P-frame the system
               says it dispatched (re-dispatches after rewinds included),
               segment_sum launched.
  6. stereo  : System(settings, STEREO) on the card at full width (640x480,
               b = 0.25 m, bf = 80) over SyntheticStereoStream(seed=5): a
               per-frame drive of 25 pairs (track_stereo) and a windowed
               drive (track_stereo_batch, W=8, pipeline_depth=2, flush=False,
               batches of 8) of 16 warm-up + 48 timed pairs, then 8 more
               under torch.profiler. Gates: 0 lost in the windowed drive,
               every frame answered, state OK at the end of both, > 100 map
               points, metric error (estimate composed with the ground-truth
               pose of the init frame, no fitted scale) median < 0.20 m and
               max < 0.8 m over the windowed drive's 64 warm-up and timed
               pairs, median < 0.35 m per frame,
               score_candidates launched once for every left P-frame
               dispatched, and a mapper job with bf != 0 committed from a
               window's wire. Rewinds are reported, not gated: a stereo
               window always rewinds at a mid-window keyframe.
  7. vi      : System(settings, IMU_MONOCULAR) on the card at 640x480
               (camera 320/320/320/240, fps 30, vi_min_kfs = 8) over
               SyntheticVIStream(n_points=400, seed=11), the settings and
               stream of tests/test_vi_system.py: 60 frames through
               track_monocular(..., imu=), then 96 frames through
               track_monocular_batch((ts, smv, imu) triples, batches of 8,
               W=8, pipeline_depth=2, flush=False) and one flush=True, then 8
               more under torch.profiler; one _local_ba_vi call and one
               preintegrate call under the profiler after the per-frame
               drive. Gates: the map IMU-initialized in both drives, metric
               keyframe camera-centre error (no fitted scale) median
               < 0.15 * max(span, 0.5), the reference's bound, velocity and
               gyro bias on the last keyframe of the per-frame drive, at
               least one _local_ba_vi call there, 0 lost and every frame
               answered from the init on, and score_candidates launched once
               for every P-frame dispatched.
  8. atlas   : the Atlas back end on phase 3's map. (a) save_atlas, then
               load_atlas: the same keyframe and point counts, poses and
               points bit-equal; the ms of each step and the file's bytes.
               (b) the loaded copy as the old map and a re-keyed copy moved
               by a known Sim3 (s = 1.7) as the new one
               (tests/test_map_merge.py::_build_map_pair), welded by
               map_merge.try_merge(device="cuda"): one map left, median
               welded-point error < 0.05 m; ms, and the pose graph's launches
               under torch.profiler. (c) System.global_bundle_adjustment(
               iters=20), timed on a System resumed from the checkpoint and
               profiled on phase 3's own: everything finite, mean
               reprojection error <= 1.5x before + 1e-6; post-hoc ATE before
               and after, printed. (d) global BA at the reference's caps: a
               synthetic map (tests/test_global_ba.py::_build_map) of 512
               keyframes, 16,384 points, every one observed, and 128
               observations per keyframe, 20 iterations: the map at those
               caps, every non-anchor keyframe moved, finite, the
               reprojection error fell; ms, peak device memory, launches;
               segment_sum launched over the phase.
  9. ingest  : whether pkg-config finds libav (libavformat, libavcodec,
               libavutil, libswscale). Where it does: build the port's
               native decoder, encode 320 frames of SyntheticStream(
               n_points=400, seed=42) at 640x480 with libx264 (CAVLC, ref 4,
               keyint 1000; tests/test_codec_e2e.py's stream), decode them
               with io/video.VideoDecoder, and drive the file through
               cli.mono_drive on the card (windowed, batches of 8), two
               batch calls under torch.profiler. Gates: every frame counted,
               0 lost, >= 10 keyframes, scale-aligned ATE < 5% of the span,
               score_candidates once per dispatched P-frame. Where it does
               not, one line says so and the phase goes on. Either way:
               synthetic://n_frames=48 through cli.mono_drive and cli._finish
               in a temporary directory, the System made by the CLI with
               --viewer (results.txt: 48 frames, 0 lost; both trajectory
               files; the viewer saw 48 frames; whether cv2 is found and the
               PNGs written: 48 with cv2, none without).
 10. parallel: a one-rank NCCL group (HashStore). (a) parallel/multistream
               over 8 streams x 2048 tracks at 640x480: one
               score_candidates launch, results equal to 8 single-stream
               calls, ms per batch; (b) parallel/sharded_ba against
               ops/ba.ba_solve on phase 3's map's global-BA problem, 40 LM
               iterations each (rotations, and translations with mono BA's
               free scale removed, within 5e-3; points seen from two
               keyframes or more within 5e-2 without the scale; the best
               cost <= 1.1x ba_solve's + 1e-3, tests/test_parallel.py's
               criterion; two ba_solve calls bit-equal, and whether the
               sharded BA equals ba_solve bit for bit, printed);
               (c) System.global_bundle_adjustment(iters=40,
               mesh=group) against mesh=None on two copies of phase 3's
               map (the same keyframes and points, pruning apart on <= 1%
               of the points; without the scale, poses within 5e-3 and
               points seen twice or more within 5e-2); segment_sum launched
               over (b) and (c).
Every drive and phases 8 and 10 also gate that segment_sum launched (the
BA's and pose graph's ordered sums).
Before the last line it prints the card's name and power limit and one JSON
line describing each kernel; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The port imports neither jax, flax nor the JAX package movslam_tpu, and
this script checks that none of them was loaded.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 40
L_FRAMES = 20  # phase 4's drives
PROFILED = range(16, 20)
W_WARM, W_TIMED, W_PROFILED, W_BATCH = 48, 96, 16, 8  # phase 5, in frames
W_LOC = 16  # phase 5: frames tracked in localization mode
PF_TIMED = 24  # phase 5: timed frames of the per-frame comparison drive
S_PER_FRAME, S_WARM, S_TIMED, S_PROFILED = 25, 16, 48, 8  # phase 6, in stereo pairs
STEREO_B, STEREO_BF = 0.25, 80.0
VI_PER_FRAME, VI_WINDOWED, VI_PROFILED, VI_MIN_KFS = 60, 96, 8, 8  # phase 7, in frames
MERGE_SIM3 = (1.7, [0.05, -0.3, 0.1], [2.0, -1.0, 0.5])  # phase 8 (b): s, rotation vector, t
GBA_TOP_KF, GBA_TOP_MP, GBA_TOP_PER_KF = 512, 16384, 128  # phase 8 (d): the reference's global-BA caps
CLI_MVS = 8192  # phase 2: the CLI decoder's MV capacity (VideoDecoder(max_mvs=8192))
S_STREAMS = 8  # phase 2: streams of score_candidates in one launch
H264_FRAMES = 320  # phase 9: tests/test_codec_e2e.py's real-H.264 stream
H264_PROFILED = range(20, 22)  # phase 9: batch calls of the drive under the profiler
MS_STREAMS, MS_TRACKS = 8, 2048  # phase 10: multistream batch
# Phase 10 (b)-(c): LM iterations of the solves compared. Two solves of one
# mono map in two summation orders (the card's atomic scatters, or another
# rank count) take different accept steps; by 40 iterations they reach one
# solution, apart from points seen from a single keyframe, whose depth
# nothing holds (PERF.md, Findings). 20 left points 5.5e-2 apart on an H100.
PAR_ITERS = 40
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


KERNELS = ("score_candidates", "score_blocks", "segment_sum")


def reset_launches(kernels):
    """Set every kernel wrapper's launch count to 0."""
    for name in KERNELS:
        getattr(kernels, name).launches = 0


def kernel_launches(kernels):
    """Every kernel wrapper's launch count, by name."""
    return {name: getattr(kernels, name).launches for name in KERNELS}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


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


def ba_index_case(rng, K, P, O, n_kf, n_mp, lo, hi, mopp=16):
    """The index arrays of a BA problem as core/local_mapping assembles
    them: n_mp of P points, each seen from lo..hi of the first n_kf of K
    keyframes (distinct), point-major, cut or padded to O rows (padding:
    keyframe 0, point 0, invalid), and obs_by_point (P, mopp)."""
    import numpy as np

    from movslam_tpu_torch.ops.ba import build_obs_by_point

    n_obs = rng.integers(lo, hi + 1, n_mp)
    kf_choice = np.argsort(rng.random((n_mp, n_kf)), axis=1)[:, :hi]
    take = np.arange(hi)[None, :] < n_obs[:, None]
    obs_kf = np.zeros(O, np.int64)
    obs_mp = np.zeros(O, np.int64)
    valid = np.zeros(O, bool)
    n = min(int(take.sum()), O)
    obs_kf[:n] = kf_choice[take][:n]
    obs_mp[:n] = np.nonzero(take)[0][:n]
    valid[:n] = True
    obp = build_obs_by_point(np.where(valid, obs_mp, P), P, mopp, O)
    return obs_kf, obs_mp, valid, obp


def spread_values(gen, shape):
    """f32 values on gen's device whose sum depends on its order: signs
    mixed, magnitudes 1e-4 to 1e4 row by row."""
    import torch

    dev = gen.device
    mag = 10.0 ** (8.0 * torch.rand((shape[0],) + (1,) * (len(shape) - 1), generator=gen, device=dev) - 4.0)
    return torch.randn(shape, generator=gen, device=dev) * mag


def segment_sum_phase(kernels, rng, dev, card):
    """Phase 2's segment_sum part: at phase 3's local-BA shapes and at the
    global-BA caps, every sum of ops/ba.py (by keyframe, by point, the Schur
    pair scatter) through the kernel on the plans ops/ba.segment_plans
    builds, against CPU index_add_ over every row of the same inputs:
    bit-equal, and two launches bit-equal. Rows a plan leaves out are
    zeroed first, as the BA's are. Also unmasked plans (every row). The
    values are made on the card and copied to the CPU. Returns (max abs
    error, timings by case)."""
    import numpy as np
    import torch

    from movslam_tpu_torch.ops import ba

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    shapes = {  # K, P, O, keyframes and points in use, observations per point
        "local_ba": (48, 1024, 4096, 11, 527, 2, 8),
        "gba_caps": (768, GBA_TOP_MP, 65536, GBA_TOP_KF, GBA_TOP_MP, 4, 4),
    }
    err, times = 0.0, {}
    for label, (K, P, O, n_kf, n_mp, lo, hi) in shapes.items():
        obs_kf, obs_mp, valid, obp = ba_index_case(rng, K, P, O, n_kf, n_mp, lo, hi)
        okf, omp, oval, oobp = (torch.as_tensor(a, device=dev) for a in (obs_kf, obs_mp, valid, obp))
        plans = ba.segment_plans(okf, omp, oval, oobp, K, P, O)
        pad = obp < O
        pair_keep = (pad[:, :, None] & pad[:, None, :]).reshape(-1)
        kfp = obs_kf[np.minimum(obp, O - 1)]
        ab = (kfp[:, :, None] * K + kfp[:, None, :]).reshape(-1)
        cases = {  # name: (plan key, index, segments, trailing shape, rows kept)
            "kf_C6": ("kf", obs_kf, K, (6,), valid), "kf_C36": ("kf", obs_kf, K, (6, 6), valid),
            "mp_C3": ("mp", obs_mp, P, (3,), valid), "mp_C9": ("mp", obs_mp, P, (3, 3), valid),
            "pair_C36": ("pair", ab, K * K, (6, 6), pair_keep),
        }
        for name, (key, idx, n, trail, keep) in cases.items():
            keep_d = torch.as_tensor(keep, device=dev).reshape((-1,) + (1,) * len(trail))
            xd = spread_values(gen, (len(idx),) + trail) * keep_d  # left-out rows carry zeros, as the BA's
            want = torch.zeros((n,) + trail).index_add_(0, torch.as_tensor(idx), xd.cpu())
            full = kernels.segment_plan(torch.as_tensor(idx, device=dev), n)
            x_full = spread_values(gen, (len(idx),) + trail)
            want_full = torch.zeros((n,) + trail).index_add_(0, torch.as_tensor(idx), x_full.cpu())
            got = [kernels.segment_sum(xd, plans[key]) for _ in range(2)]
            got_full = [kernels.segment_sum(x_full, full) for _ in range(2)]
            torch.cuda.synchronize()
            for g, w, what in ((got[0], want, "plan of ops/ba.segment_plans"),
                               (got_full[0], want_full, "plan of every row")):
                e = max_err([g.cpu()], [w])
                err = max(err, e)
                if e or not torch.equal(g.cpu(), w):
                    fail(f"segment_sum {label} {name} ({what}) is not bit-equal to CPU index_add_: {e}")
            if not (torch.equal(got[0], got[1]) and torch.equal(got_full[0], got_full[1])):
                fail(f"segment_sum {label} {name}: two launches on the same inputs differ")
            plan = plans[key]
            kept = int(plan.offsets[-1])
            C = int(np.prod(trail))
            nbytes = 4 * (kept * C + kept + (n + 1) + n * C)
            idx_d = torch.as_tensor(idx, device=dev)
            big = len(idx) * C > 2**24  # index_add_ over every row: ~9 ms a call at the caps
            t = {
                "ms": graph_ms(lambda: kernels.segment_sum(xd, plan), n=20 if big else GRAPH_LAUNCHES),
                "wrapper_ms": call_ms(lambda: kernels.segment_sum(xd, plan), reps=20),
                "plain_ms": call_ms(lambda: kernels.segment_sum_ref(xd, plan), reps=10),
                "library_ms": graph_ms(lambda: torch.zeros((n,) + trail, device=dev).index_add_(0, idx_d, xd),
                                       n=20 if big else GRAPH_LAUNCHES),
                "rows": len(idx), "rows_kept": kept, "segments": n, "columns": C, "bytes": nbytes,
            }
            t["bound_ms"], t["bound_by"] = bound(nbytes, kept * C)
            times[f"{label} {name}"] = t
            print(f"kernels: segment_sum {label} {name}: {len(idx)} rows ({kept} in the plan) x {C} into "
                  f"{n} segments, bit-equal to CPU index_add_ and run to run; device {t['ms'] * 1e3:.3f} "
                  f"us/launch, wrapper {t['wrapper_ms'] * 1e3:.2f} us/call, plain {t['plain_ms'] * 1e3:.2f} "
                  f"us/call, index_add_ {t['library_ms'] * 1e3:.3f} us/launch (device, zeros included), bound "
                  f"{t['bound_ms'] * 1e3:.4f} us ({t['bound_by']}, {nbytes} B) on {card}", flush=True)
            del xd, x_full, got, got_full
        torch.cuda.empty_cache()
    return err, times


def drive(system_cls, settings, frames, monocular, profile_frames=(), poses=None):
    """One per-frame drive; returns (system, est centers, profiler or None,
    wall seconds of the profiled frames). Appends each returned pose to
    `poses` when it is a list."""
    import torch
    from torch.profiler import profile

    system = system_cls(settings, monocular, device="cuda")
    est, prof, wall = {}, None, 0.0
    for k, smv in enumerate(frames):
        if profile_frames and k == profile_frames[0]:
            torch.cuda.synchronize()
            prof = profile(activities=drive_activities())
            prof.__enter__()
            t0 = time.perf_counter()
        pose = system.track_monocular(smv.timestamp, smv)
        if poses is not None:
            poses.append(pose)
        if pose is not None:
            R, t = pose
            est[k] = -(R.T @ t)
        if profile_frames and k == profile_frames[-1]:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.__exit__(None, None, None)
    torch.cuda.synchronize()
    return system, est, prof, wall


@contextlib.contextmanager
def recorded_wires():
    """Keep a copy of the int32 wire of every per-frame and window program
    the System dispatches (a device copy, no sync), in dispatch order."""
    from movslam_tpu_torch.core import system as sysmod

    wires = []
    originals = sysmod.tracked_frame_step, sysmod.tracked_window_step

    def recording(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            wires.append(out["wire"].clone())
            return out
        return call

    sysmod.tracked_frame_step, sysmod.tracked_window_step = map(recording, originals)
    try:
        yield wires
    finally:
        sysmod.tracked_frame_step, sysmod.tracked_window_step = originals


def digests(arrays):
    """A short hash of each array's bytes (tensors are copied to the host)."""
    import numpy as np

    out = []
    for a in arrays:
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        out.append(hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:16])
    return out


def repro_drive(System, settings, monocular, frames, batches=None):
    """One drive of `frames` on the card for the reproducibility check: per
    frame (track_monocular) when batches is None, else windowed
    (track_monocular_batch over (start, stop, flush) batches). Returns the
    system (shut down) and dict(wires: digest per dispatched program,
    poses: digest per frame of the returned pose, None where none,
    trajectory: digest of frame_trajectory())."""
    import torch

    system = System(settings, monocular, device="cuda")
    with recorded_wires() as wires:
        if batches is None:
            poses = [system.track_monocular(f.timestamp, f) for f in frames]
        else:
            items = [(f.timestamp, f) for f in frames]
            poses = []
            for a, b, flush in batches:
                poses += system.track_monocular_batch(items[a:b], flush=flush)
        system.shutdown()
        torch.cuda.synchronize()
    return system, {"wires": digests(wires), "poses": pose_digests(poses),
                    "trajectory": trajectory_digest(system)}


def pose_digests(poses):
    """digests() of each returned pose, (R, t) or None."""
    import numpy as np

    return digests([np.concatenate([np.ravel(p[0]), np.ravel(p[1])]) if p is not None else np.zeros(0)
                    for p in poses])


def trajectory_digest(system):
    """digests() of system.frame_trajectory()'s timestamps and poses."""
    import numpy as np

    return digests([np.array([np.concatenate([[ts], np.ravel(R), np.ravel(t)])
                              for ts, R, t, _ in system.frame_trajectory()])])[0]


def first_difference(a, b):
    """Index of the first unequal entry of two lists (the shorter length
    when one is a prefix of the other), or None when they are equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def drive_activities():
    """What the drives are profiled for: the CUDA runtime's launch calls and
    the kernels the device ran. The host's operator events are left out: at
    ~10k launches per frame they triple the trace and slow the drive."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA]


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
    from torch.profiler import profile

    from movslam_tpu_torch.multistream_eval import scale_aligned_ate

    n_tracked = W_WARM + W_TIMED + W_PROFILED  # frames tracked with mapping on
    n_fed = n_tracked + W_LOC
    stream = SyntheticStream(n_points=400, seed=42)
    items = [(f.timestamp, f) for f in (stream.frame(k) for k in range(n_fed))]  # rendering is set-up
    gt = lambda k: -(stream.gt_pose(k)[0].T @ stream.gt_pose(k)[1])  # noqa: E731

    reset_launches(kernels)
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
    with profile(activities=drive_activities()) as prof:
        t0 = time.perf_counter()
        for k in range(W_WARM + W_TIMED, n_tracked, W_BATCH):
            poses += system.track_monocular_batch(items[k:k + W_BATCH], flush=False)
        poses += system.track_monocular_batch([], flush=True)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / W_PROFILED
    profiled = collections.Counter(system.counts)
    profiled.subtract(before)
    host, devk, busy = launch_counts(prof, W_PROFILED)

    # Localization mode: the map is frozen, tracking goes on.
    m = system.atlas.current
    system.activate_localization_mode()
    frozen = (m.n_keyframes(), m.n_mappoints(), m.change_index)
    loc_poses = []
    for k in range(n_tracked, n_fed, W_BATCH):
        loc_poses += system.track_monocular_batch(items[k:k + W_BATCH], flush=False)
    loc_poses += system.track_monocular_batch([], flush=True)
    loc_after = (m.n_keyframes(), m.n_mappoints(), m.change_index)
    loc_answered = sum(p is not None for p in loc_poses)
    poses += loc_poses
    launches = kernel_launches(kernels)
    system.shutdown()
    torch.cuda.synchronize()

    # The ATE is of the frames tracked with mapping on, as before the
    # localization frames were added; theirs is printed beside it.
    est = {k: -(p[0].T @ p[1]) for k, p in enumerate(poses) if p is not None}
    mapped = {k: c for k, c in est.items() if k < n_tracked}
    ate_live = scale_aligned_ate([gt(k) for k in mapped], list(mapped.values()))[0]
    ate_live_all = scale_aligned_ate([gt(k) for k in est], list(est.values()))[0]
    traj = [row for row in system.frame_trajectory() if round(row[0] * 30.0) < n_tracked]
    ate_post = scale_aligned_ate([gt(round(ts * 30.0)) for ts, _, _, _ in traj],
                                 [-(R.T @ t) for _, R, t, _ in traj])[0]
    c = system.counts
    by_len = {int(k.rsplit("_", 1)[1]): v for k, v in sorted(timed.items()) if k.startswith("windows_len_") and v}
    dispatched = c["window_frames"] + c["per_frame_p"]

    # The same frames through the per-frame drive, in the same call.
    psys = System(settings, monocular, device="cuda")
    for k, (ts, smv) in enumerate(items[:W_WARM + PF_TIMED]):
        if k == W_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        psys.track_monocular(ts, smv)
    torch.cuda.synchronize()
    pf_ms = 1e3 * (time.perf_counter() - t0) / PF_TIMED
    pf_lost = psys.get_total_lost()
    psys.shutdown()
    torch.cuda.synchronize()

    print(f"windows: windowed drive {win_ms:.2f} ms/frame ({1e3 / win_ms:.2f} frames/s) over the "
          f"{W_TIMED} timed frames (W={system.window}, depth {system.pipeline_depth}, batches of "
          f"{W_BATCH}, flush=False) on {card}", flush=True)
    print(f"windows: per-frame drive of the warm-up and the first {PF_TIMED} timed frames {pf_ms:.2f} "
          f"ms/frame ({1e3 / pf_ms:.2f} frames/s), lost {pf_lost}, in the same call on {card}", flush=True)
    print(f"windows: localization mode over {W_LOC} more frames: {loc_answered} answered; keyframes, "
          f"map points, change index {frozen} -> {loc_after}; live ATE with these frames "
          f"{ate_live_all:.4f} m", flush=True)
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
        "one pose per frame": len(poses) == n_fed and all(p is not None for p in poses[W_WARM:n_tracked]),
        ">= 5 keyframes": m.n_keyframes() >= 5,
        "> 100 map points": m.n_mappoints() > 100,
        f"live ATE < {LIVE_ATE_MAX}": ate_live < LIVE_ATE_MAX,
        f"post-hoc ATE < {POSTHOC_ATE_MAX}": ate_post < POSTHOC_ATE_MAX,
        "a speculative window": c["spec_windows"] >= 1,
        "a mapper job committed from a window's wire": system.mapper.n_fused_jobs >= 1,
        "score_candidates once per dispatched P-frame": launches["score_candidates"] == dispatched,
        "segment_sum launched": launches["segment_sum"] > 0,
        "localization mode leaves the map as it was": loc_after == frozen,
        f">= {W_LOC - 4} of {W_LOC} localization frames answered": loc_answered >= W_LOC - 4,
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"windowed drive gates failed: {bad}")
    return {
        "ms_per_frame": win_ms, "per_frame_drive_ms_per_frame": pf_ms, "per_frame_drive_lost": pf_lost,
        "per_frame_drive_timed_frames": PF_TIMED,
        "localization": {"frames": W_LOC, "answered": loc_answered, "before": frozen, "after": loc_after,
                         "ate_live_with_these_frames": ate_live_all},
        "windows_by_length": by_len,
        "window_frames": timed["window_frames"], "per_frame_p": timed["per_frame_p"],
        "speculative_windows": timed["spec_windows"], "rewinds": timed["rewinds"],
        "mapper_jobs_fused": jobs[0], "mapper_jobs_standalone": jobs[1], "prof_seconds": prof_s,
        "profiled": {"host_launches": host, "device_kernels": devk, "busy_ms": busy, "wall_ms": prof_wall_ms},
        "ate_live": ate_live, "ate_post": ate_post, "keyframes": m.n_keyframes(),
        "launches": launches, "p_frames_dispatched": dispatched,
    }


def metric_errors(system, stream):
    """Per-frame camera-center error in metres, no fitted scale or alignment:
    the estimate's world frame is the init camera frame (identity there,
    Tracking.cc:524), so it is composed with the ground-truth pose of the
    init frame. Returns (init frame, errors of frames init+1, init+2, ...)."""
    import numpy as np

    tr = system.tracking
    k0 = min(kf.frame_id for kf in system.atlas.current.keyframes.values())
    R0, t0 = stream.gt_pose(k0)
    errs = []
    for k, (R_rel, t_rel) in enumerate(tr.rel_poses):
        if k + 1 < k0:
            continue
        ref = tr.rel_refs[k]
        R, t = R_rel @ ref.R, R_rel @ ref.t + t_rel
        Rg, tg = R @ R0, R @ t0 + t
        R_gt, t_gt = stream.gt_pose(k + 1)
        errs.append(float(np.linalg.norm(R_gt.T @ t_gt - Rg.T @ tg)))
    return k0, np.array(errs)


def stereo_phase(System, settings, stereo, State, SyntheticStereoStream, kernels, card):
    """Phase 6 (see the module docstring). Returns the numbers it printed."""
    import numpy as np
    import torch
    from torch.profiler import profile

    n_win = S_WARM + S_TIMED + S_PROFILED
    stream = SyntheticStereoStream(seed=5)
    t_setup = time.perf_counter()
    items = [(left.timestamp, left, right) for left, right in stream.pairs(n_win)]  # set-up
    print(f"stereo: rendered {n_win} pairs in {time.perf_counter() - t_setup:.1f} s", flush=True)

    def summary(system, poses, n, n_gated):
        m = system.atlas.current
        k0, errs_all = metric_errors(system, stream)
        errs = errs_all[: max(n_gated - 1 - k0, 1)]  # frames k0+1 .. n_gated-1
        kfs = [kf for kf in m.keyframes.values() if kf.depth_right is not None and len(kf.depth_right)]
        c = system.counts
        return {
            "state": system.tracking.state.name, "lost": system.get_total_lost(),
            "keyframes": m.n_keyframes(), "map_points": m.n_mappoints(), "init_frame": k0,
            "frames": system.image_count, "poses": len(poses),
            "answered_from_init": all(p is not None for p in poses[k0:]) and len(poses) == n,
            "err_median_m": float(np.median(errs)), "err_max_m": float(errs.max()),
            "err_frames": len(errs), "err_max_all_frames_m": float(errs_all.max()),
            "slots_with_depth": float(np.mean([(kf.depth_right > 0).mean() for kf in kfs])),
            "rewinds": c["rewinds"], "window_frames": c["window_frames"], "per_frame_p": c["per_frame_p"],
            "p_frames_dispatched": c["window_frames"] + c["per_frame_p"],
            "launches": kernel_launches(kernels),
        }

    # The per-frame drive.
    reset_launches(kernels)
    psys = System(settings, stereo, device="cuda")
    poses = []
    for k, it in enumerate(items[:S_PER_FRAME]):
        if k == 5:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        poses.append(psys.track_stereo(*it))
    torch.cuda.synchronize()
    pf_ms = 1e3 * (time.perf_counter() - t0) / (S_PER_FRAME - 5)
    psys.shutdown()
    torch.cuda.synchronize()
    pf = summary(psys, poses, S_PER_FRAME, S_PER_FRAME)
    pf["ms_per_frame"] = pf_ms
    print(f"stereo: per-frame drive of {S_PER_FRAME} pairs: {pf_ms:.2f} ms/frame over pairs 5-"
          f"{S_PER_FRAME - 1}, state {pf['state']}, init at frame {pf['init_frame']}, lost {pf['lost']}, "
          f"{pf['keyframes']} keyframes, {pf['map_points']} map points, metric error median "
          f"{pf['err_median_m']:.4f} m max {pf['err_max_m']:.4f} m, {pf['slots_with_depth']:.3f} of "
          f"keyframe slots with depth, score_candidates launches {pf['launches']['score_candidates']} "
          f"for {pf['p_frames_dispatched']} left P-frames on {card}", flush=True)

    # The windowed drive.
    reset_launches(kernels)
    system = System(settings, stereo, device="cuda")
    poses = []
    for k in range(0, S_WARM, W_BATCH):  # the last warm-up batch drains the pipeline
        poses += system.track_stereo_batch(items[k:k + W_BATCH], flush=k + W_BATCH >= S_WARM)
    torch.cuda.synchronize()
    warm = collections.Counter(system.counts)
    warm_jobs = (system.mapper.n_fused_jobs, system.mapper.n_standalone_jobs)
    t0 = time.perf_counter()
    for k in range(S_WARM, S_WARM + S_TIMED, W_BATCH):
        poses += system.track_stereo_batch(items[k:k + W_BATCH], flush=False)
    poses += system.track_stereo_batch([], flush=True)
    torch.cuda.synchronize()
    win_ms = 1e3 * (time.perf_counter() - t0) / S_TIMED
    timed = collections.Counter(system.counts)
    timed.subtract(warm)
    jobs = (system.mapper.n_fused_jobs - warm_jobs[0], system.mapper.n_standalone_jobs - warm_jobs[1])
    before = collections.Counter(system.counts)
    with profile(activities=drive_activities()) as prof:
        t0 = time.perf_counter()
        poses += system.track_stereo_batch(items[S_WARM + S_TIMED:], flush=True)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / S_PROFILED
    profiled = collections.Counter(system.counts)
    profiled.subtract(before)
    host, devk, busy = launch_counts(prof, S_PROFILED)
    # A rewind dispatches frames again: launches per frame the window program ran.
    per_window_frame = host * S_PROFILED / max(profiled["window_frames"], 1)
    system.shutdown()
    torch.cuda.synchronize()
    win = summary(system, poses, n_win, S_WARM + S_TIMED)  # the profiled pairs are not gated
    by_len = {int(k.rsplit("_", 1)[1]): v for k, v in sorted(timed.items()) if k.startswith("windows_len_") and v}
    win.update({
        "ms_per_frame": win_ms, "windows_by_length": by_len, "timed_rewinds": timed["rewinds"],
        "timed_window_frames": timed["window_frames"], "timed_per_frame_p": timed["per_frame_p"],
        "speculative_windows": timed["spec_windows"], "mapper_bf": system.mapper.bf,
        "mapper_jobs_fused": system.mapper.n_fused_jobs, "mapper_jobs_standalone": system.mapper.n_standalone_jobs,
        "timed_mapper_jobs_fused": jobs[0], "timed_mapper_jobs_standalone": jobs[1],
        "profiled": {"host_launches": host, "device_kernels": devk, "busy_ms": busy, "wall_ms": prof_wall_ms,
                     "window_frames": profiled["window_frames"], "per_frame_p": profiled["per_frame_p"],
                     "host_launches_per_window_frame": per_window_frame,
                     "idle_share": 1 - busy / prof_wall_ms},
    })
    print(f"stereo: windowed drive {win_ms:.2f} ms/frame ({1e3 / win_ms:.2f} frames/s) over the {S_TIMED} "
          f"timed pairs (W={system.window}, depth {system.pipeline_depth}, batches of {W_BATCH}, "
          f"flush=False) on {card}", flush=True)
    print(f"stereo: timed windows by length {by_len}, {timed['window_frames']} window frames, "
          f"{timed['per_frame_p']} per-frame P-frames, {timed['spec_windows']} speculative windows, "
          f"{timed['rewinds']} rewinds ({win['rewinds']} in the whole drive); mapper jobs run by a "
          f"window {system.mapper.n_fused_jobs} (bf = {system.mapper.bf}), standalone "
          f"{system.mapper.n_standalone_jobs} on {card}", flush=True)
    print(f"stereo: {S_PROFILED} more pairs under the profiler ({profiled['window_frames']} window frames, "
          f"{profiled['per_frame_p']} per-frame): {host:.1f} launch calls per pair "
          f"({per_window_frame:.1f} per window frame dispatched), {devk:.1f} device kernels per pair, device "
          f"busy {busy:.2f} ms of {prof_wall_ms:.2f} ms per pair with the profiler on "
          f"(idle {1 - busy / prof_wall_ms:.3f}) on {card}", flush=True)
    print(f"stereo: state {win['state']}, init at frame {win['init_frame']}, {win['keyframes']} keyframes, "
          f"{win['map_points']} map points, {win['poses']} poses, lost {win['lost']}, metric error over the "
          f"{S_WARM + S_TIMED} warm-up and timed pairs median {win['err_median_m']:.4f} m max "
          f"{win['err_max_m']:.4f} m (max with the profiled pairs {win['err_max_all_frames_m']:.4f} m), "
          f"{win['slots_with_depth']:.3f} of "
          f"keyframe slots with depth; score_candidates launches {win['launches']['score_candidates']} "
          f"for {win['p_frames_dispatched']} left P-frames dispatched ({win['window_frames']} in windows, "
          f"{win['per_frame_p']} per frame)", flush=True)
    # What the stereo depth costs: one eager lk_track call, left -> right, at
    # the track capacity.
    from movslam_tpu_torch.ops.lk import lk_track

    left, right = (torch.as_tensor(items[20][i].im_gray, device="cuda") for i in (1, 2))
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(20, 460, (2048, 2)).astype(np.float32), device="cuda")
    valid = torch.ones(2048, dtype=torch.bool, device="cuda")
    lk_call = lambda: lk_track(left, right, pts, valid)  # noqa: E731
    lk_wall_ms = call_ms(lk_call, reps=5, warmup=2)
    with profile(activities=drive_activities()) as prof:
        lk_call()
        torch.cuda.synchronize()
    lk_host, _, lk_busy = launch_counts(prof, 1)
    lk = {"host_launches": lk_host, "busy_ms": lk_busy, "wall_ms": lk_wall_ms}
    print(f"stereo: one lk_track call (left -> right, 2048 points, 640x480): {lk_host:.0f} launch calls, "
          f"device busy {lk_busy:.2f} ms, {lk_wall_ms:.2f} ms per call on {card}", flush=True)

    checks = {
        "windowed: 0 lost": win["lost"] == 0,
        "windowed: every frame counted and answered": win["frames"] == n_win and win["answered_from_init"],
        "per frame: every frame counted and answered": pf["frames"] == S_PER_FRAME and pf["answered_from_init"],
        "windowed: state OK": win["state"] == State.OK.name,
        "per frame: state OK": pf["state"] == State.OK.name,
        "windowed: > 100 map points": win["map_points"] > 100,
        "per frame: > 100 map points": pf["map_points"] > 100,
        "windowed: median error < 0.20 m": win["err_median_m"] < 0.20,
        "windowed: max error < 0.8 m": win["err_max_m"] < 0.8,
        "per frame: median error < 0.35 m": pf["err_median_m"] < 0.35,
        "windowed: score_candidates once per left P-frame":
            win["launches"]["score_candidates"] == win["p_frames_dispatched"] > 0,
        "per frame: score_candidates once per left P-frame":
            pf["launches"]["score_candidates"] == pf["p_frames_dispatched"] > 0,
        "windowed: segment_sum launched": win["launches"]["segment_sum"] > 0,
        "per frame: segment_sum launched": pf["launches"]["segment_sum"] > 0,
        "a stereo window ran": win["window_frames"] > 0,
        "a mapper job with bf != 0 committed from a window's wire":
            system.mapper.n_fused_jobs >= 1 and system.mapper.bf != 0,
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"stereo gates failed: {bad}")
    return {"per_frame": pf, "windowed": win, "lk_track": lk}


def vi_phase(System, settings, sensor, SyntheticVIStream, kernels, card):
    """Phase 7 (see the module docstring). Returns the numbers it printed."""
    import numpy as np
    import torch
    from torch.profiler import profile

    from movslam_tpu_torch.core import local_mapping
    from movslam_tpu_torch.core.inertial import _stack_windows, preintegrate_windows

    n_win = VI_WINDOWED + VI_PROFILED
    stream = SyntheticVIStream(n_points=400, seed=11)
    items = list(stream.items(n_win))  # rendering and the IMU samples are set-up

    def gt_center(k):
        R, t = stream.gt_pose(k)
        return -(R.T @ t)

    def summary(system, poses, n):
        m = system.atlas.current
        errs = np.array([np.linalg.norm(kf.center() - gt_center(kf.frame_id)) for kf in m.keyframes.values()])
        span = float(np.linalg.norm(np.ptp(np.array([gt_center(k) for k in range(n)]), axis=0)))
        init = next((k for k, p in enumerate(poses) if p is not None), n)
        mp = system.mapper
        c = system.counts
        return {
            "state": system.tracking.state.name, "lost": system.get_total_lost(), "frames": system.image_count,
            "poses": len(poses), "init_frame": init,
            "answered_from_init": len(poses) == n and all(p is not None for p in poses[init:]),
            "keyframes": m.n_keyframes(), "map_points": m.n_mappoints(),
            "imu_initialized": m.imu_initialized, "imu_scale": m.imu_scale, "init_stages": m.imu_init_count,
            "vi_inits": [{"stage": st, "keyframes": nk, "scale": sc, "ms": ms, "preintegrate_steps": steps}
                         for st, nk, sc, ms, steps in mp.vi_inits],
            "vi_ba_calls": len(mp.vi_ba_ms), "vi_ba_ms": mp.vi_ba_ms, "vi_ba_preintegrate_steps": mp.vi_ba_steps,
            "kf_err_median_m": float(np.median(errs)), "kf_err_max_m": float(errs.max()), "span_m": span,
            "err_bound_m": 0.15 * max(span, 0.5),
            "window_frames": c["window_frames"], "per_frame_p": c["per_frame_p"],
            "p_frames_dispatched": c["window_frames"] + c["per_frame_p"], "rewinds": c["rewinds"],
            "launches": kernel_launches(kernels),
        }

    # The per-frame drive.
    reset_launches(kernels)
    psys = System(settings, sensor, device="cuda")
    psys.mapper.vi_min_kfs = VI_MIN_KFS
    poses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ts, smv, imu in items[:VI_PER_FRAME]:
        poses.append(psys.track_monocular(ts, smv, imu=imu))
    torch.cuda.synchronize()
    pf_ms = 1e3 * (time.perf_counter() - t0) / VI_PER_FRAME
    pf = summary(psys, poses, VI_PER_FRAME)
    m = psys.atlas.current
    last = max(m.keyframes.values(), key=lambda kf: kf.id)
    pf.update({"ms_per_frame": pf_ms, "last_kf_velocity_set": last.velocity is not None,
               "last_kf_bias_g_set": last.bias_g is not None})

    # One _local_ba_vi call and one preintegrate call (the chain's windows at
    # the VI BA's padding) under the profiler, on the drive's final map.
    mapper = psys.mapper
    chain = [mapper.current_kf]
    while len(chain) < 24 and chain[-1].prev_kf is not None and chain[-1].prev_kf.id in m.keyframes:
        chain.append(chain[-1].prev_kf)
    win = _stack_windows(chain[::-1], psys.imu_buffer)
    pad = lambda x: np.concatenate([x, np.zeros((47 - len(x),) + x.shape[1:], x.dtype)])  # noqa: E731
    zero = np.zeros((47, 3), np.float32)
    one = {}
    torch.cuda.synchronize()
    for name, call in (  # both ran all through the drive: no warm-up call
        ("local_ba_vi", lambda: mapper._local_ba_vi(m)),
        ("preintegrate", lambda: preintegrate_windows(*(pad(x) for x in win[:4]), zero, zero, psys.device)),
    ):
        with profile(activities=drive_activities()) as prof:
            t1 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t1)
        host, _, busy = launch_counts(prof, 1)
        one[name] = {"host_launches": host, "busy_ms": busy, "wall_ms_profiled": wall}
        if name == "preintegrate":
            one[name]["steps"] = out[1]
    psys.shutdown()
    torch.cuda.synchronize()

    # The windowed drive, noting for each init attempt whether it ran inside
    # a window's replay and how many windows were in flight then.
    reset_launches(kernels)
    system = System(settings, sensor, device="cuda")
    system.mapper.vi_min_kfs = VI_MIN_KFS
    replaying, crossings = [], []
    replay, init = system._replay_window, local_mapping.visual_inertial_init

    def replay_noted(wf):
        replaying.append(len(wf["run"]))
        try:
            return replay(wf)
        finally:
            replaying.pop()

    def init_noted(*args, **kwargs):
        crossings.append({"frame": system.image_count, "in_replay": bool(replaying),
                          "windows_in_flight": len(system._wfq)})
        return init(*args, **kwargs)

    system._replay_window = replay_noted
    local_mapping.visual_inertial_init = init_noted
    poses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for k in range(0, VI_WINDOWED, W_BATCH):
            poses += system.track_monocular_batch(items[k:k + W_BATCH], flush=False)
        poses += system.track_monocular_batch([], flush=True)
        torch.cuda.synchronize()
    finally:
        local_mapping.visual_inertial_init = init
    win_ms = 1e3 * (time.perf_counter() - t0) / VI_WINDOWED
    before = collections.Counter(system.counts)
    with profile(activities=drive_activities()) as prof:
        t0 = time.perf_counter()
        poses += system.track_monocular_batch(items[VI_WINDOWED:], flush=True)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / VI_PROFILED
    profiled = collections.Counter(system.counts)
    profiled.subtract(before)
    host, devk, busy = launch_counts(prof, VI_PROFILED)
    per_window_frame = host * VI_PROFILED / max(profiled["window_frames"], 1)
    system.shutdown()
    torch.cuda.synchronize()
    wd = summary(system, poses, n_win)
    wd.update({
        "ms_per_frame": win_ms, "speculative_windows": system.counts["spec_windows"],
        "mapper_jobs_fused": system.mapper.n_fused_jobs, "mapper_jobs_standalone": system.mapper.n_standalone_jobs,
        "imu_buffer_frames": len(system.imu_buffer.by_frame), "init_attempts": crossings,
        "profiled": {"host_launches": host, "device_kernels": devk, "busy_ms": busy, "wall_ms": prof_wall_ms,
                     "window_frames": profiled["window_frames"], "per_frame_p": profiled["per_frame_p"],
                     "host_launches_per_window_frame": per_window_frame, "idle_share": 1 - busy / prof_wall_ms},
    })

    for label, r in (("per-frame", pf), ("windowed", wd)):
        inits = ", ".join(f"stage {i['stage']} at {i['keyframes']} KFs scale {i['scale']} in {i['ms']:.1f} ms "
                          f"({i['preintegrate_steps']} preintegrate steps)" for i in r["vi_inits"]
                          if i["scale"] is not None)
        ba = r["vi_ba_ms"]
        print(f"vi: {label} drive {r['ms_per_frame']:.2f} ms/frame over {r['frames']} frames, state {r['state']}, "
              f"init at frame {r['init_frame']}, lost {r['lost']}, {r['keyframes']} keyframes, {r['map_points']} map "
              f"points; IMU initialized {r['imu_initialized']} ({r['init_stages']} stages: {inits}); "
              f"_local_ba_vi calls {r['vi_ba_calls']}"
              + (f", {np.mean(ba):.1f} ms per call (median {np.median(ba):.1f}), preintegrate steps per call "
                 f"{sorted(set(r['vi_ba_preintegrate_steps']))}" if ba else "")
              + f"; keyframe metric error median {r['kf_err_median_m']:.4f} m max {r['kf_err_max_m']:.4f} m "
              f"(bound {r['err_bound_m']:.4f} m, span {r['span_m']:.4f} m); score_candidates launches "
              f"{r['launches']['score_candidates']} for {r['p_frames_dispatched']} P-frames dispatched "
              f"({r['window_frames']} in windows, {r['per_frame_p']} per frame, {r['rewinds']} rewinds) on {card}",
              flush=True)
    print(f"vi: windowed drive init attempts (frame, inside a window's replay, windows in flight): "
          f"{[(c['frame'], c['in_replay'], c['windows_in_flight']) for c in crossings]}", flush=True)
    print(f"vi: {VI_PROFILED} more windowed frames under the profiler ({profiled['window_frames']} window frames, "
          f"{profiled['per_frame_p']} per-frame): {host:.1f} launch calls/frame ({per_window_frame:.1f} per window "
          f"frame dispatched), {devk:.1f} device kernels/frame, device busy {busy:.2f} ms of {prof_wall_ms:.2f} "
          f"ms/frame with the profiler on (idle {1 - busy / prof_wall_ms:.3f}) on {card}", flush=True)
    for name, r in one.items():
        print(f"vi: one {name} call ({'the last keyframe chain, K = 48' if name == 'local_ba_vi' else str(r.get('steps')) + ' steps, 47 windows'}): "
              f"{r['host_launches']:.0f} launch calls, device busy {r['busy_ms']:.2f} ms, {r['wall_ms_profiled']:.2f} "
              f"ms with the profiler on, on {card}", flush=True)

    checks = {}
    for label, r in (("per frame", pf), ("windowed", wd)):
        checks.update({
            f"{label}: IMU initialized": r["imu_initialized"],
            f"{label}: median keyframe metric error < 0.15 * max(span, 0.5)": r["kf_err_median_m"] < r["err_bound_m"],
            f"{label}: 0 lost": r["lost"] == 0,
            f"{label}: every frame counted and answered from the init": r["answered_from_init"]
            and r["frames"] == r["poses"],
            f"{label}: score_candidates once per dispatched P-frame":
                r["launches"]["score_candidates"] == r["p_frames_dispatched"] > 0,
            f"{label}: segment_sum launched": r["launches"]["segment_sum"] > 0,
        })
    checks.update({
        "per frame: velocity and gyro bias on the last keyframe": pf["last_kf_velocity_set"] and pf["last_kf_bias_g_set"],
        "per frame: at least one _local_ba_vi call": pf["vi_ba_calls"] >= 1,
        "windowed: a window ran": wd["window_frames"] > 0,
    })
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"vi gates failed: {bad}")
    return {"per_frame": pf, "windowed": wd, "one_call": one}

def mean_reprojection(m, cam):
    """Mean squared reprojection error (px^2) over every observation of a good
    map point in front of its keyframe (tests/test_system_features.py's
    measure)."""
    import numpy as np

    errs = []
    for kf in m.keyframes.values():
        slots = np.flatnonzero(kf.mp_ids >= 0)
        mps = [m.mappoints.get(int(kf.mp_ids[s])) for s in slots]
        keep = [i for i, mp in enumerate(mps) if mp is not None and not mp.bad]
        if not keep:
            continue
        pc = np.stack([mps[i].pos for i in keep]) @ kf.R.T + kf.t
        uv = kf.pts[slots[keep]]
        ok = pc[:, 2] > 1e-6
        u = cam.fx * pc[ok, 0] / pc[ok, 2] + cam.cx
        v = cam.fy * pc[ok, 1] / pc[ok, 2] + cam.cy
        errs.append((u - uv[ok, 0]) ** 2 + (v - uv[ok, 1]) ** 2)
    return float(np.concatenate(errs).mean())


def map_copy_moved(checkpoint, path):
    """The map in the checkpoint, loaded, moved by a known Sim3 (s = 1.7:
    x_new = R^T (x_old - t) / s) and re-keyed past the original's ids: the
    "new map" of tests/test_map_merge.py::_build_map_pair."""
    import numpy as np
    import torch

    from movslam_tpu_torch.ops.lie import so3_exp

    m = checkpoint.load_atlas(path).current
    s, R, t = MERGE_SIM3[0], so3_exp(torch.tensor(MERGE_SIM3[1], dtype=torch.float64)).numpy(), \
        np.array(MERGE_SIM3[2])
    for kf in m.keyframes.values():
        kf.set_pose(kf.R @ R, (kf.t + kf.R @ t) / s)
    for mp in m.mappoints.values():
        mp.pos = R.T @ (mp.pos - t) / s
    off_kf, off_mp = max(m.keyframes) + 1000, max(m.mappoints) + 100000
    m.keyframes = {k + off_kf: kf for k, kf in m.keyframes.items()}
    for k, kf in m.keyframes.items():
        kf.id = k
        kf.covis = {c + off_kf: w for c, w in kf.covis.items()}
        kf.mp_ids = np.where(kf.mp_ids >= 0, kf.mp_ids + off_mp, -1)
    m.mappoints = {k + off_mp: mp for k, mp in m.mappoints.items()}
    for k, mp in m.mappoints.items():
        mp.id = k
        mp.obs = {kf_id + off_kf: slot for kf_id, slot in mp.obs.items()}
        mp.first_kf_id += off_kf
    m.init_kf_id += off_kf
    return m


def top_bucket_map(n_kf, n_mp, per_kf, seed=0, noise=5e-3):
    """tests/test_global_ba.py::_build_map at the reference's global-BA caps:
    a circular trajectory of n_kf keyframes around a point cloud, each
    keyframe observing per_kf points drawn from those it sees; poses (but the
    first) and points perturbed so that BA has something to correct. Every
    point is observed: each is first given to the least-loaded keyframe that
    sees it (the points seen by the fewest keyframes first), and each keyframe
    fills its other slots at random from the rest of what it sees."""
    import types

    import numpy as np

    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.map import KeyFrame, Map, MapPoint

    rng = np.random.default_rng(seed)
    cam = Pinhole(300.0, 300.0, 160.0, 120.0, 320, 240)
    m = Map()
    X = rng.uniform(-4, 4, (n_mp, 3))
    X[:, 2] += 12.0
    a = np.arange(n_kf) / n_kf
    t_cws = -np.stack([3 * np.sin(2 * np.pi * a), 3 * np.cos(2 * np.pi * a), -1.0 + 2 * a], axis=1)
    pc = X[None] + t_cws[:, None]  # (n_kf, n_mp, 3)
    u, v = cam.fx * pc[..., 0] / pc[..., 2] + cam.cx, cam.fy * pc[..., 1] / pc[..., 2] + cam.cy
    seen = (pc[..., 2] > 1) & (u >= 0) & (u < 320) & (v >= 0) & (v < 240)
    if not seen.any(axis=0).all():
        fail("top_bucket_map: a point no keyframe sees")
    owner, load = np.empty(n_mp, np.int64), np.zeros(n_kf, np.int64)
    for j in np.argsort(seen.sum(axis=0), kind="stable"):
        ks = np.flatnonzero(seen[:, j])
        owner[j] = ks[np.argmin(load[ks])]
        load[owner[j]] += 1
    owned = [np.flatnonzero(owner == k) for k in range(n_kf)]
    kfs, sels = [], []
    for k in range(n_kf):
        t_cw = t_cws[k]
        rest = np.setdiff1d(np.flatnonzero(seen[k]), owned[k])
        if len(owned[k]) > per_kf or len(owned[k]) + len(rest) < per_kf:
            fail(f"top_bucket_map: keyframe {k} owns {len(owned[k])} points and sees {len(rest)} more")
        sel = np.sort(np.concatenate([owned[k], rng.choice(rest, per_kf - len(owned[k]), replace=False)]))
        u_k, v_k = u[k], v[k]
        frame = types.SimpleNamespace(
            id=k, timestamp=k / 10.0, R=np.eye(3), t=t_cw, track_ids=sel.astype(np.int64),
            pts=np.stack([u_k[sel], v_k[sel]], axis=1), desc=None, mappoints=[None] * per_kf, image=None,
            depth_right=None, uright=None)
        kf = KeyFrame(frame, m.id)
        m.add_keyframe(kf)
        kfs.append(kf)
        sels.append(sel)
    mps = [MapPoint(X[j] + rng.normal(0, noise, 3), kfs[0].id, j, m.id) for j in range(n_mp)]
    for kf, sel in zip(kfs, sels):
        for slot, j in enumerate(sel):
            mps[j].add_observation(kf, slot)
            kf.mp_ids[slot] = mps[j].id
    for mp in mps:
        m.add_mappoint(mp)
    for kf in kfs[1:]:
        kf.set_pose(kf.R, kf.t + rng.normal(0, noise * 4, 3))
    return m, cam


def atlas_phase(System, settings, monocular, system, stream, card):
    """Phase 8 (see the module docstring). `system` is phase 3's, after its
    drive. Returns the numbers it printed."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import profile

    from movslam_tpu_torch.core import checkpoint, local_mapping, map_merge
    from movslam_tpu_torch.multistream_eval import scale_aligned_ate
    from movslam_tpu_torch.ops import kernels

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def profiled(fn):
        with profile(activities=drive_activities()) as prof:
            out, wall = synced(fn)
        host, _, busy = launch_counts(prof, 1)
        return out, {"host_launches": host, "busy_ms": busy, "wall_ms_profiled": wall}

    def posthoc_ate(sys_):
        traj = sys_.frame_trajectory()
        gt = lambda k: -(stream.gt_pose(k)[0].T @ stream.gt_pose(k)[1])  # noqa: E731
        return scale_aligned_ate([gt(round(ts * 30.0)) for ts, _, _, _ in traj],
                                 [-(R.T @ t) for _, R, t, _ in traj])[0]

    out, checks = {}, {}
    m = system.atlas.current
    reset_launches(kernels)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the checkpoint round trip
        path = os.path.join(tmp, "phase3.atlas")
        _, save_ms = synced(lambda: system.save_atlas(path))
        loaded, load_ms = synced(lambda: checkpoint.load_atlas(path))
        m2 = loaded.current
        out["checkpoint"] = {"save_ms": save_ms, "load_ms": load_ms, "bytes": os.path.getsize(path),
                             "keyframes": m.n_keyframes(), "map_points": m.n_mappoints()}
        checks["checkpoint: counts equal"] = (m2.n_keyframes(), m2.n_mappoints()) == (m.n_keyframes(),
                                                                                      m.n_mappoints())
        checks["checkpoint: poses and points bit-equal"] = sorted(m2.keyframes) == sorted(m.keyframes) and all(
            np.array_equal(m2.keyframes[k].R, kf.R) and np.array_equal(m2.keyframes[k].t, kf.t)
            for k, kf in m.keyframes.items()) and all(
            np.array_equal(m2.mappoints[k].pos, mp.pos) for k, mp in m.mappoints.items())

        # (b) the merge: the loaded copy is the old map, a moved copy the new
        merge = {}
        for label in ("first", "timed", "profiled"):  # the first call warms torch.func up
            atlas = loaded if label == "first" else checkpoint.load_atlas(path)
            old_pos = {mp.track_id: mp.pos.copy() for mp in atlas.current.mappoints.values() if not mp.bad}
            new = map_copy_moved(checkpoint, path)
            atlas.maps.append(new)
            atlas.current = new
            call = lambda: map_merge.try_merge(atlas, device="cuda")  # noqa: E731
            if label == "profiled":
                merged, merge["pose_graph"] = profiled(call)
            else:
                merged, merge[f"{label}_ms"] = synced(call)
            errs = [np.linalg.norm(mp.pos - old_pos[mp.track_id]) for mp in atlas.current.mappoints.values()
                    if not mp.bad and mp.track_id in old_pos]
            merge[f"{label}_median_weld_error_m"] = float(np.median(errs))
            merge[f"{label}_maps_left"] = len(atlas.maps)
            checks[f"merge ({label}): welded, one map left"] = merged and len(atlas.maps) == 1
            checks[f"merge ({label}): median welded-point error < 0.05 m"] = np.median(errs) < 0.05
        out["merge"] = merge

        # (c) System.global_bundle_adjustment(iters=20): unprofiled on a system
        # resumed from the checkpoint, profiled on the drive's own system
        resumed = System(settings, monocular, device="cuda")
        resumed.load_atlas(path)
        before = mean_reprojection(resumed.atlas.current, resumed.mapper.camera)
        _, gba_ms = synced(lambda: resumed.global_bundle_adjustment(iters=20))
        after_resumed = mean_reprojection(resumed.atlas.current, resumed.mapper.camera)
    ate_before = posthoc_ate(system)
    _, gba_prof = profiled(lambda: system.global_bundle_adjustment(iters=20))
    after = mean_reprojection(m, system.mapper.camera)
    out["global_ba_drive_map"] = {
        "keyframes": m.n_keyframes(), "map_points": m.n_mappoints(), "ms": gba_ms, **gba_prof,
        "mean_reproj_px2_before": before, "mean_reproj_px2_after": after,
        "mean_reproj_px2_after_resumed": after_resumed, "posthoc_ate_before_m": ate_before,
        "posthoc_ate_after_m": posthoc_ate(system)}
    for label, kfs_, mps_, err in (("resumed", resumed.atlas.current.keyframes.values(),
                                    resumed.atlas.current.mappoints.values(), after_resumed),
                                   ("drive", m.keyframes.values(), m.mappoints.values(), after)):
        checks[f"global BA ({label}): finite"] = all(np.isfinite(kf.t).all() and np.isfinite(kf.R).all()
                                                     for kf in kfs_) and all(np.isfinite(mp.pos).all() for mp in mps_)
        checks[f"global BA ({label}): mean reprojection error <= 1.5x before + 1e-6"] = err <= before * 1.5 + 1e-6

    # (d) global BA at the reference's caps (one window, the top bucket)
    top = {}
    for label in ("timed", "profiled"):
        tm, cam = top_bucket_map(GBA_TOP_KF, GBA_TOP_MP, GBA_TOP_PER_KF)
        kfs = sorted(tm.keyframes.values(), key=lambda kf: kf.id)
        t_before = {kf.id: kf.t.copy() for kf in kfs}
        cost_before = mean_reprojection(tm, cam)
        call = lambda: local_mapping.global_bundle_adjustment(tm, cam, device="cuda", iters=20)  # noqa: E731
        if label == "timed":
            torch.cuda.reset_peak_memory_stats()
            _, top["ms"] = synced(call)
            top["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        else:
            _, top["profiled"] = profiled(call)
        moved = sum(np.abs(kf.t - t_before[kf.id]).max() > 1e-9 for kf in kfs[1:])
        cost_after = mean_reprojection(tm, cam)
        top.update({f"{label}_moved_keyframes": int(moved), f"{label}_mean_reproj_px2_before": cost_before,
                    f"{label}_mean_reproj_px2_after": cost_after})
        checks[f"top-bucket global BA ({label}): every non-anchor keyframe moved"] = moved >= len(kfs) - 2
        checks[f"top-bucket global BA ({label}): finite"] = all(np.isfinite(kf.t).all() for kf in kfs) and all(
            np.isfinite(mp.pos).all() for mp in tm.mappoints.values())
        checks[f"top-bucket global BA ({label}): the cost fell"] = cost_after < cost_before
    n_obs = sum(int((kf.mp_ids >= 0).sum()) for kf in tm.keyframes.values())
    K = local_mapping._bucket(len(tm.keyframes), local_mapping.GBA_KF_BUCKETS[0], local_mapping.GBA_KF_BUCKETS[-1])
    top.update({"keyframes": len(tm.keyframes), "map_points": tm.n_mappoints(), "observations": n_obs,
                "kf_bucket": K, "schur_dim": 6 * K})
    checks["top-bucket map at the caps"] = (len(tm.keyframes), tm.n_mappoints(), n_obs) == (
        GBA_TOP_KF, GBA_TOP_MP, GBA_TOP_KF * GBA_TOP_PER_KF)
    out["launches"] = kernel_launches(kernels)
    checks["segment_sum launched (pose graph, global BA)"] = out["launches"]["segment_sum"] > 0
    out["global_ba_top_bucket"] = top

    c, mg, g, tp = out["checkpoint"], out["merge"], out["global_ba_drive_map"], top
    print(f"atlas: (a) checkpoint of phase 3's map ({c['keyframes']} keyframes, {c['map_points']} map points): "
          f"save {c['save_ms']:.2f} ms, load {c['load_ms']:.2f} ms, {c['bytes']} bytes on {card}", flush=True)
    print(f"atlas: (b) merge of a moved copy (s = {MERGE_SIM3[0]}): try_merge {mg['timed_ms']:.2f} ms (first call "
          f"{mg['first_ms']:.2f} ms), median welded-point "
          f"error {mg['timed_median_weld_error_m']:.5f} m, {mg['timed_maps_left']} map left; under the profiler "
          f"{mg['pose_graph']['host_launches']:.0f} launch calls, device busy {mg['pose_graph']['busy_ms']:.2f} ms, "
          f"{mg['pose_graph']['wall_ms_profiled']:.2f} ms on {card}", flush=True)
    print(f"atlas: (c) System.global_bundle_adjustment(iters=20) on the drive's map ({g['keyframes']} keyframes, "
          f"{g['map_points']} map points): {g['ms']:.2f} ms (resumed from the checkpoint); under the profiler "
          f"{g['host_launches']:.0f} launch calls, device busy {g['busy_ms']:.2f} ms, {g['wall_ms_profiled']:.2f} ms; "
          f"mean reprojection {g['mean_reproj_px2_before']:.4f} -> {g['mean_reproj_px2_after']:.4f} px^2 "
          f"(resumed {g['mean_reproj_px2_after_resumed']:.4f}); post-hoc ATE {g['posthoc_ate_before_m']:.4f} -> "
          f"{g['posthoc_ate_after_m']:.4f} m on {card}", flush=True)
    print(f"atlas: (d) global BA at the caps ({tp['keyframes']} keyframes -> bucket {tp['kf_bucket']}, Schur "
          f"{tp['schur_dim']}^2, {tp['map_points']} map points, {tp['observations']} observations, 20 iterations): "
          f"{tp['ms']:.2f} ms, peak {tp['peak_memory_bytes'] / 2**30:.3f} GiB allocated; under the profiler "
          f"{tp['profiled']['host_launches']:.0f} launch calls, device busy {tp['profiled']['busy_ms']:.2f} ms, "
          f"{tp['profiled']['wall_ms_profiled']:.2f} ms; moved {tp['timed_moved_keyframes']} keyframes, mean "
          f"reprojection {tp['timed_mean_reproj_px2_before']:.4f} -> {tp['timed_mean_reproj_px2_after']:.4f} px^2 "
          f"on {card}", flush=True)
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"atlas gates failed: {bad}")
    return out


def ingest_phase(System, settings, monocular, SyntheticStream, kernels, card):
    """Phase 9 (see the module docstring). Returns the numbers it printed."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import profile

    from movslam_tpu_torch import cli
    from movslam_tpu_torch.io import video
    from movslam_tpu_torch.io.mvimage import FrameType
    from movslam_tpu_torch.multistream_eval import scale_aligned_ate

    out, checks = {}, {}
    found = video.libav_found()
    out["libav_found"] = found
    out["launches"] = None  # the real-H.264 drive's, where it ran
    print(f"ingest: pkg-config finds {', '.join(video.LIBAV)}: {'yes' if found else 'no'}", flush=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        if not found:
            print("ingest: libav's development files are absent on this host: the real-H.264 drive is "
                  "verified on the CPU host only (tests/test_torch_video.py, test_torch_cli.py, "
                  "test_torch_codec_e2e.py)", flush=True)
        else:
            t0 = time.perf_counter()
            video.build(verbose=True)
            out["decoder_build_s"] = time.perf_counter() - t0
            stream = SyntheticStream(n_points=400, seed=42)
            frames = np.stack([stream.render(k)[0] for k in range(H264_FRAMES)])  # rendering is set-up
            path = os.path.join(tmp, "codec.mp4")
            t0 = time.perf_counter()
            video.encode_gray(path, frames, fps=30.0, keyint=1000, refs=4, cavlc=True)
            out["encode_s"] = time.perf_counter() - t0
            dec = video.VideoDecoder(path)
            dec.init()
            t0 = time.perf_counter()
            decoded = list(dec)
            out["decode_ms_per_frame"] = 1e3 * (time.perf_counter() - t0) / max(len(decoded), 1)
            dec.close()
            out["max_mvs"] = max(f.n_mvs for f in decoded)
            n_p = sum(f.ft == FrameType.P_FRAME for f in decoded)

            # The CLI's throughput drive on the card; two batch calls in the
            # middle under the profiler, for the device's idle share.
            system = System(settings, monocular, device="cuda")
            plain_batch, calls, prof = system.track_monocular_batch, [0], {}

            def batch(items, flush=True):
                k = calls[0]
                calls[0] += 1
                if k == H264_PROFILED[0]:
                    torch.cuda.synchronize()
                    prof["p"] = profile(activities=drive_activities())
                    prof["p"].__enter__()
                    prof["t0"], prof["frames"] = time.perf_counter(), 0
                res = plain_batch(items, flush=flush)
                if k in H264_PROFILED:
                    prof["frames"] += len(items)
                if k == H264_PROFILED[-1]:
                    torch.cuda.synchronize()
                    prof["wall_ms"] = 1e3 * (time.perf_counter() - prof["t0"])
                    prof["p"].__exit__(None, None, None)
                return res

            system.track_monocular_batch = batch
            reset_launches(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n, _ = cli.mono_drive(system, path)
            torch.cuda.synchronize()
            drive_ms = 1e3 * (time.perf_counter() - t0) / max(n, 1)
            launches = kernel_launches(kernels)
            _, _, busy = launch_counts(prof["p"], 1)
            system.shutdown()
            torch.cuda.synchronize()
            c, m = system.counts, system.atlas.current
            dispatched = c["window_frames"] + c["per_frame_p"]
            traj = system.frame_trajectory()
            gt = np.array([-(stream.gt_pose(round(ts * 30.0))[0].T @ stream.gt_pose(round(ts * 30.0))[1])
                           for ts, _, _, _ in traj])
            ate = scale_aligned_ate(gt, [-(R.T @ t) for _, R, t, _ in traj])[0]
            span = float(np.linalg.norm(np.ptp(gt, axis=0)))
            out.update({
                "frames": n, "p_frames": int(n_p), "drive_ms_per_frame": drive_ms, "lost": system.get_total_lost(),
                "keyframes": m.n_keyframes(), "ate_m": ate, "span_m": span, "ate_pct_of_span": 100 * ate / span,
                "launches": launches, "p_frames_dispatched": dispatched,
                "profiled": {"frames": prof["frames"], "busy_ms": busy, "wall_ms": prof["wall_ms"],
                             "idle": 1 - busy / prof["wall_ms"]},
            })
            print(f"ingest: decoder built in {out['decoder_build_s']:.1f} s; {H264_FRAMES} frames of "
                  f"SyntheticStream(seed=42) encoded (CAVLC, ref 4, keyint 1000) in {out['encode_s']:.1f} s; "
                  f"decode {out['decode_ms_per_frame']:.3f} ms/frame on the host, up to {out['max_mvs']} MVs",
                  flush=True)
            print(f"ingest: real-H.264 drive (cli.mono_drive, windowed, batches of {system.window}) "
                  f"{drive_ms:.2f} ms/frame incl. decoding, {n} frames, lost {system.get_total_lost()}, "
                  f"{m.n_keyframes()} keyframes, ATE {ate:.4f} m = {100 * ate / span:.2f}% of {span:.3f} m; "
                  f"score_candidates launches {launches['score_candidates']} for {dispatched} P-frames "
                  f"dispatched; device busy {busy:.2f} ms of {prof['wall_ms']:.2f} ms over {prof['frames']} "
                  f"profiled frames (idle {1 - busy / prof['wall_ms']:.3f}) on {card}", flush=True)
            checks.update({
                "real H.264: every frame counted": n == H264_FRAMES == system.image_count,
                "real H.264: 0 lost": system.get_total_lost() == 0,
                "real H.264: >= 10 keyframes": m.n_keyframes() >= 10,
                "real H.264: ATE < 5% of span": 100 * ate / span < 5.0,
                "real H.264: score_candidates once per dispatched P-frame":
                    launches["score_candidates"] == dispatched > 0,
            })

        # synthetic://n_frames=48 through the same drive function and _finish,
        # with the CLI's --viewer (the System is built from settings in code:
        # no pyyaml on the card host)
        url = "synthetic://n_frames=48"
        os.chdir(tmp)
        try:
            system = cli._system(["mono", settings, url, "--viewer", "frames"], monocular)
            reset_launches(kernels)
            n, wall = cli.mono_drive(system, url)
            cli._finish(system, n, wall)
            cli_launches = kernel_launches(kernels)
            fields = open("results.txt").read().strip().split(",")
            kitti = np.loadtxt("TrajectoryKITTIKeyFrame.txt", ndmin=2)
            euroc = np.loadtxt("TrajectoryEUROC.txt", ndmin=2)
            pngs = len([f for f in os.listdir("frames") if f.endswith(".png")]) if os.path.isdir("frames") else 0
        finally:
            os.chdir(cwd)
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    out["cli_synthetic"] = {"results": fields, "kitti_rows": len(kitti), "euroc_rows": len(euroc),
                            "ms_per_frame": 1e3 * wall / max(n, 1), "launches": cli_launches,
                            "viewer": {"cv2": has_cv2, "frames_seen": system.viewer.count, "pngs": pngs}}
    print(f"ingest: cli synthetic://n_frames=48: results.txt {','.join(fields)}, {len(kitti)} keyframe rows, "
          f"{len(euroc)} frame rows, {1e3 * wall / max(n, 1):.2f} ms/frame, score_candidates launches "
          f"{cli_launches['score_candidates']} on {card}", flush=True)
    print(f"ingest: --viewer: cv2 {'found' if has_cv2 else 'not found'}, the viewer saw "
          f"{system.viewer.count} frames and wrote {pngs} PNGs", flush=True)
    checks["cli synthetic: the viewer saw every frame, a PNG each where cv2 is found"] = (
        system.viewer.count == 48 and pngs == (48 if has_cv2 else 0))
    checks["cli synthetic: results.txt 48 frames, 0 lost"] = (len(fields) == 3 and int(fields[0]) == 48
                                                              and int(fields[1]) == 0)
    checks["cli synthetic: score_candidates launched"] = cli_launches["score_candidates"] > 0
    checks["cli synthetic: segment_sum launched"] = cli_launches["segment_sum"] > 0
    checks["cli synthetic: trajectory files"] = kitti.shape[1] == 13 and euroc.shape[1] == 8 and len(euroc) >= 40
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"ingest gates failed: {bad}")
    return out


def parallel_phase(System, settings, monocular, SyntheticStream, kernels, card, system):
    """Phase 10 (see the module docstring). `system` is phase 3's. Returns
    the numbers it printed."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from movslam_tpu_torch.core import local_mapping
    from movslam_tpu_torch.multistream_eval import frontend_inputs
    from movslam_tpu_torch.ops.ba import ba_solve
    from movslam_tpu_torch.ops.propagate import propagate_mv_tracks
    from movslam_tpu_torch.parallel import gba
    from movslam_tpu_torch.parallel.multistream import make_multistream_propagate
    from movslam_tpu_torch.parallel.sharded_ba import make_sharded_ba

    out, checks = {}, {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        # (a) S streams' MV propagation in one call against S single calls
        streams = [SyntheticStream(n_points=400, seed=100 + s) for s in range(MS_STREAMS)]
        args = [torch.as_tensor(a, device="cuda") for a in frontend_inputs(streams, cap=MS_TRACKS)]
        prop = make_multistream_propagate("cuda", group=group)
        reset_launches(kernels)
        got = prop(*args, THR)
        torch.cuda.synchronize()
        launches = kernel_launches(kernels)

        def singles():
            return [propagate_mv_tracks(*[a[s] for a in args], n_kps_capacity=args[9].shape[1], threshold=THR)
                    for s in range(MS_STREAMS)]

        one = singles()
        same = all(torch.equal(got[k], torch.stack([o[k] for o in one])) for k in got)
        batch_ms, singles_ms = call_ms(lambda: prop(*args, THR), reps=20), call_ms(singles, reps=5)
        out["multistream"] = {"streams": MS_STREAMS, "tracks": MS_TRACKS, "mvs": int(args[7].shape[1]),
                              "ms_per_batch": batch_ms, "ms_8_single_calls": singles_ms, "launches": launches,
                              "accepted": int(got["accepted"].sum())}
        print(f"parallel: multistream propagate, {MS_STREAMS} streams x {MS_TRACKS} tracks x "
              f"{args[7].shape[1]} MVs: {batch_ms:.2f} ms per batch ({launches['score_candidates']} score_candidates "
              f"launch) "
              f"against {singles_ms:.2f} ms for {MS_STREAMS} single-stream calls; equal: {same} on {card}",
              flush=True)
        checks["multistream: equal to single-stream calls"] = same
        checks["multistream: one score_candidates launch per batch"] = launches["score_candidates"] == 1

        # (b) the sharded BA against ba_solve, on phase 3's map's problem;
        # mono BA leaves the scale free, so poses and points are compared
        # without it, and the cost as tests/test_parallel.py compares it.
        m, cam = system.atlas.current, system.mapper.camera
        reset_launches(kernels)
        (w_kfs, n_anchor), = local_mapping.gba_windows(m)
        ordered, prob = local_mapping.gba_problem(m, w_kfs, n_anchor)
        sh = gba._shard_problem(prob, 1, prob["obp"].shape[1])
        T = lambda x: torch.as_tensor(np.ascontiguousarray(x), device="cuda")  # noqa: E731
        kf, mp, ob = prob["kf_pack"], prob["mp_pack"], prob["obs_pack"]
        R, t, X, costs = make_sharded_ba(group, iters=PAR_ITERS)(
            T(kf[:, 0:9].reshape(-1, 3, 3)), T(kf[:, 9:12]), T(kf[:, 12] > 0), T(kf[:, 13] > 0),
            T(sh["mp_pos"]), T(sh["mp_valid"]), T(sh["obs_kf"]), T(sh["obs_mp"]), T(sh["obs_uv"]),
            T(sh["obs_valid"]), T(sh["obp"]), cam.fx, cam.fy, cam.cx, cam.cy)
        ref, ref2 = (ba_solve(T(kf[:, 0:9].reshape(-1, 3, 3)), T(kf[:, 9:12]), T(kf[:, 12] > 0), T(kf[:, 13] > 0),
                              T(mp[:, 0:3]), T(mp[:, 3] > 0), T(ob[:, 0].astype(np.int64)),
                              T(ob[:, 1].astype(np.int64)), T(ob[:, 2:4]), T(ob[:, 5] > 0),
                              T(prob["obp"].astype(np.int64)), cam.fx, cam.fy, cam.cx, cam.cy, iters=PAR_ITERS)
                     for _ in range(2))
        torch.cuda.synchronize()
        # The card's sums are ordered (ops/kernels.segment_sum): two solves of
        # one problem give the same bits, and so may the one-rank sharded BA.
        repeat_equal = all(torch.equal(ref[k], ref2[k]) for k in ref)
        sharded_equal = all(torch.equal(a, ref[k]) for a, k in ((R, "kf_R"), (t, "kf_t"), (X, "mp_pos")))
        kv, pv = kf[:, 13] > 0, mp[:, 3] > 0
        seen2 = np.bincount(ob[ob[:, 5] > 0, 1].astype(np.int64), minlength=len(mp))[pv] >= 2
        k0 = int(np.flatnonzero(kv & (kf[:, 12] > 0))[0])  # the fixed keyframe
        Ra, ta, Xa = (x.double().cpu().numpy() for x in (R, t, X))
        Rb, tb, Xb = (ref[k].double().cpu().numpy() for k in ("kf_R", "kf_t", "mp_pos"))
        scale, ta_s, Xa_s = gba.remove_scale_gauge(Ra[kv], ta[kv], Xa[pv], Rb[kv], tb[kv], int(kv[:k0].sum()))
        dR = float(np.abs(Ra - Rb).max())
        dt = float(np.abs(ta_s - tb[kv]).max())
        dX, dX_s = float(np.abs(Xa - Xb)[pv].max()), float(np.abs(Xa_s - Xb[pv]).max())
        dX_s2 = float(np.abs(Xa_s - Xb[pv])[seen2].max())
        best, ref_cost = float(costs[torch.isfinite(costs)].min()), float(ref["cost"])
        out["sharded_ba"] = {"K": int(kf.shape[0]), "P": int(mp.shape[0]), "O": int(sh["Od"]),
                             "scale": scale, "max_R_diff": dR, "max_t_diff_scale_removed": dt,
                             "iters": PAR_ITERS, "max_point_diff": dX, "max_point_diff_scale_removed": dX_s,
                             "max_point_diff_scale_removed_seen_twice": dX_s2, "points_seen_twice": int(seen2.sum()),
                             "trial_cost_first": float(costs[0]), "trial_cost_best": best,
                             "ba_solve_cost": ref_cost, "ba_solve_twice_bit_equal": repeat_equal,
                             "bit_equal_to_ba_solve": sharded_equal}
        print(f"parallel: sharded BA (1 NCCL rank) vs ba_solve on phase 3's map (K={kf.shape[0]}, "
              f"P={mp.shape[0]}), {PAR_ITERS} iterations: scale {scale:.6f}, then max |t| diff {dt:.3e}; R "
              f"{dR:.3e}; points {dX:.3e} ({dX_s:.3e} without the scale, {dX_s2:.3e} over the {seen2.sum()} "
              f"seen twice or more); best trial cost {best:.4f} vs {ref_cost:.4f}; bit-equal to ba_solve "
              f"{sharded_equal}; two ba_solve calls bit-equal {repeat_equal} on {card}", flush=True)
        checks["ba_solve: two calls on one problem bit-equal"] = repeat_equal
        checks["sharded BA: R, t within 5e-3, points seen twice within 5e-2 without the scale"] = (
            dR < 5e-3 and dt < 5e-3 and dX_s2 < 5e-2)
        checks["sharded BA: cost <= 1.1x ba_solve's + 1e-3"] = best <= 1.1 * ref_cost + 1e-3
        checks["sharded BA: finite poses and points"] = all(bool(torch.isfinite(x).all()) for x in (R, t, X))

        # (c) System.global_bundle_adjustment(mesh=group) against mesh=None
        states = {}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "phase3.atlas")
            system.save_atlas(path)
            for label, mesh in (("mesh", group), ("one device", None)):
                sys_ = System(settings, monocular, device="cuda")
                sys_.load_atlas(path)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sys_.global_bundle_adjustment(iters=PAR_ITERS, mesh=mesh)
                torch.cuda.synchronize()
                mm = sys_.atlas.current
                states[label] = ({k: (kf_.R.copy(), kf_.t.copy()) for k, kf_ in mm.keyframes.items()},
                                 {k: mp.pos.copy() for k, mp in mm.mappoints.items()},
                                 {k: len(mp.obs) for k, mp in mm.mappoints.items()},
                                 1e3 * (time.perf_counter() - t0))
        (ka, pa, oa, ms_a), (kb, pb, ob, ms_b) = states["mesh"], states["one device"]
        kids, pids = sorted(kb), sorted(pb)
        pose = lambda st, i: np.array([st[k][i] for k in kids])  # noqa: E731
        scale, ta_s, Xa_s = gba.remove_scale_gauge(pose(ka, 0), pose(ka, 1), np.array([pa[k] for k in pids]),
                                         pose(kb, 0), pose(kb, 1), 0)  # the first keyframe is fixed
        gdt = float(np.abs(ta_s - pose(kb, 1)).max())
        gdR = float(np.abs(pose(ka, 0) - pose(kb, 0)).max())
        gd = np.abs(Xa_s - np.array([pb[k] for k in pids])).max(1)
        twice = np.array([ob[k] >= 2 for k in pids])
        gdX, gdX2 = float(gd.max()), float(gd[twice].max())
        # Pruning is judged from host f64 residuals on the mesh path (as in
        # the reference) and from f32 ones on one device: an observation at
        # the chi2 threshold may go either way.
        differ = sum(oa[k] != ob[k] for k in ob)
        out["gba_mesh"] = {"keyframes": len(kb), "map_points": len(pb), "ms_mesh": ms_a, "ms_one_device": ms_b,
                           "scale": scale, "max_t_diff_scale_removed": gdt, "max_R_diff": gdR,
                           "iters": PAR_ITERS, "max_point_diff_scale_removed": gdX,
                           "max_point_diff_scale_removed_seen_twice": gdX2, "points_seen_twice": int(twice.sum()),
                           "points_pruned_differently": differ}
        print(f"parallel: System.global_bundle_adjustment(iters={PAR_ITERS}, mesh=group) {ms_a:.2f} ms vs "
              f"mesh=None {ms_b:.2f} ms on phase 3's map ({len(kb)} keyframes, {len(pb)} points): scale "
              f"{scale:.6f}, then max |t| diff {gdt:.3e}, points {gdX:.3e} ({gdX2:.3e} over the {twice.sum()} "
              f"seen twice or more); R {gdR:.3e}; {differ} points pruned differently on {card}", flush=True)
        checks["gba mesh: same keyframes and points"] = set(ka) == set(kb) and set(pa) == set(pb)
        checks["gba mesh: pruning differs on <= 1% of points"] = differ <= 0.01 * len(ob)
        checks["gba mesh: R, t within 5e-3, points seen twice within 5e-2 without the scale"] = (
            gdt < 5e-3 and gdR < 5e-3 and gdX2 < 5e-2)
        out["launches_ba"] = kernel_launches(kernels)  # (b) and (c)
        checks["sharded and mesh BA: segment_sum launched"] = out["launches_ba"]["segment_sum"] > 0
    finally:
        dist.destroy_process_group()
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"parallel gates failed: {bad}")
    return out


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
        from movslam_tpu_torch.config.settings import IMU_MONOCULAR, MONOCULAR, STEREO, Settings
        from movslam_tpu_torch.core.camera import Pinhole
        from movslam_tpu_torch.core.system import System
        from movslam_tpu_torch.core.tracking import State
        from movslam_tpu_torch.io.mvimage import FrameType
        from movslam_tpu_torch.io.synthetic import SyntheticStream
        from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream
        from movslam_tpu_torch.io.synthetic_vi import SyntheticVIStream
        from movslam_tpu_torch.multistream_eval import scale_aligned_ate
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
    print(f"build: score_blocks.cu and segment_sum.cu compiled (in parallel) and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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

    # The stream axis (S streams of N tracks in one launch) and the CLI
    # decoder's M = 8192 MVs.
    streams = [candidate_case(kernels, rng, dev, H, W, N, CLI_MVS) for _ in range(S_STREAMS)]
    s8_args = [torch.stack([c[0] for c in streams])] + [
        torch.cat([c[i] for c in streams]).contiguous() for i in range(1, 6)]
    s8_args[2] = torch.cat([torch.where(c[2] >= 0, c[2] + k * CLI_MVS, c[2])
                            for k, c in enumerate(streams)]).contiguous()
    extra = {"S8_N2048_M8192": s8_args, "N2048_M8192": streams[0]}
    for label, args in extra.items():
        got = kernels.score_candidates(*args, THR)
        want = kernels.score_candidates_ref(*args, THR)
        torch.cuda.synchronize()
        err = max_err(got, want)
        cand_err = max(cand_err, err)
        if err:
            fail(f"score_candidates differs from score_candidates_ref at {label}: {err}")
    singles = [kernels.score_candidates(*c, THR) for c in streams]
    got = kernels.score_candidates(*s8_args, THR)
    offset = torch.arange(S_STREAMS, device=dev, dtype=torch.int32).repeat_interleave(N) * CLI_MVS
    mv = torch.cat([x[0] for x in singles])
    if max_err(got, [torch.where(mv >= 0, mv + offset, mv)] + [torch.cat(x) for x in list(zip(*singles))[1:]]):
        fail("score_candidates over 8 streams differs from 8 single-stream launches")
    print(f"kernels: score_candidates bit-exact with score_candidates_ref at S={S_STREAMS} streams x N={N} "
          f"x M={CLI_MVS} ({H}x{W}) and at N={N} M={CLI_MVS}; the 8-stream launch equals 8 single-stream "
          f"launches", flush=True)

    bargs = [torch.as_tensor(a, device=dev) for a in (img, tl, prev)]
    times = {}
    cases = (("score_blocks", "score_blocks", kernels.score_blocks, kernels.score_blocks_ref, bargs,
              "score_blocks_kernel", B),
             ("score_candidates", "score_candidates", kernels.score_candidates, kernels.score_candidates_ref,
              main_cargs, "score_candidates_kernel", 4 * N))
    cases += tuple((f"score_candidates {label}", "score_candidates", kernels.score_candidates,
                    kernels.score_candidates_ref, args, None, 4 * args[1].shape[0])
                   for label, args in extra.items())
    for key, name, fn, ref, args, kname, blocks in cases:
        t = {
            "plain_ms": call_ms(lambda: ref(*args, THR)),
            "ms": graph_ms(lambda: fn(*args, THR)),
            "wrapper_ms": call_ms(lambda: fn(*args, THR)),
            "profiler_ms": profiler_ms(lambda: fn(*args, THR), kname) if kname else None,
        }
        if kname:
            try:
                t["plain_device_ms"] = graph_ms(lambda: ref(*args, THR))
            except RuntimeError as e:  # a plain version that cannot be captured
                print(f"kernels: {name} plain version not captured in a graph: {e}", flush=True)
                t["plain_device_ms"] = None
        else:
            t["plain_device_ms"] = None
        out = fn(*args, THR)
        nbytes = sum(a.numel() * a.element_size() for a in args) + sum(
            o.numel() * o.element_size() for o in out)
        ops = blocks * (2 * 256 + 3 * 8)  # two compares a pixel; xor, popc, add a word
        t["bound_ms"], t["bound_by"] = bound(nbytes, ops)
        t["bytes"] = nbytes
        times[key] = t
        us = {k: (v * 1e3 if v is not None else float("nan")) for k, v in t.items() if k.endswith("ms")}
        print(f"kernels: {key}: device {us['ms']:.3f} us/launch (graph of {GRAPH_LAUNCHES}), "
              f"profiler {us['profiler_ms']:.3f} us/launch, wrapper {us['wrapper_ms']:.2f} us/call, "
              f"plain {us['plain_ms']:.2f} us/call (device {us['plain_device_ms']:.2f} us), "
              f"bound {us['bound_ms']:.4f} us ({t['bound_by']}, {nbytes} B) on {card}", flush=True)
    seg_err, seg_times = segment_sum_phase(kernels, rng, dev, card)

    phase_done("kernels")

    # --- 3. the per-frame monocular drive on the card -----------------------
    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    stream = SyntheticStream(n_points=400, seed=11)
    frames = [stream.frame(k) for k in range(N_FRAMES)]  # rendering is set-up
    n_pframes = sum(1 for k, f in enumerate(frames) if k > 0 and f.ft == FrameType.P_FRAME)
    reset_launches(kernels)
    poses3 = []
    with recorded_wires() as wires3:
        system, est, _, _ = drive(System, s, frames, MONOCULAR, poses=poses3)
    launches = kernel_launches(kernels)
    system.shutdown()
    torch.cuda.synchronize()

    m = system.atlas.current
    gt = lambda k: -(stream.gt_pose(k)[0].T @ stream.gt_pose(k)[1])  # noqa: E731
    ate_live = scale_aligned_ate([gt(k) for k in est], list(est.values()))[0]
    traj = system.frame_trajectory()
    ate_post = scale_aligned_ate([gt(round(ts * 30.0)) for ts, _, _, _ in traj],
                                 [-(R.T @ t) for _, R, t, _ in traj])[0]
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
        "segment_sum launched": launches["segment_sum"] > 0,
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"drive gates failed: {bad}")

    # The same drive again with the same seed. The card's sums are ordered
    # (ops/kernels.segment_sum), so every dispatched program's wire and
    # every pose must come out bit-equal, and with them the post-hoc ATE.
    # Frames 16-19 run under the profiler: phase 4's launches per frame of
    # the fused scoring come from this drive.
    reset_launches(kernels)
    poses_again = []
    with recorded_wires() as wires_again:
        again_sys, _, again_prof, again_wall = drive(System, s, frames, MONOCULAR, PROFILED, poses=poses_again)
    again_launches = kernel_launches(kernels)
    again_sys.shutdown()
    torch.cuda.synchronize()
    again = {"wires": digests(wires_again), "poses": pose_digests(poses_again),
             "trajectory": trajectory_digest(again_sys)}
    first = {"wires": digests(wires3), "poses": pose_digests(poses3), "trajectory": trajectory_digest(system)}
    repro = {"frames": N_FRAMES, "dispatches": [len(first["wires"]), len(again["wires"])],
             "first_wire_difference": first_difference(first["wires"], again["wires"]),
             "first_pose_difference": first_difference(first["poses"], again["poses"]),
             "trajectory_equal": first["trajectory"] == again["trajectory"], "ate_post": ate_post}
    print(f"repro: phase 3's drive again with the same seed: {repro['dispatches'][1]} programs dispatched "
          f"({repro['dispatches'][0]} before), first differing wire {repro['first_wire_difference']}, first "
          f"differing pose {repro['first_pose_difference']}, trajectory bit-equal {repro['trajectory_equal']}; "
          f"post-hoc ATE {ate_post:.4f} m on {card}", flush=True)
    if repro["first_wire_difference"] is not None or repro["first_pose_difference"] is not None \
            or not repro["trajectory_equal"]:
        fail(f"reproducibility gate failed: {repro}")

    phase_done("drive")

    # --- 4. launches per frame, fused scoring vs the unfused composition ------
    # The fused scoring's frames were profiled in phase 3's repeat; the
    # unfused composition drives the first 20 frames again.
    unfused = functools.partial(kernels.score_candidates_ref, block_scorer=kernels.score_blocks)
    fused = propagate.score_candidates
    propagate.score_candidates = unfused
    reset_launches(kernels)
    try:
        unfused_run = drive(System, s, frames[:L_FRAMES], MONOCULAR, PROFILED)
    finally:
        propagate.score_candidates = fused
    unfused_run[0].shutdown()
    torch.cuda.synchronize()
    per_frame = {}
    for label, (psys, prof, wall, counts) in (
            ("score_candidates", (again_sys, again_prof, again_wall, again_launches)),
            ("unfused", (unfused_run[0], unfused_run[2], unfused_run[3], kernel_launches(kernels)))):
        host, devk, busy = launch_counts(prof, len(PROFILED))
        per_frame[label] = {
            "host_launches": host, "device_kernels": devk, "busy_ms": busy,
            "wall_ms": wall * 1e3 / len(PROFILED),
            "track_ms_10_15": float(np.mean(psys.track_ms[10:PROFILED[0]])),
            "frames": len(psys.track_ms), "score_blocks": counts["score_blocks"],
            "score_candidates": counts["score_candidates"], "lost": psys.get_total_lost(),
        }
        r = per_frame[label]
        print(f"launches: {label} scoring, frames {PROFILED[0]}-{PROFILED[-1]} under the profiler: "
              f"{host:.1f} launch calls/frame, {devk:.1f} device kernels/frame, device busy "
              f"{busy:.2f} ms of {r['wall_ms']:.2f} ms/frame with the profiler on "
              f"(idle {1 - busy / r['wall_ms']:.3f}); "
              f"track_ms frames 10-{PROFILED[0] - 1} {r['track_ms_10_15']:.2f} ms; score_blocks launches "
              f"{r['score_blocks']}, score_candidates launches {r['score_candidates']}, "
              f"lost {r['lost']} on {card}", flush=True)
    d_host = per_frame["unfused"]["host_launches"] - per_frame["score_candidates"]["host_launches"]
    print(f"launches: fusing the scoring step removes {d_host:.1f} launch calls/frame", flush=True)
    if per_frame["unfused"]["score_blocks"] == 0:
        fail("the unfused composition never launched score_blocks")
    phase_done("launches")

    # --- 5. the windowed drive on the card -------------------------------------
    win = windowed_phase(System, s, MONOCULAR, SyntheticStream, kernels, card)
    phase_done("windows")

    # --- 6. stereo, per frame and windowed, on the card ---------------------------
    ss = Settings()
    ss.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    ss.fps = 30.0
    ss.sensor = STEREO
    ss.b, ss.bf, ss.th_depth = STEREO_B, STEREO_BF, 50.0
    ste = stereo_phase(System, ss, STEREO, State, SyntheticStereoStream, kernels, card)
    phase_done("stereo")

    # --- 7. visual-inertial, per frame and windowed, on the card -----------------
    vs = Settings()
    vs.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    vs.fps = 30.0
    vs.sensor = IMU_MONOCULAR
    vi = vi_phase(System, vs, IMU_MONOCULAR, SyntheticVIStream, kernels, card)
    phase_done("vi")

    # --- 8. the Atlas back end on phase 3's map -------------------------------------
    atlas = atlas_phase(System, s, MONOCULAR, system, stream, card)
    phase_done("atlas")

    # --- 9. video ingest and the CLI's drive ----------------------------------------
    ingest = ingest_phase(System, s, MONOCULAR, SyntheticStream, kernels, card)
    phase_done("ingest")

    # --- 10. parallel/ over a one-rank NCCL group -----------------------------------
    par = parallel_phase(System, s, MONOCULAR, SyntheticStream, kernels, card, system)
    phase_done("parallel")
    check_banned()

    drives = ("per-frame drive (phase 3); launches_windowed: windowed drive (phase 5); "
              "launches_stereo_*: the stereo drives (phase 6); launches_vi_*: the VI drives (phase 7); "
              "launches_atlas: the Atlas back end (phase 8: merges, global BA); launches_h264: the real-H.264 "
              "drive (phase 9; null where libav is absent); launches_cli_synthetic: the CLI's drive on "
              "synthetic://n_frames=48 (phase 9); launches_multistream: one 8-stream batch (phase 10); "
              "launches_parallel_ba: the sharded BA, two ba_solve calls and the mesh global BA (phase 10)")
    seg_main = "local_ba pair_C36"  # the largest sum of phase 3's local BA
    times["segment_sum"] = dict(seg_times[seg_main], profiler_ms=None, plain_device_ms=None)
    rows = []
    for name, src, replaces, launched, path in (
        ("score_candidates", "movslam_tpu_torch/csrc/score_blocks.cu", "movslam_tpu/ops/pallas_kernels.py:129",
         launches["score_candidates"], drives),
        ("score_blocks", "movslam_tpu_torch/csrc/score_blocks.cu", "movslam_tpu/ops/pallas_kernels.py:129",
         per_frame["unfused"]["score_blocks"], "per-frame drive with unfused scoring (phase 4)"),
        ("segment_sum", "movslam_tpu_torch/csrc/segment_sum.cu",
         "none (no TPU kernel; stands in for jax.ops.segment_sum, movslam_tpu/ops/ba.py:119)",
         launches["segment_sum"], drives),
    ):
        t = times[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launched, "launches_windowed": win["launches"][name],
            "launches_stereo_windowed": ste["windowed"]["launches"][name],
            "launches_stereo_per_frame": ste["per_frame"]["launches"][name],
            "launches_vi_per_frame": vi["per_frame"]["launches"][name],
            "launches_vi_windowed": vi["windowed"]["launches"][name],
            "launches_h264": ingest["launches"][name] if ingest["launches"] is not None else None,
            "launches_cli_synthetic": ingest["cli_synthetic"]["launches"][name],
            "launches_multistream": par["multistream"]["launches"][name],
            "launches_atlas": atlas["launches"][name],
            "launches_parallel_ba": par["launches_ba"][name],
            "path": path,
            "max_abs_err": {"score_candidates": cand_err, "score_blocks": blocks_err, "segment_sum": seg_err}[name],
            "ms": t["ms"], "wrapper_ms": t["wrapper_ms"], "profiler_ms": t["profiler_ms"],
            "plain_ms": t["plain_ms"], "plain_device_ms": t["plain_device_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
        })
        if name == "score_candidates":
            rows[-1]["other_shapes"] = {
                label: {k: times[f"score_candidates {label}"][k]
                        for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "bytes")}
                for label in ("S8_N2048_M8192", "N2048_M8192")}
        if name == "segment_sum":
            rows[-1]["shape"] = seg_main
            rows[-1]["other_shapes"] = {label: v for label, v in seg_times.items() if label != seg_main}
    print(json.dumps({"reproducibility": repro, "card": card}), flush=True)
    print(json.dumps({"launches_per_frame": per_frame, "card": card}), flush=True)
    print(json.dumps({"windowed_drive": win, "card": card}), flush=True)
    print(json.dumps({"stereo_drive": ste, "card": card}), flush=True)
    print(json.dumps({"vi_drive": vi, "card": card}), flush=True)
    print(json.dumps({"atlas": atlas, "card": card}), flush=True)
    print(json.dumps({"ingest": ingest, "card": card}), flush=True)
    print(json.dumps({"parallel": par, "card": card}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
