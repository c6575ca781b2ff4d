"""Render a cell's frames in parallel, in set-up.

Rendering is host numpy at ~0.1 s a frame, as slow as the drive itself, so
it runs in set-up over the host's cores (spawned workers that import numpy
and traffic/synthetic.py only, one BLAS thread each) and never in the
measured window. Each worker renders a contiguous chunk and sends it back
packed. Nothing is cached on disk: a run that loaded a cached sequence
measured its window faster than one that had just rendered it (PERF.md),
so every run renders.

A configuration's sensor adds to each frame what the port's batch entry
takes beside the left image: an IMU_MONOCULAR frame its IMU rows
(traffic/synthetic_vi.py; `imu`, None on frame 0), a STEREO frame the right
camera's image (traffic/synthetic_stereo.py; `im_right`). A MONOCULAR
frame carries neither, and renders as it did before they existed.
"""
from __future__ import annotations

import multiprocessing
import os

import numpy as np

from . import synthetic, synthetic_stereo, synthetic_vi

FIXED = ("im_gray", "gt_R", "gt_t")
RAGGED = ("mv_delta", "mv_rect", "mv_dindx", "kps_rect")  # one row per macroblock kept
SCALARS = ("ft", "timestamp", "coverage")
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def camera(block):
    """synthetic.Camera of a configuration's camera block."""
    return synthetic.Camera(block["fx"], block["fy"], block["cx"], block["cy"], block["width"], block["height"])


def scene_args(config, mix, seed):
    """The Scene's keyword arguments for a configuration and a traffic mix."""
    return dict(camera=camera(config["camera"]), fps=config["camera"]["fps"], seed=seed, **mix["scene"])


def sensor_args(config):
    """What a frame carries beside the left camera's, by the configuration's
    sensor: {"imu_rows": IMU rows a frame} or {"stereo": the right camera},
    or None for a monocular one."""
    sensor = config.get("sensor")
    if sensor == "IMU_MONOCULAR":
        return {"imu_rows": round(float(config["imu"]["frequency"]) / float(config["camera"]["fps"]))}
    if sensor == "STEREO":
        stereo = config["stereo"]
        if "T_c1_c2" in stereo:
            return {"stereo": {"camera2": camera(config["camera2"]), "T_c1_c2": stereo["T_c1_c2"]}}
        return {"stereo": {"baseline": float(stereo["b"])}}
    return None


def seed_of(seed):
    """The generator's seed: any whole number, negative ones included."""
    return int(seed) % 2**63


def _pack(frames):
    """Frames (dicts) -> arrays: fixed-shape ones stacked, ragged ones
    concatenated with their row counts."""
    fixed = FIXED + tuple(name for name in ("im_right",) if name in frames[0])
    out = {name: np.stack([f[name] for f in frames]) for name in fixed}
    out.update({name: np.concatenate([f[name] for f in frames]) for name in RAGGED})
    out.update({name: np.array([f[name] for f in frames]) for name in SCALARS})
    out["rows"] = np.array([len(f["mv_delta"]) for f in frames])
    if "imu" in frames[0]:
        imu = [np.zeros((0, 7), np.float32) if f["imu"] is None else f["imu"] for f in frames]
        out["imu"], out["imu_rows"] = np.concatenate(imu), np.array([len(x) for x in imu])
    return out


def _unpack(data):
    ends = np.cumsum(data["rows"])
    fixed = FIXED + tuple(name for name in ("im_right",) if name in data)
    imu_ends = np.cumsum(data["imu_rows"]) if "imu" in data else None
    frames = []
    for i, (stop, rows) in enumerate(zip(ends, data["rows"])):
        f = {name: data[name][i] for name in fixed}
        f.update({name: data[name][stop - rows: stop] for name in RAGGED})
        f.update(ft=int(data["ft"][i]), timestamp=float(data["timestamp"][i]),
                 coverage=float(data["coverage"][i]))
        if imu_ends is not None:
            n = data["imu_rows"][i]
            f["imu"] = data["imu"][imu_ends[i] - n: imu_ends[i]] if n else None
        frames.append(f)
    return frames


def _render_chunk(args, start, stop, sensors=None):
    scene = synthetic.Scene(**args)
    frames = [scene.frame(k) for k in range(start, stop)]
    if sensors and "imu_rows" in sensors:
        for k, f in zip(range(start, stop), frames):
            f["imu"] = synthetic_vi.imu_window(scene, k, sensors["imu_rows"])
    if sensors and "stereo" in sensors:
        rig = sensors["stereo"]
        right = (synthetic_stereo.right_scene(scene, rig["baseline"]) if "baseline" in rig
                 else synthetic_stereo.raw_right_scene(scene, rig["camera2"], rig["T_c1_c2"]))
        for k, f in zip(range(start, stop), frames):
            f["im_right"] = right.render(k)
    return _pack(frames)


def frames(config, mix, seed, n, workers=None):
    """The first n frames of the cell's sequence for `seed`, as dicts
    (traffic/synthetic.Scene.frame, with the sensor's `imu` or `im_right`)."""
    args, sensors = scene_args(config, mix, seed_of(seed)), sensor_args(config)
    workers = max(1, min(workers or os.cpu_count() or 1, n))
    bounds = np.linspace(0, n, workers + 1).astype(int)
    chunks = [(args, int(a), int(b), sensors) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    if len(chunks) == 1:
        return _unpack(_render_chunk(*chunks[0]))
    # One BLAS thread a worker: the workers already fill the cores.
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update({k: "1" for k in THREAD_VARS})
    try:
        pool = multiprocessing.get_context("spawn").Pool(len(chunks))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    try:
        packed = pool.starmap(_render_chunk, chunks)
    finally:
        pool.close()
        pool.join()
    return [f for data in packed for f in _unpack(data)]
