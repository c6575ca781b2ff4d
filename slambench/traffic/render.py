"""Render a cell's frames in parallel, in set-up.

Rendering is host numpy at ~0.1 s a frame, as slow as the drive itself, so
it runs in set-up over the host's cores (spawned workers that import numpy
and traffic/synthetic.py only, one BLAS thread each) and never in the
measured window. Each worker renders a contiguous chunk and sends it back
packed. Nothing is cached on disk: a run that loaded a cached sequence
measured its window faster than one that had just rendered it (PERF.md),
so every run renders.
"""
from __future__ import annotations

import multiprocessing
import os

import numpy as np

from . import synthetic

FIXED = ("im_gray", "gt_R", "gt_t")
RAGGED = ("mv_delta", "mv_rect", "mv_dindx", "kps_rect")  # one row per macroblock kept
SCALARS = ("ft", "timestamp", "coverage")
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def scene_args(config, mix, seed):
    """The Scene's keyword arguments for a configuration and a traffic mix."""
    cam = config["camera"]
    return dict(
        camera=synthetic.Camera(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["width"], cam["height"]),
        fps=cam["fps"], seed=seed, **mix["scene"],
    )


def seed_of(seed):
    """The generator's seed: any whole number, negative ones included."""
    return int(seed) % 2**63


def _pack(frames):
    """Frames (dicts) -> arrays: fixed-shape ones stacked, ragged ones
    concatenated with their row counts."""
    out = {name: np.stack([f[name] for f in frames]) for name in FIXED}
    out.update({name: np.concatenate([f[name] for f in frames]) for name in RAGGED})
    out.update({name: np.array([f[name] for f in frames]) for name in SCALARS})
    out["rows"] = np.array([len(f["mv_delta"]) for f in frames])
    return out


def _unpack(data):
    ends = np.cumsum(data["rows"])
    frames = []
    for i, (stop, rows) in enumerate(zip(ends, data["rows"])):
        f = {name: data[name][i] for name in FIXED}
        f.update({name: data[name][stop - rows: stop] for name in RAGGED})
        f.update(ft=int(data["ft"][i]), timestamp=float(data["timestamp"][i]),
                 coverage=float(data["coverage"][i]))
        frames.append(f)
    return frames


def _render_chunk(args, start, stop):
    scene = synthetic.Scene(**args)
    return _pack([scene.frame(k) for k in range(start, stop)])


def frames(config, mix, seed, n, workers=None):
    """The first n frames of the cell's sequence for `seed`, as dicts
    (traffic/synthetic.Scene.frame)."""
    args = scene_args(config, mix, seed_of(seed))
    workers = max(1, min(workers or os.cpu_count() or 1, n))
    bounds = np.linspace(0, n, workers + 1).astype(int)
    chunks = [(args, int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
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
